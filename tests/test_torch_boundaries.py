"""The rules rdycore_tpu_torch keeps, checked on the CPU.

- Importing it imports neither jax nor rdycore_tpu.
- Without a CUDA device, entry points called without `device` raise
  RuntimeError instead of running on the CPU.
- The kernel wrappers take their plain PyTorch versions for CPU tensors
  (and count no launch).
- Each feature outside the ported slices raises NotImplementedError.
- `operator_arrays_from_numpy` carries a JAX OperatorArrays across exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rdycore_tpu.mesh import native as jax_native
from rdycore_tpu.mesh import structured_quad as jax_structured_quad
from rdycore_tpu.operator import build_operator as jax_build_operator
from rdycore_tpu_torch import Simulation, build_operator
from rdycore_tpu_torch.config.yaml_input import config_from_dict
from rdycore_tpu_torch.convert import operator_arrays_from_numpy
from rdycore_tpu_torch.io.writers import attach_output_monitors
from rdycore_tpu_torch.mesh import structured_quad
from rdycore_tpu_torch.operator import bnd_codes
from rdycore_tpu_torch.ops import kernels
from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
from rdycore_tpu_torch.timestepping import make_interval_advancer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BC_TYPES = {"left": 0, "right": 2}


def test_import_pulls_in_no_jax():
    code = (
        "import sys, rdycore_tpu_torch, rdycore_tpu_torch.__main__\n"
        "import rdycore_tpu_torch.convert, rdycore_tpu_torch.io.writers\n"
        "import rdycore_tpu_torch.io.time_series, rdycore_tpu_torch.ops.structured\n"
        "import rdycore_tpu_torch.ops.kernels.raster_step\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'rdycore_tpu' or "
        "m.startswith('rdycore_tpu.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env,
                   timeout=120)


def _deck(**numerics):
    return config_from_dict({
        "numerics": numerics,
        "time": {"stop": 0.01, "time_step": 0.001},
        "logging": {"level": "none"},
    }).validate()


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = structured_quad(4, 3, 0.0, 1.0, 0.0, 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_operator(mesh)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_operator(mesh, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(_deck(), mesh=mesh)
    assert Simulation(_deck(), mesh=mesh, device="cpu").q.device.type == "cpu"


def _inputs(seed=0):
    mesh = structured_quad(8, 6, 0.0, 1.0, 0.0, 1.0)
    op = build_operator(mesh, bc_types=BC_TYPES, mannings_n=np.full(48, 0.02),
                        device="cpu")
    rng = np.random.default_rng(seed)
    h = rng.uniform(0.0, 1.0, mesh.num_cells)
    q = torch.as_tensor(np.stack([h, 0.1 * h, -0.1 * h]))
    bv = torch.as_tensor(rng.uniform(0.1, 0.3, (3, op.num_boundary_edges)))
    return op, q, bv


def test_wrappers_take_plain_versions_on_cpu():
    op, q, bv = _inputs()
    kernels.reset_launch_counts()
    flux, courant = op.edge_flux(q, bv)
    fp, cp = swe_edge_flux_plain(op.arrays, q, bv, op.tiny_h, op.h_anuga)
    assert torch.equal(flux, fp) and torch.equal(courant, cp)
    assert flux.shape == (3, op.num_edges + 1) and torch.all(flux[:, -1] == 0)

    dt = torch.tensor(0.001, dtype=q.dtype)
    out = op.cell_stage(flux, q, dt, None, stage=(0.0, 1.0, 1.0),
                        emit_prim=True)
    plain = swe_cell_stage_plain(
        op.arrays, flux, q, dt, None, tiny_h=op.tiny_h, h_anuga=op.h_anuga,
        xq2018_threshold=op.xq2018_threshold, source_method=op.source_method,
        stage=(0.0, 1.0, 1.0), emit_prim=True,
    )
    assert torch.equal(out.q_out, plain.q_out)
    assert torch.equal(out.prim, plain.prim)

    run_max = torch.zeros((), dtype=q.dtype)
    run_idx = torch.zeros((), dtype=torch.int32)
    m, i = kernels.courant_argmax(courant, dt, run_max, run_idx)
    assert (m, i) == courant_argmax_plain(courant)
    assert float(run_max) == float(m * dt) and int(run_idx) == int(i)
    assert [k.launches for k in kernels.KERNELS] == [0, 0, 0, 0]


def test_courant_argmax_ties_go_to_lowest_index():
    x = torch.tensor([1.0, 3.0, 2.0, 3.0, 3.0], dtype=torch.float64)
    m, i = kernels.courant_argmax(x)
    assert float(m) == 3.0 and int(i) == 1


def test_stage_with_gamma_other_than_beta_is_refused():
    op, q, bv = _inputs()
    flux, _ = op.edge_flux(q, bv)
    with pytest.raises(ValueError, match="gamma"):
        op.cell_stage(flux, q, torch.tensor(0.001, dtype=q.dtype), None,
                      stage=(0.5, 0.5, 0.25))


@pytest.mark.parametrize("numerics, physics", [
    ({"edge_flux_backend": "fused_structured", "second_order": True}, {}),
    ({"edge_flux_backend": "fused_structured"}, {"sediment": {"num_classes": 1}}),
    ({"edge_flux_backend": "fused_structured", "temporal": "beuler"}, {}),
    ({"second_order": True}, {}),
    ({"temporal": "ark_imex"}, {}),
    ({"temporal": "beuler"}, {}),
    ({"cell_ordering": "rcm"}, {}),
    ({}, {"flow": {"well_balancing": "hydrostatic_reconstruction"}}),
    ({}, {"flow": {"well_balancing": "bs2002"}}),
    ({}, {"sediment": {"num_classes": 1}}),
    ({}, {"salinity": True}),
    ({}, {"heat": True}),
])
def test_features_outside_the_slice_raise(numerics, physics):
    cfg = config_from_dict({
        "numerics": numerics, "physics": physics,
        "time": {"stop": 0.01, "time_step": 0.001},
    }).validate()
    mesh = structured_quad(4, 3, 0.0, 1.0, 0.0, 1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Simulation(cfg, mesh=mesh, device="cpu")


@pytest.mark.parametrize("section", [
    {"parallel": {"n_devices": 2}},
    {"restart": {"file": "ckpt.h5"}},
    {"checkpoint": {"interval": 5}},
    {"ensemble": {"size": 1, "members": [{"name": "m0"}]}},
])
def test_run_modes_outside_the_slice_raise(section):
    cfg = config_from_dict({
        **section, "time": {"stop": 0.01, "time_step": 0.001},
    }).validate()
    mesh = structured_quad(4, 3, 0.0, 1.0, 0.0, 1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Simulation(cfg, mesh=mesh, device="cpu")


@pytest.mark.parametrize("call", [
    lambda sim: sim.mark_cells_for_amr(np.ones(sim.num_cells, bool)),
    lambda sim: sim.perform_amr(),
])
def test_amr_raises(call):
    cfg = config_from_dict({"time": {"stop": 0.01, "time_step": 0.001}})
    sim = Simulation(cfg.validate(), device="cpu",
                     mesh=structured_quad(4, 3, 0.0, 1.0, 0.0, 1.0))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 14"):
        call(sim)


@pytest.mark.parametrize("fmt", ["xdmf", "cgns"])
def test_hdf5_outputs_raise(fmt, tmp_path):
    cfg = config_from_dict({
        "output": {"format": fmt, "directory": str(tmp_path)},
        "time": {"stop": 0.01, "time_step": 0.001},
    }).validate()
    sim = Simulation(cfg, mesh=structured_quad(4, 3, 0.0, 1.0, 0.0, 1.0),
                     device="cpu")
    with pytest.raises(NotImplementedError, match="binary"):
        attach_output_monitors(sim)


def test_diffusion_mode_raises():
    cfg = config_from_dict({
        "physics": {"flow": {"mode": "diffusion"}},
        "time": {"stop": 0.01, "time_step": 0.001},
    }).validate()
    with pytest.raises(NotImplementedError, match="swe"):
        Simulation(cfg, mesh=structured_quad(4, 3, 0.0, 1.0, 0.0, 1.0),
                   device="cpu")


def test_pallas_backend_selects_the_same_path():
    op, q, bv = _inputs()
    cfgs = [config_from_dict({
        "numerics": {"edge_flux_backend": b},
        "time": {"stop": 0.004, "time_step": 0.001},
        "logging": {"level": "none"},
    }).validate() for b in ("xla", "pallas")]
    mesh = structured_quad(8, 6, 0.0, 1.0, 0.0, 1.0)
    sims = [Simulation(c, mesh=mesh, device="cpu") for c in cfgs]
    for sim in sims:
        sim.set_solution(q.numpy())
        sim.run()
    assert np.array_equal(sims[0].get_solution(), sims[1].get_solution())


def test_implicit_schemes_raise_in_the_advancer():
    op, _, _ = _inputs()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_interval_advancer(op, "beuler")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_operator_arrays_round_trip(dtype):
    import jax.numpy as jnp

    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    jmesh = jax_structured_quad(10, 7, 0.0, 2.0, 0.0, 1.0)
    n = np.random.default_rng(2).uniform(0.01, 0.05, jmesh.num_cells)
    jop = jax_build_operator(jmesh, bc_types=BC_TYPES, mannings_n=n,
                             dtype=jdtype)
    d = {k: np.asarray(v) for k, v in jop.arrays._asdict().items()
         if v is not None}
    d["bnd_code"] = bnd_codes(jop.segments)
    arrays = operator_arrays_from_numpy(d, "cpu", dtype)
    back = arrays.numpy()
    assert set(back) <= set(d)
    for k, v in back.items():
        assert v.dtype == d[k].dtype, k
        assert np.array_equal(v, d[k]), k

    # the port builds the same arrays from its own copy of the mesh code. Its
    # edges are numbered as the JAX package's native mesh builder numbers
    # them (first appearance); the JAX package's NumPy fallback, taken where
    # that library cannot be built or loaded, numbers them otherwise, and
    # then only the cell fields can be compared
    own = build_operator(structured_quad(10, 7, 0.0, 2.0, 0.0, 1.0),
                         bc_types=BC_TYPES, mannings_n=n, dtype=dtype,
                         device="cpu")
    own_arrays = own.arrays.numpy()
    cell_fields = ("area", "dz_dx", "dz_dy", "cell_z", "mannings_n")
    for k in own_arrays if jax_native.available() else cell_fields:
        assert np.array_equal(own_arrays[k], back[k]), k
    assert [(s.name, s.bc_type, s.start, s.count) for s in own.segments] == [
        (s.name, s.bc_type, s.start, s.count) for s in jop.segments
    ]

    with pytest.raises(KeyError, match="bnd_code"):
        operator_arrays_from_numpy(
            {k: v for k, v in d.items() if k != "bnd_code"}, "cpu", dtype
        )
