"""The rules rdycore_tpu_torch keeps, checked on the CPU.

- Importing it imports neither jax nor rdycore_tpu.
- Without a CUDA device, entry points called without `device` raise
  RuntimeError instead of running on the CPU.
- The kernel wrappers take their plain PyTorch versions for CPU tensors
  (and count no launch).
- Each feature outside the ported slices raises NotImplementedError, with
  tracers too; `cell_ordering: rcm`, once among them, runs on an Exodus
  mesh with every unstructured mode and is the JAX package's ConfigError
  on the raster; a deck with an `ensemble` section, once among them,
  runs its base deck as the JAX package's Simulation does, and AMR, once
  refused, raises the JAX package's errors.
- `operator_arrays_from_numpy` carries a JAX OperatorArrays across exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from rdycore_tpu.config.schema import ConfigError as JaxConfigError
from rdycore_tpu.config.yaml_input import config_from_dict as jax_config_from_dict
from rdycore_tpu.config.yaml_input import load_config as jax_load_config
from rdycore_tpu.mesh import native as jax_native
from rdycore_tpu.mesh import structured_quad as jax_structured_quad
from rdycore_tpu.operator import build_operator as jax_build_operator
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, build_operator, load_config, timestepping
from rdycore_tpu_torch.config.schema import ConfigError
from rdycore_tpu_torch.config.yaml_input import config_from_dict
from rdycore_tpu_torch.convert import operator_arrays_from_numpy
from rdycore_tpu_torch.io.writers import attach_output_monitors
from rdycore_tpu_torch.mesh import structured_quad, structured_tri
from rdycore_tpu_torch.operator import bnd_codes
from rdycore_tpu_torch.ops import kernels
from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
from rdycore_tpu_torch.timestepping import make_interval_advancer
from tools.torch_flood_files import MeshFile, write_exodus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BC_TYPES = {"left": 0, "right": 2}


def test_import_pulls_in_no_jax():
    code = (
        "import sys, rdycore_tpu_torch, rdycore_tpu_torch.__main__\n"
        "import rdycore_tpu_torch.convert, rdycore_tpu_torch.io.writers\n"
        "import rdycore_tpu_torch.io.time_series, rdycore_tpu_torch.ops.structured\n"
        "import rdycore_tpu_torch.ops.kernels.raster_step\n"
        "import rdycore_tpu_torch.forcing, rdycore_tpu_torch.io.netcdf3\n"
        "import rdycore_tpu_torch.mesh.exodus, rdycore_tpu_torch.mesh.native\n"
        "import rdycore_tpu_torch.ensemble, rdycore_tpu_torch.amr\n"
        "import rdycore_tpu_torch.profiling\n"
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
    assert not any(k.launches for k in kernels.KERNELS)


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
    # on the raster paths RCM is a ConfigError in both packages (their
    # raster detection refuses a reordered mesh)
    ({"edge_flux_backend": "fused_structured", "second_order": True,
      "temporal": "beuler", "cell_ordering": "rcm"}, {}),
    ({"edge_flux_backend": "fused_structured", "temporal": "beuler",
      "cell_ordering": "rcm"}, {"sediment": {"num_classes": 1}}),
    ({"edge_flux_backend": "fused_structured", "temporal": "beuler",
      "cell_ordering": "rcm"}, {}),
    # on the unstructured path RCM runs with every scheme, second order,
    # well-balancing and tracers
    ({"second_order": True, "temporal": "beuler", "cell_ordering": "rcm"},
     {"flow": {"well_balancing": "bs2002"}}),
    ({"temporal": "ark_imex", "cell_ordering": "rcm"}, {}),
    ({"temporal": "beuler", "cell_ordering": "rcm"}, {}),
    ({"cell_ordering": "rcm"}, {}),
    ({"temporal": "ark_imex", "cell_ordering": "rcm"},
     {"flow": {"well_balancing": "hydrostatic_reconstruction"}}),
    ({"temporal": "beuler", "cell_ordering": "rcm"},
     {"flow": {"well_balancing": "bs2002"}}),
    ({"cell_ordering": "rcm"}, {"sediment": {"num_classes": 1},
          "flow": {"well_balancing": "hydrostatic_reconstruction"}}),
    ({"temporal": "ark_imex", "cell_ordering": "rcm"}, {"salinity": True}),
    ({"temporal": "beuler", "cell_ordering": "rcm"},
     {"heat": True, "flow": {"well_balancing": "hydrostatic_reconstruction"}}),
])
def test_features_outside_the_slice_raise(numerics, physics, tmp_path,
                                         monkeypatch):
    """Each of these decks asks for `cell_ordering: rcm`, which raised
    until the mesh files and RCM were ported. On a mesh read from an
    Exodus file, the unstructured ones now reorder it and take a step;
    on fused_structured RCM is the JAX package's ConfigError."""
    write_exodus(str(tmp_path / "m.exo"), shuffled_mesh_file())
    path = str(tmp_path / "deck.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({
            "numerics": numerics, "physics": physics,
            "time": {"stop": 0.001, "time_step": 0.001},
            "grid": {"file": "m.exo"}, "logging": {"level": "none"},
        }, f)
    if numerics.get("edge_flux_backend") == "fused_structured":
        with pytest.raises(JaxConfigError):
            JaxSimulation(jax_load_config(path))
        with pytest.raises(ConfigError, match="raster"):
            Simulation(load_config(path), device="cpu")
        return
    monkeypatch.setattr(timestepping, "NEWTON_ITERS", 1)
    monkeypatch.setattr(timestepping, "KRYLOV_M", 2)
    sim = Simulation(load_config(path), device="cpu")
    nat = sim.get_natural_ids()
    assert not np.array_equal(nat, np.arange(sim.num_cells))
    assert np.array_equal(np.sort(nat), np.arange(sim.num_cells))
    sim.run()
    assert sim.step == 1 and np.isfinite(sim.get_solution()).all()


def shuffled_mesh_file():
    """structured_tri(4, 3) over 1 m x 1 m, its cells shuffled, one block
    and no side set: an Exodus mesh that RCM reorders."""
    mesh = structured_tri(4, 3, 0.0, 1.0, 0.0, 1.0)
    perm = np.random.default_rng(0).permutation(mesh.num_cells)
    return MeshFile(mesh.points, mesh.cell_vertices[perm],
                    np.ones(mesh.num_cells, int), {1: "all"}, [])


@pytest.mark.parametrize("section", [
    # shards run since they were ported (tests/test_torch_sharded*.py):
    # both packages reorder the cells by RCM (partitioning: auto), so the
    # states are compared in natural order
    {"parallel": {"n_devices": 2}},
    {"parallel": {"n_devices": 4}},
    # a deck with an ensemble section: Simulation runs its base deck, as
    # the JAX package's does (the members: tests/test_torch_ensemble.py)
    {"ensemble": {"size": 2, "members": [{"name": "m0"}, {"name": "m1"}]}},
    {"ensemble": {"size": 1, "members": [{"name": "m0"}]}},
])
def test_run_modes_outside_the_slice_raise(section):
    cfg = config_from_dict({
        **section, "time": {"stop": 0.01, "time_step": 0.001},
    }).validate()
    mesh = structured_quad(4, 3, 0.0, 1.0, 0.0, 1.0)
    jax_cfg = jax_config_from_dict({
        **section, "time": {"stop": 0.01, "time_step": 0.001},
    }).validate()
    want = JaxSimulation(jax_cfg, mesh=jax_structured_quad(
        4, 3, 0.0, 1.0, 0.0, 1.0))
    sim = Simulation(cfg, mesh=mesh, device="cpu")
    q = np.zeros((3, 12))  # in natural order
    q[0] = np.linspace(0.1, 0.5, 12)
    got = []
    for s in (sim, want):
        nat = np.asarray(s.get_natural_ids())
        s.set_solution(q[:, nat])
        s.run()
        got.append(np.empty((3, 12)))
        got[-1][:, nat] = s.get_solution()
    assert sim.step == want.step == 10
    np.testing.assert_allclose(got[0], got[1], rtol=0, atol=1e-12)


@pytest.mark.parametrize("call", [
    lambda sim: sim.mark_cells_for_amr(np.ones(3, bool)),
    lambda sim: sim.perform_amr(),
])
def test_amr_raises(call):
    """AMR runs since it was ported (tests/test_torch_amr*.py); what it
    raises is the JAX package's: ValueError for marks of the wrong shape,
    RuntimeError for perform_amr before any mark."""
    cfg = config_from_dict({"time": {"stop": 0.01, "time_step": 0.001}})
    sim = Simulation(cfg.validate(), device="cpu",
                     mesh=structured_quad(4, 3, 0.0, 1.0, 0.0, 1.0))
    with pytest.raises((ValueError, RuntimeError),
                       match="refine_cell must have shape|no cells marked"):
        call(sim)
    sim.mark_cells_for_amr(np.ones(sim.num_cells, bool))
    sim.perform_amr()
    assert sim.num_cells == 48


@pytest.mark.parametrize("fmt", ["xdmf", "cgns"])
def test_hdf5_outputs_raise(fmt, tmp_path, monkeypatch):
    """XDMF and CGNS write HDF5 through h5py (ported with item 5b): where
    it does not import, they raise a ConfigError naming h5py and the
    binary format, at setup and in the writer, and switch no format."""
    cfg = config_from_dict({
        "output": {"format": fmt, "directory": str(tmp_path)},
        "time": {"stop": 0.01, "time_step": 0.001},
    }).validate()
    mesh = structured_quad(4, 3, 0.0, 1.0, 0.0, 1.0)
    sim = Simulation(cfg, mesh=mesh, device="cpu")
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py fails
    with pytest.raises(ConfigError, match="h5py.*binary"):
        attach_output_monitors(sim)
    with pytest.raises(ConfigError, match="h5py.*binary"):
        Simulation(cfg, mesh=mesh, device="cpu")
    assert not os.listdir(tmp_path)


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
    """The implicit and IMEX schemes build; a scheme neither package
    knows raises, as the JAX package's `_rk_step` does."""
    op, _, _ = _inputs()
    for scheme in ("beuler", "ark_imex"):
        assert callable(make_interval_advancer(op, scheme))
    with pytest.raises(ValueError, match="unknown temporal scheme"):
        make_interval_advancer(op, "bdf2")


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
