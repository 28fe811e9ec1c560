"""rdycore_tpu_torch's CUDA kernels against their plain PyTorch versions on
the card. These tests skip without a CUDA device (there is no nvcc and no
card on a CPU-only machine). On a machine with the card, which may have no
JAX (which tests/conftest.py imports) and no pytest-xdist (which pytest.ini's
addopts name), run

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts=""

Tolerances, relative to each output's largest magnitude: 1e-12 in f64 and
2e-5 in f32 (nvcc contracts multiply-adds into FMAs; CUDA's pow, cbrt and
rsqrt are not PyTorch's). Launch counts must move only on the CUDA path.
The raster step K2 runs in f32 only; its Simulation on the card is held to
the CPU run to 1e-5 after 20 ssprk3 steps, and the `structured` kind (plain
PyTorch, f64) to 1e-12 after 10 rk4 steps.
"""

import numpy as np
import pytest
import torch

from rdycore_tpu_torch import Simulation
from rdycore_tpu_torch.config.yaml_input import config_from_dict
from rdycore_tpu_torch.mesh import structured_quad, structured_tri
from rdycore_tpu_torch.operator import build_operator
from rdycore_tpu_torch.ops import kernels
from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
from rdycore_tpu_torch.ops.kernels.raster_step import (
    StructuredPlan,
    swe_raster_step,
    swe_raster_step_plain,
)
from rdycore_tpu_torch.ops.structured import FUSED_STAGES

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.float64: 1e-12}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel(got, want):
    want = want.double()
    return float((got.double() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def setup(mesh_fn, dtype, dev, seed=0):
    mesh = mesh_fn()
    rng = np.random.default_rng(seed)
    op = build_operator(mesh, bc_types={"left": 0, "right": 2, "top": 1},
                        mannings_n=rng.uniform(0.01, 0.05, mesh.num_cells),
                        dtype=dtype, device=dev)
    C, Eb = op.num_cells, op.num_boundary_edges
    h = rng.uniform(0.05, 1.0, C)
    h = np.where(rng.uniform(size=C) < 0.3, 0.0, h)
    q = np.stack([h, h * rng.normal(0, 0.4, C), h * rng.normal(0, 0.4, C)])
    bv = np.stack([np.full(Eb, 0.3), np.full(Eb, 0.05), np.zeros(Eb)])

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    return op, t(q), t(bv), t(rng.normal(0, 1e-3, (3, C)))


MESHES = [lambda: structured_quad(48, 32, 0.0, 2.0, 0.0, 1.0),
          lambda: structured_tri(24, 16, 0.0, 2.0, 0.0, 1.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mesh", [0, 1])
def test_kernels_match_plain_versions(dev, mesh, dtype):
    op, q, bv, ext = setup(MESHES[mesh], dtype, dev)
    a = op.arrays
    kernels.reset_launch_counts()
    flux, courant = op.edge_flux(q, bv)
    fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga)
    assert rel(flux, fp) <= TOL[dtype] and rel(courant, cp) <= TOL[dtype]
    dt = torch.tensor(0.002, dtype=dtype, device=dev)
    for method in (0, 1, 2):
        kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
                  xq2018_threshold=op.xq2018_threshold, source_method=method)
        for mode in (dict(), dict(stage=(0.75, 0.25, 0.25), qA=q.flip(1))):
            got = kernels.swe_cell_stage(a, fp, q, dt, ext, emit_prim=True,
                                         **kw, **mode)
            want = swe_cell_stage_plain(a, fp, q, dt, ext, emit_prim=True,
                                        **kw, **mode)
            for g, w in zip(got, want):
                if w is not None:
                    assert rel(g, w) <= TOL[dtype]
    m, i = op.courant_max(cp)
    mp, ip = courant_argmax_plain(cp)
    assert float(m) == float(mp) and int(i) == int(ip)
    assert [k.launches for k in kernels.KERNELS] == [1, 6, 1, 0]


def test_simulation_on_the_card_matches_the_cpu(dev):
    cfg = {
        "numerics": {"temporal": "ssprk2"},
        "time": {"stop": 0.02, "time_step": 0.001},
        "logging": {"level": "none"},
        "regions": [{"name": "all", "grid_region_id": 1}],
        "initial_conditions": [{"region": "all", "flow": "bump"}],
        "flow_conditions": [{"name": "bump", "type": "dirichlet",
                             "height": "0.1 + 0.05*exp(-20*((x-1)^2+(y-0.5)^2))",
                             "x_momentum": 0, "y_momentum": 0}],
    }
    mesh = structured_quad(40, 20, 0.0, 2.0, 0.0, 1.0,
                           region_fn=lambda cx, cy: np.ones_like(cx))
    sims = [Simulation(config_from_dict(cfg).validate(), mesh=mesh, device=d)
            for d in (dev, "cpu")]
    for sim in sims:
        sim.run()
    gpu, cpu = sims
    assert gpu.step == cpu.step == 20
    assert rel(torch.as_tensor(gpu.get_solution()),
               torch.as_tensor(cpu.get_solution())) <= 1e-12


@pytest.mark.parametrize("rain", [False, True])
def test_raster_step_matches_plain_version(dev, rain):
    nx, ny = 100, 37  # ragged against the 32x8 blocks
    rng = np.random.default_rng(1)
    h = rng.uniform(0.05, 1.0, (ny, nx))
    h = np.where(rng.uniform(size=h.shape) < 0.3, 0.0, h)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    q = t(np.stack([h, h * rng.normal(0, 0.4, h.shape),
                    h * rng.normal(0, 0.4, h.shape)]).reshape(3, -1))
    geo = [t(rng.normal(0, 0.01, (ny, nx))), t(rng.normal(0, 0.01, (ny, nx))),
           t(rng.uniform(0.01, 0.05, (ny, nx)))]
    plan = StructuredPlan(nx, ny, 0.01, 0.02, 1e-7, 0.0, 0, 2, 2, 1)
    kw = dict(src=t(rng.uniform(0, 1e-2, (ny, nx))) if rain else None,
              bc_vals={"left": t([np.full(ny, 0.3), np.full(ny, 0.05),
                                  np.zeros(ny)])})
    dt = t(0.002)
    qA = q.flip(1).contiguous()
    modes = [dict(emit_prim=True)] + [
        dict(stage=s, qA=qA if i else None, emit_prim=True)
        for i, s in enumerate(FUSED_STAGES["ssprk3"])
    ]
    kernels.reset_launch_counts()
    for mode in modes:
        got = swe_raster_step(plan, q, *geo, dt, **kw, **mode)
        want = swe_raster_step_plain(plan, q, *geo, dt, **kw, **mode)
        for g, w in zip(got, want):
            assert rel(g, w) <= TOL[torch.float32]
    assert kernels.swe_raster_step.launches == len(modes)


def test_raster_simulation_on_the_card_matches_the_cpu(dev):
    cfg = {
        "numerics": {"temporal": "ssprk3", "precision": "single",
                     "edge_flux_backend": "fused_structured"},
        "time": {"stop": 0.02, "time_step": 0.001},
        "logging": {"level": "none"},
        "output": {"time_series": {"boundary_fluxes": 10}},
        "regions": [{"name": "all", "grid_region_id": 1}],
        "initial_conditions": [{"region": "all", "flow": "bump"}],
        "boundaries": [{"name": "right", "grid_boundary_id": 2}],
        "boundary_conditions": [{"boundaries": ["right"], "flow": "out"}],
        "flow_conditions": [
            {"name": "bump", "type": "dirichlet",
             "height": "0.1 + 0.05*exp(-20*((x-1)^2+(y-0.25)^2))",
             "x_momentum": 0, "y_momentum": 0},
            {"name": "out", "type": "critical-outflow"}],
    }
    mesh = structured_quad(128, 32, 0.0, 2.0, 0.0, 0.5,
                           region_fn=lambda cx, cy: np.ones_like(cx))
    sims = [Simulation(config_from_dict(cfg).validate(), mesh=mesh, device=d)
            for d in (dev, "cpu")]
    kernels.reset_launch_counts()
    for sim in sims:
        sim.run()
    gpu, cpu = sims
    assert gpu._structured["kind"] == "fused"
    assert gpu.step == cpu.step == 20
    assert rel(torch.as_tensor(gpu.get_solution()),
               torch.as_tensor(cpu.get_solution())) <= 1e-5
    assert rel(torch.as_tensor(gpu.bflux_accum),
               torch.as_tensor(cpu.bflux_accum)) <= 1e-5
    assert [k.launches for k in kernels.KERNELS] == [20, 0, 20, 60]


def test_structured_kind_on_the_card_matches_the_cpu(dev):
    cfg = {
        "numerics": {"temporal": "rk4", "edge_flux_backend": "structured"},
        "time": {"stop": 0.01, "time_step": 0.001},
        "logging": {"level": "none"},
        "regions": [{"name": "all", "grid_region_id": 1}],
        "initial_conditions": [{"region": "all", "flow": "bump"}],
        "boundaries": [{"name": "right", "grid_boundary_id": 2}],
        "boundary_conditions": [{"boundaries": ["right"], "flow": "out"}],
        "flow_conditions": [
            {"name": "bump", "type": "dirichlet",
             "height": "0.1 + 0.05*exp(-20*((x-1)^2+(y-0.25)^2))",
             "x_momentum": 0, "y_momentum": 0},
            {"name": "out", "type": "critical-outflow"}],
    }
    mesh = structured_quad(32, 8, 0.0, 2.0, 0.0, 0.5,
                           region_fn=lambda cx, cy: np.ones_like(cx))
    sims = [Simulation(config_from_dict(cfg).validate(), mesh=mesh, device=d)
            for d in (dev, "cpu")]
    for sim in sims:
        sim.run()
    gpu, cpu = sims
    assert gpu._structured["kind"] == "xla"
    assert gpu.step == cpu.step == 10
    assert rel(torch.as_tensor(gpu.get_solution()),
               torch.as_tensor(cpu.get_solution())) <= 1e-12
