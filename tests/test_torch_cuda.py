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
PyTorch, f64) to 1e-12 after 10 rk4 steps. The tracer instances (three
tracers, two of them sediment classes, Roe and upwind-Roe) of K1a, K1b
and K2 are held to their plain versions the same way, and a sediment deck
on the card to the CPU run on both paths. So are the second-order kernels
(K3a, K1a in MUSCL mode and K3b on the unstructured mesh for each limiter,
f32 and f64; K2 MUSCL's faces and update launches on the raster), and a
second-order deck on the card to the CPU run on both paths (1e-10 in f64
on the unstructured path, 1e-5 in f32 on the raster). So are the
well-balancing modes over a bumpy bed (K1a and K1b with hydrostatic
reconstruction at NT = 0 and 3, K1a's BS2002 correction at first order
and for each limiter, and K5), and a well-balanced deck on the card to
the CPU run (1e-10 in f64). The row-strip modes of K2 and K2 MUSCL (4
strips of a 256x176 raster) are held to their plain versions the same way
and to the whole raster's launch bit for bit, and 20 steps of 4 strips on
one card (euler; rk4 with tracers; MUSCL ssprk2) to the single strip bit
for bit.
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
from rdycore_tpu_torch.ops.swe.bs2002 import eta_vertices
from rdycore_tpu_torch.ops.kernels.muscl import (
    positivity_drain_plain,
    positivity_scale_plain,
)
from rdycore_tpu_torch.ops.kernels.raster_muscl import (
    raster_muscl_faces_plain,
    raster_muscl_update_plain,
    swe_raster_muscl_faces,
    swe_raster_muscl_update,
)
from rdycore_tpu_torch.ops.swe.muscl import ls_gradients
from rdycore_tpu_torch.ops.kernels.raster_step import (
    StructuredPlan,
    swe_raster_step,
    swe_raster_step_plain,
)
from rdycore_tpu_torch.ops.strips import (
    split_rows,
    strip_layout,
    strip_wall_values,
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


def setup(mesh_fn, dtype, dev, seed=0, nt=0, riemann="roe", z_fn=None,
          **muscl):
    mesh = mesh_fn() if z_fn is None else mesh_fn(z_fn=z_fn)
    rng = np.random.default_rng(seed)
    op = build_operator(mesh, bc_types={"left": 0, "right": 2, "top": 1},
                        mannings_n=rng.uniform(0.01, 0.05, mesh.num_cells),
                        num_tracers=nt, num_sediment=min(nt, 2),
                        riemann=riemann, dtype=dtype, device=dev, **muscl)
    C, Eb = op.num_cells, op.num_boundary_edges
    h = rng.uniform(0.05, 1.0, C)
    h = np.where(rng.uniform(size=C) < 0.3, 0.0, h)
    q = np.concatenate([
        [h, h * rng.normal(0, 0.4, C), h * rng.normal(0, 0.4, C)],
        h * rng.uniform(0.0, 0.5, (nt, C))])
    bv = np.concatenate([[np.full(Eb, 0.3), np.full(Eb, 0.05), np.zeros(Eb)],
                         rng.uniform(0.0, 0.1, (nt, Eb))])

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    return op, t(q), t(bv), t(rng.normal(0, 1e-3, (3 + nt, C)))


def launches():
    """The launch count of each kernel, in the order of kernels.KERNELS:
    K1a, K1b, K1c, K2, K3a, K3b drain, K3b scale, K2 MUSCL faces and
    update, K5."""
    return [k.launches for k in kernels.KERNELS]


MESHES = [lambda **kw: structured_quad(48, 32, 0.0, 2.0, 0.0, 1.0, **kw),
          lambda **kw: structured_tri(24, 16, 0.0, 2.0, 0.0, 1.0, **kw)]


def bed(x, y):
    """A bumpy bed of 0 to 0.4 m, partly above the random depths."""
    return 0.2 * (1.0 + np.sin(4 * np.pi * x) * np.sin(4 * np.pi * y))


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
    assert launches() == [1, 6, 1, 0, 0, 0, 0, 0, 0, 0]


@pytest.mark.parametrize("riemann", ["roe", "upwind_roe"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mesh", [0, 1])
def test_tracer_kernels_match_plain_versions(dev, mesh, dtype, riemann):
    op, q, bv, ext = setup(MESHES[mesh], dtype, dev, nt=3, riemann=riemann)
    a = op.arrays
    upwind = riemann == "upwind_roe"
    kernels.reset_launch_counts()
    flux, courant = op.edge_flux(q, bv)
    fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga, upwind)
    assert flux.shape == (6, op.num_edges + 1)
    assert rel(flux, fp) <= TOL[dtype] and rel(courant, cp) <= TOL[dtype]
    dt = torch.tensor(0.002, dtype=dtype, device=dev)
    for method in (0, 2):
        kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
                  xq2018_threshold=op.xq2018_threshold, source_method=method,
                  num_sediment=2)
        for mode in (dict(), dict(stage=(0.75, 0.25, 0.25), qA=q.flip(1))):
            got = kernels.swe_cell_stage(a, fp, q, dt, ext, emit_prim=True,
                                         **kw, **mode)
            want = swe_cell_stage_plain(a, fp, q, dt, ext, emit_prim=True,
                                        **kw, **mode)
            for g, w in zip(got, want):
                if w is not None:
                    assert g.shape == (6, op.num_cells)
                    assert rel(g, w) <= TOL[dtype]
    assert launches() == [1, 4, 0, 0, 0, 0, 0, 0, 0, 0]


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


@pytest.mark.parametrize("upwind", [False, True])
def test_tracer_raster_step_matches_plain_version(dev, upwind):
    nx, ny, nt = 100, 37, 3
    rng = np.random.default_rng(2)
    h = rng.uniform(0.05, 1.0, (ny, nx))
    h = np.where(rng.uniform(size=h.shape) < 0.3, 0.0, h)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    q = t(np.concatenate([
        [h, h * rng.normal(0, 0.4, h.shape), h * rng.normal(0, 0.4, h.shape)],
        h * rng.uniform(0.0, 0.5, (nt,) + h.shape)]).reshape(3 + nt, -1))
    geo = [t(rng.normal(0, 0.01, (ny, nx))), t(rng.normal(0, 0.01, (ny, nx))),
           t(rng.uniform(0.01, 0.05, (ny, nx)))]
    plan = StructuredPlan(nx, ny, 0.01, 0.02, 1e-7, 0.0, 0, 2, 2, 1)
    bcl = np.concatenate([[np.full(ny, 0.3), np.full(ny, 0.05),
                           np.zeros(ny)], rng.uniform(0, 0.1, (nt, ny))])
    kw = dict(src=t(rng.uniform(0, 1e-2, (ny, nx))), bc_vals={"left": t(bcl)},
              num_sediment=2, upwind=upwind)
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


@pytest.mark.parametrize("backend", ["xla", "fused_structured"])
def test_tracer_simulation_on_the_card_matches_the_cpu(dev, backend):
    cfg = {
        "physics": {"sediment": {"num_classes": 2}, "salinity": True},
        "numerics": {"temporal": "euler", "precision": "single",
                     "edge_flux_backend": backend},
        "time": {"stop": 0.02, "time_step": 0.001},
        "logging": {"level": "none"},
        "output": {"time_series": {"boundary_fluxes": 10}},
        "regions": [{"name": "all", "grid_region_id": 1}],
        "initial_conditions": [{"region": "all", "flow": "bump",
                                "sediment": "mud", "salinity": "salt"}],
        "boundaries": [{"name": "right", "grid_boundary_id": 2}],
        "boundary_conditions": [{"boundaries": ["right"], "flow": "out"}],
        "flow_conditions": [
            {"name": "bump", "type": "dirichlet",
             "height": "0.1 + 0.05*exp(-20*((x-1)^2+(y-0.25)^2))",
             "x_momentum": 0.02, "y_momentum": 0},
            {"name": "out", "type": "critical-outflow"}],
        "sediment_conditions": [{"name": "mud", "c0": {"value": 2e-4},
                                 "c1": {"value": 1e-4}}],
        "salinity_conditions": [{"name": "salt", "concentration": 1e-3}],
    }
    mesh = structured_quad(128, 32, 0.0, 2.0, 0.0, 0.5,
                           region_fn=lambda cx, cy: np.ones_like(cx))
    sims = [Simulation(config_from_dict(cfg).validate(), mesh=mesh, device=d)
            for d in (dev, "cpu")]
    kernels.reset_launch_counts()
    for sim in sims:
        sim.run()
    gpu, cpu = sims
    assert gpu.step == cpu.step == 20 and gpu.ndof == 6
    for k in range(6):
        assert rel(torch.as_tensor(gpu.get_solution()[k]),
                   torch.as_tensor(cpu.get_solution()[k])) <= 1e-5
        assert rel(torch.as_tensor(gpu.bflux_accum[k]),
                   torch.as_tensor(cpu.bflux_accum[k])) <= 1e-5
    expected = ([20, 20, 20, 0, 0, 0, 0, 0, 0, 0] if backend == "xla"
                else [20, 0, 20, 20, 0, 0, 0, 0, 0, 0])
    assert launches() == expected


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
    assert launches() == [20, 0, 20, 60, 0, 0, 0, 0, 0, 0]


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


@pytest.mark.parametrize("limiter", ["minmod", "van_leer", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mesh", [0, 1])
def test_muscl_kernels_match_plain_versions(dev, mesh, dtype, limiter):
    op, q, bv, _ = setup(MESHES[mesh], dtype, dev, second_order=True,
                         limiter=limiter)
    a = op.arrays
    tol = TOL[dtype]
    kernels.reset_launch_counts()
    grad = op.muscl_grad(q)
    gp = ls_gradients(a, q)
    assert rel(grad, gp) <= tol
    # each kernel on its plain predecessor's output: errors do not compound
    flux, courant = op.edge_flux(q, bv, gp)
    fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga, grad=gp,
                                 limiter=limiter)
    assert rel(flux, fp) <= tol and rel(courant, cp) <= tol
    dt = torch.tensor(0.002, dtype=dtype, device=dev)
    s = kernels.swe_positivity_drain(a, fp, q[0], dt)
    sp = positivity_drain_plain(a, fp, q[0], dt)
    assert rel(s, sp) <= tol and bool((sp < 1.0).any())
    scaled = kernels.swe_positivity_scale(a, fp.clone(), sp)
    assert rel(scaled, positivity_scale_plain(a, fp.clone(), sp)) <= tol
    # dt = 0: the factor divides by 1, never 0/0
    s0 = kernels.swe_positivity_drain(a, fp, q[0], torch.zeros_like(dt))
    assert bool(torch.isfinite(s0).all())
    assert rel(s0, positivity_drain_plain(a, fp, q[0],
                                          torch.zeros_like(dt))) <= tol
    assert launches() == [1, 0, 0, 0, 1, 2, 1, 0, 0, 0]


@pytest.mark.parametrize("limiter", ["minmod", "van_leer", "none"])
@pytest.mark.parametrize("rain", [False, True])
def test_raster_muscl_matches_plain_version(dev, rain, limiter):
    nx, ny = 100, 37  # ragged against the 32x8 blocks
    rng = np.random.default_rng(3)
    h = rng.uniform(0.05, 1.0, (ny, nx))
    h = np.where(rng.uniform(size=h.shape) < 0.3, 0.0, h)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    q = t(np.stack([h, h * rng.normal(0, 0.4, h.shape),
                    h * rng.normal(0, 0.4, h.shape)]).reshape(3, -1))
    geo = [t(rng.normal(0, 0.01, (ny, nx))), t(rng.normal(0, 0.01, (ny, nx))),
           t(rng.uniform(0.01, 0.05, (ny, nx)))]
    plan = StructuredPlan(nx, ny, 0.01, 0.02, 1e-7, 1e-3, 0, 2, 1, 2)
    bc_vals = {"left": t([np.full(ny, 0.3), np.full(ny, 0.05), np.zeros(ny)])}
    src = t(rng.uniform(0, 1e-2, (ny, nx))) if rain else None
    dt = t(0.002)
    qA = q.flip(1).contiguous()
    kernels.reset_launch_counts()
    got = kernels.swe_raster_muscl_faces(plan, q, bc_vals, limiter)
    want = raster_muscl_faces_plain(plan, q, bc_vals, limiter)
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL[torch.float32]
    modes = [dict(emit_prim=True)] + [
        dict(stage=s, qA=qA if i else None, emit_prim=True)
        for i, s in enumerate(FUSED_STAGES["ssprk3"])
    ]
    for mode in modes:  # on the plain faces: errors do not compound
        out = kernels.swe_raster_muscl_update(plan, q, *want[:2], *geo, dt,
                                              src=src, **mode)
        ref = raster_muscl_update_plain(plan, q, *want[:2], *geo, dt,
                                        src=src, **mode)
        for g, w in zip(out, ref):
            assert rel(g, w) <= TOL[torch.float32]
    assert launches() == [0, 0, 0, 0, 0, 0, 0, 1, len(modes), 0]


@pytest.mark.parametrize("backend", ["xla", "fused_structured"])
def test_muscl_simulation_on_the_card_matches_the_cpu(dev, backend):
    raster = backend == "fused_structured"
    cfg = {
        "numerics": {"temporal": "ssprk2", "second_order": True,
                     "limiter": "van_leer", "edge_flux_backend": backend,
                     "precision": "single" if raster else "double"},
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
    assert gpu.step == cpu.step == 20
    tol = 1e-5 if raster else 1e-10
    assert rel(torch.as_tensor(gpu.get_solution()),
               torch.as_tensor(cpu.get_solution())) <= tol
    assert rel(torch.as_tensor(gpu.bflux_accum),
               torch.as_tensor(cpu.bflux_accum)) <= tol
    # ssprk2: two stages a step, the Courant fold and (raster) the
    # boundary fluxes once a step
    assert launches() == ([20, 0, 20, 0, 0, 0, 0, 40, 40, 0] if raster
                          else [40, 40, 20, 0, 40, 40, 40, 0, 0, 0])


@pytest.mark.parametrize("nt, riemann", [(0, "roe"), (3, "roe"),
                                         (3, "upwind_roe")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mesh", [0, 1])
def test_hr_kernels_match_plain_versions(dev, mesh, dtype, nt, riemann):
    op, q, bv, ext = setup(MESHES[mesh], dtype, dev, nt=nt, riemann=riemann,
                           z_fn=bed, well_balancing_hr=True)
    a = op.arrays
    upwind = riemann == "upwind_roe"
    kernels.reset_launch_counts()
    flux, courant = op.edge_flux(q, bv)
    fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga, upwind,
                                 hr=True)
    assert rel(flux, fp) <= TOL[dtype] and rel(courant, cp) <= TOL[dtype]
    dt = torch.tensor(0.002, dtype=dtype, device=dev)
    methods = (0, 1, 2) if nt == 0 else (0, 2)
    for method in methods:
        kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
                  xq2018_threshold=op.xq2018_threshold, source_method=method,
                  num_sediment=min(nt, 2), hr=True)
        for mode in (dict(), dict(stage=(0.75, 0.25, 0.25), qA=q.flip(1))):
            got = kernels.swe_cell_stage(a, fp, q, dt, ext, emit_prim=True,
                                         **kw, **mode)
            want = swe_cell_stage_plain(a, fp, q, dt, ext, emit_prim=True,
                                        **kw, **mode)
            for g, w in zip(got, want):
                if w is not None:
                    assert rel(g, w) <= TOL[dtype]
    assert launches() == [1, 2 * len(methods), 0, 0, 0, 0, 0, 0, 0, 0]


@pytest.mark.parametrize("limiter", [None, "minmod", "van_leer", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mesh", [0, 1])
def test_bs2002_kernels_match_plain_versions(dev, mesh, dtype, limiter):
    op, q, bv, _ = setup(MESHES[mesh], dtype, dev, z_fn=bed, h_anuga=1e-3,
                         second_order=True, well_balancing_bs2002=True)
    a = op.arrays
    kernels.reset_launch_counts()
    eta_v = op.eta_vertices(q[0])
    ep = eta_vertices(a.bs2002, q[0], op.tiny_h)
    assert eta_v.shape == (a.bs2002.vertex_cells.shape[0],)
    assert rel(eta_v, ep) <= TOL[dtype]
    grad = None if limiter is None else ls_gradients(a, q)
    lim = limiter or "minmod"
    flux, courant = kernels.swe_edge_flux(a, q, bv, op.tiny_h, op.h_anuga,
                                          grad=grad, limiter=lim, bs=a.bs2002,
                                          eta_v=ep)
    fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga, grad=grad,
                                 limiter=lim, bs=a.bs2002, eta_v=ep)
    assert rel(flux, fp) <= TOL[dtype] and rel(courant, cp) <= TOL[dtype]
    # the correction is there: without it the momentum fluxes differ
    f0, _ = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga, grad=grad,
                                limiter=lim)
    assert rel(f0[1:], fp[1:]) > 1e-3
    assert launches() == [1, 0, 0, 0, 0, 0, 0, 0, 0, 1]


@pytest.mark.parametrize("wb", ["hydrostatic_reconstruction", "bs2002"])
def test_wb_simulation_on_the_card_matches_the_cpu(dev, wb):
    cfg = {
        "physics": {"flow": {"well_balancing": wb}},
        "numerics": {"temporal": "ssprk2"},
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
    mesh = structured_tri(64, 16, 0.0, 2.0, 0.0, 0.5, z_fn=lambda x, y:
                          0.05 * np.sin(3 * x) * np.cos(5 * y))
    mesh.regions["__id_1"] = np.arange(mesh.num_cells, dtype=np.int32)
    sims = [Simulation(config_from_dict(cfg).validate(), mesh=mesh, device=d)
            for d in (dev, "cpu")]
    kernels.reset_launch_counts()
    for sim in sims:
        sim.run()
    gpu, cpu = sims
    assert gpu.step == cpu.step == 20
    for name in ("q", "bflux_accum"):
        got = getattr(gpu, name) if name != "q" else gpu.get_solution()
        want = getattr(cpu, name) if name != "q" else cpu.get_solution()
        assert rel(torch.as_tensor(got), torch.as_tensor(want)) <= 1e-10
    # ssprk2: two stages a step, the Courant fold once; K5 before each K1a
    k5 = 40 if wb == "bs2002" else 0
    assert launches() == [40, 40, 20, 0, 0, 0, 0, 0, 0, k5]


# ------------------------------------------------------------- row strips
def strip_case(dev, nt, second_order, n_strips=4):
    """A 256x176 random wet/dry raster in `n_strips` row strips (halo 3 at
    second order, else 1) with a Dirichlet left and top wall, critical
    outflow on the right and a reflecting bottom, and the rain plane."""
    nx, ny = 256, 176
    rng = np.random.default_rng(4)
    h = rng.uniform(0.05, 1.0, (ny, nx))
    h = np.where(rng.uniform(size=h.shape) < 0.3, 0.0, h)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    q = t(np.concatenate([
        [h, h * rng.normal(0, 0.4, h.shape), h * rng.normal(0, 0.4, h.shape)],
        h * rng.uniform(0.0, 0.5, (nt,) + h.shape)]).reshape(3 + nt, -1))
    geo = [t(rng.normal(0, 0.01, (ny, nx))), t(rng.normal(0, 0.01, (ny, nx))),
           t(rng.uniform(0.01, 0.05, (ny, nx)))]
    plan = StructuredPlan(nx, ny, 0.01, 0.02, 1e-7,
                          1e-3 if second_order else 0.0, 0, 2, 1, 0)
    bc_vals = {s: t(np.concatenate([[rng.uniform(0.1, 0.6, n),
                                     rng.normal(0, 0.1, n),
                                     rng.normal(0, 0.1, n)],
                                    rng.uniform(0, 0.1, (nt, n))]))
               for s, n in (("left", ny), ("top", nx))}
    strips = strip_layout(ny, n_strips, 3 if second_order else 1)
    src = t(rng.uniform(0, 1e-2, (ny, nx)))
    return plan, q, geo, bc_vals, src, strips


@pytest.mark.parametrize("nt", [0, 3])
def test_raster_strip_step_matches_plain_version(dev, nt):
    """K2 in strip mode on 4 strips of 44 rows: each strip's launch against
    its plain version (2e-5), and the strips' owned rows bit for bit the
    whole raster's launch."""
    plan, q, geo, bc_vals, src, strips = strip_case(dev, nt, False)
    nx, ny = plan.nx, plan.ny
    dt = torch.tensor(0.002, dtype=torch.float32, device=dev)
    qA = q.flip(1).contiguous()
    kw = dict(num_sediment=min(nt, 2), upwind=bool(nt))
    modes = [dict(emit_prim=True)] + [
        dict(stage=s, qA=qA if i else None, emit_prim=True)
        for i, s in enumerate(FUSED_STAGES["ssprk3"])]
    bufs = split_rows(q, strips, [dev] * 4, nx)
    bufs_A = split_rows(qA, strips, [dev] * 4, nx)
    kernels.reset_launch_counts()
    for mode in modes:
        whole = swe_raster_step(plan, q, *geo, dt, src=src, bc_vals=bc_vals,
                                **kw, **mode)
        for s, b, bA in zip(strips, bufs, bufs_A):
            rows = slice(s.row0, s.row0 + s.rows)
            args = (plan, b, *(g[rows] for g in geo), dt)
            m = dict(mode, qA=bA if mode.get("qA") is not None else None)
            skw = dict(src=src[rows], strip=s, **kw, **m,
                       bc_vals=strip_wall_values(bc_vals, s, ny, dev))
            got = swe_raster_step(*args, **skw)
            want = swe_raster_step_plain(*args, **skw)
            out_k, out_p = (s.owned(x.out) for x in (got, want))
            assert rel(out_k, out_p) <= TOL[torch.float32]
            assert rel(got.prim, want.prim) <= TOL[torch.float32]
            assert rel(got.cmax, want.cmax) <= TOL[torch.float32]
            assert torch.equal(
                out_k, whole.out.reshape(3 + nt, ny, nx)[:, rows])
            assert torch.equal(got.prim.reshape(3 + nt, -1, nx),
                               whole.prim.reshape(3 + nt, ny, nx)[:, rows])
        assert torch.equal(torch.stack([swe_raster_step(
            plan, b, *(g[s.row0:s.row0 + s.rows] for g in geo), dt,
            src=src[s.row0:s.row0 + s.rows], strip=s,
            bc_vals=strip_wall_values(bc_vals, s, ny, dev), **kw,
            **dict(mode, qA=bA if mode.get("qA") is not None else None),
        ).cmax.max() for s, b, bA in zip(strips, bufs, bufs_A)]).max(),
            whole.cmax.max())
    assert kernels.swe_raster_step.launches == len(modes) * 9


@pytest.mark.parametrize("limiter", ["minmod", "van_leer"])
def test_raster_strip_muscl_matches_plain_version(dev, limiter):
    """K2 MUSCL in strip mode on 4 strips with 3 halo rows: faces (its
    face rows: one halo row beyond each inner strip boundary) and update
    against their plain versions (2e-5), and bit for bit the whole
    raster's faces and update."""
    plan, q, geo, bc_vals, src, strips = strip_case(dev, 0, True)
    nx, ny = plan.nx, plan.ny
    dt = torch.tensor(0.002, dtype=torch.float32, device=dev)
    qA = q.flip(1).contiguous()
    bufs = split_rows(q, strips, [dev] * 4, nx)
    bufs_A = split_rows(qA, strips, [dev] * 4, nx)
    kernels.reset_launch_counts()
    fx_w, fy_w, cm_w = swe_raster_muscl_faces(plan, q, bc_vals, limiter)
    out_w, prim_w = swe_raster_muscl_update(
        plan, q, fx_w, fy_w, *geo, dt, src=src, stage=(0.5, 0.5, 0.5),
        qA=qA, emit_prim=True)
    cms = []
    for s, b, bA in zip(strips, bufs, bufs_A):
        rows = slice(s.row0, s.row0 + s.rows)
        bcs = strip_wall_values(bc_vals, s, ny, dev)
        fk = swe_raster_muscl_faces(plan, b, bcs, limiter, s)
        fp = raster_muscl_faces_plain(plan, b, bcs, limiter, s)
        for a, w in zip(fk, fp):
            assert rel(a, w) <= TOL[torch.float32]
        x_lo = int(s.halo_lo > 0)
        f0 = s.row0 - x_lo
        assert torch.equal(fk[0], fx_w[:, f0:f0 + fk[0].shape[1]])
        assert torch.equal(fk[1], fy_w[:, f0:f0 + fk[1].shape[1]])
        cms.append(fk[2].max())
        args = (plan, b, fk[0], fk[1], *(g[rows] for g in geo), dt)
        ukw = dict(src=src[rows], stage=(0.5, 0.5, 0.5), qA=bA,
                   emit_prim=True, strip=s)
        ok, pk = swe_raster_muscl_update(*args, **ukw)
        op, pp = raster_muscl_update_plain(*args, **ukw)
        assert rel(s.owned(ok), s.owned(op)) <= \
            TOL[torch.float32]
        assert rel(pk, pp) <= TOL[torch.float32]
        assert torch.equal(s.owned(ok),
                           out_w.reshape(3, ny, nx)[:, rows])
    assert torch.equal(torch.stack(cms).max(), cm_w.max())
    assert kernels.swe_raster_muscl_faces.launches == 5
    assert kernels.swe_raster_muscl_update.launches == 5


def strip_deck(n_devices, scheme="euler", tracers=False, second_order=False):
    cfg = {
        "physics": ({"sediment": {"num_classes": 2}, "salinity": True}
                    if tracers else {}),
        "numerics": {"temporal": scheme, "precision": "single",
                     "edge_flux_backend": "fused_structured",
                     "second_order": second_order},
        "parallel": {"n_devices": n_devices},
        "time": {"stop": 0.02, "time_step": 0.001},
        "logging": {"level": "none"},
        "output": {"time_series": {"boundary_fluxes": 10}},
        "regions": [{"name": "all", "grid_region_id": 1}],
        "initial_conditions": [{"region": "all", "flow": "bump"}
                               | ({"sediment": "mud", "salinity": "salt"}
                                  if tracers else {})],
        "boundaries": [{"name": "right", "grid_boundary_id": 2},
                       {"name": "left", "grid_boundary_id": 1}],
        "boundary_conditions": [{"boundaries": ["right"], "flow": "out"},
                                {"boundaries": ["left"], "flow": "in"}],
        "flow_conditions": [
            {"name": "bump", "type": "dirichlet",
             "height": "0.1 + 0.05*exp(-20*((x-1)^2+(y-0.25)^2))",
             "x_momentum": 0.01, "y_momentum": 0},
            {"name": "in", "type": "dirichlet", "height": 0.12,
             "x_momentum": 0.01, "y_momentum": 0},
            {"name": "out", "type": "critical-outflow"}],
    }
    if tracers:
        cfg["sediment_conditions"] = [{"name": "mud", "c0": {"value": 2e-4},
                                       "c1": {"value": 1e-4}}]
        cfg["salinity_conditions"] = [{"name": "salt",
                                       "concentration": 1e-3}]
    return config_from_dict(cfg).validate()


@pytest.mark.parametrize("deck", [
    dict(scheme="euler"), dict(scheme="rk4", tracers=True),
    dict(scheme="ssprk2", second_order=True)])
def test_strips_on_one_card_match_the_single_strip(dev, deck):
    """20 steps of 4 row strips of 8 rows on one card, bit for bit the
    single strip: q, t, the Courant number and the accumulators; K2 (or
    K2 MUSCL), K1c and K1a launched once per strip where the single strip
    launches once."""
    mesh = structured_quad(128, 32, 0.0, 2.0, 0.0, 0.5,
                           region_fn=lambda cx, cy: np.ones_like(cx))
    runs = []
    for n_dev in (1, 4):
        sim = Simulation(strip_deck(n_dev, **deck), mesh=mesh, device=dev,
                         strip_devices=[dev] * 4 if n_dev > 1 else None)
        kernels.reset_launch_counts()
        sim.run()
        runs.append((sim, launches()))
    (one, l1), (four, l4) = runs
    assert one.step == four.step == 20 and one.t == four.t
    assert one.prev_max_courant == four.prev_max_courant > 0.0
    for name in ("bflux_accum", "accum_sol", "accum_prim"):
        assert np.array_equal(getattr(one, name), getattr(four, name)), name
    assert np.array_equal(one.get_solution(), four.get_solution())
    assert [4 * n for n in l1] == l4 and l1[0] == l1[2] == 20
