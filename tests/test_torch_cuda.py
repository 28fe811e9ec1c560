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
f32 and f64; K2 MUSCL on the raster, one launch per stage, at ragged
sizes under every wall code, and on a state whose donor
factors fall below 1 on cells at tile edges and corners), and a
second-order deck on the card to the CPU run on both paths (1e-10 in f64
on the unstructured path, 1e-5 in f32 on the raster). So are the
well-balancing modes over a bumpy bed (K1a and K1b with hydrostatic
reconstruction at NT = 0 and 3, K1a's BS2002 correction at first order
and for each limiter, and K5), and a well-balanced deck on the card to
the CPU run (1e-10 in f64). The row-strip modes of K2 (4 strips of a
256x176 raster) and K2 MUSCL (2-4 strips, the last ragged) are held to
their plain versions the same way
and to the whole raster's launch bit for bit, and 20 steps of 4 strips on
one card (euler; rk4 with tracers; MUSCL ssprk2) to the single strip bit
for bit, and 20 steps of the unstructured path in 2 shards on one card
(euler; rk4 with tracers; MUSCL ssprk2) to one device on the same cell
order bit for bit. K1c is held to its plain version exactly (max, index and run
fold; NaN, ties, infinities, signed zeros, misaligned slices, 1 to 5.77M
values, f32 and f64) and counted as one kernel per call by torch.profiler;
K2 at every tracer count and Riemann option on ragged rasters (a single
cell, row and column among them) under every wall code, and in 4 strips
bit for bit the whole raster's launch. A step of ark_imex and of beuler
(unstructured, raster, raster MUSCL) makes no synchronizing CUDA call.
The JAX package's unchanged C host csrc/test_capi.c, linked against the
port's embedded C API, runs a coupler's deck on the card with each kernel
launched once a step, and the bridge's advance reads the device back at
the end of its interval only. A four-member ensemble and a refined
(AMR) dam break at 256 x 176 run on the card as on the CPU, to 1e-5, with
exact launches.
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
    TILE,
    donor_factors,
    raster_muscl_faces_plain,
    raster_muscl_step_plain,
    swe_raster_muscl_step,
)
from rdycore_tpu_torch.ops.swe.muscl import ls_gradients
from rdycore_tpu_torch.ops.kernels.raster_step import (
    Strip,
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
    K1a, K1b, K1c, K2, K3a, K3b drain, K3b scale, K2 MUSCL, K5."""
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
    assert launches() == [1, 6, 1, 0, 0, 0, 0, 0, 0]


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
    assert launches() == [1, 4, 0, 0, 0, 0, 0, 0, 0]


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
    nx, ny = 100, 37  # ragged against the 32x16 tiles
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
    expected = ([20, 20, 20, 0, 0, 0, 0, 0, 0] if backend == "xla"
                else [20, 0, 20, 20, 0, 0, 0, 0, 0])
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
    assert launches() == [20, 0, 20, 60, 0, 0, 0, 0, 0]


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
    assert launches() == [1, 0, 0, 0, 1, 2, 1, 0, 0]


def muscl_case(dev, nx, ny, bc, seed):
    """A random wet/dry nx x ny raster for K2 MUSCL (h_anuga = 1e-3), its
    geometry, rain plane, wall codes bc (left, right, bottom, top),
    non-zero Dirichlet values on every wall and qA."""
    rng = np.random.default_rng(seed)
    h = rng.uniform(0.05, 1.0, (ny, nx))
    h = np.where(rng.uniform(size=h.shape) < 0.3, 0.0, h)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    q = t(np.stack([h, h * rng.normal(0, 0.4, h.shape),
                    h * rng.normal(0, 0.4, h.shape)]).reshape(3, -1))
    geo = [t(rng.normal(0, 0.01, (ny, nx))), t(rng.normal(0, 0.01, (ny, nx))),
           t(rng.uniform(0.01, 0.05, (ny, nx)))]
    plan = StructuredPlan(nx, ny, 0.01, 0.02, 1e-7, 1e-3, *bc)
    bc_vals = {s: t([rng.uniform(0.1, 0.6, n), rng.normal(0, 0.1, n),
                     rng.normal(0, 0.1, n)])
               for s, n in (("left", ny), ("right", ny), ("bottom", nx),
                            ("top", nx))}
    return (plan, q, geo, bc_vals, t(rng.uniform(0, 1e-2, (ny, nx))),
            q.flip(1).contiguous())


def check_muscl(got, want, what):
    """K2 MUSCL's (out, prim, cmax) against its plain version: 2e-5, the
    tile layout exact."""
    for g, w in zip(got, want):
        assert (g is None) == (w is None), what
        if w is not None:
            assert g.shape == w.shape, what
            assert rel(g, w) <= TOL[torch.float32], what


@pytest.mark.parametrize("limiter", ["minmod", "van_leer", "none"])
@pytest.mark.parametrize("rain", [False, True])
def test_raster_muscl_matches_plain_version(dev, rain, limiter):
    """K2 MUSCL, one launch a call, against its plain version on ragged
    rasters (a single cell, row and column among them)
    under every wall code on every side (Dirichlet non-zero), in rhs mode
    and each ssprk3 stage (qA in the later ones) with the primitives, at a
    step long enough for donor factors below 1; the K1c fold of its tile
    maxima exact against the plain fold of the same maxima."""
    dt = torch.tensor(0.02, dtype=torch.float32, device=dev)
    kernels.reset_launch_counts()
    n = 0
    for k, (nx, ny) in enumerate(SHAPES):
        plan, q, geo, bc_vals, src, qA = muscl_case(
            dev, nx, ny, WALLS[k % len(WALLS)], k)
        if nx * ny > 1000:
            fx, fy, _ = raster_muscl_faces_plain(plan, q, bc_vals, limiter)
            assert bool((donor_factors(plan, q, fx, fy, dt) < 1.0).any())
        modes = [dict(emit_prim=True)] + [
            dict(stage=st, qA=qA if i else None, emit_prim=True)
            for i, st in enumerate(FUSED_STAGES["ssprk3"])]
        for mode in modes:
            kw = dict(src=src if rain else None, **mode)
            got = swe_raster_muscl_step(plan, q, *geo, dt, bc_vals, limiter,
                                        **kw)
            want = raster_muscl_step_plain(plan, q, *geo, dt, bc_vals,
                                           limiter, **kw)
            n += 1
            check_muscl(got, want, (nx, ny, mode.get("stage")))
            run = (torch.zeros((), device=dev),
                   torch.zeros((), dtype=torch.int32, device=dev))
            run_p = tuple(x.clone() for x in run)
            mk, ik = kernels.courant_argmax(got.cmax, dt, *run)
            mp, ip = courant_argmax_plain(got.cmax, dt, *run_p)
            assert torch.equal(mk, mp) and int(ik) == int(ip)
            assert torch.equal(run[0], run_p[0])
    assert launches() == [0, 0, n, 0, 0, 0, 0, n, 0]


def test_raster_muscl_donors_at_tile_edges(dev):
    """K2 MUSCL on a 96 x 48 raster (3 x 3 tiles of 32 x 16) of thin,
    fast layers over a step long enough that most cells drain faster than
    they hold, those on the tiles' edges and at their corners among them
    (their donor factors, which the neighbouring tiles form again from
    their own faces, below 1): the result agrees with the plain version,
    one launch a call."""
    nx, ny = 96, 48
    rng = np.random.default_rng(8)
    h = rng.uniform(0.002, 0.02, (ny, nx))
    h = np.where(rng.uniform(size=h.shape) < 0.1, 0.0, h)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    q = t(np.stack([h, h * rng.normal(0, 1.5, h.shape),
                    h * rng.normal(0, 1.5, h.shape)]).reshape(3, -1))
    geo = [t(np.zeros((ny, nx))), t(np.zeros((ny, nx))),
           t(np.full((ny, nx), 0.02))]
    plan = StructuredPlan(nx, ny, 0.01, 0.01, 1e-7, 1e-3, 1, 2, 1, 2)
    dt = t(0.02)
    fx, fy, _ = raster_muscl_faces_plain(plan, q, None, "minmod")
    s = donor_factors(plan, q, fx, fy, dt).cpu().numpy() < 1.0
    bx, by = TILE
    cols = [c for k in range(bx, nx, bx) for c in (k - 1, k)]
    rows = [r for k in range(by, ny, by) for r in (k - 1, k)]
    assert s[:, cols].mean() > 0.75 and s[rows].mean() > 0.75
    assert s[np.ix_(rows, cols)].mean() > 0.75  # the corners
    kernels.reset_launch_counts()
    for mode in (dict(stage=(0.0, 1.0, 1.0), emit_prim=True),
                 dict(stage=(0.5, 0.5, 0.5), qA=q.flip(1).contiguous()),
                 dict()):
        got = swe_raster_muscl_step(plan, q, *geo, dt, None, "minmod", **mode)
        want = raster_muscl_step_plain(plan, q, *geo, dt, None, "minmod",
                                       **mode)
        check_muscl(got, want, mode.get("stage"))
    assert kernels.swe_raster_muscl_step.launches == 3


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
    assert launches() == ([20, 0, 20, 0, 0, 0, 0, 40, 0] if raster
                          else [40, 40, 20, 0, 40, 40, 40, 0, 0])


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
    assert launches() == [1, 2 * len(methods), 0, 0, 0, 0, 0, 0, 0]


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
    assert launches() == [1, 0, 0, 0, 0, 0, 0, 0, 1]


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
    assert launches() == [40, 40, 20, 0, 0, 0, 0, 0, k5]


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


def ragged_strips(ny, P):
    """P row strips with 3 halo rows off the walls, each of ny // P + 1
    rows but the last, which takes the rest (ragged against the tiles)."""
    rows = ny // P + 1
    return [Strip(p * rows, min(rows, ny - p * rows), 3 if p else 0,
                  3 if p < P - 1 else 0) for p in range(P)]


@pytest.mark.parametrize("limiter", ["minmod", "van_leer"])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_raster_strip_muscl_matches_plain_version(dev, P, limiter):
    """K2 MUSCL in strip mode on P strips with 3 halo rows, the last one
    ragged, in the ssprk2 second stage (qA) with the primitives and in rhs
    mode: each strip's launch against its plain version (2e-5), and bit for
    bit the whole raster's launch on the owned rows (out, prim), the
    strips' largest tile maximum the whole raster's; one launch a strip."""
    plan, q, geo, bc_vals, src, _ = strip_case(dev, 0, True)
    nx, ny = plan.nx, plan.ny
    dt = torch.tensor(0.002, dtype=torch.float32, device=dev)
    qA = q.flip(1).contiguous()
    strips = ragged_strips(ny, P)
    assert strips[-1].rows < strips[0].rows
    bufs = split_rows(q, strips, [dev] * P, nx)
    bufs_A = split_rows(qA, strips, [dev] * P, nx)
    kernels.reset_launch_counts()
    for mode in (dict(stage=(0.5, 0.5, 0.5), emit_prim=True), dict()):
        whole = swe_raster_muscl_step(plan, q, *geo, dt, bc_vals, limiter,
                                      src=src, **mode,
                                      qA=qA if "stage" in mode else None)
        cms = []
        for s, b, bA in zip(strips, bufs, bufs_A):
            rows = slice(s.row0, s.row0 + s.rows)
            args = (plan, b, *(g[rows] for g in geo), dt,
                    strip_wall_values(bc_vals, s, ny, dev), limiter, s)
            skw = dict(src=src[rows], qA=bA if "stage" in mode else None,
                       **mode)
            got = swe_raster_muscl_step(*args, **skw)
            want = raster_muscl_step_plain(*args, **skw)
            assert rel(s.owned(got.out), s.owned(want.out)) <= \
                TOL[torch.float32]
            check_muscl(got[1:], want[1:], list(s))
            assert torch.equal(s.owned(got.out),
                               whole.out.reshape(3, ny, nx)[:, rows])
            if whole.prim is not None:
                assert torch.equal(got.prim.reshape(3, -1, nx),
                                   whole.prim.reshape(3, ny, nx)[:, rows])
            cms.append(got.cmax.max())
        assert torch.equal(torch.stack(cms).max(), whole.cmax.max())
    assert kernels.swe_raster_muscl_step.launches == 2 * (P + 1)


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


@pytest.mark.parametrize("deck", [
    dict(scheme="euler"), dict(scheme="rk4", tracers=True),
    dict(scheme="ssprk2", second_order=True)])
def test_two_shards_on_one_card_match_one_device(dev, deck):
    """20 steps of the unstructured path in 2 shards in one process on one
    card (the shards side by side as one unit), bit for bit the single
    device on the same cell order (partitioning: auto is RCM): q, t, the
    Courant number and edge and the accumulators, each kernel launched as
    often as on one device."""
    mesh = structured_tri(64, 16, 0.0, 2.0, 0.0, 0.5)
    mesh.regions = {"__id_1": np.arange(mesh.num_cells, dtype=np.int32)}
    runs = []
    for n_dev in (1, 2):
        cfg = strip_deck(n_dev, **deck)
        cfg.numerics.edge_flux_backend = "xla"
        if n_dev == 1:
            cfg.numerics.cell_ordering = "rcm"
        sim = Simulation(cfg, mesh=mesh, device=dev,
                         strip_devices=[dev] * 2 if n_dev > 1 else None)
        assert (sim._sharded is not None) == (n_dev > 1)
        kernels.reset_launch_counts()
        sim.run()
        runs.append((sim, launches()))
    (one, l1), (two, l2) = runs
    assert one.step == two.step == 20 and one.t == two.t
    assert (one.get_courant_number_diagnostics()
            == two.get_courant_number_diagnostics())
    assert one.prev_max_courant > 0.0
    for name in ("bflux_accum", "accum_sol", "accum_prim"):
        assert np.array_equal(getattr(one, name), getattr(two, name)), name
    assert np.array_equal(one.get_solution(), two.get_solution())
    assert l1 == l2 and l1[0] > 0


# ------------------------------------------- K1c and K2 redesigned (tiles)
def courant_cases(dtype, dev):
    """(name, values) on the card: random at the sizes of the main paths
    (one value; a block's share; the 5,770,624 edges of the 2048x1408
    raster), with NaN, ties, infinities and signed zeros, and slices whose
    start is not 16-byte aligned."""
    rng = np.random.default_rng(7)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    big = rng.uniform(0.0, 1.0, 5_770_624)
    big[[123_457, 4_000_001]] = 2.0  # a tie far apart
    cases = [("n=1", t([0.3])), ("n=4097", t(rng.uniform(0, 1, 4097))),
             ("n=5770624 tie", t(big)),
             ("odd n=40001", t(rng.uniform(0, 1, 40001)))]
    x = rng.uniform(0, 1, 100_003)
    x[[5, 70_000]] = np.nan
    cases.append(("nan", t(x)))
    cases.append(("+inf tie", t([1.0, np.inf, 3.0, np.inf])))
    cases.append(("-inf only", t([-np.inf] * 9)))
    cases.append(("signed zeros", t([-0.0, 0.0, -0.0])))
    cases.append(("zeros then -0", t([0.0, -0.0, -1.0])))
    base = t(rng.uniform(0, 1, 70_001))
    for off in (1, 2, 3):
        cases.append((f"slice at +{off}", base[off:]))
    cases.append(("slice of 3 at +1", base[1:4]))
    return cases


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_courant_argmax_matches_plain_version(dev, dtype):
    """K1c returns exactly the plain version's (max, first index) and run
    fold on every case, in one launch per call."""
    dt = torch.tensor(0.5, dtype=dtype, device=dev)
    kernels.reset_launch_counts()
    cases = courant_cases(dtype, dev)
    for name, x in cases:
        run = (torch.full((), 0.25, dtype=dtype, device=dev),
               torch.full((), -1, dtype=torch.int32, device=dev))
        run_p = tuple(r.clone() for r in run)
        m, i = kernels.courant_argmax(x, dt, *run)
        mp, ip = courant_argmax_plain(x, dt, *run_p)
        same = (float(m) == float(mp)
                or (np.isnan(float(m)) and np.isnan(float(mp))))
        assert same and int(i) == int(ip), name
        assert m.dtype == dtype and i.dtype == torch.int32
        assert float(x[int(i)]) == float(m) or np.isnan(float(m)), name
        for r, rp in zip(run, run_p):
            assert torch.equal(r, rp) or (
                r.isnan().all() and rp.isnan().all()), name
    assert kernels.courant_argmax.launches == len(cases)


def test_courant_argmax_is_one_kernel_per_call(dev):
    """One K1c call is one kernel launch, by torch.profiler, on one block's
    share and on the 5.77M values that take the whole grid: the CUDA
    runtime launches 3 kernels over 3 calls, and the device records none
    but K1c's (a session that records no kernel, as the profiler sometimes
    does there, is taken again, up to five times)."""
    dt = torch.tensor(0.5, dtype=torch.float32, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for n in (11_264, 5_770_624):
        x = torch.rand(n, device=dev)
        run = (torch.zeros((), device=dev),
               torch.zeros((), dtype=torch.int32, device=dev))
        kernels.courant_argmax(x, dt, *run)  # the workspace, once
        torch.cuda.synchronize()
        for _ in range(5):
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(3):
                    kernels.courant_argmax(x, dt, *run)
                torch.cuda.synchronize()
            avgs = prof.key_averages()
            device = {e.key for e in avgs
                      if "CUDA" in str(getattr(e, "device_type", ""))
                      and getattr(e, "self_device_time_total", 0.0) > 0}
            if device:
                break
        launches = sum(e.count for e in avgs if e.key.startswith(
            ("cudaLaunchKernel", "cuLaunchKernel")))
        assert launches == 3, launches
        assert len(device) <= 1 and all("argmax" in k for k in device)


def raster_case(dev, nx, ny, nt, bc, seed=5):
    """A random wet/dry nx x ny raster with nt tracer rows, its geometry,
    rain plane, wall codes bc (left, right, bottom, top) and non-zero
    Dirichlet values on every wall."""
    rng = np.random.default_rng(seed)
    h = rng.uniform(0.05, 1.0, (ny, nx))
    h = np.where(rng.uniform(size=h.shape) < 0.3, 0.0, h)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    q = t(np.concatenate([
        [h, h * rng.normal(0, 0.4, h.shape), h * rng.normal(0, 0.4, h.shape)],
        h * rng.uniform(0.0, 0.5, (nt,) + h.shape)]).reshape(3 + nt, -1))
    geo = [t(rng.normal(0, 0.01, (ny, nx))), t(rng.normal(0, 0.01, (ny, nx))),
           t(rng.uniform(0.01, 0.05, (ny, nx)))]
    plan = StructuredPlan(nx, ny, 0.01, 0.02, 1e-7, 0.0, *bc)
    bc_vals = {s: t(np.concatenate([[rng.uniform(0.1, 0.6, n),
                                     rng.normal(0, 0.1, n),
                                     rng.normal(0, 0.1, n)],
                                    rng.uniform(0, 0.1, (nt, n))]))
               for s, n in (("left", ny), ("right", ny), ("bottom", nx),
                            ("top", nx))}
    return plan, q, geo, bc_vals, t(rng.uniform(0, 1e-2, (ny, nx)))


# every wall code on every side across the cases: Dirichlet 0, reflecting
# 1, critical outflow 2 (left, right, bottom, top)
WALLS = [(0, 2, 2, 1), (1, 0, 2, 2), (2, 1, 0, 2), (2, 2, 1, 0)]
# ragged against the 32x8 tiles, a single cell, row and column
SHAPES = [(1, 1), (70, 1), (1, 23), (33, 9), (100, 37)]


@pytest.mark.parametrize("nt, upwind", [(0, False)] + [
    (n, u) for n in range(1, 8) for u in (False, True)])
def test_raster_step_tiles_match_plain_version(dev, nt, upwind):
    """K2 at every tracer count and Riemann option (so in both its tiles)
    against its plain version (2e-5) on ragged rasters, a single cell, row
    and column, under every wall code on every side (Dirichlet non-zero),
    in rhs mode with the primitives and in a stage with qA, rain off and
    on; and in 4 strips of 9 rows of a 70 x 36 raster, each strip's launch
    against its plain version and bit for bit the whole raster's."""
    dt = torch.tensor(0.002, dtype=torch.float32, device=dev)
    kw = dict(num_sediment=min(nt, 2), upwind=upwind)
    kernels.reset_launch_counts()
    n = 0
    for k, (nx, ny) in enumerate(SHAPES):
        plan, q, geo, bc_vals, src = raster_case(dev, nx, ny, nt,
                                                 WALLS[k % len(WALLS)], k)
        for mode in (dict(emit_prim=True, src=src if k % 2 else None),
                     dict(stage=(0.75, 0.25, 0.25), qA=q.flip(1).contiguous(),
                          src=src if k % 2 == 0 else None)):
            got = swe_raster_step(plan, q, *geo, dt, bc_vals=bc_vals, **kw,
                                  **mode)
            want = swe_raster_step_plain(plan, q, *geo, dt, bc_vals=bc_vals,
                                         **kw, **mode)
            n += 1
            for g, w in zip(got, want):
                if w is not None:
                    assert g.shape == w.shape
                    assert rel(g, w) <= TOL[torch.float32], (nx, ny, mode)
    plan, q, geo, bc_vals, src = raster_case(dev, 70, 36, nt, WALLS[0])
    strips = strip_layout(36, 4, 1)
    mode = dict(stage=(0.0, 1.0, 1.0), emit_prim=True)
    whole = swe_raster_step(plan, q, *geo, dt, src=src, bc_vals=bc_vals,
                            **kw, **mode)
    for s, b in zip(strips, split_rows(q, strips, [dev] * 4, 70)):
        rows = slice(s.row0, s.row0 + s.rows)
        args = (plan, b, *(g[rows] for g in geo), dt)
        skw = dict(src=src[rows], strip=s, **kw, **mode,
                   bc_vals=strip_wall_values(bc_vals, s, 36, dev))
        got = swe_raster_step(*args, **skw)
        want = swe_raster_step_plain(*args, **skw)
        assert rel(s.owned(got.out), s.owned(want.out)) <= TOL[torch.float32]
        assert rel(got.prim, want.prim) <= TOL[torch.float32]
        assert torch.equal(s.owned(got.out),
                           whole.out.reshape(3 + nt, 36, 70)[:, rows])
    assert kernels.swe_raster_step.launches == n + 5


# ------------------------------------------------ implicit and IMEX schemes
def closed_dam_break(dtype, dev):
    """A 256x176 raster of 1/512 m cells in a closed box (every wall
    reflecting), the dam break's depths (0.25 m | 0.05 m), Manning 0.018."""
    mesh = structured_quad(256, 176, 0.0, 0.5, 0.0, 176 / 512)
    op = build_operator(mesh, mannings_n=np.full(mesh.num_cells, 0.018),
                        dtype=dtype, device=dev)
    h = np.where(mesh.cell_centroid[:, 0] < 0.25, 0.25, 0.05)
    q = torch.zeros((3, mesh.num_cells), dtype=dtype, device=dev)
    q[0] = torch.as_tensor(h, dtype=dtype)
    return op, q


@pytest.mark.parametrize("scheme", ["beuler", "ark_imex"])
def test_implicit_step_on_the_kernels_matches_the_twin(dev, scheme):
    """One step with its residuals on the kernels against the same step on
    the linearization twin (plain residuals): beuler to 2e-5 relative to
    1 + |q| at a Courant number of about 2, ark_imex to 1e-4 of each row's
    largest magnitude; exact launches (beuler: 1 + 24 residuals of K1a and
    K1b, one K1c; ark_imex: two of K1a and K1b, one K1c)."""
    from rdycore_tpu_torch.operator import linearization_twin
    from rdycore_tpu_torch.timestepping import make_interval_advancer

    op, q = closed_dam_break(torch.float32, dev)
    dt = 0.0025 if scheme == "beuler" else 0.0005
    bv = op.zero_boundary_values()
    out = []
    for o in (op, linearization_twin(op)):
        kernels.reset_launch_counts()
        res = make_interval_advancer(o, scheme)(q, 0.0, dt, 1, dt, bv, None)
        out.append((res, launches()))
    (rk, lk), (rp, lp) = out
    assert torch.isfinite(rk.q).all() and float(rk.max_courant) > 0.0
    if scheme == "beuler":
        assert float(rk.max_courant) > 1.5
        assert float(((rk.q - rp.q).abs() / (1.0 + rp.q.abs())).max()) <= 2e-5
        assert lk == [25, 25, 1, 0, 0, 0, 0, 0, 0]
    else:
        for k in range(3):
            assert rel(rk.q[k], rp.q[k]) <= 1e-4
        assert lk == [2, 2, 1, 0, 0, 0, 0, 0, 0]
    assert lp == [0] * len(kernels.KERNELS)
    assert float(rk.max_courant) == pytest.approx(float(rp.max_courant),
                                                  rel=1e-5)


@pytest.mark.parametrize("path", ["beuler", "ark_imex", "raster beuler",
                                  "raster beuler+muscl"])
def test_implicit_interval_reads_nothing_back(dev, path):
    """A step of the implicit and IMEX schemes reads no device value back
    to the host: under torch.cuda.set_sync_debug_mode("warn") it warns of
    no synchronizing operation (an .item(), a nonzero, a blocking copy, a
    linear-algebra call that checks its error code). The unstructured
    path on closed_dam_break's 256x176 box, and raster beuler at first
    and second order on the same box; the interval's time, dt and end
    are device tensors, and a first step outside the mode builds the
    kernels."""
    import warnings

    from rdycore_tpu_torch.timestepping import make_interval_advancer

    f32 = torch.float32
    dt = 0.0025 if "beuler" in path else 0.0005
    t0, dt_, t1 = (torch.tensor(x, dtype=f32, device=dev)
                   for x in (0.0, dt, dt))
    if path.startswith("raster"):
        d = {"numerics": {"temporal": "beuler", "precision": "single",
                          "edge_flux_backend": "fused_structured",
                          "second_order": path.endswith("muscl")},
             "time": {"stop": dt, "time_step": dt},
             "logging": {"level": "none"}}
        mesh = structured_quad(256, 176, 0.0, 0.5, 0.0, 176 / 512)
        sim = Simulation(config_from_dict(d).validate(), mesh=mesh,
                         device=dev)
        st = sim._structured
        assert st["kind"] == "fused" and st["scheme"] == "beuler"
        q = torch.zeros((3, mesh.num_cells), dtype=f32, device=dev)
        q[0] = torch.as_tensor(np.where(
            mesh.cell_centroid[:, 0] < 0.25, 0.25, 0.05), dtype=f32)
        bc_vals = {side: sim.boundary_values[:, cols].to(f32)
                   for side, cols in st["side_cols"].items()}

        def interval():
            return st["adv"](q, t0, dt_, 1, t1, bc_vals=bc_vals)
    else:
        op, q = closed_dam_break(f32, dev)
        adv = make_interval_advancer(op, path, accumulate=False,
                                     ext_sources=False)
        bv = op.zero_boundary_values()

        def interval():
            return adv(q, t0, dt_, 1, t1, bv, None)

    interval()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = interval()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [f"{w.filename}:{w.lineno}: {w.message}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert not syncs, "\n".join(syncs)
    assert torch.isfinite(res.q).all() and float(res.max_courant) > 0.0


def test_least_squares_on_the_card_for_singular_hessenbergs(dev):
    """`newton_beuler_solve`'s minimum-norm least-squares solve on the
    card: a zero Hessenberg (beta = 0), a rank-1 one (h_10 = 0) and a
    general one, finite and equal to the CPU's; and Newton on a fixed point
    and on a Krylov space that closes at once, as on the CPU."""
    from rdycore_tpu_torch.timestepping import (lstsq_min_norm,
                                                newton_beuler_solve)

    rng = np.random.default_rng(4)
    rank1 = np.zeros((17, 16))
    rank1[0, 0] = 1.51
    for H, b0 in ((np.zeros((17, 16)), 0.0), (rank1, 0.37),
                  (np.triu(rng.normal(size=(17, 16)), -1), 0.8)):
        b = np.zeros(17)
        b[0] = b0
        y = [lstsq_min_norm(torch.as_tensor(H, device=d),
                            torch.as_tensor(b, device=d)).cpu()
             for d in (dev, "cpu")]
        assert torch.isfinite(y[0]).all()
        assert torch.allclose(y[0], y[1], rtol=1e-12, atol=1e-14)
    shape = (3, 17)
    c = rng.normal(size=shape)
    closing = c.copy()
    closing[1, 5] += 0.7
    for q, lam, kap in ((c.copy(), rng.uniform(0.5, 3, shape),
                         rng.uniform(0, 2, shape)),
                        (closing, np.full(shape, 1.7), np.zeros(shape))):
        u = []
        for d in (dev, "cpu"):
            c_, lam_, kap_ = (torch.as_tensor(x, device=d)
                              for x in (c, lam, kap))

            def F(x):
                e = x - c_
                return -lam_ * e - kap_ * e * e * e

            u.append(newton_beuler_solve(
                F, F, torch.as_tensor(q, device=d),
                torch.tensor(0.3, dtype=torch.float64, device=d)).cpu())
        assert torch.isfinite(u[0]).all()
        assert torch.allclose(u[0], u[1], rtol=0, atol=1e-12)


JVP_MESHES = [
    lambda **kw: structured_quad(256, 176, 0.0, 2.0, 0.0, 1.375, **kw),
    lambda **kw: structured_tri(128, 88, 0.0, 2.0, 0.0, 1.375, **kw)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mesh", [0, 1])
def test_twin_jvp_on_the_card(dev, mesh, dtype):
    """Forward-mode AD through the linearization twin on the card's
    tensors (a 256x176 raster, and a triangle mesh of as many cells), on a
    state with dry cells (30% at h = 0): finite, no kernel launched, and
    the CPU's tangent (1e-12 in f64, 2e-5 in f32)."""
    from rdycore_tpu_torch.operator import linearization_twin
    from rdycore_tpu_torch.timestepping import jvp

    op, q, bv, ext = setup(JVP_MESHES[mesh], dtype, dev)
    v = torch.randn(q.shape, generator=torch.Generator().manual_seed(3),
                    dtype=dtype).to(dev) * q.abs().clamp_min(1e-3)
    dt = torch.tensor(0.002, dtype=dtype, device=dev)
    out = []
    for d in (dev, "cpu"):
        twin = linearization_twin(op) if d == dev else linearization_twin(
            build_operator(JVP_MESHES[mesh](), bc_types={"left": 0,
                                                         "right": 2,
                                                         "top": 1},
                           mannings_n=op.arrays.mannings_n.cpu().numpy(),
                           dtype=dtype, device="cpu"))
        kernels.reset_launch_counts()
        out.append(jvp(lambda x: twin.rhs(x, dt.to(d), bv.to(d),
                                          ext.to(d)),
                       q.to(d), v.to(d)).cpu())
        assert launches() == [0] * len(kernels.KERNELS)
    assert torch.isfinite(out[0]).all() and float(out[0].abs().max()) > 0
    assert rel(out[0], out[1]) <= TOL[dtype]


def mms_level(dtype, dev, nx=32, ny=22, tri=False, **deck):
    """An MMS level of the manufactured solution of tools/torch_mms_decks.py
    (a Dirichlet BC on every wall, its values and the sources evaluated on
    the card each step) on an nx x ny quad (or triangle) mesh."""
    from rdycore_tpu_torch.mms import MMSProblem, setup_mms_level
    from tools.torch_mms_decks import base_mesh, mms_deck

    precision = "single" if dtype == torch.float32 else "double"
    cfg = config_from_dict(mms_deck("unused.npz", 2e-3, 0.02, 0,
                                    precision=precision, **deck)).validate()
    return setup_mms_level(MMSProblem(cfg), base_mesh(nx, ny, tri), dtype,
                           dev)


@pytest.mark.parametrize("deck", [
    dict(), dict(second_order=True, temporal="ssprk2"),
    dict(num_sediment=2, riemann="upwind_roe"), dict(temporal="rk4")],
    ids=["euler", "muscl ssprk2", "sediment", "rk4"])
def test_mms_interval_reads_nothing_back(dev, deck):
    """An MMS interval evaluates its Dirichlet values and sources on the
    card at each step's half time and reads nothing back to the host: no
    synchronizing CUDA call under torch.cuda.set_sync_debug_mode("warn")
    (a first run outside the mode builds the kernels)."""
    import warnings

    level = mms_level(torch.float64, dev, **deck)
    level.advance(n_steps=2)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = level.advance(n_steps=3)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [f"{w.filename}:{w.lineno}: {w.message}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert not syncs, "\n".join(syncs)
    assert torch.isfinite(res.q).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mms_kernels_match_plain(dev, dtype):
    """K1a with every boundary edge Dirichlet (the analytic values at the
    edge midpoints) and K1b in stage mode with the analytic sources on
    every row and per-cell Manning values, on the 256x176 MMS level, each
    against its plain version."""
    level = mms_level(dtype, dev, 256, 176)
    op, q = level.op, level.q0
    a = op.arrays
    assert a.mannings_n.std() > 0 and bool((a.bnd_code == 0).all())
    t = torch.full((), 0.013, dtype=dtype, device=dev)
    bv, es = level.bc_fn(t), level.src_fn(t)
    assert bool((es.abs() > 0).all(dim=1).any())
    flux, courant = op.edge_flux(q, bv)
    fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga)
    assert rel(flux, fp) <= TOL[dtype] and rel(courant, cp) <= TOL[dtype]
    dt = torch.full((), 2e-3, dtype=dtype, device=dev)
    for stage in ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5)):
        got = op.cell_stage(fp, q, dt, es, stage=stage, qA=q,
                            emit_prim=True)
        want = swe_cell_stage_plain(
            a, fp, q, dt, es, tiny_h=op.tiny_h, h_anuga=op.h_anuga,
            xq2018_threshold=op.xq2018_threshold,
            source_method=op.source_method, stage=stage, qA=q,
            emit_prim=True)
        assert rel(got.q_out, want.q_out) <= TOL[dtype]
        assert rel(got.prim, want.prim) <= TOL[dtype]


def test_mms_ladder_on_the_card_matches_the_cpu(dev, tmp_path):
    """A 2-level first-order MMS ladder through `MMSDriver` on the card and
    on the CPU: the norms of every level and the rates to 1e-10."""
    from rdycore_tpu_torch.mesh import save_mesh_npz
    from rdycore_tpu_torch.mms import MMSDriver
    from tools.torch_mms_decks import base_mesh, mms_deck

    save_mesh_npz(base_mesh(16, 11), str(tmp_path / "base.npz"))
    cfg = config_from_dict(mms_deck(str(tmp_path / "base.npz"), 5e-3, 0.05,
                                    1)).validate()
    runs = {}
    for where in (dev, "cpu"):
        drv = MMSDriver(cfg, device=where)
        drv.run(log=lambda *_: None)
        runs[str(where)] = drv
    card, cpu = runs[str(dev)], runs["cpu"]
    for rc, rh in zip(card.results, cpu.results):
        for norm in ("L1", "L2", "Linf"):
            np.testing.assert_allclose(getattr(rc, norm), getattr(rh, norm),
                                       rtol=1e-10, atol=0)
    for norm in ("L1", "L2", "Linf"):
        np.testing.assert_allclose(card.rates[norm], cpu.rates[norm],
                                   rtol=0, atol=1e-10)


def coupler_deck(tmp_path, backend, steps=20, interval_steps=5):
    """The coupler's dam break on a 256x176 raster of 1/512 m cells, f32,
    euler, dt 0.0005 s: every wall reflecting and the floodplain dry (so
    that 1 um/s of rain is held in float32), written as a deck beside its
    .npz mesh."""
    import json

    from rdycore_tpu_torch.mesh import save_mesh_npz

    save_mesh_npz(structured_quad(
        256, 176, 0.0, 0.5, 0.0, 176 / 512,
        region_fn=lambda cx, cy: np.where(cx < 0.25, 1, 2)),
        str(tmp_path / "coupler.npz"))
    dt = 0.0005
    deck = {
        "numerics": {"temporal": "euler", "precision": "single",
                     "edge_flux_backend": backend},
        "logging": {"level": "none"},
        "time": {"stop": steps * dt, "time_step": dt,
                 "coupling_interval": interval_steps * dt},
        "grid": {"file": "coupler.npz"},
        "regions": [{"name": "reservoir", "grid_region_id": 1},
                    {"name": "floodplain", "grid_region_id": 2}],
        "initial_conditions": [{"region": "reservoir", "flow": "column"},
                               {"region": "floodplain", "flow": "dry"}],
        "flow_conditions": [
            {"name": "column", "type": "dirichlet", "height": 0.25},
            {"name": "dry", "type": "dirichlet", "height": 0.0}],
    }
    path = tmp_path / f"coupler_{backend}.yaml"
    path.write_text(json.dumps(deck))
    return str(path)


COUPLER_LAUNCHES = {
    "xla": {"swe_edge_flux": 1, "swe_cell_stage": 1, "courant_argmax": 1},
    "fused_structured": {"swe_raster_step": 1, "courant_argmax": 1},
}


@pytest.mark.parametrize("backend", sorted(COUPLER_LAUNCHES))
def test_c_host_runs_the_port_on_the_card(dev, tmp_path, backend):
    """The JAX package's unchanged C host csrc/test_capi.c, linked against
    the port's shim, runs a deck on the card (no RDYTPU_PLATFORM): its three
    OK lines, and each kernel of the path launched once a step."""
    import json
    import os
    import shutil
    import subprocess

    if not (shutil.which("cc") or shutil.which("gcc")):
        pytest.skip("no C compiler")
    from rdycore_tpu_torch.capi import build

    host = build.build_host(os.path.join(os.path.dirname(__file__), "..",
                                         "csrc", "test_capi.c"))
    deck = coupler_deck(tmp_path, backend)
    env = dict(os.environ, RDYTPU_TIMINGS=str(tmp_path / "t.jsonl"))
    env.pop("RDYTPU_PLATFORM", None)
    r = subprocess.run([host, deck, str(tmp_path / "c.bin"),
                        str(tmp_path / "v.bin")], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, f"\n{r.stdout}\n{r.stderr}"
    assert sum(line.startswith("OK:") for line in r.stdout.splitlines()) == 3
    report = json.loads((tmp_path / "t.jsonl").read_text())
    assert report["device"].startswith("cuda") and report["steps"] == 20
    want = {k: 20 * n for k, n in COUPLER_LAUNCHES[backend].items()}
    assert {k: n for k, n in report["launches"].items() if n} == want


@pytest.mark.parametrize("backend", sorted(COUPLER_LAUNCHES))
def test_coupling_loop_syncs_only_at_interval_ends(dev, tmp_path,
                                                   monkeypatch, backend):
    """The bridge's advance synchronizes with the device at the start and
    end of its interval only: under torch.cuda.set_sync_debug_mode("warn")
    around it, an interval of 8 steps makes as many synchronizing calls as
    one of 2 (the interval's clock going up, its results coming back). The
    coupling loop's setters and getters run outside the mode."""
    import warnings

    from rdycore_tpu_torch import capi_bridge as bridge

    monkeypatch.delenv("RDYTPU_PLATFORM", raising=False)
    monkeypatch.delenv("RDYTPU_TIMINGS", raising=False)
    h = bridge.create(coupler_deck(tmp_path, backend, steps=40))
    try:
        n = bridge.num_cells(h)
        rain = np.full(n, 1e-6).tobytes()
        bridge.set_domain_water_source(h, rain)
        bridge.advance(h)  # builds and loads the kernels
        syncs = {}
        for steps in (2, 8):
            bridge.set_coupling_interval(h, steps * 0.0005)
            bridge.set_domain_water_source(h, rain)
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    bridge.advance(h)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs[steps] = [w for w in caught if "called a synchronizing "
                            "CUDA operation" in str(w.message)]
            h_bytes = bridge.get_height(h)
            assert np.isfinite(np.frombuffer(h_bytes)).all()
        where = {k: [f"{w.filename}:{w.lineno}" for w in v]
                 for k, v in syncs.items()}
        assert len(syncs[2]) == len(syncs[8]), where
        assert bridge.step(h) == 5 + 2 + 8
    finally:
        bridge.destroy(h)


def test_exodus_rcm_deck_on_the_card_matches_the_cpu(dev, tmp_path):
    """A valley of tools/torch_flood_files.py at 128 x 88 (22,528
    triangles, cells and vertices shuffled) read from its Exodus file by
    the native builder and reordered by RCM, 40 euler steps on the card
    against the CPU: the state by natural id to 1e-5, one K1a, K1b and K1c
    launch a step."""
    import yaml

    from rdycore_tpu_torch.config.yaml_input import load_config
    from tools.torch_flood_files import flood_deck, write_flood_files

    write_flood_files(str(tmp_path), 128, 88, gmsh=False)
    deck = flood_deck("valley.exo", 1.0, 40.0, 20.0, "rcm", series=20)
    path = str(tmp_path / "flood.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(deck, f)
    sims = [Simulation(load_config(path), device=d) for d in (dev, "cpu")]
    kernels.reset_launch_counts()
    for sim in sims:
        sim.run()
    gpu, cpu = sims
    nat = gpu.get_natural_ids()
    assert np.array_equal(nat, cpu.get_natural_ids())
    assert not np.array_equal(nat, np.arange(len(nat)))
    assert gpu.step == cpu.step == 40
    assert rel(torch.as_tensor(gpu.get_solution()),
               torch.as_tensor(cpu.get_solution())) <= 1e-5
    assert launches() == [40, 40, 40, 0, 0, 0, 0, 0, 0]


def test_raster_rain_on_the_card_matches_the_cpu(dev):
    """Constant rain (forcing.ConstantRain, as --constant-rain-rate sets
    it) on a fused_structured dam break: K2's rain plane on the card
    against the CPU, 20 steps, one K2 launch a step."""
    from rdycore_tpu_torch.forcing import ConstantRain, Forcing, attach_forcing

    cfg = {
        "numerics": {"temporal": "euler", "precision": "single",
                     "edge_flux_backend": "fused_structured"},
        "time": {"stop": 0.02, "time_step": 0.001,
                 "coupling_interval": 0.01},
        "logging": {"level": "none"},
        "regions": [{"name": "all", "grid_region_id": 1}],
        "initial_conditions": [{"region": "all", "flow": "bump"}],
        "flow_conditions": [
            {"name": "bump", "type": "dirichlet",
             "height": "0.1 + 0.05*exp(-20*((x-1)^2+(y-0.25)^2))",
             "x_momentum": 0, "y_momentum": 0}],
    }
    mesh = structured_quad(128, 32, 0.0, 2.0, 0.0, 0.5,
                           region_fn=lambda cx, cy: np.ones_like(cx))
    sims = [Simulation(config_from_dict(cfg).validate(), mesh=mesh, device=d)
            for d in (dev, "cpu")]
    for sim in sims:
        attach_forcing(sim, Forcing(constant_rain=ConstantRain(2e-3)))
    kernels.reset_launch_counts()
    v0 = float(np.sum(sims[1].get_height() * mesh.cell_area))
    for sim in sims:
        sim.run()
    gpu, cpu = sims
    assert gpu._structured["kind"] == "fused" and gpu._structured["with_src"]
    assert gpu.step == cpu.step == 20
    assert rel(torch.as_tensor(gpu.get_solution()),
               torch.as_tensor(cpu.get_solution())) <= 1e-5
    assert launches()[3] == 20
    gained = float(np.sum(gpu.get_height() * mesh.cell_area)) - v0
    assert gained == pytest.approx(2e-3 * 0.02 * 1.0, rel=1e-3)


def dam_break_256(tmp_path, steps=20, members=0):
    """Phase 13's dam break at 256 x 176 quads of 1/64 m (f32, euler, dt
    0.0005 s, coupling intervals of 10 steps, boundary fluxes on) from an
    .npz; with `members`, phase 13a's ensemble section (Manning n 0.012,
    0.018, ...; members 2 and 3 with a 0.20 and 0.30 m reservoir)."""
    from rdycore_tpu_torch.mesh import save_mesh_npz

    mesh = structured_quad(256, 176, 0.0, 4.0, 0.0, 2.75, region_fn=lambda
                           cx, cy: np.where(cx < 2.0, 1, 2))
    mesh.boundaries["__id_2"] = mesh.boundaries["right"]
    npz = str(tmp_path / "dam.npz")
    save_mesh_npz(mesh, npz)
    d = {
        "numerics": {"temporal": "euler", "precision": "single"},
        "time": {"stop": steps * 0.0005, "time_step": 0.0005,
                 "coupling_interval": 0.005},
        "logging": {"level": "none"},
        "output": {"format": "none", "time_series": {"boundary_fluxes": 10}},
        "grid": {"file": npz},
        "regions": [{"name": "reservoir", "grid_region_id": 1},
                    {"name": "floodplain", "grid_region_id": 2}],
        "surface_composition": [
            {"region": "reservoir", "material": "smooth"},
            {"region": "floodplain", "material": "smooth"}],
        "materials": [{"name": "smooth",
                       "properties": {"manning": {"value": 0.018}}}],
        "initial_conditions": [{"region": "reservoir", "flow": "column"},
                               {"region": "floodplain", "flow": "wet_bed"}],
        "boundaries": [{"name": "right", "grid_boundary_id": 2}],
        "boundary_conditions": [{"boundaries": ["right"], "flow": "outflow"}],
        "flow_conditions": [
            {"name": "column", "type": "dirichlet", "height": 0.25,
             "x_momentum": 0, "y_momentum": 0},
            {"name": "wet_bed", "type": "dirichlet", "height": 0.05,
             "x_momentum": 0, "y_momentum": 0},
            {"name": "outflow", "type": "critical-outflow"}],
    }
    if members:
        ms = []
        for i in range(members):
            m = {"materials": [{"name": "smooth", "properties": {
                "manning": {"value": 0.012 + 0.006 * i}}}]}
            if i >= 2:
                m["flow_conditions"] = [{
                    "name": "column", "type": "dirichlet",
                    "height": 0.1 * i, "x_momentum": 0, "y_momentum": 0}]
            ms.append(m)
        d["ensemble"] = {"size": members, "members": ms}
    return config_from_dict(d).validate(), mesh


def test_ensemble_on_the_card_matches_the_cpu(dev, tmp_path):
    """Phase 13a's four-member ensemble at 256 x 176: 20 steps on the
    card against the CPU, every member to 1e-5; K1a, K1b and K1c launched
    once a member-step."""
    from rdycore_tpu_torch.ensemble import EnsembleSimulation

    cfg, _ = dam_break_256(tmp_path, members=4)
    ens = [EnsembleSimulation(cfg, device=d) for d in (dev, "cpu")]
    kernels.reset_launch_counts()
    for e in ens:
        e.run()
    assert launches() == [80, 80, 80, 0, 0, 0, 0, 0, 0]
    for mg, mc in zip(ens[0].members, ens[1].members):
        assert mg.step == mc.step == 20
        assert rel(torch.as_tensor(mg.get_solution()),
                   torch.as_tensor(mc.get_solution())) <= 1e-5
        assert rel(torch.as_tensor(mg.bflux_accum),
                   torch.as_tensor(mc.bflux_accum)) <= 1e-5


def test_amr_on_the_card_matches_the_cpu(dev, tmp_path):
    """The dam break at 256 x 176, the columns within 0.25 m of the dam
    refined (red quads, their neighbours fans of 5 triangles), then 20
    steps on the card against the CPU to 1e-5; K1a, K1b and K1c once a
    step on the mixed mesh."""
    cfg, mesh = dam_break_256(tmp_path)
    marked = np.abs(mesh.cell_centroid[:, 0] - 2.0) < 0.25
    sims = [Simulation(cfg, device=d) for d in (dev, "cpu")]
    for sim in sims:
        sim.mark_cells_for_amr(marked)
        sim.perform_amr()
        assert sim.num_cells == 45056 + 3 * 32 * 176 + 4 * 2 * 176
    kernels.reset_launch_counts()
    for sim in sims:
        sim.run()
    gpu, cpu = sims
    assert gpu.step == cpu.step == 20
    assert launches() == [20, 20, 20, 0, 0, 0, 0, 0, 0]
    assert rel(torch.as_tensor(gpu.get_solution()),
               torch.as_tensor(cpu.get_solution())) <= 1e-5
