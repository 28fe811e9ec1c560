#!/usr/bin/env python3
"""Smoke run of rdycore_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed N] [--steps N]

Phases, each printing as it goes; any failure exits non-zero:

1. Card and build: the card's name and power limit, torch's CUDA, the
   triton and nvcc versions, and a fresh nvcc build of every kernel of the
   package (one nvcc per source, all started together).
2. Kernels against their plain PyTorch versions on the card, with a random
   wet/dry state made with numpy from --seed. On a 256x176 quad mesh and a
   triangle mesh, in f32 and f64, with all three BC codes (Dirichlet values
   non-zero): K1a swe_edge_flux; K1b swe_cell_stage in stage mode for each
   ssprk3 stage and in rhs mode, with each source method; K1c
   courant_argmax, including a constructed tie whose index must be exact.
   On a 256x176 raster, in f32: K2 swe_raster_step with a Dirichlet left
   wall (non-zero values), critical outflow on the right and bottom and a
   reflecting top, the rain plane off and on, in stage mode for each
   ssprk3 stage and in rhs mode with the primitives, and its per-block
   Courant maxima folded by K1c. Tolerance, relative to each output's
   largest magnitude: 1e-12 in f64, 2e-5 in f32 (nvcc contracts
   multiply-adds into FMAs; CUDA's pow, cbrt and rsqrt are not PyTorch's).
3. The unstructured main path at full size: the dam break of
   examples/dam_break.yaml (reservoir at x < Lx/2 with h = 0.25 m,
   floodplain h = 0.05 m, Manning n = 0.018, critical outflow on the right,
   reflecting walls elsewhere, euler, dt = 0.0005 s, boundary-flux time
   series on) in f32 on a 2048x1408 raster of 1/512 m cells (4 m x 2.75 m,
   2,883,584 cells; a spacing exact in binary, which the raster detection
   of phase 4 needs), built once with the package's own mesh generator
   for phases 3 and 4. 10 steps through `Simulation` on the kernels are
   held against 10 steps on the plain versions (relative 1e-4); then
   --steps steps through `Simulation.run` with every launch count set to 0
   just before: h must be finite and >= 0, the volume lost must equal the
   outflow through the accumulated boundary fluxes (to 1e-4 of the initial
   volume, summed in f64 on the host), and K1a, K1b and K1c must have been
   launched once per step and K2 never. Then each kernel is timed at the
   path's shapes (device time per call, from torch.profiler) beside its
   plain version, its bound and, where one PyTorch call computes the same
   function, that call.
4. The raster main path at full size: the same deck and mesh with
   `edge_flux_backend: fused_structured`. 10 steps on the kernels against
   10 steps on the plain versions: q, each row of the boundary-flux
   accumulator and the Courant number to relative 1e-4. Then --steps steps
   with the launch counts set to 0 just before, the same checks of the
   state and the volume budget, and K2, K1c and K1a (on the boundary edges,
   for the boundary-flux accumulator) launched once per step each and K1b
   never. ssprk3 and rk4 then run a few dozen steps each (K2 in stage mode
   with qA, and in rhs mode, at full size). At this path's shapes, K2 (in
   stage and rhs mode), K1c on K2's block maxima and K1a on the boundary
   edges alone are held against their plain versions (2e-5; the Courant
   fold exact) and timed like the others.

Before the last line it prints the card's name and power limit and a JSON
line {"kernels": [...]} with one row per kernel and path ("path":
"unstructured" or "raster"), each with that path's own launches, times and
bound; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}  # non-tensor
TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
DT = 0.0005
# floating-point operations per item, counted from the CUDA sources (sqrt,
# divide, pow and cbrt count as one each)
OPS_PER_EDGE = 165  # K1a: two regularizations, ghost state, Roe, mask
OPS_PER_CELL = 80  # K1b: 4-slot divergence, semi-implicit sources, stage
OPS_PER_VALUE = 1  # K1c: one comparison per Courant value
# K2: four Roe solves (~140 each), five regularizations and square roots,
# the divergence, sources, stage update and Courant maxima
OPS_PER_RASTER_CELL = 700
DX = 1.0 / 512.0  # cell size of the full-size raster [m]
_CSRC = "rdycore_tpu_torch/ops/kernels/csrc/"
SOURCES = {"swe_edge_flux": _CSRC + "swe_edge_flux.cu",
           "swe_cell_stage": _CSRC + "swe_cell_stage.cu",
           "courant_argmax": _CSRC + "courant_argmax.cu",
           "swe_raster_step": _CSRC + "swe_raster_step.cu"}
REPLACES = {"swe_edge_flux": "rdycore_tpu/ops/pallas/slotted.py:2463",
            "swe_cell_stage": "rdycore_tpu/ops/pallas/slotted.py:2463",
            "courant_argmax": "rdycore_tpu/ops/pallas/slotted.py:2463",
            "swe_raster_step": "rdycore_tpu/ops/pallas/structured_step.py:172"}


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want) -> float:
    want = want.double()
    scale = float(want.abs().max()) if want.numel() else 1.0
    err = float((got.double() - want).abs().max()) if want.numel() else 0.0
    return err / max(scale, 1e-30)


def abs_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def cuda_ms(fn, reps=20) -> float:
    """Mean milliseconds per call of fn() between CUDA events: device time,
    or the host's launch time where that is longer."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_us(evt) -> float:
    """Self device time of a torch.profiler average, in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_events(prof):
    """(device us, count, name) of every device activity (kernels, copies)
    that torch.profiler recorded."""
    return [(device_us(e), e.count, e.key) for e in prof.key_averages()
            if device_us(e) > 0.0 and "CUDA" in str(getattr(e, "device_type",
                                                             ""))]


def device_ms(fn, reps=20) -> float:
    """Mean device milliseconds per call of fn(): the device time of every
    kernel and copy it launches, from torch.profiler."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    if not events:
        raise SystemExit("torch.profiler recorded no device time")
    return sum(e[0] for e in events) / 1e3 / reps


# ------------------------------------------------------------------ phase 1
def phase_build():
    from rdycore_tpu_torch.ops.kernels import build

    log("== phase 1: card and build")
    log(f"card: {nvidia_smi_line()}")
    log(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    try:
        import triton

        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: not installed")
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    log(f"nvcc: {nvcc}")
    t0 = time.perf_counter()
    built = build.build_all(force=True)
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s wall "
        f"(per source: "
        f"{', '.join(f'{k} {v[0]:.2f} s' for k, v in built.items())})")
    for name, (_, report) in built.items():
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
        log(f"  ptxas {name}: {' | '.join(regs)}")


# ------------------------------------------------------------------ phase 2
def random_state(op, rng, dtype, dev):
    C, Eb = op.num_cells, op.num_boundary_edges
    h = rng.uniform(0.05, 1.0, C)
    h = np.where(rng.uniform(size=C) < 0.25, rng.uniform(0, 5e-8, C), h)
    h = np.where(rng.uniform(size=C) < 0.1, 0.0, h)
    q = np.stack([h, h * rng.normal(0, 0.4, C), h * rng.normal(0, 0.4, C)])
    bv = np.stack([rng.uniform(0.1, 0.6, Eb), rng.normal(0, 0.1, Eb),
                   rng.normal(0, 0.1, Eb)])
    ext = rng.normal(0.0, 1e-3, (3, C))

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    return t(q), t(bv), t(ext)


def phase_kernels(seed, errs, dev):
    from rdycore_tpu_torch.mesh import structured_quad, structured_tri
    from rdycore_tpu_torch.operator import build_operator
    from rdycore_tpu_torch.ops.kernels.cell_stage import (
        swe_cell_stage, swe_cell_stage_plain)
    from rdycore_tpu_torch.ops.kernels.courant import (
        courant_argmax, courant_argmax_plain)
    from rdycore_tpu_torch.ops.kernels.edge_flux import (
        swe_edge_flux, swe_edge_flux_plain)
    from rdycore_tpu_torch.ops.kernels.raster_step import (
        StructuredPlan, swe_raster_step, swe_raster_step_plain)
    from rdycore_tpu_torch.ops.structured import FUSED_STAGES
    from rdycore_tpu_torch.timestepping import _FUSED_STEP_STAGES

    log("== phase 2: kernels against their plain versions on the card")
    rng = np.random.default_rng(seed)
    meshes = {
        "quad 256x176": structured_quad(256, 176, 0.0, 0.512, 0.0, 0.352),
        "tri 128x88": structured_tri(128, 88, 0.0, 0.512, 0.0, 0.352),
    }
    bc = {"left": 0, "right": 2, "top": 1, "bottom": 0}  # all three codes
    failures = []

    def check(kernel, what, got, want, dtype):
        r, a = rel_err(got, want), abs_err(got, want)
        errs[kernel] = max(errs.get(kernel, 0.0), a)
        ok = r <= TOL[dtype]
        log(f"  {kernel:15s} {what:48s} rel {r:.3e} abs {a:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{kernel} {what}")

    for mname, mesh in meshes.items():
        for dtype in (torch.float32, torch.float64):
            tag = f"{mname} {str(dtype)[6:]}"
            n = rng.uniform(0.01, 0.05, mesh.num_cells)
            op = build_operator(mesh, bc_types=bc, mannings_n=n, dtype=dtype,
                                device=dev)
            a = op.arrays
            q, bv, ext = random_state(op, rng, dtype, dev)
            # K1a
            fk, ck = swe_edge_flux(a, q, bv, op.tiny_h, op.h_anuga)
            fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga)
            check("swe_edge_flux", f"{tag} flux", fk, fp, dtype)
            check("swe_edge_flux", f"{tag} courant", ck, cp, dtype)
            # K1b, on the plain flux so that errors do not compound
            dt = torch.tensor(0.002, dtype=dtype, device=dev)
            qA, _, _ = random_state(op, rng, dtype, dev)
            for method in (0, 1, 2):
                kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
                          xq2018_threshold=op.xq2018_threshold,
                          source_method=method)
                modes = [("rhs", dict(emit_prim=True))] + [
                    (f"stage {i + 1}", dict(stage=s, qA=qA if i else None,
                                            emit_prim=True))
                    for i, s in enumerate(_FUSED_STEP_STAGES["ssprk3"])
                ]
                for mode, extra in modes:
                    ok_ = swe_cell_stage(a, fp, q, dt, ext, **kw, **extra)
                    op_ = swe_cell_stage_plain(a, fp, q, dt, ext, **kw,
                                               **extra)
                    for field in ("q_out", "flux_div", "rhs", "prim"):
                        if getattr(op_, field) is not None:
                            check("swe_cell_stage",
                                  f"{tag} src{method} {mode} {field}",
                                  getattr(ok_, field), getattr(op_, field),
                                  dtype)
            # K1c: random values, then a constructed tie
            for what, x in (("random", cp.clone()), ("tie", cp.clone())):
                if what == "tie":
                    i1, i2 = sorted(rng.choice(x.numel(), 2, replace=False))
                    x[i2] = x[i1] = x.max() + 1.0
                run = (torch.zeros((), dtype=dtype, device=dev),
                       torch.zeros((), dtype=torch.int32, device=dev))
                mk, ik = courant_argmax(x, dt, *run)
                mp, ip = courant_argmax_plain(x)
                exact = (float(mk) == float(mp) and int(ik) == int(ip)
                         and float(run[0]) == float(mp * dt)
                         and int(run[1]) == int(ip))
                if what == "tie":
                    exact = exact and int(ik) == int(i1)
                errs["courant_argmax"] = max(
                    errs.get("courant_argmax", 0.0), abs(float(mk) - float(mp)))
                log(f"  {'courant_argmax':15s} {tag + ' ' + what:48s} "
                    f"idx {int(ik)} (plain {int(ip)}) "
                    f"{'ok' if exact else 'FAIL'}")
                if not exact:
                    failures.append(f"courant_argmax {tag} {what}")
    # K2 on a 256x176 raster, f32
    nx, ny = 256, 176
    f32 = torch.float32

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=f32, device=dev)

    h = rng.uniform(0.05, 1.0, nx * ny)
    h = np.where(rng.uniform(size=h.size) < 0.25, rng.uniform(0, 5e-8, h.size),
                 h)
    h = np.where(rng.uniform(size=h.size) < 0.1, 0.0, h)
    q = t([h, h * rng.normal(0, 0.4, h.size), h * rng.normal(0, 0.4, h.size)])
    qA = t([h[::-1], h * rng.normal(0, 0.4, h.size), np.zeros(h.size)])
    geo = [t(rng.normal(0, 0.01, (ny, nx))), t(rng.normal(0, 0.01, (ny, nx))),
           t(rng.uniform(0.01, 0.05, (ny, nx)))]
    plan = StructuredPlan(nx, ny, 0.002, 0.002, 1e-7, 0.0, bc_left=0,
                          bc_right=2, bc_bottom=2, bc_top=1)
    bc_vals = {"left": t([rng.uniform(0.1, 0.6, ny), rng.normal(0, 0.1, ny),
                          rng.normal(0, 0.1, ny)])}
    dt = torch.tensor(0.002, dtype=f32, device=dev)
    modes = [("rhs", dict(emit_prim=True))] + [
        (f"stage {i + 1}", dict(stage=s, qA=qA if i else None,
                                emit_prim=True))
        for i, s in enumerate(FUSED_STAGES["ssprk3"])
    ]
    for rain in (False, True):
        src = t(rng.uniform(0.0, 1e-2, (ny, nx))) if rain else None
        for mode, extra in modes:
            tag = f"raster 256x176 f32 rain {'on' if rain else 'off'} {mode}"
            got = swe_raster_step(plan, q, *geo, dt, src=src, bc_vals=bc_vals,
                                  **extra)
            want = swe_raster_step_plain(plan, q, *geo, dt, src=src,
                                         bc_vals=bc_vals, **extra)
            for field in ("out", "prim", "cmax"):
                check("swe_raster_step", f"{tag} {field}",
                      getattr(got, field), getattr(want, field), f32)
            run = (torch.zeros((), dtype=f32, device=dev),
                   torch.zeros((), dtype=torch.int32, device=dev))
            courant_argmax(got.cmax, dt, *run)
            check("swe_raster_step", f"{tag} courant fold", run[0],
                  want.cmax.max() * dt, f32)
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"kernel checks failed: {failures}")


# ------------------------------------------------------------------ phase 3
def dam_break_config(steps, backend="xla", scheme="euler"):
    from rdycore_tpu_torch.config.yaml_input import config_from_dict

    return config_from_dict({
        "physics": {"flow": {"mode": "swe"}},
        "numerics": {"spatial": "fv", "temporal": scheme, "riemann": "roe",
                     "precision": "single", "edge_flux_backend": backend},
        "logging": {"level": "none"},
        "time": {"stop": steps * DT, "unit": "seconds", "time_step": DT,
                 "coupling_interval": 0.1},
        "output": {"format": "none", "time_series": {"boundary_fluxes": 100}},
        "regions": [{"name": "reservoir", "grid_region_id": 1},
                    {"name": "floodplain", "grid_region_id": 2}],
        "surface_composition": [
            {"region": "reservoir", "material": "smooth"},
            {"region": "floodplain", "material": "smooth"}],
        "materials": [{"name": "smooth",
                       "properties": {"manning": {"value": 0.018}}}],
        "initial_conditions": [{"region": "reservoir", "flow": "column"},
                               {"region": "floodplain", "flow": "wet_bed"}],
        "boundaries": [{"name": "left", "grid_boundary_id": 1},
                       {"name": "right", "grid_boundary_id": 2}],
        "boundary_conditions": [{"boundaries": ["right"], "flow": "outflow"}],
        "flow_conditions": [
            {"name": "column", "type": "dirichlet", "height": 0.25,
             "x_momentum": 0, "y_momentum": 0},
            {"name": "wet_bed", "type": "dirichlet", "height": 0.05,
             "x_momentum": 0, "y_momentum": 0},
            {"name": "outflow", "type": "critical-outflow"}],
    }).validate()


def plain_operator(op):
    """The same operator with every kernel replaced by its plain version
    (run on the card's tensors), for holding the kernels' run against."""
    from rdycore_tpu_torch.operator import SWEOperator
    from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain

    class PlainSWEOperator(SWEOperator):
        def edge_flux(self, q, bv):
            return swe_edge_flux_plain(self.arrays, q, bv, self.tiny_h,
                                       self.h_anuga)

        def courant_max(self, courant, dt=None, run_max=None, run_idx=None):
            return courant_argmax_plain(courant, dt, run_max, run_idx)

        def cell_stage(self, flux, q, dt, ext_src, **mode):
            return swe_cell_stage_plain(
                self.arrays, flux, q, dt, ext_src, tiny_h=self.tiny_h,
                h_anuga=self.h_anuga, xq2018_threshold=self.xq2018_threshold,
                source_method=self.source_method, **mode)

    return PlainSWEOperator(**{f.name: getattr(op, f.name)
                               for f in dataclasses.fields(op)})


def edge_flux_bytes(Ei, Eb, q_bytes, s):
    """Bytes K1a must move over Ei interior and Eb boundary edges, reading
    q_bytes of the state: each input read once, each output written once."""
    E = Ei + Eb
    return (q_bytes + Ei * (4 + 4 + s + s) + Eb * (4 + s + s + 1 + 3 * s)
            + E * s + 3 * (E + 1) * s + E * s)


def courant_bytes(n, s):
    """Bytes K1c must move to fold n Courant values into the running
    maximum: the values, dt, and the running maximum and index."""
    return n * s + s + 4


def kernel_bytes(op, q_bytes, s, rhs=False):
    """Bytes each kernel must move at the main path's configuration (euler
    stage with primitives, no external source; with `rhs`, K1b in rhs mode
    writing flux_div, rhs and primitives): each input read once, each
    output written once."""
    C, Ei, Eb = op.num_cells, op.num_internal_edges, op.num_boundary_edges
    E, K = Ei + Eb, op.arrays.cell_edges.shape[1]
    k1b = (3 * (E + 1) * s + C * K * (4 + s) + q_bytes + s + 3 * C * s
           + q_bytes * (3 if rhs else 2))
    return {"swe_edge_flux": edge_flux_bytes(Ei, Eb, q_bytes, s),
            "swe_cell_stage": k1b, "courant_argmax": courant_bytes(E, s)}


def kernel_row(name, path, source, replaces, launches, err, timing, nbytes,
               nops, dtype):
    """One entry of the {"kernels": [...]} line; timing = (device ms, plain
    ms, library ms or None)."""
    ms, plain_ms, lib_ms = timing
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * nops / PEAK_OPS_PER_S[dtype]
    return {
        "name": name, "path": path, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
    }


def log_row(card, row, nbytes, nops, extra=""):
    log(f"  [{card}] {row['name']} on the {row['path']} path: device "
        f"{row['ms']:.4f} ms/call, plain {row['plain_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({nbytes / 1e6:.3f} MB, "
        f"{nops / 1e9:.4f} Gop), bound/time "
        f"{100 * row['bound_ms'] / row['ms']:.1f}%"
        + (f", torch.max(dim) {row['library_ms']:.4f} ms"
           if row["library_ms"] else "") + extra)


def dam_break_mesh(nx=2048, ny=1408):
    """The full-size raster of both main paths and the seconds it took."""
    from rdycore_tpu_torch.mesh import structured_quad

    lx, ly = nx * DX, ny * DX
    t0 = time.perf_counter()
    mesh = structured_quad(nx, ny, 0.0, lx, 0.0, ly,
                           region_fn=lambda cx, cy: np.where(cx < lx / 2, 1, 2))
    t_mesh = time.perf_counter() - t0
    log(f"== mesh: {nx}x{ny} raster of {DX} m cells, {mesh.num_cells} cells, "
        f"{mesh.num_edges} edges in {t_mesh:.2f} s")
    return mesh, t_mesh


def check_launches(path, launches, expected):
    """Fail unless the path launched each kernel exactly as expected."""
    log(f"  launches over the {path}: {launches}")
    if launches != expected:
        raise SystemExit(f"{path}: launches {launches}, expected {expected}")


def check_state_and_budget(sim, v0, area):
    """h finite and >= 0, and the volume lost equal to the outflow through
    the accumulated boundary fluxes, to 1e-4 of the initial volume."""
    h = sim.get_height()
    if not (np.all(np.isfinite(sim.get_solution())) and h.min() >= 0.0):
        raise SystemExit(f"bad state: finite={np.isfinite(h).all()}, "
                         f"min h {h.min()}")
    v1 = float(np.sum(h.astype(np.float64) * area))
    lens = sim.operator.arrays.bnd_len.cpu().numpy().astype(np.float64)
    outflow = float(np.sum(sim.bflux_accum[0] * lens))
    budget = abs((v0 - v1) - outflow) / v0
    log(f"  volume: initial {v0:.9e} m^3, final {v1:.9e}, lost {v0 - v1:.6e}, "
        f"outflow {outflow:.6e}, budget error {budget:.3e} of the initial "
        f"volume")
    if not budget <= 1e-4:
        raise SystemExit(f"volume budget error {budget} > 1e-4")
    if not outflow > 0.0:
        raise SystemExit("no outflow through the critical-outflow boundary")


def phase_main(steps, errs, dev, mesh, t_mesh):
    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.ops import kernels
    from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain

    log(f"== phase 3: unstructured main path, dam break on {mesh.num_cells:,} "
        "cells, f32")
    card = nvidia_smi_line()

    # 10 steps on the kernels against 10 steps on the plain versions
    sim_k = Simulation(dam_break_config(10), mesh=mesh, device=dev)
    sim_p = Simulation(dam_break_config(10), mesh=mesh, device=dev)
    sim_p.operator = plain_operator(sim_p.operator)
    sim_k.run()
    sim_p.run()
    torch.cuda.synchronize()
    if sim_k.step != 10 or sim_p.step != 10:
        raise SystemExit(f"10-step runs took {sim_k.step}/{sim_p.step} steps")
    r10 = rel_err(sim_k.q, sim_p.q)
    log(f"  10 steps, kernels vs plain versions: q rel {r10:.3e} "
        f"abs {abs_err(sim_k.q, sim_p.q):.3e}, courant "
        f"{sim_k.prev_max_courant:.6f} vs {sim_p.prev_max_courant:.6f}")
    if not r10 <= 1e-4:
        raise SystemExit(f"10-step kernel run differs from plain: {r10}")
    del sim_k, sim_p

    # the main path: --steps steps through Simulation.run
    t0 = time.perf_counter()
    sim = Simulation(dam_break_config(steps), mesh=mesh, device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    area = mesh.cell_area
    v0 = float(np.sum(sim.get_height().astype(np.float64) * area))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sim.advance()  # first interval: kernel libraries load
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    s_first = sim.step
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    n_steady = sim.step - s_first
    if sim.step != steps:
        raise SystemExit(f"main path took {sim.step} steps, expected {steps}")
    check_launches("unstructured main path", launches, {
        "swe_edge_flux": steps, "swe_cell_stage": steps,
        "courant_argmax": steps, "swe_raster_step": 0})
    check_state_and_budget(sim, v0, area)
    rate = n_steady * mesh.num_cells / t_steady
    log(f"  [{card}] setup {t_setup:.2f} s (mesh {t_mesh:.2f} s more); first "
        f"interval {t_first:.3f} s ({s_first} steps); steady state "
        f"{t_steady:.3f} s for {n_steady} steps = {1e3 * t_steady / n_steady:.4f}"
        f" ms/step, {rate:.4e} cell-updates/s; max Courant "
        f"{sim.prev_max_courant:.4f}")

    # each kernel at the main path's shapes: time, plain time, bound
    op, q, bv = sim.operator, sim.q, sim.boundary_values
    a, s = op.arrays, q.element_size()
    dt = torch.tensor(DT, dtype=q.dtype, device=dev)
    kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
              xq2018_threshold=op.xq2018_threshold,
              source_method=op.source_method)
    stage = dict(stage=(0.0, 1.0, 1.0), emit_prim=True)
    flux, courant = op.edge_flux(q, bv)
    fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga)
    ok_ = op.cell_stage(flux, q, dt, None, **stage)
    op_ = swe_cell_stage_plain(a, flux, q, dt, None, **kw, **stage)
    run = (torch.zeros((), dtype=q.dtype, device=dev),
           torch.zeros((), dtype=torch.int32, device=dev))
    mk, ik = op.courant_max(courant, dt, *run)
    mp, ip = courant_argmax_plain(courant)
    checks = {
        "swe_edge_flux": max(rel_err(flux, fp), rel_err(courant, cp)),
        "swe_cell_stage": max(rel_err(ok_.q_out, op_.q_out),
                              rel_err(ok_.prim, op_.prim)),
    }
    main_abs = {
        "swe_edge_flux": max(abs_err(flux, fp), abs_err(courant, cp)),
        "swe_cell_stage": max(abs_err(ok_.q_out, op_.q_out),
                              abs_err(ok_.prim, op_.prim)),
        "courant_argmax": abs(float(mk) - float(mp)),
    }
    log(f"  full-size kernels vs plain: {checks}; courant idx {int(ik)} "
        f"(plain {int(ip)})")
    if any(r > TOL[q.dtype] for r in checks.values()) or int(ik) != int(ip):
        raise SystemExit("full-size kernel check failed")

    calls = {
        "swe_edge_flux": (
            lambda: op.edge_flux(q, bv),
            lambda: swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga),
            None),
        "swe_cell_stage": (
            lambda: op.cell_stage(flux, q, dt, None, **stage),
            lambda: swe_cell_stage_plain(a, flux, q, dt, None, **kw, **stage),
            None),
        "courant_argmax": (
            lambda: op.courant_max(courant, dt, *run),
            lambda: courant_argmax_plain(courant, dt, *run),
            lambda: torch.max(courant, 0)),
    }
    timings = {
        name: tuple(None if f is None else device_ms(f) for f in fns)
        for name, fns in calls.items()
    }
    call_ms = {name: cuda_ms(fns[0]) for name, fns in calls.items()}
    nbytes = kernel_bytes(op, q.numel() * s, s)
    nops = {"swe_edge_flux": OPS_PER_EDGE * op.num_edges,
            "swe_cell_stage": OPS_PER_CELL * op.num_cells,
            "courant_argmax": OPS_PER_VALUE * op.num_edges}
    rows = []
    for name, timing in timings.items():
        rows.append(kernel_row(
            name, "unstructured", SOURCES[name], REPLACES[name],
            launches[name], max(errs.get(name, 0.0), main_abs[name]), timing,
            nbytes[name], nops[name], q.dtype))
        log_row(card, rows[-1], nbytes[name], nops[name],
                f" (between CUDA events {call_ms[name]:.4f} ms)")
    # rhs mode (rk4 and apply), and apply = K1a + K1c + K1b rhs
    pop = plain_operator(op)
    rhs_ms = device_ms(lambda: op.cell_stage(flux, q, dt, None,
                                             emit_prim=True))
    rhs_plain = device_ms(lambda: pop.cell_stage(flux, q, dt, None,
                                                 emit_prim=True), reps=5)
    rhs_bound = 1e3 * kernel_bytes(op, q.numel() * s, s, rhs=True)[
        "swe_cell_stage"] / HBM_BYTES_PER_S
    apply_ms = device_ms(lambda: op.apply(q, dt, bv, None))
    apply_plain = device_ms(lambda: pop.apply(q, dt, bv, None), reps=5)
    apply_bound = (rows[0]["bound_ms"] + rows[2]["bound_ms"] + rhs_bound)
    log(f"  [{card}] swe_cell_stage in rhs mode: device {rhs_ms:.4f} ms/call, "
        f"plain {rhs_plain:.4f} ms, bound {rhs_bound:.4f} ms; "
        f"SWEOperator.apply (K1a + K1c + K1b rhs): device {apply_ms:.4f} ms, "
        f"plain {apply_plain:.4f} ms, sum of its kernels' bounds "
        f"{apply_bound:.4f} ms")
    kern_ms = sum(r["ms"] for r in rows)
    log(f"  [{card}] kernel device time per step {kern_ms:.4f} ms of "
        f"{1e3 * t_steady / n_steady:.4f} ms/step wall")
    return rows


def plain_raster_operator(op):
    """The raster path's operator with every kernel replaced by its plain
    version (run on the card's tensors)."""
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.kernels.raster_step import swe_raster_step_plain
    from rdycore_tpu_torch.ops.structured import FusedStructuredOperator

    class PlainFusedStructuredOperator(FusedStructuredOperator):
        def step(self, q, dt, src=None, bc_vals=None, **mode):
            return swe_raster_step_plain(
                self.plan, q, self.dz_dx, self.dz_dy, self.mannings_n, dt,
                src=src, bc_vals=bc_vals, **mode)

        def courant_max(self, cmax_blocks, dt, run_max, run_idx):
            return courant_argmax_plain(cmax_blocks, dt, run_max, run_idx)

        def boundary_fluxes(self, q, bv_edges):
            flux, _ = swe_edge_flux_plain(self.bnd, q, bv_edges,
                                          self.plan.tiny_h, self.plan.h_anuga)
            return flux[:, :-1]

    return PlainFusedStructuredOperator(**{f.name: getattr(op, f.name)
                                           for f in dataclasses.fields(op)})


def raster_simulation(steps, dev, mesh, scheme="euler", plain=False):
    """The dam break with edge_flux_backend: fused_structured."""
    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.ops.structured import make_fused_structured_stepper

    sim = Simulation(dam_break_config(steps, "fused_structured", scheme),
                     mesh=mesh, device=dev)
    st = sim._structured
    if st["kind"] != "fused":
        raise SystemExit(f"the raster deck took the {st['kind']} path")
    if plain:
        st["op"] = plain_raster_operator(st["op"])
        st["adv"] = make_fused_structured_stepper(
            st["op"], st["scheme"], accumulate=st["accumulate"])
    return sim


def phase_raster(steps, errs, dev, mesh):
    from rdycore_tpu_torch.ops import kernels
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.kernels.raster_step import swe_raster_step_plain

    log(f"== phase 4: raster main path (fused_structured), dam break on "
        f"{mesh.num_cells:,} cells, f32")
    card = nvidia_smi_line()
    area = mesh.cell_area

    # 10 steps on the kernels against 10 steps on the plain versions
    sim_k = raster_simulation(10, dev, mesh)
    sim_p = raster_simulation(10, dev, mesh, plain=True)
    sim_k.run()
    sim_p.run()
    torch.cuda.synchronize()
    if sim_k.step != 10 or sim_p.step != 10:
        raise SystemExit(f"10-step runs took {sim_k.step}/{sim_p.step} steps")
    r10 = rel_err(sim_k.q, sim_p.q)
    # each row (h, hu, hv) of the accumulated boundary fluxes on its own
    bk, bp = (torch.as_tensor(s.bflux_accum) for s in (sim_k, sim_p))
    rb = max(rel_err(bk[k], bp[k]) for k in range(3))
    ck, cp = sim_k.prev_max_courant, sim_p.prev_max_courant
    rc = abs(ck - cp) / max(abs(cp), 1e-30)
    log(f"  10 steps, kernels vs plain versions: q rel {r10:.3e} "
        f"abs {abs_err(sim_k.q, sim_p.q):.3e}, boundary flux accumulator "
        f"rel {rb:.3e} (worst row), courant {ck:.9f} vs {cp:.9f} (rel "
        f"{rc:.3e})")
    if not (r10 <= 1e-4 and rb <= 1e-4 and rc <= 1e-4):
        raise SystemExit(f"10-step raster run differs from plain: q {r10}, "
                         f"boundary fluxes {rb}, courant {rc}")
    del sim_k, sim_p

    # the main path: --steps steps through Simulation.run
    t0 = time.perf_counter()
    sim = raster_simulation(steps, dev, mesh)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    v0 = float(np.sum(sim.get_height().astype(np.float64) * area))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sim.advance()  # first interval: the kernel library loads
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    s_first = sim.step
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    n_steady = sim.step - s_first
    if sim.step != steps:
        raise SystemExit(f"raster path took {sim.step} steps, expected {steps}")
    check_launches("raster main path", launches, {
        "swe_edge_flux": steps, "swe_cell_stage": 0,
        "courant_argmax": steps, "swe_raster_step": steps})
    check_state_and_budget(sim, v0, area)
    rate = n_steady * mesh.num_cells / t_steady
    log(f"  [{card}] setup {t_setup:.2f} s; first interval {t_first:.3f} s "
        f"({s_first} steps); steady state {t_steady:.3f} s for {n_steady} "
        f"steps = {1e3 * t_steady / n_steady:.4f} ms/step, {rate:.4e} "
        f"cell-updates/s; max Courant {sim.prev_max_courant:.4f}")

    # ssprk3 (stage mode with qA) and rk4 (rhs mode) at full size
    for scheme, per_step in (("ssprk3", 3), ("rk4", 4)):
        n = 24
        s2 = raster_simulation(n, dev, mesh, scheme)
        v0_2 = float(np.sum(s2.get_height().astype(np.float64) * area))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        s2.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_launches(f"raster {scheme} run of {n} steps",
                       {k.__name__: k.launches for k in kernels.KERNELS}, {
                           "swe_edge_flux": n, "swe_cell_stage": 0,
                           "courant_argmax": n,
                           "swe_raster_step": per_step * n})
        check_state_and_budget(s2, v0_2, area)
        log(f"  [{card}] raster {scheme}: {n} steps in {wall:.3f} s "
            f"(first interval included) = {1e3 * wall / n:.4f} ms/step")
        del s2

    # each kernel at the main path's shapes against its plain version: K2
    # in an euler stage with the primitives and in rhs mode, K1c on that
    # stage's block maxima, K1a on the boundary edges
    op, q = sim._structured["op"], sim.q
    bv = sim.boundary_values.to(q.dtype)
    th, ta = op.plan.tiny_h, op.plan.h_anuga
    C, Eb = q.shape[1], op.bnd.bnd_left.shape[0]
    dt = torch.tensor(DT, dtype=q.dtype, device=dev)
    modes = {"stage": dict(stage=(0.0, 1.0, 1.0), emit_prim=True),
             "rhs": dict(emit_prim=True)}
    # K2's phase 2 errors count too (phase 2 ran K1a and K1c at other shapes)
    main_abs = {"swe_raster_step": errs.get("swe_raster_step", 0.0)}
    for mode, kw in modes.items():
        got = op.step(q, dt, **kw)
        want = swe_raster_step_plain(op.plan, q, op.dz_dx, op.dz_dy,
                                     op.mannings_n, dt, **kw)
        r = max(rel_err(g, w) for g, w in zip(got, want))
        main_abs["swe_raster_step"] = max(
            main_abs["swe_raster_step"],
            max(abs_err(g, w) for g, w in zip(got, want)))
        log(f"  full-size swe_raster_step vs plain, {mode} mode: rel {r:.3e}")
        if not r <= TOL[q.dtype]:
            raise SystemExit("full-size raster kernel check failed")
        if mode == "stage":
            blocks = got.cmax
    run = (torch.zeros((), dtype=q.dtype, device=dev),
           torch.zeros((), dtype=torch.int32, device=dev))
    mk, ik = op.courant_max(blocks, dt, *run)
    mp, ip = courant_argmax_plain(blocks)
    exact = (float(mk) == float(mp) and int(ik) == int(ip)
             and float(run[0]) == float(mp * dt))
    main_abs["courant_argmax"] = abs(float(mk) - float(mp))
    log(f"  full-size courant_argmax on {blocks.numel()} block maxima vs "
        f"plain: max {float(mk):.9f} (plain {float(mp):.9f}), idx {int(ik)} "
        f"(plain {int(ip)}) {'ok' if exact else 'FAIL'}")
    if not exact:
        raise SystemExit("full-size raster Courant fold differs from plain")
    fk = op.boundary_fluxes(q, bv)
    fp = swe_edge_flux_plain(op.bnd, q, bv, th, ta)[0][:, :-1]
    rb = max(rel_err(fk[k], fp[k]) for k in range(3))
    main_abs["swe_edge_flux"] = abs_err(fk, fp)
    log(f"  full-size swe_edge_flux on the {Eb} boundary edges vs plain: "
        f"rel {rb:.3e} (worst of the h, hu, hv rows)")
    if not rb <= TOL[q.dtype]:
        raise SystemExit("full-size raster boundary-flux check failed")

    calls = {
        "swe_raster_step": (
            lambda: op.step(q, dt, **modes["stage"]),
            lambda: swe_raster_step_plain(op.plan, q, op.dz_dx, op.dz_dy,
                                          op.mannings_n, dt, **modes["stage"]),
            None),
        "swe_edge_flux": (
            lambda: op.boundary_fluxes(q, bv),
            lambda: swe_edge_flux_plain(op.bnd, q, bv, th, ta),
            None),
        "courant_argmax": (
            lambda: op.courant_max(blocks, dt, *run),
            lambda: courant_argmax_plain(blocks, dt, *run),
            lambda: torch.max(blocks, 0)),
    }
    s = q.element_size()
    # K2: q, the three geometry planes, out and prim, the block maxima;
    # K1a: the boundary cells' state and the boundary edges' arrays
    nbytes = {
        "swe_raster_step": s * (12 * C + blocks.numel() + 1),
        "swe_edge_flux": edge_flux_bytes(
            0, Eb, 3 * s * int(torch.unique(op.bnd.bnd_left).numel()), s),
        "courant_argmax": courant_bytes(blocks.numel(), s),
    }
    nops = {"swe_raster_step": OPS_PER_RASTER_CELL * C,
            "swe_edge_flux": OPS_PER_EDGE * Eb,
            "courant_argmax": OPS_PER_VALUE * blocks.numel()}
    # K1a stands in for the edge kernel on the boundary edges; K1c folds
    # the per-tile Courant maxima that the raster step kernel writes
    replaces = dict(REPLACES,
                    swe_edge_flux="rdycore_tpu/ops/pallas/slotted.py:1254",
                    courant_argmax=REPLACES["swe_raster_step"])
    rows = []
    for name, fns in calls.items():
        timing = tuple(None if f is None else
                       device_ms(f, reps=5 if i == 1 else 20)
                       for i, f in enumerate(fns))
        rows.append(kernel_row(
            name, "raster", SOURCES[name], replaces[name], launches[name],
            main_abs[name], timing, nbytes[name], nops[name], q.dtype))
        log_row(card, rows[-1], nbytes[name], nops[name],
                f" (between CUDA events {cuda_ms(fns[0]):.4f} ms)")
    log(f"  [{card}] swe_raster_step in rhs mode: device "
        f"{device_ms(lambda: op.step(q, dt, **modes['rhs'])):.4f} ms/call; "
        "no single PyTorch call computes it")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=500)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the GPU only")
        return 1
    import rdycore_tpu_torch  # noqa: F401  (fails outside the repository)

    t_start = time.perf_counter()
    errs = {}
    phase_build()
    dev = torch.device("cuda")
    phase_kernels(args.seed, errs, dev)
    mesh, t_mesh = dam_break_mesh()
    # one row per kernel and path, each with that path's own launches
    rows = phase_main(args.steps, errs, dev, mesh, t_mesh)
    rows += phase_raster(args.steps, errs, dev, mesh)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
