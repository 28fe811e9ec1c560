#!/usr/bin/env python3
"""Smoke run of rdycore_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed N] [--steps N]

Phases, each printing as it goes; any failure exits non-zero:

1. Card and build: the card's name and power limit, torch's CUDA, the
   triton and nvcc versions, and a fresh nvcc build of every kernel of the
   package (one nvcc per source, all started together), with each
   kernel's registers, shared memory and spills.
2. Kernels against their plain PyTorch versions on the card, with a random
   wet/dry state made with numpy from --seed. On a 256x176 quad mesh and a
   triangle mesh, in f32 and f64, with all three BC codes (Dirichlet values
   non-zero): K1a swe_edge_flux; K1b swe_cell_stage in stage mode for each
   ssprk3 stage and in rhs mode, with each source method; K1c
   courant_argmax, including a constructed tie whose index must be exact,
   and (f32 and f64) NaN, infinities, signed zeros, one value, odd sizes
   and slices off a 16-byte boundary, its (max, index, run fold) exactly
   the plain version's. K1c must be one device kernel per call, by
   torch.profiler, here and at each main path's shapes (phases 3, 4, 8).
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
   held against 10 steps on the plain versions (every row of q and of the
   accumulators, and the Courant number, to relative 1e-4); then --steps
   steps through `Simulation.advance` and `run` with every launch count set
   to 0 just before: h must be finite and >= 0, the volume lost must equal the
   outflow through the accumulated boundary fluxes (to 1e-4 of the initial
   volume, summed in f64 on the host), and K1a, K1b and K1c must have been
   launched once per step and K2 never. Then each kernel is timed at the
   path's shapes (device time per call, from torch.profiler) beside its
   plain version, its bound and, where one PyTorch call computes the same
   function, that call. Phases 4-6 drive their paths the same way
   (`run_main_path`).
4. The raster main path at full size: the same deck and mesh with
   `edge_flux_backend: fused_structured`. 10 steps on the kernels against
   10 steps on the plain versions: every row of q and of the
   accumulators, and the Courant number, to relative 1e-4. Then --steps steps
   with the launch counts set to 0 just before, the same checks of the
   state and the volume budget, and K2, K1c and K1a (on the boundary edges,
   for the boundary-flux accumulator) launched once per step each and K1b
   never. ssprk3 and rk4 then run a few dozen steps each (K2 in stage mode
   with qA, and in rhs mode, at full size). At this path's shapes, K2 (in
   stage and rhs mode), K1c on K2's block maxima and K1a on the boundary
   edges alone are held against their plain versions (2e-5; the Courant
   fold exact) and timed like the others.

5. Tracers (two sediment classes with Hairsine-Rose sources and salinity,
   NT = 3 tracer rows, ndof = 6). At 256x176 (quad and triangle meshes,
   f32 and f64, Roe and upwind-Roe, all three BC codes with non-zero
   Dirichlet tracer masses): K1a and K1b (each ssprk3 stage and rhs mode,
   source methods semi-implicit and none) at NT = 3, and K2 at NT = 3 on
   the raster (rain on, each stage and rhs mode), against their plain
   versions, tolerances as in phase 2. Then, on each main path at full
   size, the dam break with sediment in the reservoir and one salt
   concentration everywhere: 10 steps on the kernels against 10 on the
   plain versions (every row of q and of the accumulators, and the Courant
   number, to relative 1e-4); --steps euler steps with the launch counts
   set to 0 just before (K1a, K1b and K1c once per unstructured step; K2,
   K1c and boundary-only K1a once per raster step); h finite and >= 0,
   every row finite, the volume budget, and on the unstructured path the
   salinity mass budget (mass lost = accumulated outflow of its row, to
   1e-4 of the initial mass); the NT = 3 kernels held against their plain
   versions at the path's shapes and timed like the others.

6. Second order (MUSCL with the positivity limiter, flow only). At
   256x176 (quad and triangle meshes, f32 and f64, every BC code,
   h_anuga = 1e-3): K3a swe_muscl_grad, K1a in MUSCL mode for each
   limiter, K3b swe_positivity_drain and swe_positivity_scale (on a state
   where some donor factor is below 1, and with dt = 0), and on the raster
   K2 MUSCL swe_raster_muscl_step (one launch per stage: each limiter, in
   each ssprk3 stage and rhs mode, rain off and on, at a step where some
   donor factor is below 1, with its tile maxima and their K1c fold),
   against their plain versions, tolerances as in phase 2. Then, on each main path at full size, the dam break at
   second order (minmod, ssprk2, dt = 0.00025 s, a Courant number near
   0.4, the floodplain dry): 10 steps on the kernels against 10 on the
   plain versions (every row of q and of the accumulators, and the
   Courant number, to relative 1e-4), with the number of cells whose
   donor factor fell below 1 in each stage of the plain run; --steps
   steps with the launch counts set to 0 just before (per step 2 each of
   K3a, K1a, K3b drain, K3b scale and K1b and 1 K1c; on the raster 2 K2
   MUSCL, 1 K1c and 1 boundary-only K1a); h finite and >= -1e-7, the
   volume kept to 1e-4 (the front does not reach the outflow wall); each
   kernel of the path held against its plain version at the path's shapes
   (K3b drain and scale, and K2 MUSCL, also at 40 times the step, where
   the limiter acts) and timed like the others.

7. Well-balancing. At 256x176 (quad and triangle meshes over the bumpy
   bed z = 0.035 (1 + sin 4 pi x sin 4 pi y), f32 and f64, every BC code;
   phase 7a): K1a in HR mode (NT = 0 and 3, Roe and upwind-Roe), K1b in HR
   mode (each ssprk3 stage and rhs mode, each source method, NT = 0 and
   3), K5 swe_eta_vertex and K1a's BS2002 correction (first order and
   each limiter, h_anuga = 1e-3), against their plain versions,
   tolerances as in phase 2. Then, on a 1448x996 triangle mesh over the
   dam break's 4 m x 2.75 m (2,884,416 cells) with its vertices on that
   bed, the dam break set through `Simulation.set_height` (eta 0.25 m for
   x < 2 m; beyond, 0.05 m for HR, whose bump tops stay dry, and 0.1 m
   for BS2002, which diverges over dry bump tops in both packages, ROADMAP
   fault 19), Manning 0.018, critical outflow on the right, dt 0.0002 s,
   f32, three runs through `run_main_path`: HR euler, BS2002 euler, and
   BS2002 with MUSCL minmod and the positivity limiter under ssprk2 (h >=
   -1e-7). Each: 10 steps against the plain versions, exact launches
   (K5 before every K1a under BS2002), h >= 0, the volume budget, the
   kernels held against their plain versions and timed at the path's
   shapes. Last, a lake at rest on the same mesh, all walls reflecting:
   HR at eta 0.05 m (a fifth of the cells dry) must keep the momentum
   rows of `apply` below 1e-4; BS2002 at eta 0.1 m keeps no lake at rest
   (fault 19), so its rows and its max |hu|, |hv| after 100 steps are
   printed beside those without well-balancing.

8. Row strips (the raster in parallel.n_devices = 4 strips of 352 rows,
   all on the one card through an explicit device list; halo rows copied
   between stages). The phase-4 deck in strips through `run_main_path`: 10
   steps on the kernels against the plain strip versions (1e-4, every
   row); then --steps euler steps with the launch counts set to 0 just
   before (K2, K1c and boundary-only K1a once per strip and step), the
   state and volume checks, and the end state bit for bit phase 4's
   single strip (q, t, Courant number, boundary-flux accumulator); wall
   ms/step beside phase 4's. Then phase 5's NT = 3 deck (euler) and phase
   6's second-order deck (ssprk2) for 24 steps each in strips, bit for
   bit their single strips, with exact launches (K2 MUSCL 2 per strip
   and step). Each strip kernel (K2 or K2 MUSCL in
   strip mode, K1c, K1a) launched on an inner strip of the final state is
   held against its plain version (2e-5; the Courant fold exact) and
   timed beside its bound, and the halo exchange is timed per stage.

Before the last line it prints the card's name and power limit and a JSON
line {"kernels": [...]} with one row per kernel and path ("path":
"unstructured", "raster", "unstructured+tracers", "raster+tracers" (these
two with "nt": 3), "unstructured+muscl", "raster+muscl",
"unstructured+hr", "unstructured+bs2002", "unstructured+bs2002+muscl",
"raster+strips4", "raster+strips4+tracers" or "raster+strips4+muscl"; a
strip row names its strip [row0, rows, halo_lo, halo_hi]),
each with that path's own launches, times and bound, and "timers" naming
the timer of each time ("profiler", or "cuda events" where torch.profiler
recorded no device time); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
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
# K2: the work of the function, each face once: two Roe solves (~140
# each) per cell, one regularization and square root, the divergence,
# sources, stage update and Courant maxima
OPS_PER_RASTER_CELL = 360
DX = 1.0 / 512.0  # cell size of the full-size raster [m]
H_RESERVOIR, H_FLOODPLAIN = 0.25, 0.05  # initial depths [m]
# phase 5: two sediment classes (their concentrations in the reservoir)
# and salinity (one concentration everywhere)
NT, NUM_SEDIMENT = 3, 2
SEDIMENT_C = (2e-3, 1e-3)
SALINITY_C = 1e-3
# operations per item that the tracers add, counted from the CUDA sources:
# K1a two concentrations and the advected wave per tracer; K1b its gather,
# Hairsine-Rose, stage and primitive; K2 one concentration, two faces'
# waves (each face once), the divergence, sources and stage
OPS_PER_TRACER = {"swe_edge_flux": 25, "swe_cell_stage": 20,
                  "swe_raster_step": 60}
# phase 6: the second-order dam break (dry floodplain, minmod, ssprk2)
DT_MUSCL = 0.00025
LIMITERS = ("minmod", "van_leer", "none")
# operations per item of the second-order kernels, counted from the CUDA
# sources: K3a per cell (4 slots of 3 differences and 6 multiply-adds);
# K1a in MUSCL mode per edge (K1a's plus two sides' 3 extrapolations and
# limited slopes); K3b per cell (4 slots, the factor) and per edge (the
# donor test, 3 products); K2 MUSCL per cell, each face once: two MUSCL
# faces (about 190 each: six limited slopes, two regularizations and
# square roots, Roe), two gradients, the donor factor, the divergence,
# sources and stage
OPS_PER_GRAD_CELL = 60
OPS_PER_MUSCL_EDGE = 225
OPS_PER_DRAIN_CELL = 16
OPS_PER_SCALE_EDGE = 4
OPS_PER_MUSCL_RASTER_CELL = 500
# phase 7: well-balancing on a 1448x996 triangle mesh over a bumpy bed
# (2,884,416 cells over the dam break's 4 m x 2.75 m), dt for a Courant
# number of about 0.3-0.5
WB_NX, WB_NY = 1448, 996
DT_WB = 0.0002
WB_INTERVAL_STEPS = 100  # steps per coupling interval
H_WB_SUBMERGED = 0.1  # a floodplain level above every bump [m]
# operations the well-balancing modes add, counted from the CUDA sources:
# K1a HR per interior edge (two bed gathers, the higher bed, two
# reconstructed depths, the inner mask); K1a BS2002 per edge (two eta
# gathers, dhv, the correction of two rows); K1b HR per slot (the
# neighbour, its reconstructed depth, the pressure term, two products);
# K5 per (vertex, cell) pair (eta_cell with a cube or square root, the sum)
OPS_PER_HR_EDGE = 8
OPS_PER_BS_EDGE = 10
OPS_PER_HR_SLOT = 14
OPS_PER_ETA_PAIR = 30
_CSRC = "rdycore_tpu_torch/ops/kernels/csrc/"
SOURCES = {"swe_edge_flux": _CSRC + "swe_edge_flux.cu",
           "swe_cell_stage": _CSRC + "swe_cell_stage.cu",
           "courant_argmax": _CSRC + "courant_argmax.cu",
           "swe_raster_step": _CSRC + "swe_raster_step.cu",
           "swe_muscl_grad": _CSRC + "swe_muscl_grad.cu",
           "swe_positivity_drain": _CSRC + "swe_positivity.cu",
           "swe_positivity_scale": _CSRC + "swe_positivity.cu",
           "swe_raster_muscl_step": _CSRC + "swe_raster_muscl.cu",
           "swe_eta_vertex": _CSRC + "swe_eta_vertex.cu"}
_SLOTTED = "rdycore_tpu/ops/pallas/slotted.py"
# the per-shard kernel call of the row-strip sharded raster stepper
_SHARDED = "rdycore_tpu/ops/pallas/structured_step.py:1211"
REPLACES = {"swe_edge_flux": _SLOTTED + ":2463",
            "swe_cell_stage": _SLOTTED + ":2463",
            "courant_argmax": _SLOTTED + ":2463",
            "swe_raster_step": "rdycore_tpu/ops/pallas/structured_step.py:172",
            "swe_muscl_grad": _SLOTTED + ":3066",
            "swe_positivity_drain": _SLOTTED + ":1597",
            "swe_positivity_scale": _SLOTTED + ":1654",
            "swe_raster_muscl_step":
                "rdycore_tpu/ops/pallas/structured_step.py:341",
            "swe_eta_vertex": "rdycore_tpu/ops/pallas/routed.py:264"}


# steady-state (ms/step, cell-updates/s) of each path `run_main_path` drove,
# and the final state of phase 4's raster run, which phase 8 must reproduce
STEADY = {}
REFERENCE = {}
STRIPS = 4  # phase 8: row strips on the one card


def log(*args):
    print(*args, flush=True)


def final_state(sim):
    """(q, t, Courant number, boundary-flux accumulator) of a run."""
    return (sim.get_solution(), sim.t, sim.prev_max_courant,
            sim.bflux_accum.copy())


def same_state(a, b):
    """Whether two `final_state`s are equal bit for bit."""
    return (np.array_equal(a[0], b[0]) and a[1] == b[1] and a[2] == b[2]
            and np.array_equal(a[3], b[3]))


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


def device_time(fn, reps=20):
    """(mean device milliseconds per call of fn(), the timer that gave
    them): the device time of every kernel and copy it launches, from
    torch.profiler ("profiler"), the larger of two sessions: a session on
    that card has missed a whole run's events (once in four runs) and,
    more often, part of them (a time below the kernel's bytes bound).
    Where neither session records device time, the time between CUDA
    events ("cuda events"), which counts the host's launch time where
    that is longer."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    totals = []
    for _ in range(2):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        if events:
            totals.append(sum(e[0] for e in events) / 1e3 / reps)
    if totals:
        return max(totals), "profiler"
    log("  torch.profiler recorded no device time twice: timing between "
        "CUDA events instead")
    return cuda_ms(fn, reps), "cuda events"


def check_one_kernel(fn, what, calls=3, sessions=5):
    """Fail unless fn() launches exactly one device kernel a call, by
    torch.profiler over `calls` calls: the CUDA runtime's kernel launches
    number `calls`, and the device records no kernel but one. A session on
    that card may leave out some or all of a run's device records, never
    the runtime calls; one that records no kernel is taken again, up to
    `sessions` times."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages()
                       if e.key.startswith(("cudaLaunchKernel",
                                            "cuLaunchKernel")))
        kernels = {name: n for _, n, name in device_events(prof)}
        if kernels:
            break
    log(f"  {what}: {launches} kernel launches over {calls} calls, device "
        f"records {kernels}")
    if launches != calls or len(kernels) > 1:
        raise SystemExit(f"{what}: not one kernel per call")


def device_ms(fn, reps=20) -> float:
    """The milliseconds of `device_time`, for the log."""
    return device_time(fn, reps)[0]


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
        log(f"  ptxas {name}: {' | '.join(ptxas_summary(report))}")


def ptxas_summary(report):
    """'kernel<args>: R registers, S B shared memory, P B spilled' of each
    entry function in nvcc's -Xptxas -v report whose tracer count is 0 or
    NT (the others are the same source at other counts); a MUSCL instance
    names its limiter code, a K2 or K2 MUSCL instance its tile (its shared
    memory: the static, and the dynamic that the kernel reports,
    `smem_bytes` of raster_step and raster_muscl)."""
    from rdycore_tpu_torch.ops.kernels import raster_muscl, raster_step

    out, entry, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry and "spill stores" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if entry and m:
            k = re.search(r"\d+([a-z_]+_kernel)(I\w+?EE|E)", entry)
            counts = re.findall(r"Li(\d+)E", entry)
            lims, wb, tile = [], [], []
            if "edge_flux" in entry:
                counts, lims, wb = counts[:1], counts[1:2], counts[2:3]
            if "raster_muscl" in entry:
                tile, lims, counts = [int(c) for c in counts[:2]], \
                    counts[2:3], []
            if "raster_step" in entry:
                tile, counts = [int(c) for c in counts[:2]], counts[2:3]
            if k and (not counts or int(counts[0]) in (0, NT)):
                args = k.group(2)
                what = ["f64" if args.startswith("Id") else "f32"]
                what += [f"tile {tile[0]}x{tile[1]}"] if tile else []
                what += [f"nt {c}" for c in counts[:1]]
                what += [f"limiter {c}" for c in lims if c != "0"]
                what += [{"1": "hr", "2": "bs2002"}[c] for c in wb
                         if c != "0"]
                flags = re.findall(r"Lb(\d)", args)
                if "1" in flags:
                    what += ["hr" if "cell_stage" in entry else "upwind"]
                spills = re.findall(r"(\d+) bytes spill", spill)
                smem = int(re.search(r"(\d+) bytes smem", line).group(1)
                           if "bytes smem" in line else 0)
                if tile:  # a tile lives in dynamic shared memory
                    smem += (raster_muscl.smem_bytes()
                             if "raster_muscl" in entry
                             else raster_step.smem_bytes(int(counts[0])))
                out.append(f"{k.group(1)}<{', '.join(what)}>: {m.group(1)} "
                           f"regs, {smem} B shared memory, "
                           f"{sum(map(int, spills))} B spilled")
            entry = None
    return out


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
    # K1c: NaN, infinities, signed zeros, one value, odd sizes and slices
    # that start off a 16-byte boundary, against the plain version exactly
    for dtype in (torch.float32, torch.float64):
        x = torch.as_tensor(rng.uniform(0, 1, 70_001), dtype=dtype,
                            device=dev)
        nan = x.clone()
        nan[[5, 60_000]] = float("nan")
        cases = {"n=1": x[:1], "n=4097": x[:4097], "nan": nan,
                 "+inf tie": torch.tensor([1.0, float("inf"), 3.0,
                                           float("inf")], dtype=dtype,
                                          device=dev),
                 "-inf": torch.full((9,), -float("inf"), dtype=dtype,
                                    device=dev),
                 "signed zeros": torch.tensor([-0.0, 0.0, -0.0],
                                              dtype=dtype, device=dev),
                 **{f"slice at +{o}": x[o:] for o in (1, 2, 3)}}
        dt = torch.tensor(0.5, dtype=dtype, device=dev)
        for what, v in cases.items():
            run = (torch.full((), 0.25, dtype=dtype, device=dev),
                   torch.full((), -1, dtype=torch.int32, device=dev))
            run_p = tuple(r.clone() for r in run)
            mk, ik = courant_argmax(v, dt, *run)
            mp, ip = courant_argmax_plain(v, dt, *run_p)
            exact = ((float(mk) == float(mp) or (np.isnan(float(mk))
                                                 and np.isnan(float(mp))))
                     and int(ik) == int(ip) and int(run[1]) == int(run_p[1])
                     and (torch.equal(run[0], run_p[0])
                          or bool(run[0].isnan() and run_p[0].isnan())))
            log(f"  {'courant_argmax':15s} {str(dtype)[6:] + ' ' + what:48s} "
                f"idx {int(ik)} (plain {int(ip)}) {'ok' if exact else 'FAIL'}")
            if not exact:
                failures.append(f"courant_argmax {dtype} {what}")
    check_one_kernel(lambda: courant_argmax(x, dt, *run),
                     "courant_argmax on 70,001 values")
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
def dam_break_dict(steps, backend="xla", scheme="euler"):
    """The dam-break deck of both main paths as a config dictionary."""
    return {
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
            {"name": "column", "type": "dirichlet", "height": H_RESERVOIR,
             "x_momentum": 0, "y_momentum": 0},
            {"name": "wet_bed", "type": "dirichlet", "height": H_FLOODPLAIN,
             "x_momentum": 0, "y_momentum": 0},
            {"name": "outflow", "type": "critical-outflow"}],
    }


def dam_break_config(steps, backend="xla", scheme="euler"):
    from rdycore_tpu_torch.config.yaml_input import config_from_dict

    return config_from_dict(dam_break_dict(steps, backend, scheme)).validate()


def tracer_dam_break_config(steps, backend="xla", scheme="euler"):
    """The dam break with two sediment classes and salinity (ndof = 6): the
    reservoir holds sediment, and salt has one concentration everywhere
    (the initial conditions give tracer masses h*c)."""
    from rdycore_tpu_torch.config.yaml_input import config_from_dict

    d = dam_break_dict(steps, backend, scheme)
    d["physics"].update({"sediment": {"num_classes": 2}, "salinity": True})
    d["initial_conditions"] = [
        {"region": "reservoir", "flow": "column", "sediment": "mud",
         "salinity": "salt_deep"},
        {"region": "floodplain", "flow": "wet_bed", "salinity": "salt_shallow"}]
    d["sediment_conditions"] = [{
        "name": "mud", "c0": {"value": H_RESERVOIR * SEDIMENT_C[0]},
        "c1": {"value": H_RESERVOIR * SEDIMENT_C[1]}}]
    d["salinity_conditions"] = [
        {"name": "salt_deep", "concentration": H_RESERVOIR * SALINITY_C},
        {"name": "salt_shallow", "concentration": H_FLOODPLAIN * SALINITY_C}]
    return config_from_dict(d).validate()


def plain_operator(op):
    """The same operator with every kernel replaced by its plain version
    (run on the card's tensors), for holding the kernels' run against. Its
    `donor_counts` collects, per positivity pass, the number of cells whose
    donor factor is below 1."""
    from rdycore_tpu_torch.operator import SWEOperator
    from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.kernels.muscl import (
        positivity_drain_plain, positivity_scale_plain)
    from rdycore_tpu_torch.ops.swe.bs2002 import eta_vertices
    from rdycore_tpu_torch.ops.swe.muscl import ls_gradients

    class PlainSWEOperator(SWEOperator):
        donor_counts = []

        def muscl_grad(self, q):
            return ls_gradients(self.arrays, q)

        def eta_vertices(self, h):
            return eta_vertices(self.arrays.bs2002, h, self.tiny_h)

        def edge_flux(self, q, bv, grad=None, eta_v=None):
            return swe_edge_flux_plain(self.arrays, q, bv, self.tiny_h,
                                       self.h_anuga,
                                       self.riemann == "upwind_roe", grad,
                                       self.limiter, self.well_balancing_hr,
                                       self.arrays.bs2002, eta_v)

        def limit_positivity(self, flux, h, dt):
            s = positivity_drain_plain(self.arrays, flux, h, dt)
            self.donor_counts.append(int((s < 1.0).sum()))
            return positivity_scale_plain(self.arrays, flux, s)

        def courant_max(self, courant, dt=None, run_max=None, run_idx=None):
            return courant_argmax_plain(courant, dt, run_max, run_idx)

        def cell_stage(self, flux, q, dt, ext_src, **mode):
            return swe_cell_stage_plain(
                self.arrays, flux, q, dt, ext_src, tiny_h=self.tiny_h,
                h_anuga=self.h_anuga, xq2018_threshold=self.xq2018_threshold,
                source_method=self.source_method,
                num_sediment=self.num_sediment,
                hr=self.well_balancing_hr, **mode)

    return PlainSWEOperator(**{f.name: getattr(op, f.name)
                               for f in dataclasses.fields(op)})


def edge_flux_bytes(Ei, Eb, q_bytes, s, ndof=3):
    """Bytes K1a must move over Ei interior and Eb boundary edges, reading
    q_bytes of the state (ndof rows): each input read once, each output
    written once."""
    E = Ei + Eb
    return (q_bytes + Ei * (4 + 4 + s + s) + Eb * (4 + s + s + 1 + ndof * s)
            + E * s + ndof * (E + 1) * s + E * s)


def courant_bytes(n, s):
    """Bytes K1c must move to fold n Courant values into the running
    maximum: the values, dt, and the running maximum and index."""
    return n * s + s + 4


def kernel_bytes(op, q_bytes, s, rhs=False):
    """Bytes each kernel must move at the main path's configuration (euler
    stage with primitives, no external source; with `rhs`, K1b in rhs mode
    writing flux_div, rhs and primitives), over the operator's ndof rows:
    each input read once, each output written once."""
    C, Ei, Eb = op.num_cells, op.num_internal_edges, op.num_boundary_edges
    E, K, nd = Ei + Eb, op.arrays.cell_edges.shape[1], op.ndof
    k1b = (nd * (E + 1) * s + C * K * (4 + s) + q_bytes + s + 3 * C * s
           + q_bytes * (3 if rhs else 2))
    return {"swe_edge_flux": edge_flux_bytes(Ei, Eb, q_bytes, s, nd),
            "swe_cell_stage": k1b, "courant_argmax": courant_bytes(E, s)}


def raster_step_bytes(C, ndof, blocks, s):
    """Bytes K2 must move in an euler stage with the primitives: q and the
    three geometry planes read, out and prim written, the block maxima."""
    return s * ((3 * ndof + 3) * C + blocks + 1)


def kernel_row(card, name, path, fns, launches, err, nbytes, nops, dtype,
               replaces=REPLACES, **extra):
    """One entry of the {"kernels": [...]} line, logged. fns = (the
    kernel's call, its plain version's, one PyTorch call that computes the
    same function or None), each timed here; the bound from nbytes and
    nops; "timers" names the timer that gave each time (`device_time`)."""
    times = [None if f is None else device_time(f, reps=5 if i == 1 else 20)
             for i, f in enumerate(fns)]
    ms, plain_ms, lib_ms = (None if t is None else t[0] for t in times)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * nops / PEAK_OPS_PER_S[dtype]
    row = {
        "name": name, "path": path, "route": "cuda", "source": SOURCES[name],
        "replaces": replaces[name], "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms, **extra,
        "timers": {k: None if t is None else t[1] for k, t in
                   zip(("ms", "plain_ms", "library_ms"), times)},
    }
    log(f"  [{card}] {name} on the {path} path: device {ms:.4f} ms/call "
        f"(between CUDA events {cuda_ms(fns[0]):.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({nbytes / 1e6:.3f} MB, {nops / 1e9:.4f} Gop), bound/time "
        f"{100 * row['bound_ms'] / ms:.1f}%, "
        + (f"one PyTorch call {lib_ms:.4f} ms" if lib_ms is not None
           else "no single PyTorch call computes it"))
    return row


def dam_break_mesh(nx=2048, ny=1408):
    """The full-size raster of both main paths."""
    from rdycore_tpu_torch.mesh import structured_quad

    lx, ly = nx * DX, ny * DX
    t0 = time.perf_counter()
    mesh = structured_quad(nx, ny, 0.0, lx, 0.0, ly,
                           region_fn=lambda cx, cy: np.where(cx < lx / 2, 1, 2))
    log(f"== mesh: {nx}x{ny} raster of {DX} m cells, {mesh.num_cells} cells, "
        f"{mesh.num_edges} edges in {time.perf_counter() - t0:.2f} s")
    return mesh


def check_launches(path, launches, expected):
    """Fail unless the path launched each kernel exactly as expected (a
    kernel that `expected` does not name: never)."""
    log(f"  launches over the {path}: {launches}")
    unknown = set(expected) - set(launches)
    expected = {k: expected.get(k, 0) for k in launches}
    if unknown or launches != expected:
        raise SystemExit(f"{path}: launches {launches}, expected {expected}")


def check_state_and_budget(sim, q0, area, min_h=0.0):
    """h finite and >= min_h, and the volume lost (from the initial state
    q0) equal to the outflow through the accumulated boundary fluxes, to
    1e-4 of the initial volume."""
    h = sim.get_height()
    if not (np.all(np.isfinite(sim.get_solution())) and h.min() >= min_h):
        raise SystemExit(f"bad state: finite={np.isfinite(h).all()}, "
                         f"min h {h.min()}")
    v0 = float(np.sum(q0[0] * area))
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


def rows_rel_err(a, b):
    """The worst over rows of each row's error relative to its largest
    magnitude (a row of zeros in both counts 0)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return max(rel_err(a[k], b[k]) for k in range(a.shape[0]))


def path_operator(sim):
    """The operator whose kernels the simulation's steps launch (the first
    strip's, on a strip deck)."""
    if not sim._structured:
        return sim.operator
    op = sim._structured["op"]
    return op[0] if isinstance(op, list) else op


def run_main_path(path, make_sim, steps, per_step, check):
    """Drive one main path at full size through `Simulation`, as a user
    does. make_sim(n, plain=False) builds the deck for n steps (its kernels
    replaced by their plain versions when `plain`). 10 steps on the kernels
    are held against 10 on the plain versions: every row of q and of the
    accumulators, and the Courant number, to relative 1e-4. Then `steps`
    steps through advance and run, with every launch count set to 0 just
    before: each kernel must have been launched per_step[name] times a step
    (a kernel per_step does not name: never), and check(sim, q0) (q0 the
    initial state in f64) must pass. Returns the simulation and the
    launches."""
    from rdycore_tpu_torch.ops import kernels

    card = nvidia_smi_line()
    sim_k, sim_p = make_sim(10), make_sim(10, plain=True)
    sim_k.run()
    sim_p.run()
    torch.cuda.synchronize()
    if sim_k.step != 10 or sim_p.step != 10:
        raise SystemExit(f"10-step runs took {sim_k.step}/{sim_p.step} steps")
    r10 = {"q": rows_rel_err(sim_k.q, sim_p.q)}
    for name in ("bflux_accum", "accum_sol", "accum_prim"):
        r10[name] = rows_rel_err(getattr(sim_k, name), getattr(sim_p, name))
    ck, cp = sim_k.prev_max_courant, sim_p.prev_max_courant
    r10["courant"] = abs(ck - cp) / max(abs(cp), 1e-30)
    log(f"  10 steps, kernels vs plain versions (worst row): "
        + ", ".join(f"{k} {v:.3e}" for k, v in r10.items())
        + f"; courant {ck:.9f} vs {cp:.9f}")
    counts = path_operator(sim_p).donor_counts
    if counts:
        log(f"  cells with donor factor s < 1 (plain run, per stage): first "
            f"step {counts[:2]}, all 10 steps {sum(counts)} over "
            f"{len(counts)} stages")
    if not all(v <= 1e-4 for v in r10.values()):
        raise SystemExit(f"10-step {path} run differs from plain: {r10}")
    del sim_k, sim_p

    t0 = time.perf_counter()
    sim = make_sim(steps)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    q0 = sim.get_solution().astype(np.float64)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sim.advance()  # first interval: the kernel libraries load
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
        raise SystemExit(f"{path} took {sim.step} steps, expected {steps}")
    check_launches(path, launches,
                   {k: n * steps for k, n in per_step.items()})
    check(sim, q0)
    rate = n_steady * sim.q.shape[1] / t_steady
    STEADY[path] = (1e3 * t_steady / n_steady, rate)
    log(f"  [{card}] setup {t_setup:.2f} s; first interval {t_first:.3f} s "
        f"({s_first} steps); steady state {t_steady:.3f} s for {n_steady} "
        f"steps = {1e3 * t_steady / n_steady:.4f} ms/step, {rate:.4e} "
        f"cell-updates/s; max Courant {sim.prev_max_courant:.4f}")
    return sim, launches


def unstructured_simulation(steps, dev, mesh, plain=False,
                            config=dam_break_config):
    """The dam break (`config`) on the unstructured path, its kernels
    replaced by their plain versions when `plain`."""
    from rdycore_tpu_torch import Simulation

    sim = Simulation(config(steps), mesh=mesh, device=dev)
    if plain:
        sim.operator = plain_operator(sim.operator)
    return sim


def phase_main(steps, errs, dev, mesh):
    from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain

    log(f"== phase 3: unstructured main path, dam break on {mesh.num_cells:,} "
        "cells, f32")
    card = nvidia_smi_line()
    sim, launches = run_main_path(
        "unstructured main path",
        lambda n, plain=False: unstructured_simulation(n, dev, mesh, plain),
        steps, {"swe_edge_flux": 1, "swe_cell_stage": 1, "courant_argmax": 1},
        lambda sim, q0: check_state_and_budget(sim, q0, mesh.cell_area))

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
    check_one_kernel(lambda: op.courant_max(courant, dt, *run),
                     f"courant_argmax on {courant.numel():,} edge values")

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
    nbytes = kernel_bytes(op, q.numel() * s, s)
    nops = {"swe_edge_flux": OPS_PER_EDGE * op.num_edges,
            "swe_cell_stage": OPS_PER_CELL * op.num_cells,
            "courant_argmax": OPS_PER_VALUE * op.num_edges}
    rows = [kernel_row(card, name, "unstructured", fns, launches[name],
                       max(errs.get(name, 0.0), main_abs[name]),
                       nbytes[name], nops[name], q.dtype)
            for name, fns in calls.items()]
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
    log(f"  [{card}] kernel device time per step {kern_ms:.4f} ms")
    return rows


def plain_raster_operator(op):
    """The raster path's operator with every kernel replaced by its plain
    version (run on the card's tensors); `donor_counts` as for
    `plain_operator`, per second-order step or stage."""
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.kernels.raster_muscl import (
        TILE, donor_factors, raster_muscl_faces_plain,
        raster_muscl_update_plain)
    from rdycore_tpu_torch.ops.kernels.raster_step import (
        RasterStepOut, block_max, swe_raster_step_plain)
    from rdycore_tpu_torch.ops.structured import FusedStructuredOperator

    class PlainFusedStructuredOperator(FusedStructuredOperator):
        donor_counts = []

        def step(self, q, dt, src=None, bc_vals=None, **mode):
            if self.second_order:
                # raster_muscl_step_plain's parts, to count the donors
                fx, fy, own = raster_muscl_faces_plain(
                    self.plan, q, bc_vals, self.limiter, self.strip)
                s = donor_factors(self.plan, q, fx, fy, dt, self.strip)
                self.donor_counts.append(int((s < 1.0).sum()))
                out, prim = raster_muscl_update_plain(
                    self.plan, q, fx, fy, self.dz_dx, self.dz_dy,
                    self.mannings_n, dt, src=src, strip=self.strip, **mode)
                return RasterStepOut(out, prim, block_max(
                    own, self.plan.nx, own.shape[0], TILE))
            return swe_raster_step_plain(
                self.plan, q, self.dz_dx, self.dz_dy, self.mannings_n, dt,
                src=src, bc_vals=bc_vals, num_sediment=self.num_sediment,
                upwind=self.riemann == "upwind_roe", strip=self.strip,
                **mode)

        def courant_max(self, cmax_blocks, dt, run_max, run_idx):
            return courant_argmax_plain(cmax_blocks, dt, run_max, run_idx)

        def boundary_fluxes(self, q, bv_edges):
            flux, _ = swe_edge_flux_plain(self.bnd, q, bv_edges,
                                          self.plan.tiny_h, self.plan.h_anuga)
            return flux[:, :-1]

    return PlainFusedStructuredOperator(**{f.name: getattr(op, f.name)
                                           for f in dataclasses.fields(op)})


def raster_simulation(steps, dev, mesh, scheme="euler", plain=False,
                      config=dam_break_config):
    """The dam break (`config`) with edge_flux_backend: fused_structured."""
    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.ops.structured import make_fused_structured_stepper

    sim = Simulation(config(steps, "fused_structured", scheme),
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
    sim, launches = run_main_path(
        "raster main path",
        lambda n, plain=False: raster_simulation(n, dev, mesh, plain=plain),
        steps, {"swe_edge_flux": 1, "courant_argmax": 1, "swe_raster_step": 1},
        lambda sim, q0: check_state_and_budget(sim, q0, area))
    # phase 8 runs the same steps in row strips and must end here bit for
    # bit
    REFERENCE["raster"] = final_state(sim)

    # ssprk3 (stage mode with qA) and rk4 (rhs mode) at full size
    for scheme, per_step in (("ssprk3", 3), ("rk4", 4)):
        n = 24
        s2 = raster_simulation(n, dev, mesh, scheme)
        q0 = s2.get_solution().astype(np.float64)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        s2.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_launches(f"raster {scheme} run of {n} steps",
                       {k.__name__: k.launches for k in kernels.KERNELS}, {
                           "swe_edge_flux": n, "courant_argmax": n,
                           "swe_raster_step": per_step * n})
        check_state_and_budget(s2, q0, area)
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
    check_one_kernel(lambda: op.courant_max(blocks, dt, *run),
                     f"courant_argmax on {blocks.numel():,} block maxima")
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
        "swe_raster_step": raster_step_bytes(C, 3, blocks.numel(), s),
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
    rows = [kernel_row(card, name, "raster", fns, launches[name],
                       main_abs[name], nbytes[name], nops[name], q.dtype,
                       replaces)
            for name, fns in calls.items()]
    log(f"  [{card}] swe_raster_step in rhs mode: device "
        f"{device_ms(lambda: op.step(q, dt, **modes['rhs'])):.4f} ms/call; "
        "no single PyTorch call computes it")
    return rows


# ------------------------------------------------------------------ phase 5
def tracer_rows(q, bv, ext, rng):
    """q, bv and ext of random_state with NT tracer rows: masses h*c in q,
    Dirichlet masses in bv, small external sources in ext."""
    def add(x, rows):
        return torch.cat([x, torch.as_tensor(rows, dtype=x.dtype,
                                             device=x.device)])

    C, Eb = q.shape[1], bv.shape[1]
    h, hb = q[0].cpu().numpy(), bv[0].cpu().numpy()
    return (add(q, h * rng.uniform(0.0, 0.5, (NT, C))),
            add(bv, hb * rng.uniform(0.0, 0.2, (NT, Eb))),
            add(ext, rng.normal(0.0, 1e-4, (NT, C))))


def phase_tracer_kernels(seed, errs, dev):
    """K1a, K1b and K2 at NT = 3 against their plain versions at 256x176,
    Roe and upwind-Roe, every BC code."""
    from rdycore_tpu_torch.mesh import structured_quad, structured_tri
    from rdycore_tpu_torch.operator import build_operator
    from rdycore_tpu_torch.ops.kernels.cell_stage import (
        swe_cell_stage, swe_cell_stage_plain)
    from rdycore_tpu_torch.ops.kernels.edge_flux import (
        swe_edge_flux, swe_edge_flux_plain)
    from rdycore_tpu_torch.ops.kernels.raster_step import (
        StructuredPlan, swe_raster_step, swe_raster_step_plain)
    from rdycore_tpu_torch.ops.structured import FUSED_STAGES
    from rdycore_tpu_torch.timestepping import _FUSED_STEP_STAGES

    log(f"== phase 5a: the NT = {NT} kernels ({NUM_SEDIMENT} sediment "
        "classes and salinity) against their plain versions")
    rng = np.random.default_rng(seed + 5)
    meshes = {
        "quad 256x176": structured_quad(256, 176, 0.0, 0.512, 0.0, 0.352),
        "tri 128x88": structured_tri(128, 88, 0.0, 0.512, 0.0, 0.352),
    }
    bc = {"left": 0, "right": 2, "top": 1, "bottom": 0}  # all three codes
    failures = []

    def check(kernel, what, got, want, dtype):
        r, a = rel_err(got, want), abs_err(got, want)
        key = f"{kernel} nt{NT}"
        errs[key] = max(errs.get(key, 0.0), a)
        ok = r <= TOL[dtype] and got.shape == want.shape
        log(f"  {kernel:15s} {what:56s} rel {r:.3e} abs {a:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{kernel} {what}")

    for mname, mesh in meshes.items():
        for dtype in (torch.float32, torch.float64):
            for riemann in ("roe", "upwind_roe"):
                tag = f"{mname} {str(dtype)[6:]} {riemann}"
                upwind = riemann == "upwind_roe"
                op = build_operator(
                    mesh, bc_types=bc,
                    mannings_n=rng.uniform(0.01, 0.05, mesh.num_cells),
                    num_tracers=NT, num_sediment=NUM_SEDIMENT,
                    riemann=riemann, dtype=dtype, device=dev)
                a = op.arrays
                q, bv, ext = tracer_rows(*random_state(op, rng, dtype, dev),
                                         rng)
                qA, _, _ = tracer_rows(*random_state(op, rng, dtype, dev),
                                       rng)
                fk, ck = swe_edge_flux(a, q, bv, op.tiny_h, op.h_anuga,
                                       upwind)
                fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h,
                                             op.h_anuga, upwind)
                check("swe_edge_flux", f"{tag} flux", fk, fp, dtype)
                check("swe_edge_flux", f"{tag} courant", ck, cp, dtype)
                dt = torch.tensor(0.002, dtype=dtype, device=dev)
                for method in (0, 2):
                    kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
                              xq2018_threshold=op.xq2018_threshold,
                              source_method=method,
                              num_sediment=NUM_SEDIMENT)
                    modes = [("rhs", dict(emit_prim=True))] + [
                        (f"stage {i + 1}",
                         dict(stage=st, qA=qA if i else None, emit_prim=True))
                        for i, st in enumerate(_FUSED_STEP_STAGES["ssprk3"])]
                    for mode, extra in modes:
                        got = swe_cell_stage(a, fp, q, dt, ext, **kw, **extra)
                        want = swe_cell_stage_plain(a, fp, q, dt, ext, **kw,
                                                    **extra)
                        for field in ("q_out", "flux_div", "rhs", "prim"):
                            if getattr(want, field) is not None:
                                check("swe_cell_stage",
                                      f"{tag} src{method} {mode} {field}",
                                      getattr(got, field),
                                      getattr(want, field), dtype)
    # K2 at NT = 3 on a 256x176 raster, f32, the rain plane on
    nx, ny = 256, 176
    f32 = torch.float32

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=f32, device=dev)

    h = rng.uniform(0.05, 1.0, nx * ny)
    h = np.where(rng.uniform(size=h.size) < 0.25, rng.uniform(0, 5e-8, h.size),
                 h)
    h = np.where(rng.uniform(size=h.size) < 0.1, 0.0, h)
    q = t(np.concatenate([[h, h * rng.normal(0, 0.4, h.size),
                           h * rng.normal(0, 0.4, h.size)],
                          h * rng.uniform(0.0, 0.5, (NT, h.size))]))
    qA = q.flip(1).contiguous()
    geo = [t(rng.normal(0, 0.01, (ny, nx))), t(rng.normal(0, 0.01, (ny, nx))),
           t(rng.uniform(0.01, 0.05, (ny, nx)))]
    plan = StructuredPlan(nx, ny, 0.002, 0.002, 1e-7, 0.0, bc_left=0,
                          bc_right=2, bc_bottom=2, bc_top=1)
    hl = rng.uniform(0.1, 0.6, ny)
    bc_vals = {"left": t(np.concatenate([
        [hl, rng.normal(0, 0.1, ny), rng.normal(0, 0.1, ny)],
        hl * rng.uniform(0.0, 0.2, (NT, ny))]))}
    src = t(rng.uniform(0.0, 1e-2, (ny, nx)))
    dt = torch.tensor(0.002, dtype=f32, device=dev)
    modes = [("rhs", dict(emit_prim=True))] + [
        (f"stage {i + 1}", dict(stage=st, qA=qA if i else None,
                                emit_prim=True))
        for i, st in enumerate(FUSED_STAGES["ssprk3"])]
    for upwind in (False, True):
        for mode, extra in modes:
            tag = (f"raster 256x176 f32 {'upwind_roe' if upwind else 'roe'} "
                   f"{mode}")
            kw = dict(src=src, bc_vals=bc_vals, num_sediment=NUM_SEDIMENT,
                      upwind=upwind, **extra)
            got = swe_raster_step(plan, q, *geo, dt, **kw)
            want = swe_raster_step_plain(plan, q, *geo, dt, **kw)
            for field in ("out", "prim", "cmax"):
                check("swe_raster_step", f"{tag} {field}",
                      getattr(got, field), getattr(want, field), f32)
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"tracer kernel checks failed: {failures}")


def tracer_simulation(steps, backend, dev, mesh, plain=False):
    """The sediment and salinity dam break on `backend`, its kernels
    replaced by their plain versions when `plain`."""
    if backend == "fused_structured":
        return raster_simulation(steps, dev, mesh, plain=plain,
                                 config=tracer_dam_break_config)
    return unstructured_simulation(steps, dev, mesh, plain,
                                   tracer_dam_break_config)


def phase_tracers(steps, errs, dev, mesh):
    """Both main paths with NT = 3 at full size (`run_main_path`), with the
    sediment moved, the volume and (unstructured) the salinity budget
    checked, and each NT = 3 kernel timed at the path's shapes."""
    from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.kernels.raster_step import swe_raster_step_plain

    card = nvidia_smi_line()
    area = mesh.cell_area
    rows = []
    for path, backend in (("unstructured", "xla"),
                          ("raster", "fused_structured")):
        log(f"== phase 5: {path} main path with {NUM_SEDIMENT} sediment "
            f"classes and salinity (ndof {3 + NT}), {mesh.num_cells:,} "
            "cells, f32")
        raster = backend == "fused_structured"

        def check(sim, q0):
            if sim.ndof != 3 + NT:
                raise SystemExit(f"tracer run has ndof {sim.ndof}")
            check_state_and_budget(sim, q0, area)
            q1 = sim.get_solution().astype(np.float64)
            moved = np.abs(q1[3:3 + NUM_SEDIMENT]
                           - q0[3:3 + NUM_SEDIMENT]).max()
            log(f"  sediment moved by up to {moved:.3e} (mass h*c)")
            if not moved > 0.0:
                raise SystemExit("the sediment rows did not move")
            if raster:
                return
            # salinity is passive: mass lost = accumulated outflow
            m0 = float(np.sum(q0[3 + NUM_SEDIMENT] * area))
            m1 = float(np.sum(q1[3 + NUM_SEDIMENT] * area))
            lens = sim.operator.arrays.bnd_len.cpu().numpy().astype(
                np.float64)
            out = float(np.sum(sim.bflux_accum[3 + NUM_SEDIMENT] * lens))
            budget = abs((m0 - m1) - out) / m0
            log(f"  salinity mass: initial {m0:.9e}, final {m1:.9e}, lost "
                f"{m0 - m1:.6e}, outflow {out:.6e}, budget error "
                f"{budget:.3e} of the initial mass")
            if not (budget <= 1e-4 and out > 0.0):
                raise SystemExit(f"salinity budget error {budget}, "
                                 f"outflow {out}")

        sim, launches = run_main_path(
            f"{path} main path with tracers",
            lambda n, plain=False: tracer_simulation(n, backend, dev, mesh,
                                                     plain),
            steps, {"swe_edge_flux": 1, "courant_argmax": 1,
                    "swe_raster_step" if raster else "swe_cell_stage": 1},
            check)

        # the NT = 3 kernels at the path's shapes: held against their plain
        # versions, then timed beside them and their bounds
        q, bv = sim.q, sim.boundary_values
        s = q.element_size()
        dt = torch.tensor(DT, dtype=q.dtype, device=dev)
        stage = dict(stage=(0.0, 1.0, 1.0), emit_prim=True)
        if raster:
            op = sim._structured["op"]
            C = q.shape[1]
            got = op.step(q, dt, **stage)
            want = swe_raster_step_plain(
                op.plan, q, op.dz_dx, op.dz_dy, op.mannings_n, dt,
                num_sediment=op.num_sediment, **stage)
            r = max(rel_err(g, w) for g, w in zip(got, want))
            err = {"swe_raster_step": max(abs_err(g, w)
                                          for g, w in zip(got, want))}
            calls = {"swe_raster_step": (
                lambda: op.step(q, dt, **stage),
                lambda: swe_raster_step_plain(
                    op.plan, q, op.dz_dx, op.dz_dy, op.mannings_n, dt,
                    num_sediment=op.num_sediment, **stage), None)}
            nbytes = {"swe_raster_step": raster_step_bytes(
                C, 3 + NT, got.cmax.numel(), s)}
            nops = {"swe_raster_step": (OPS_PER_RASTER_CELL + NT *
                                        OPS_PER_TRACER["swe_raster_step"]) * C}
        else:
            op = sim.operator
            a = op.arrays
            kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
                      xq2018_threshold=op.xq2018_threshold,
                      source_method=op.source_method,
                      num_sediment=op.num_sediment)
            flux, courant = op.edge_flux(q, bv)
            fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga)
            ok_ = op.cell_stage(flux, q, dt, None, **stage)
            op_ = swe_cell_stage_plain(a, flux, q, dt, None, **kw, **stage)
            r = max(rel_err(flux, fp), rel_err(courant, cp),
                    rel_err(ok_.q_out, op_.q_out), rel_err(ok_.prim, op_.prim))
            err = {"swe_edge_flux": max(abs_err(flux, fp),
                                        abs_err(courant, cp)),
                   "swe_cell_stage": max(abs_err(ok_.q_out, op_.q_out),
                                         abs_err(ok_.prim, op_.prim))}
            calls = {
                "swe_edge_flux": (
                    lambda: op.edge_flux(q, bv),
                    lambda: swe_edge_flux_plain(a, q, bv, op.tiny_h,
                                                op.h_anuga), None),
                "swe_cell_stage": (
                    lambda: op.cell_stage(flux, q, dt, None, **stage),
                    lambda: swe_cell_stage_plain(a, flux, q, dt, None, **kw,
                                                 **stage), None)}
            nbytes = kernel_bytes(op, q.numel() * s, s)
            nops = {name: (base + NT * OPS_PER_TRACER[name]) * n
                    for name, base, n in (
                        ("swe_edge_flux", OPS_PER_EDGE, op.num_edges),
                        ("swe_cell_stage", OPS_PER_CELL, op.num_cells))}
        log(f"  full-size NT = {NT} kernels vs plain on the {path} path: "
            f"rel {r:.3e}")
        if not r <= TOL[q.dtype]:
            raise SystemExit(f"full-size {path} tracer kernel check failed")
        rows += [kernel_row(card, name, f"{path}+tracers", fns,
                            launches[name],
                            max(errs.get(f"{name} nt{NT}", 0.0), err[name]),
                            nbytes[name], nops[name], q.dtype, nt=NT)
                 for name, fns in calls.items()]
        # rhs mode (rk4): K2, or K1b and SWEOperator.apply (K1a + K1c +
        # K1b rhs), at NT = 3
        if raster:
            def rhs_plain():
                return swe_raster_step_plain(
                    op.plan, q, op.dz_dx, op.dz_dy, op.mannings_n, dt,
                    num_sediment=op.num_sediment, emit_prim=True)

            log(f"  [{card}] swe_raster_step at NT = {NT} in rhs mode: device "
                f"{device_ms(lambda: op.step(q, dt, emit_prim=True)):.4f} "
                f"ms/call, plain {device_ms(rhs_plain, reps=5):.4f} ms, bound "
                f"{rows[-1]['bound_ms']:.4f} ms")
        else:
            pop = plain_operator(op)
            rhs_ms = device_ms(lambda: op.cell_stage(flux, q, dt, None,
                                                     emit_prim=True))
            rhs_plain = device_ms(lambda: pop.cell_stage(
                flux, q, dt, None, emit_prim=True), reps=5)
            rhs_bound = 1e3 * kernel_bytes(op, q.numel() * s, s, rhs=True)[
                "swe_cell_stage"] / HBM_BYTES_PER_S
            apply_ms = device_ms(lambda: op.apply(q, dt, bv, None))
            apply_plain = device_ms(lambda: pop.apply(q, dt, bv, None),
                                    reps=5)
            apply_bound = (rows[-2]["bound_ms"] + rhs_bound + 1e3 *
                           courant_bytes(op.num_edges, s) / HBM_BYTES_PER_S)
            log(f"  [{card}] swe_cell_stage at NT = {NT} in rhs mode: device "
                f"{rhs_ms:.4f} ms/call, plain {rhs_plain:.4f} ms, bound "
                f"{rhs_bound:.4f} ms; SWEOperator.apply at NT = {NT} (K1a + "
                f"K1c + K1b rhs): device {apply_ms:.4f} ms, plain "
                f"{apply_plain:.4f} ms, sum of its kernels' bounds "
                f"{apply_bound:.4f} ms")
        del sim
    return rows


# ------------------------------------------------------------------ phase 6
def muscl_bytes(op, q_bytes, s):
    """Bytes the second-order unstructured kernels must move at the
    operator's shapes (flow only): each input read once, each output
    written once."""
    C, Ei, Eb = op.num_cells, op.num_internal_edges, op.num_boundary_edges
    E, K = Ei + Eb, op.arrays.cell_edges.shape[1]
    return {
        # q, cell_edges, the two coefficient planes, both cell ids of each
        # interior edge; grad out
        "swe_muscl_grad": q_bytes + C * K * (4 + 2 * s) + 8 * Ei + 6 * C * s,
        # K1a's, plus the gradients and four offsets per interior edge
        "swe_edge_flux": edge_flux_bytes(Ei, Eb, q_bytes, s) + 6 * C * s
        + 4 * Ei * s,
        # the h-flux row, cell_edges, coefficients, h and dt; s out
        "swe_positivity_drain": (E + 1) * s + C * K * (4 + s) + 2 * C * s + s,
        # three flux rows read and written, the donor ids, the factors
        "swe_positivity_scale": 6 * E * s + 8 * Ei + 4 * Eb + C * s,
    }


def raster_muscl_bytes(nx, ny, tiles, s, strip=None, qA=False):
    """Bytes K2 MUSCL must move over ny owned rows in an euler stage with
    the primitives (qA: the stage that also reads qA): K2's, reading q,
    the three geometry planes and dt and writing out, prim and the tile
    maxima; on a strip, also the halo rows of q."""
    halo = 0 if strip is None else strip.halo_lo + strip.halo_hi
    C = nx * ny
    return s * (3 * (ny + halo) * nx + 3 * C + 1 + 6 * C + tiles
                + (3 * C if qA else 0))


def phase_muscl_kernels(seed, errs, dev):
    """K3a, K1a in MUSCL mode (each limiter), K3b drain and scale (a state
    where some donor factor is below 1) on quad and triangle meshes in f32
    and f64, and K2 MUSCL (each limiter; each ssprk3 stage and rhs mode,
    rain off and on) on a raster, against their plain versions at
    256x176. The random wet/dry state has layers thinner than tiny_h, and
    a MUSCL face between such a cell and a wet one can be thin with a
    momentum that is not: with h_anuga = 0 its u = hu/h, and with it the
    flux and Courant coefficient, changes by orders of magnitude with the
    last bit of h (FMA contraction on the card, none in PyTorch), so these
    checks take h_anuga = 1e-3, which bounds u."""
    from rdycore_tpu_torch.mesh import structured_quad, structured_tri
    from rdycore_tpu_torch.operator import build_operator
    from rdycore_tpu_torch.ops.kernels import muscl as mk
    from rdycore_tpu_torch.ops.kernels import raster_muscl as rm
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax
    from rdycore_tpu_torch.ops.kernels.edge_flux import (
        swe_edge_flux, swe_edge_flux_plain)
    from rdycore_tpu_torch.ops.kernels.raster_step import StructuredPlan
    from rdycore_tpu_torch.ops.structured import FUSED_STAGES
    from rdycore_tpu_torch.ops.swe.muscl import ls_gradients

    log("== phase 6a: the second-order kernels against their plain "
        "versions")
    rng = np.random.default_rng(seed + 6)
    meshes = {
        "quad 256x176": structured_quad(256, 176, 0.0, 0.512, 0.0, 0.352),
        "tri 128x88": structured_tri(128, 88, 0.0, 0.512, 0.0, 0.352),
    }
    bc = {"left": 0, "right": 2, "top": 1, "bottom": 0}  # all three codes
    failures = []

    def check(kernel, what, got, want, dtype, key=None):
        r, a = rel_err(got, want), abs_err(got, want)
        key = key or kernel
        errs[key] = max(errs.get(key, 0.0), a)
        ok = r <= TOL[dtype] and got.shape == want.shape
        log(f"  {kernel:23s} {what:48s} rel {r:.3e} abs {a:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{kernel} {what}")

    for mname, mesh in meshes.items():
        for dtype in (torch.float32, torch.float64):
            tag = f"{mname} {str(dtype)[6:]}"
            op = build_operator(
                mesh, bc_types=bc,
                mannings_n=rng.uniform(0.01, 0.05, mesh.num_cells),
                h_anuga=1e-3, second_order=True, dtype=dtype, device=dev)
            a = op.arrays
            q, bv, _ = random_state(op, rng, dtype, dev)
            gp = ls_gradients(a, q)
            check("swe_muscl_grad", f"{tag} grad", mk.swe_muscl_grad(a, q),
                  gp, dtype)
            for lim in LIMITERS:
                fk, ck = swe_edge_flux(a, q, bv, op.tiny_h, op.h_anuga,
                                       grad=gp, limiter=lim)
                fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga,
                                             grad=gp, limiter=lim)
                for what, g, w in (("flux", fk, fp), ("courant", ck, cp)):
                    check("swe_edge_flux", f"{tag} muscl {lim} {what}", g, w,
                          dtype, "swe_edge_flux muscl")
            # K3b on the plain minmod flux: a fifth of the cells start dry
            fp, _ = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga,
                                        grad=gp, limiter="minmod")
            for dt_s in (0.002, 0.0):
                dt = torch.tensor(dt_s, dtype=dtype, device=dev)
                sk = mk.swe_positivity_drain(a, fp, q[0], dt)
                sp = mk.positivity_drain_plain(a, fp, q[0], dt)
                check("swe_positivity_drain", f"{tag} dt {dt_s} s", sk, sp,
                      dtype)
                n_lim = int((sp < 1.0).sum())
                log(f"    cells with s < 1: {n_lim} of {op.num_cells}")
                if not (n_lim > 0 and bool(torch.isfinite(sk).all())):
                    failures.append(f"swe_positivity_drain {tag} limiter "
                                    "idle or not finite")
                check("swe_positivity_scale", f"{tag} dt {dt_s} flux",
                      mk.swe_positivity_scale(a, fp.clone(), sp),
                      mk.positivity_scale_plain(a, fp.clone(), sp), dtype)
    # K2 MUSCL on a 256x176 raster, f32
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
    plan = StructuredPlan(nx, ny, 0.002, 0.002, 1e-7, 1e-3, bc_left=0,
                          bc_right=2, bc_bottom=2, bc_top=1)
    bc_vals = {"left": t([rng.uniform(0.1, 0.6, ny), rng.normal(0, 0.1, ny),
                          rng.normal(0, 0.1, ny)])}
    dt = torch.tensor(0.002, dtype=f32, device=dev)
    modes = [("rhs", dict(emit_prim=True))] + [
        (f"stage {i + 1}", dict(stage=st, qA=qA if i else None,
                                emit_prim=True))
        for i, st in enumerate(FUSED_STAGES["ssprk3"])
    ]
    fx, fy, _ = rm.raster_muscl_faces_plain(plan, q, bc_vals, "minmod")
    n_lim = int((rm.donor_factors(plan, q, fx, fy, dt) < 1.0).sum())
    log(f"    raster cells with s < 1: {n_lim} of {nx * ny}")
    if not n_lim > 0:
        failures.append("swe_raster_muscl_step limiter idle")
    for lim in LIMITERS:
        for rain in (False, True):
            src = t(rng.uniform(0.0, 1e-2, (ny, nx))) if rain else None
            for mode, extra in modes:
                tag = f"raster {lim} rain {'on' if rain else 'off'} {mode}"
                got = rm.swe_raster_muscl_step(plan, q, *geo, dt, bc_vals,
                                               lim, src=src, **extra)
                want = rm.raster_muscl_step_plain(plan, q, *geo, dt,
                                                  bc_vals, lim, src=src,
                                                  **extra)
                for field, g, w in zip(("out", "prim", "cmax"), got, want):
                    check("swe_raster_muscl_step", f"{tag} {field}", g, w,
                          f32)
        run = (torch.zeros((), dtype=f32, device=dev),
               torch.zeros((), dtype=torch.int32, device=dev))
        courant_argmax(got.cmax, dt, *run)
        check("swe_raster_muscl_step", f"raster 256x176 {lim} courant fold",
              run[0], want.cmax.max() * dt, f32)
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"second-order kernel checks failed: {failures}")


def muscl_dam_break_config(steps, backend="xla", scheme="ssprk2"):
    """The dam break at second order (minmod) with the positivity limiter
    and a DRY floodplain, ssprk2, dt = DT_MUSCL (Courant number about
    0.4)."""
    from rdycore_tpu_torch.config.yaml_input import config_from_dict

    d = dam_break_dict(steps, backend, scheme)
    d["numerics"].update(second_order=True, limiter="minmod")
    d["time"].update(time_step=DT_MUSCL, stop=steps * DT_MUSCL)
    d["flow_conditions"][1]["height"] = 0.0
    return config_from_dict(d).validate()


def muscl_simulation(steps, backend, dev, mesh, plain=False):
    """The second-order dam break on `backend`, its kernels replaced by
    their plain versions when `plain`."""
    if backend == "fused_structured":
        return raster_simulation(steps, dev, mesh, "ssprk2", plain,
                                 muscl_dam_break_config)
    return unstructured_simulation(steps, dev, mesh, plain,
                                   muscl_dam_break_config)


def phase_muscl(steps, errs, dev, mesh):
    """Both main paths at second order at full size (`run_main_path`, with
    the state and the volume kept), and each kernel of the path held
    against its plain version and timed at the path's shapes."""
    from rdycore_tpu_torch.ops.kernels import muscl as mk
    from rdycore_tpu_torch.ops.kernels import raster_muscl as rm
    from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.swe.muscl import ls_gradients

    card = nvidia_smi_line()
    area = mesh.cell_area
    rows = []

    def check(sim, q0):
        """h finite and >= -1e-7, the volume kept to 1e-4 (the front does
        not reach the outflow wall)."""
        hq = sim.get_height()
        v0 = float(np.sum(q0[0] * area))
        v1 = float(np.sum(hq.astype(np.float64) * area))
        lens = sim.operator.arrays.bnd_len.cpu().numpy().astype(np.float64)
        outflow = float(np.sum(sim.bflux_accum[0] * lens))
        kept = abs(v1 - v0) / v0
        finite = bool(np.isfinite(sim.get_solution()).all())
        log(f"  state: finite {finite}, min h {hq.min():.3e}; volume initial "
            f"{v0:.9e} m^3, final {v1:.9e}, change {kept:.3e} of the initial "
            f"volume, outflow {outflow:.3e}")
        if not (finite and hq.min() >= -1e-7 and kept <= 1e-4):
            raise SystemExit("second-order state or volume failed")

    for path, backend in (("unstructured", "xla"),
                          ("raster", "fused_structured")):
        raster = backend == "fused_structured"
        log(f"== phase 6: {path} main path at second order (MUSCL minmod, "
            f"positivity limiter, ssprk2, dt {DT_MUSCL} s, dry floodplain), "
            f"{mesh.num_cells:,} cells, f32")
        if raster:  # two launches a step; K1a for the accumulator
            per_step = {"swe_raster_muscl_step": 2, "courant_argmax": 1,
                        "swe_edge_flux": 1}
        else:  # two stages of K3a, K1a, K3b drain and scale, K1b
            per_step = {k: 2 for k in (
                "swe_muscl_grad", "swe_edge_flux", "swe_positivity_drain",
                "swe_positivity_scale", "swe_cell_stage")}
            per_step["courant_argmax"] = 1
        sim, launches = run_main_path(
            f"second-order {path} main path",
            lambda n, plain=False: muscl_simulation(n, backend, dev, mesh,
                                                    plain),
            steps, per_step, check)

        # each kernel of the path at its shapes: held against its plain
        # version on the final state, then timed
        q, bv = sim.q, sim.boundary_values
        s = q.element_size()
        dt = torch.tensor(DT_MUSCL, dtype=q.dtype, device=dev)
        # a step 40 times longer, so that the limiter acts at full size
        dt_long = torch.tensor(40 * DT_MUSCL, dtype=q.dtype, device=dev)
        run = (torch.zeros((), dtype=q.dtype, device=dev),
               torch.zeros((), dtype=torch.int32, device=dev))
        stage = dict(stage=(0.0, 1.0, 1.0), emit_prim=True)
        if raster:
            op = sim._structured["op"]
            plan = op.plan
            geo = (op.dz_dx, op.dz_dy, op.mannings_n)
            # K2 MUSCL at dt and at 40 times dt, where the donor factors
            # fall below 1
            got = [op.step(q, t, **stage) for t in (dt, dt_long)]
            want = [rm.raster_muscl_step_plain(plan, q, *geo, t, None,
                                               op.limiter, **stage)
                    for t in (dt, dt_long)]
            mk_, ik = op.courant_max(got[0].cmax, dt, *run)
            mp, ip = courant_argmax_plain(got[0].cmax)
            fbk = op.boundary_fluxes(q, bv)
            fbp = swe_edge_flux_plain(op.bnd, q, bv, plan.tiny_h,
                                      plan.h_anuga)[0][:, :-1]
            pairs = {
                "swe_raster_muscl_step": [
                    gw for g, w in zip(got, want) for gw in zip(g, w)],
                "swe_edge_flux": [(fbk[k], fbp[k]) for k in range(3)],
            }
            fp = rm.raster_muscl_faces_plain(plan, q, None, op.limiter)
            n_lim = int((rm.donor_factors(plan, q, *fp[:2], dt_long)
                         < 1.0).sum())
            blocks = got[0].cmax
            calls = {
                "swe_raster_muscl_step": (
                    lambda: op.step(q, dt, **stage),
                    lambda: rm.raster_muscl_step_plain(
                        plan, q, *geo, dt, None, op.limiter, **stage),
                    None),
                "courant_argmax": (
                    lambda: op.courant_max(blocks, dt, *run),
                    lambda: courant_argmax_plain(blocks, dt, *run),
                    lambda: torch.max(blocks, 0)),
                "swe_edge_flux": (
                    lambda: op.boundary_fluxes(q, bv),
                    lambda: swe_edge_flux_plain(op.bnd, q, bv, op.plan.tiny_h,
                                                op.plan.h_anuga),
                    None),
            }
            Eb = op.bnd.bnd_left.shape[0]
            nbytes = {"swe_raster_muscl_step": raster_muscl_bytes(
                plan.nx, plan.ny, blocks.numel(), s)}
            nbytes["courant_argmax"] = courant_bytes(blocks.numel(), s)
            nbytes["swe_edge_flux"] = edge_flux_bytes(
                0, Eb, 3 * s * int(torch.unique(op.bnd.bnd_left).numel()), s)
            C = q.shape[1]
            nops = {"swe_raster_muscl_step": OPS_PER_MUSCL_RASTER_CELL * C,
                    "courant_argmax": OPS_PER_VALUE * blocks.numel(),
                    "swe_edge_flux": OPS_PER_EDGE * Eb}
            replaces = dict(
                REPLACES, courant_argmax=REPLACES["swe_raster_muscl_step"],
                swe_edge_flux=_SLOTTED + ":1254")
        else:
            op = sim.operator
            a = op.arrays
            kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
                      xq2018_threshold=op.xq2018_threshold,
                      source_method=op.source_method)
            gk = op.muscl_grad(q)
            gp = ls_gradients(a, q)
            flux, courant = op.edge_flux(q, bv, gp)
            fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga,
                                         grad=gp, limiter=op.limiter)
            # K3b at dt and at 40 times dt, where the donor factors fall
            # below 1: drain on the same flux, scale on the same factors
            sk = mk.swe_positivity_drain(a, fp, q[0], dt)
            drain, scale = [], []
            for t in (dt, dt_long):
                s_p = mk.positivity_drain_plain(a, fp, q[0], t)
                drain.append((mk.swe_positivity_drain(a, fp, q[0], t), s_p))
                scale.append((mk.swe_positivity_scale(a, fp.clone(), s_p),
                              mk.positivity_scale_plain(a, fp.clone(), s_p)))
            n_lim = int((drain[1][1] < 1.0).sum())
            ok_ = op.cell_stage(fp, q, dt, None, **stage)
            op_ = swe_cell_stage_plain(a, fp, q, dt, None, **kw, **stage)
            mk_, ik = op.courant_max(cp, dt, *run)
            mp, ip = courant_argmax_plain(cp)
            pairs = {
                "swe_muscl_grad": [(gk, gp)],
                "swe_edge_flux": [(flux, fp), (courant, cp)],
                "swe_positivity_drain": drain,
                "swe_positivity_scale": scale,
                "swe_cell_stage": [(ok_.q_out, op_.q_out),
                                   (ok_.prim, op_.prim)],
            }
            calls = {
                "swe_muscl_grad": (lambda: op.muscl_grad(q),
                                   lambda: ls_gradients(a, q), None),
                "swe_edge_flux": (
                    lambda: op.edge_flux(q, bv, gk),
                    lambda: swe_edge_flux_plain(a, q, bv, op.tiny_h,
                                                op.h_anuga, grad=gk,
                                                limiter=op.limiter),
                    None),
                "swe_positivity_drain": (
                    lambda: mk.swe_positivity_drain(a, flux, q[0], dt),
                    lambda: mk.positivity_drain_plain(a, flux, q[0], dt),
                    None),
                "swe_positivity_scale": (
                    lambda: mk.swe_positivity_scale(a, flux, sk),
                    lambda: mk.positivity_scale_plain(a, flux, sk),
                    None),
                "swe_cell_stage": (
                    lambda: op.cell_stage(flux, q, dt, None, **stage),
                    lambda: swe_cell_stage_plain(a, flux, q, dt, None, **kw,
                                                 **stage),
                    None),
                "courant_argmax": (
                    lambda: op.courant_max(courant, dt, *run),
                    lambda: courant_argmax_plain(courant, dt, *run),
                    lambda: torch.max(courant, 0)),
            }
            nbytes = muscl_bytes(op, q.numel() * s, s)
            base = kernel_bytes(op, q.numel() * s, s)
            nbytes["swe_cell_stage"] = base["swe_cell_stage"]
            nbytes["courant_argmax"] = base["courant_argmax"]
            C, E, Ei = op.num_cells, op.num_edges, op.num_internal_edges
            nops = {"swe_muscl_grad": OPS_PER_GRAD_CELL * C,
                    "swe_edge_flux": OPS_PER_EDGE * (E - Ei)
                    + OPS_PER_MUSCL_EDGE * Ei,
                    "swe_positivity_drain": OPS_PER_DRAIN_CELL * C,
                    "swe_positivity_scale": OPS_PER_SCALE_EDGE * E,
                    "swe_cell_stage": OPS_PER_CELL * C,
                    "courant_argmax": OPS_PER_VALUE * E}
            replaces = dict(REPLACES, swe_edge_flux=_SLOTTED + ":3180",
                            swe_cell_stage=_SLOTTED + ":1441")
        rel = {k: max(rel_err(g, w) for g, w in v) for k, v in pairs.items()}
        err = {k: max(abs_err(g, w) for g, w in v) for k, v in pairs.items()}
        rel["courant_argmax"] = abs(float(mk_) - float(mp)) / float(mp)
        err["courant_argmax"] = abs(float(mk_) - float(mp))
        log(f"  full-size kernels vs plain on the second-order {path} path "
            f"(relative): {rel}; courant idx {int(ik)} (plain {int(ip)}); "
            f"cells with s < 1 at dt x40: {n_lim}")
        if not (all(v <= TOL[q.dtype] for v in rel.values()) and n_lim > 0
                and int(ik) == int(ip)):
            raise SystemExit(f"full-size second-order {path} kernel check "
                             "failed")
        for name, fns in calls.items():
            # phase 6a's errors of the same kernel in the same mode count
            key = ("swe_edge_flux muscl"
                   if name == "swe_edge_flux" and not raster else name)
            rows.append(kernel_row(
                card, name, f"{path}+muscl", fns, launches[name],
                max(err[name], errs.get(key, 0.0)), nbytes[name],
                nops[name], q.dtype, replaces))
        del sim
    return rows


# ------------------------------------------------------------------ phase 7
def wb_bed(x, y):
    """The bumpy bed of phase 7 at the vertices: 0 to 0.07 m, bumps 0.25 m
    across."""
    return 0.035 * (1.0 + np.sin(4 * np.pi * x) * np.sin(4 * np.pi * y))


def eta_pairs(bs):
    """The (vertex, cell) pairs K5 gathers: the non-padding entries of
    vertex_cells."""
    return int((bs.vertex_cells < bs.z1.shape[0]).sum())


def wb_bytes(op, q_bytes, s):
    """Bytes the well-balanced kernels must move at the operator's shapes
    (each input read once, each output written once): K1a's plus the cell
    beds (HR) or the endpoint ids and beds and the vertex eta (BS2002);
    K1b's in stage mode less the bed slopes plus the interior edges' ids
    and normals, the boundary normals and the cell beds (HR); K5's ids,
    counts, sorted beds, depths and output."""
    C, Ei, Eb = op.num_cells, op.num_internal_edges, op.num_boundary_edges
    E = Ei + Eb
    base = kernel_bytes(op, q_bytes, s)
    out = dict(base)
    if op.well_balancing_hr:
        out["swe_edge_flux"] = base["swe_edge_flux"] + C * s
        out["swe_cell_stage"] = (base["swe_cell_stage"] - 2 * C * s
                                 + Ei * (8 + 2 * s) + Eb * 2 * s + C * s)
    if op.well_balancing_bs2002:
        NV, K = op.arrays.bs2002.vertex_cells.shape
        extra = E * (8 + 2 * s) + NV * s
        out["swe_edge_flux"] = base["swe_edge_flux"] + extra
        out["swe_eta_vertex"] = NV * K * 4 + 2 * NV * s + 4 * C * s
        if op.second_order:
            m = muscl_bytes(op, q_bytes, s)
            out.update({k: m[k] for k in m})
            out["swe_edge_flux"] = m["swe_edge_flux"] + extra
    return out


def wb_ops(op, eta_pairs_n=0):
    """Operations of the well-balanced kernels, counted from the CUDA
    sources (see OPS_PER_*)."""
    C, Ei, E = op.num_cells, op.num_internal_edges, op.num_edges
    K = op.arrays.cell_edges.shape[1]
    out = {"swe_edge_flux": OPS_PER_EDGE * E,
           "swe_cell_stage": OPS_PER_CELL * C,
           "courant_argmax": OPS_PER_VALUE * E}
    if op.well_balancing_hr:
        out["swe_edge_flux"] += OPS_PER_HR_EDGE * Ei
        out["swe_cell_stage"] += OPS_PER_HR_SLOT * K * C
    if op.well_balancing_bs2002:
        out["swe_eta_vertex"] = OPS_PER_ETA_PAIR * eta_pairs_n
        out["swe_edge_flux"] += OPS_PER_BS_EDGE * E
        if op.second_order:
            out["swe_edge_flux"] += (OPS_PER_MUSCL_EDGE - OPS_PER_EDGE) * Ei
            out["swe_muscl_grad"] = OPS_PER_GRAD_CELL * C
            out["swe_positivity_drain"] = OPS_PER_DRAIN_CELL * C
            out["swe_positivity_scale"] = OPS_PER_SCALE_EDGE * E
    return out


def phase_wb_kernels(seed, errs, dev):
    """K1a in HR mode (NT = 0 and 3, Roe and upwind-Roe), K1a's BS2002
    correction (first order and each limiter), K1b in HR mode (each ssprk3
    stage and rhs mode, each source method; NT = 0 and 3) and K5 on quad and
    triangle meshes over the bumpy bed of phase 7, in f32 and f64 with
    every BC code, against their plain versions at 256x176. The BS2002
    checks take h_anuga = 1e-3, for the MUSCL faces' sake (phase 6a)."""
    from rdycore_tpu_torch.mesh import structured_quad, structured_tri
    from rdycore_tpu_torch.operator import build_operator
    from rdycore_tpu_torch.ops.kernels.cell_stage import (
        swe_cell_stage, swe_cell_stage_plain)
    from rdycore_tpu_torch.ops.kernels.edge_flux import (
        swe_edge_flux, swe_edge_flux_plain)
    from rdycore_tpu_torch.ops.kernels.eta_vertex import swe_eta_vertex
    from rdycore_tpu_torch.ops.swe.bs2002 import eta_vertices
    from rdycore_tpu_torch.ops.swe.muscl import ls_gradients
    from rdycore_tpu_torch.timestepping import _FUSED_STEP_STAGES

    log("== phase 7a: the well-balancing kernels against their plain "
        "versions")
    rng = np.random.default_rng(seed + 7)
    meshes = {
        "quad 256x176": structured_quad(256, 176, 0.0, 0.512, 0.0, 0.352,
                                        z_fn=wb_bed),
        "tri 128x88": structured_tri(128, 88, 0.0, 0.512, 0.0, 0.352,
                                     z_fn=wb_bed),
    }
    bc = {"left": 0, "right": 2, "top": 1, "bottom": 0}  # all three codes
    failures = []

    def check(kernel, what, got, want, dtype, key):
        r, a = rel_err(got, want), abs_err(got, want)
        errs[key] = max(errs.get(key, 0.0), a)
        ok = r <= TOL[dtype] and got.shape == want.shape
        log(f"  {kernel:15s} {what:52s} rel {r:.3e} abs {a:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{kernel} {what}")

    for mname, mesh in meshes.items():
        for dtype in (torch.float32, torch.float64):
            tag = f"{mname} {str(dtype)[6:]}"
            n = rng.uniform(0.01, 0.05, mesh.num_cells)
            for nt, riemann in ((0, "roe"), (NT, "roe"), (NT, "upwind_roe")):
                op = build_operator(mesh, bc_types=bc, mannings_n=n,
                                    num_tracers=nt,
                                    num_sediment=min(nt, NUM_SEDIMENT),
                                    riemann=riemann, well_balancing_hr=True,
                                    dtype=dtype, device=dev)
                a = op.arrays
                q, bv, ext = random_state(op, rng, dtype, dev)
                if nt:
                    q, bv, ext = tracer_rows(q, bv, ext, rng)
                up = riemann == "upwind_roe"
                t = f"{tag} nt {nt} {riemann}"
                fk, ck = swe_edge_flux(a, q, bv, op.tiny_h, op.h_anuga, up,
                                       hr=True)
                fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga,
                                             up, hr=True)
                check("swe_edge_flux", f"{t} hr flux", fk, fp, dtype,
                      "swe_edge_flux hr")
                check("swe_edge_flux", f"{t} hr courant", ck, cp, dtype,
                      "swe_edge_flux hr")
                if up:
                    continue
                dt = torch.tensor(0.002, dtype=dtype, device=dev)
                qA = random_state(op, rng, dtype, dev)[0]
                if nt:
                    qA = tracer_rows(qA, bv, ext, rng)[0]
                for method in ((0, 1, 2) if nt == 0 else (0, 2)):
                    kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
                              xq2018_threshold=op.xq2018_threshold,
                              source_method=method,
                              num_sediment=op.num_sediment, hr=True)
                    modes = [("rhs", dict(emit_prim=True))] + [
                        (f"stage {i + 1}", dict(stage=s, qA=qA if i else None,
                                                emit_prim=True))
                        for i, s in enumerate(_FUSED_STEP_STAGES["ssprk3"])]
                    for mode, extra in modes:
                        g = swe_cell_stage(a, fp, q, dt, ext, **kw, **extra)
                        w = swe_cell_stage_plain(a, fp, q, dt, ext, **kw,
                                                 **extra)
                        for field in ("q_out", "flux_div", "rhs", "prim"):
                            if getattr(w, field) is not None:
                                check("swe_cell_stage",
                                      f"{t} hr src{method} {mode} {field}",
                                      getattr(g, field), getattr(w, field),
                                      dtype, "swe_cell_stage hr")
            op = build_operator(mesh, bc_types=bc, mannings_n=n,
                                h_anuga=1e-3, second_order=True,
                                well_balancing_bs2002=True, dtype=dtype,
                                device=dev)
            a = op.arrays
            q, bv, _ = random_state(op, rng, dtype, dev)
            ev = eta_vertices(a.bs2002, q[0], op.tiny_h)
            check("swe_eta_vertex", f"{tag} eta_v",
                  swe_eta_vertex(a.bs2002, q[0], op.tiny_h), ev, dtype,
                  "swe_eta_vertex")
            gp = ls_gradients(a, q)
            for lim in (None,) + LIMITERS:
                grad = None if lim is None else gp
                kw = dict(grad=grad, limiter=lim or "minmod", bs=a.bs2002,
                          eta_v=ev)
                fk, ck = swe_edge_flux(a, q, bv, op.tiny_h, op.h_anuga, **kw)
                fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga,
                                             **kw)
                key = "swe_edge_flux bs2002" + (" muscl" if lim else "")
                mode = f"muscl {lim}" if lim else "first order"
                check("swe_edge_flux", f"{tag} bs2002 {mode} flux", fk, fp,
                      dtype, key)
                check("swe_edge_flux", f"{tag} bs2002 {mode} courant", ck,
                      cp, dtype, key)
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"well-balancing kernel checks failed: {failures}")


def wb_mesh():
    """The triangle mesh of phase 7 over the dam break's 4 m x 2.75 m, its
    vertices on the bumpy bed, one region of every cell."""
    from rdycore_tpu_torch.mesh import structured_tri

    t0 = time.perf_counter()
    mesh = structured_tri(WB_NX, WB_NY, 0.0, 2048 * DX, 0.0, 1408 * DX,
                          z_fn=wb_bed)
    mesh.regions["__id_1"] = np.arange(mesh.num_cells, dtype=np.int32)
    log(f"== mesh: structured_tri({WB_NX}, {WB_NY}) over a bumpy bed of "
        f"{mesh.cell_z.min():.4f}-{mesh.cell_z.max():.4f} m (cell beds), "
        f"{mesh.num_cells} cells, {mesh.num_edges} edges, "
        f"{mesh.num_vertices} vertices in {time.perf_counter() - t0:.2f} s")
    return mesh


def wb_config(steps, wb, dt, scheme="euler", second_order=False,
              outflow=True):
    """The phase-7 deck: one region, still water set by `wb_simulation`,
    Manning 0.018, critical outflow on the right (or reflecting walls
    only), reflecting walls elsewhere, boundary-flux accumulators on,
    f32."""
    from rdycore_tpu_torch.config.yaml_input import config_from_dict

    d = dam_break_dict(steps, "xla", scheme)
    d["physics"]["flow"]["well_balancing"] = wb
    d["numerics"].update(second_order=second_order, limiter="minmod")
    d["time"].update(time_step=dt, stop=steps * dt,
                     coupling_interval=WB_INTERVAL_STEPS * dt)
    d["regions"] = [{"name": "domain", "grid_region_id": 1}]
    d["surface_composition"] = [{"region": "domain", "material": "smooth"}]
    d["initial_conditions"] = [{"region": "domain", "flow": "still"}]
    d["flow_conditions"] = [
        {"name": "still", "type": "dirichlet", "height": 0.0,
         "x_momentum": 0, "y_momentum": 0},
        {"name": "outflow", "type": "critical-outflow"}]
    if not outflow:
        d["boundaries"], d["boundary_conditions"] = [], []
    return config_from_dict(d).validate()


def wb_simulation(steps, dev, mesh, eta, plain=False, **deck):
    """A phase-7 deck whose depths are set, as a coupler sets them, to
    max(eta(x) - cell_z, 0); its kernels replaced by their plain versions
    when `plain`."""
    from rdycore_tpu_torch import Simulation

    sim = Simulation(wb_config(steps, **deck), mesh=mesh, device=dev)
    sim.set_height(np.maximum(eta(mesh.cell_centroid[:, 0]) - mesh.cell_z,
                              0.0))
    if plain:
        sim.operator = plain_operator(sim.operator)
    return sim


def dam_eta(floodplain):
    """The dam break's free surface as a function of x: 0.25 m for x < 2 m,
    `floodplain` beyond."""
    return lambda x: np.where(x < 1024 * DX, H_RESERVOIR, floodplain)


def phase_wb(steps, errs, dev, mesh):
    """The well-balanced main paths at full size (`run_main_path`): HR
    euler, BS2002 euler, and BS2002 with MUSCL and the positivity limiter
    under ssprk2; each kernel of the path held against its plain version
    and timed at the path's shapes; then a lake at rest on the same
    mesh."""
    from rdycore_tpu_torch.ops.kernels import muscl as mk
    from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.swe.bs2002 import eta_vertices
    from rdycore_tpu_torch.ops.swe.muscl import ls_gradients

    card = nvidia_smi_line()
    area = mesh.cell_area
    rows = []
    # HR floods a floodplain whose bump tops are dry; BS2002 one whose bumps
    # are submerged: over dry bump tops BS2002 diverges in both packages
    # (ROADMAP fault 19)
    runs = (
        ("unstructured+hr", dict(wb="hydrostatic_reconstruction", dt=DT_WB),
         H_FLOODPLAIN,
         {"swe_edge_flux": 1, "swe_cell_stage": 1, "courant_argmax": 1}),
        ("unstructured+bs2002", dict(wb="bs2002", dt=DT_WB), H_WB_SUBMERGED,
         {"swe_eta_vertex": 1, "swe_edge_flux": 1, "swe_cell_stage": 1,
          "courant_argmax": 1}),
        ("unstructured+bs2002+muscl",
         dict(wb="bs2002", dt=DT_WB, scheme="ssprk2", second_order=True),
         H_WB_SUBMERGED,
         dict({k: 2 for k in ("swe_eta_vertex", "swe_muscl_grad",
                              "swe_edge_flux", "swe_positivity_drain",
                              "swe_positivity_scale", "swe_cell_stage")},
              courant_argmax=1)),
    )
    for path, deck, floodplain, per_step in runs:
        muscl = deck.get("second_order", False)
        log(f"== phase 7: {path} main path, the dam break over a bumpy bed "
            f"({deck['wb']}, {deck.get('scheme', 'euler')}, dt "
            f"{deck['dt']} s, floodplain eta {floodplain} m), "
            f"{mesh.num_cells:,} cells, f32")

        def check(sim, q0, muscl=muscl):
            check_state_and_budget(sim, q0, area, -1e-7 if muscl else 0.0)

        sim, launches = run_main_path(
            path, lambda n, plain=False: wb_simulation(
                n, dev, mesh, dam_eta(floodplain), plain, **deck),
            steps, per_step, check)

        # each kernel of the path at its shapes: held against its plain
        # version on the final state, then timed
        op, q, bv = sim.operator, sim.q, sim.boundary_values
        a, s = op.arrays, q.element_size()
        dt = torch.tensor(deck["dt"], dtype=q.dtype, device=dev)
        run = (torch.zeros((), dtype=q.dtype, device=dev),
               torch.zeros((), dtype=torch.int32, device=dev))
        stage = dict(stage=(0.0, 1.0, 1.0), emit_prim=True)
        kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
                  xq2018_threshold=op.xq2018_threshold,
                  source_method=op.source_method, hr=op.well_balancing_hr)
        wb_kw = dict(hr=op.well_balancing_hr, bs=a.bs2002)
        pairs, calls = {}, {}
        eta_v = grad = None
        if op.well_balancing_bs2002:
            eta_v = op.eta_vertices(q[0])
            ev = eta_vertices(a.bs2002, q[0], op.tiny_h)
            pairs["swe_eta_vertex"] = [(eta_v, ev)]
            calls["swe_eta_vertex"] = (
                lambda: op.eta_vertices(q[0]),
                lambda: eta_vertices(a.bs2002, q[0], op.tiny_h), None)
            wb_kw["eta_v"] = ev
        if muscl:
            grad = op.muscl_grad(q)
            gp = ls_gradients(a, q)
            pairs["swe_muscl_grad"] = [(grad, gp)]
            calls["swe_muscl_grad"] = (lambda: op.muscl_grad(q),
                                       lambda: ls_gradients(a, q), None)
            wb_kw.update(grad=gp, limiter=op.limiter)
        flux, courant = op.edge_flux(q, bv, wb_kw.get("grad"),
                                     wb_kw.get("eta_v"))
        fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga,
                                     **wb_kw)
        pairs["swe_edge_flux"] = [(flux, fp), (courant, cp)]
        calls["swe_edge_flux"] = (
            lambda: op.edge_flux(q, bv, grad, eta_v),
            lambda: swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga,
                                        **dict(wb_kw, eta_v=eta_v,
                                               grad=grad)),
            None)
        if muscl:
            sk = mk.swe_positivity_drain(a, fp, q[0], dt)
            sp = mk.positivity_drain_plain(a, fp, q[0], dt)
            pairs["swe_positivity_drain"] = [(sk, sp)]
            pairs["swe_positivity_scale"] = [(
                mk.swe_positivity_scale(a, fp.clone(), sp),
                mk.positivity_scale_plain(a, fp.clone(), sp))]
            calls["swe_positivity_drain"] = (
                lambda: mk.swe_positivity_drain(a, flux, q[0], dt),
                lambda: mk.positivity_drain_plain(a, flux, q[0], dt), None)
            calls["swe_positivity_scale"] = (
                lambda: mk.swe_positivity_scale(a, flux, sk),
                lambda: mk.positivity_scale_plain(a, flux, sk), None)
        ok_ = op.cell_stage(fp, q, dt, None, **stage)
        op_ = swe_cell_stage_plain(a, fp, q, dt, None, **kw, **stage)
        pairs["swe_cell_stage"] = [(ok_.q_out, op_.q_out),
                                   (ok_.prim, op_.prim)]
        calls["swe_cell_stage"] = (
            lambda: op.cell_stage(flux, q, dt, None, **stage),
            lambda: swe_cell_stage_plain(a, flux, q, dt, None, **kw,
                                         **stage), None)
        mk_, ik = op.courant_max(cp, dt, *run)
        mp, ip = courant_argmax_plain(cp)
        calls["courant_argmax"] = (
            lambda: op.courant_max(courant, dt, *run),
            lambda: courant_argmax_plain(courant, dt, *run),
            lambda: torch.max(courant, 0))
        rel = {k: max(rel_err(g, w) for g, w in v) for k, v in pairs.items()}
        err = {k: max(abs_err(g, w) for g, w in v) for k, v in pairs.items()}
        rel["courant_argmax"] = abs(float(mk_) - float(mp)) / float(mp)
        err["courant_argmax"] = abs(float(mk_) - float(mp))
        log(f"  full-size kernels vs plain on the {path} path (relative): "
            f"{rel}; courant idx {int(ik)} (plain {int(ip)})")
        if not (all(v <= TOL[q.dtype] for v in rel.values())
                and int(ik) == int(ip)):
            raise SystemExit(f"full-size {path} kernel check failed")
        n_pairs = eta_pairs(a.bs2002) if a.bs2002 is not None else 0
        nbytes = wb_bytes(op, q.numel() * s, s)
        nops = wb_ops(op, n_pairs)
        mode = ("hr" if op.well_balancing_hr else
                "bs2002 muscl" if muscl else "bs2002")
        keys = {"swe_edge_flux": f"swe_edge_flux {mode}",
                "swe_cell_stage": ("swe_cell_stage hr"
                                   if op.well_balancing_hr
                                   else "swe_cell_stage")}
        replaces = dict(
            REPLACES, swe_edge_flux=_SLOTTED + (":3180" if muscl else ":1254"),
            swe_cell_stage=_SLOTTED + ":1441")
        path_rows = [kernel_row(
            card, name, path, fns, launches[name],
            max(err[name], errs.get(keys.get(name, name), 0.0)),
            nbytes[name], nops[name], q.dtype, replaces)
            for name, fns in calls.items()]
        rows += path_rows
        # SWEOperator.apply (the rk4 rhs, the TPU's fused rhs kernel with
        # its well-balancing branch): the edge phase, K1c and K1b rhs
        pop = plain_operator(op)
        apply_ms = device_ms(lambda: op.apply(q, dt, bv, None))
        apply_plain = device_ms(lambda: pop.apply(q, dt, bv, None), reps=5)
        log(f"  [{card}] SWEOperator.apply on the {path} path: device "
            f"{apply_ms:.4f} ms, plain {apply_plain:.4f} ms, sum of its "
            f"kernels' stage-mode bounds "
            f"{sum(r['bound_ms'] for r in path_rows):.4f} ms")
        del sim
    lake_at_rest(dev, mesh)
    return rows


def lake_at_rest(dev, mesh):
    """A lake at rest on the phase-7 mesh, all walls reflecting: HR at eta
    0.05 m (partly dry), BS2002 at eta 0.1 m (submerged). The momentum rows
    of `apply` and, after 100 steps, max |hu|, |hv| beside the same state
    under no well-balancing. HR must keep the rows below 1e-4 (the bound
    of the JAX package's f32 test, tests/test_pallas.py:424-441); BS2002
    keeps no lake at rest, in either package (ROADMAP fault 19): its
    numbers are printed beside those of no well-balancing."""
    card = nvidia_smi_line()
    lake_steps = 100
    for wb, level in (("hydrostatic_reconstruction", H_FLOODPLAIN),
                      ("bs2002", H_WB_SUBMERGED)):
        out = {}
        for mode in (wb, "none"):
            sim = wb_simulation(lake_steps, dev, mesh,
                                lambda x: np.full_like(x, level),
                                wb=mode, dt=DT_WB, outflow=False)
            dry = float(np.mean(sim.get_height() == 0.0))
            r = sim.operator.apply(
                sim.q, torch.tensor(DT_WB, dtype=sim.q.dtype, device=dev),
                sim.boundary_values, None)
            rhs = float(r.rhs[1:3].abs().max())
            sim.run()
            torch.cuda.synchronize()
            hu = float(np.abs(sim.get_x_momentum()).max())
            hv = float(np.abs(sim.get_y_momentum()).max())
            out[mode] = (rhs, hu, hv)
            log(f"  [{card}] lake at rest at eta {level} m ({dry:.3f} of "
                f"the cells dry), {mode}: momentum rhs of apply "
                f"{rhs:.4e}; after {sim.step} steps max |hu| {hu:.4e}, "
                f"max |hv| {hv:.4e}")
            del sim
        if wb == "hydrostatic_reconstruction" and not out[wb][0] < 1e-4:
            raise SystemExit(f"HR lake at rest: momentum rhs {out[wb][0]} "
                             ">= 1e-4")
        if not all(np.isfinite(v) for v in out[wb]):
            raise SystemExit(f"{wb} lake at rest is not finite: {out[wb]}")


# ------------------------------------------------------------------ phase 8
def strip_simulation(steps, dev, mesh, scheme="euler", plain=False,
                     config=dam_break_config):
    """`config`'s dam break on fused_structured in STRIPS row strips, all
    on the one card (parallel.n_devices with an explicit device list), its
    kernels replaced by their plain versions when `plain`."""
    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.ops.structured import make_fused_structured_stepper

    cfg = config(steps, "fused_structured", scheme)
    cfg.parallel.n_devices = STRIPS
    sim = Simulation(cfg, mesh=mesh, device=dev,
                     strip_devices=[dev] * STRIPS)
    st = sim._structured
    if not st.get("strips") or len(st["op"]) != STRIPS:
        raise SystemExit("the strip deck did not take the row-strip path")
    if plain:
        st["op"] = [plain_raster_operator(o) for o in st["op"]]
        st["adv"] = make_fused_structured_stepper(
            st["op"], st["scheme"], accumulate=st["accumulate"])
    return sim


def strip_kernel_rows(card, sim, path, launches, dev, dt, nt=0):
    """The kernels of a strip run, each launched on an inner strip (halo
    rows on both sides) of the run's final state, held against its plain
    version there and timed beside its bound: the {"kernels": ...} rows of
    `path`; and the halo exchange of all strips, timed per stage."""
    from rdycore_tpu_torch.ops.kernels import raster_muscl as rm
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.kernels.raster_step import swe_raster_step_plain
    from rdycore_tpu_torch.ops.strips import exchange, split_rows

    f32 = torch.float32
    ops = sim._structured["op"]
    strips = [o.strip for o in ops]
    plan = ops[0].plan
    nx = plan.nx
    bufs = split_rows(sim.q.to(f32), strips, [dev] * STRIPS, nx)
    op, b, st = ops[1], bufs[1], strips[1]
    geo = (op.dz_dx, op.dz_dy, op.mannings_n)
    bv = sim.boundary_values.to(f32)[:, op.bnd_idx]
    dt_t = torch.tensor(dt, dtype=f32, device=dev)
    stage = dict(stage=(0.0, 1.0, 1.0), emit_prim=True)
    sz, C = 4, st.rows * nx
    if op.second_order:
        got = op.step(b, dt_t, **stage)
        want = rm.raster_muscl_step_plain(plan, b, *geo, dt_t, None,
                                          op.limiter, st, **stage)
        pairs = {"swe_raster_muscl_step": [
            (st.owned(got.out), st.owned(want.out)),
            (got.prim, want.prim), (got.cmax, want.cmax)]}
        blocks = got.cmax
        calls = {"swe_raster_muscl_step": (
            lambda: op.step(b, dt_t, **stage),
            lambda: rm.raster_muscl_step_plain(plan, b, *geo, dt_t, None,
                                               op.limiter, st, **stage),
            None)}
        nbytes = {"swe_raster_muscl_step": raster_muscl_bytes(
            nx, st.rows, blocks.numel(), sz, st)}
        nops = {"swe_raster_muscl_step": OPS_PER_MUSCL_RASTER_CELL * C}
        kernel_names = ("swe_raster_muscl_step",)
    else:
        got = op.step(b, dt_t, **stage)
        want = swe_raster_step_plain(plan, b, *geo, dt_t,
                                     num_sediment=op.num_sediment, strip=st,
                                     **stage)
        pairs = {"swe_raster_step": [
            (st.owned(got.out), st.owned(want.out)),
            (got.prim, want.prim), (got.cmax, want.cmax)]}
        blocks = got.cmax
        calls = {"swe_raster_step": (
            lambda: op.step(b, dt_t, **stage),
            lambda: swe_raster_step_plain(
                plan, b, *geo, dt_t, num_sediment=op.num_sediment, strip=st,
                **stage), None)}
        # K2's bytes over the owned rows, and the halo rows it reads
        nbytes = {"swe_raster_step": raster_step_bytes(
            C, 3 + nt, blocks.numel(), sz)
            + sz * (3 + nt) * (st.halo_lo + st.halo_hi) * nx}
        nops = {"swe_raster_step": (
            OPS_PER_RASTER_CELL + nt * OPS_PER_TRACER["swe_raster_step"]) * C}
        kernel_names = ("swe_raster_step",)
    # K1c on the strip's block maxima, K1a on its boundary edges
    run = (torch.zeros((), dtype=f32, device=dev),
           torch.zeros((), dtype=torch.int32, device=dev))
    mk, ik = op.courant_max(blocks, dt_t, *run)
    mp, ip = courant_argmax_plain(blocks)
    th, ta = plan.tiny_h, plan.h_anuga
    fbk = op.boundary_fluxes(b[:3], bv[:3])
    fbp = swe_edge_flux_plain(op.bnd, b[:3], bv[:3], th, ta)[0][:, :-1]
    pairs["swe_edge_flux"] = [(fbk[r], fbp[r]) for r in range(3)]
    rel = {k: max(rel_err(g, w) for g, w in v) for k, v in pairs.items()}
    err = {k: max(abs_err(g, w) for g, w in v) for k, v in pairs.items()}
    exact = float(mk) == float(mp) and int(ik) == int(ip)
    err["courant_argmax"] = abs(float(mk) - float(mp))
    log(f"  strip {list(st)} kernels vs plain on the {path} path "
        f"(relative): {rel}; Courant fold {'exact' if exact else 'DIFFERS'}")
    if not (exact and all(v <= TOL[f32] for v in rel.values())):
        raise SystemExit(f"{path} strip kernel check failed")
    check_one_kernel(lambda: op.courant_max(blocks, dt_t, *run),
                     f"courant_argmax on a strip's {blocks.numel():,} block "
                     "maxima")
    Eb = op.bnd.bnd_left.shape[0]
    calls["courant_argmax"] = (lambda: op.courant_max(blocks, dt_t, *run),
                               lambda: courant_argmax_plain(blocks, dt_t,
                                                            *run),
                               lambda: torch.max(blocks, 0))
    calls["swe_edge_flux"] = (
        lambda: op.boundary_fluxes(b[:3], bv[:3]),
        lambda: swe_edge_flux_plain(op.bnd, b[:3], bv[:3], th, ta), None)
    nbytes["courant_argmax"] = courant_bytes(blocks.numel(), sz)
    nbytes["swe_edge_flux"] = edge_flux_bytes(
        0, Eb, 3 * sz * int(torch.unique(op.bnd.bnd_left).numel()), sz)
    nops["courant_argmax"] = OPS_PER_VALUE * blocks.numel()
    nops["swe_edge_flux"] = OPS_PER_EDGE * Eb
    replaces = dict(REPLACES, courant_argmax=_SHARDED,
                    swe_edge_flux=_SLOTTED + ":1254",
                    **{k: _SHARDED for k in kernel_names})
    extra = dict(strip=list(st), strips=STRIPS, **({"nt": nt} if nt else {}))
    # the strip modes run only here: their own errors
    rows = [kernel_row(card, name, path, fns, launches[name], err[name],
                       nbytes[name], nops[name], f32, replaces, **extra)
            for name, fns in calls.items()]
    ex_ms, timer = device_time(lambda: exchange(bufs, strips, nx))
    ex_bytes = sum(2 * sz * b.shape[0] * (s.halo_lo + s.halo_hi) * nx
                   for b, s in zip(bufs, strips))
    log(f"  [{card}] halo exchange on the {path} path ({2 * (STRIPS - 1)} "
        f"copies of {st.halo_lo} rows of {b.shape[0]} state rows): device "
        f"{ex_ms:.4f} ms per stage ({timer}), {ex_bytes / 1e6:.3f} MB "
        f"moved, bound {1e3 * ex_bytes / HBM_BYTES_PER_S:.4f} ms")
    return rows


def phase_strips(steps, dev, mesh):
    """Phase 8: the raster main path in STRIPS row strips on the one card,
    bit for bit phase 4's single strip, then the tracer and second-order
    decks in strips against their single strips, and each strip kernel
    held against its plain version and timed at a strip's shapes."""
    from rdycore_tpu_torch.ops import kernels

    card = nvidia_smi_line()
    area = mesh.cell_area
    path = f"raster+strips{STRIPS}"
    log(f"== phase 8: raster main path in {STRIPS} row strips on one card "
        f"(fused_structured, parallel.n_devices: {STRIPS}, an explicit "
        f"device list), dam break on {mesh.num_cells:,} cells, f32")

    def check(sim, q0):
        check_state_and_budget(sim, q0, area)
        same = same_state(final_state(sim), REFERENCE["raster"])
        log(f"  {STRIPS} strips against phase 4's single strip after "
            f"{sim.step} steps (q, t, Courant number, boundary-flux "
            f"accumulator): {'bit for bit' if same else 'DIFFERENT'}")
        if not same:
            raise SystemExit(f"{path} differs from the single strip")

    main = f"raster main path in {STRIPS} strips"
    sim, launches = run_main_path(
        main, lambda n, plain=False: strip_simulation(n, dev, mesh,
                                                      plain=plain),
        steps, {"swe_raster_step": STRIPS, "courant_argmax": STRIPS,
                "swe_edge_flux": STRIPS}, check)
    (one_ms, one_rate), (ms, rate) = STEADY["raster main path"], STEADY[main]
    log(f"  [{card}] steady state: {STRIPS} strips {ms:.4f} ms/step, "
        f"{rate:.4e} cell-updates/s; phase 4's single strip {one_ms:.4f} "
        f"ms/step, {one_rate:.4e} cell-updates/s")
    rows = strip_kernel_rows(card, sim, path, launches, dev, DT)
    del sim
    # the tracer and second-order decks, a few dozen steps each
    n = 24
    for tag, config, scheme, dt, per_step in (
            ("tracers", tracer_dam_break_config, "euler", DT,
             {"swe_raster_step": 1, "courant_argmax": 1,
              "swe_edge_flux": 1}),
            ("muscl", muscl_dam_break_config, "ssprk2", DT_MUSCL,
             {"swe_raster_muscl_step": 2,
              "courant_argmax": 1, "swe_edge_flux": 1})):
        one = raster_simulation(n, dev, mesh, scheme, config=config)
        one.run()
        four = strip_simulation(n, dev, mesh, scheme, config=config)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        four.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels.KERNELS}
        check_launches(f"{path}+{tag} run of {n} steps", launches,
                       {k: STRIPS * v * n for k, v in per_step.items()})
        same = same_state(final_state(four), final_state(one))
        finite = bool(np.isfinite(four.get_solution()).all())
        log(f"  [{card}] {path}+{tag} ({scheme}): {n} steps in {wall:.3f} s "
            f"(first interval included); against the single strip (q, t, "
            f"Courant number, boundary-flux accumulator): "
            f"{'bit for bit' if same else 'DIFFERENT'}; finite {finite}")
        if not (same and finite and four.step == n):
            raise SystemExit(f"{path}+{tag} differs from the single strip")
        rows += strip_kernel_rows(card, four, f"{path}+{tag}", launches,
                                  dev, dt, nt=NT if tag == "tracers" else 0)
        del one, four
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
    mesh = dam_break_mesh()
    # one row per kernel and path, each with that path's own launches
    rows = phase_main(args.steps, errs, dev, mesh)
    rows += phase_raster(args.steps, errs, dev, mesh)
    phase_tracer_kernels(args.seed, errs, dev)
    rows += phase_tracers(args.steps, errs, dev, mesh)
    phase_muscl_kernels(args.seed, errs, dev)
    rows += phase_muscl(args.steps, errs, dev, mesh)
    phase_wb_kernels(args.seed, errs, dev)
    rows += phase_wb(args.steps, errs, dev, wb_mesh())
    rows += phase_strips(args.steps, dev, mesh)
    del mesh
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
