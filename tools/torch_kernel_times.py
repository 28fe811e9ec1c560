#!/usr/bin/env python3
"""K2, K2 MUSCL and K1c on the GPU at the main paths' shapes, timed in
turns.

    python3 tools/torch_kernel_times.py [--nx 2048] [--ny 1408] [--reps 50]
                                        [--rounds 3] [--package-root DIR]

Builds the three kernels (printing nvcc's register, shared-memory and
spill report of each instance), then on a random wet raster of nx x ny
cells (f32, made with numpy from a fixed seed; dam-break depths 0.05-0.25
m with momentum):

- K2 `swe_raster_step`, flow only, in an euler stage with the primitives
  (the main path's launch) and in rhs mode, and with three tracer rows,
  the cases in turn each round;
- K2 MUSCL (minmod, h_anuga = 0 as in the second-order dam break) in an
  euler stage with the primitives (the first ssprk2 stage), in the ssprk2
  second stage (with qA, no primitives), in a qA stage with the
  primitives and in rhs mode: `swe_raster_muscl_step`, or, in a
  checkout that predates it, the launch pair
  `swe_raster_muscl_faces` + `swe_raster_muscl_update` (and the faces
  launch alone), each beside its bytes bound;
- K1c `courant_argmax` (with the running fold) beside `torch.max(x, 0)` on
  the 5,770,624 edge values of the unstructured path and on K2's flow-only
  tile maxima of the whole raster and of one of 4 strips, in turns (K1c,
  the library call, the library call, K1c).

With --package-root, `rdycore_tpu_torch` is imported from DIR (another
checkout, such as the parent commit unpacked with `git archive` into an
ignored directory) and only K2 and K2 MUSCL are timed: run it beside a run
of this checkout in one call to compare the kernels on one card.

Each time is the mean device time of --reps launches from torch.profiler
(between CUDA events where it records none), after a warm-up. Prints the
card's name and power limit, every time, and each kernel's bytes bound at
3.35 TB/s. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn(): the kernels' own time
    from torch.profiler (a small kernel's launch from Python takes longer
    than the kernel), or between CUDA events where the profiler records
    no device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages()
             if "CUDA" in str(getattr(e, "device_type", "")))
    if us > 0:
        return us / 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_muscl(plan, q, geo, dt, reps, rounds):
    """K2 MUSCL in three modes, each beside its bytes bound (the planes of
    swe_raster_muscl_step: q, the geometry, out and prim or qA)."""
    from rdycore_tpu_torch.ops.kernels import raster_muscl as rm

    nx, ny = plan.nx, plan.ny
    C, s = nx * ny, 4
    qA = q.flip(1).contiguous()
    # mode -> (its keywords, the f32 planes the function moves)
    modes = {"euler stage with prim": (dict(stage=(0.0, 1.0, 1.0),
                                            emit_prim=True), 12),
             "ssprk2 second stage (qA)": (dict(stage=(0.5, 0.5, 0.5),
                                               qA=qA), 12),
             "qA stage with prim": (dict(stage=(0.5, 0.5, 0.5), qA=qA,
                                         emit_prim=True), 15),
             "rhs mode": (dict(), 9)}
    cases = {}
    if hasattr(rm, "swe_raster_muscl_step"):
        for mode, (kw, planes) in modes.items():
            cases[f"step, {mode}"] = (
                lambda kw=kw: rm.swe_raster_muscl_step(
                    plan, q, *geo, dt, None, "minmod", **kw), planes)
    else:  # the former launch pair, faces then update
        def pair(kw):
            fx, fy, _ = rm.swe_raster_muscl_faces(plan, q, None, "minmod")
            return rm.swe_raster_muscl_update(plan, q, fx, fy, *geo, dt,
                                              **kw)

        for mode, (kw, planes) in modes.items():
            cases[f"faces + update, {mode}"] = (lambda kw=kw: pair(kw),
                                                planes)
        cases["faces alone"] = (
            lambda: rm.swe_raster_muscl_faces(plan, q, None, "minmod"), 0)
    ts = {what: [] for what in cases}
    for _ in range(rounds):
        for what, (fn, _) in cases.items():
            ts[what].append(device_ms(fn, reps))
    for what, (fn, planes) in cases.items():
        med = float(np.median(ts[what]))
        bound = 1e3 * s * planes * C / HBM_BYTES_PER_S
        share = (f"; bound {bound:.4f} ms ({100 * bound / med:.1f}% of the "
                 "median)" if planes else "")
        print(f"K2 MUSCL {what}, {C} cells: ms "
              f"{', '.join(f'{x:.4f}' for x in ts[what])}; median "
              f"{med:.4f}{share}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=2048)
    ap.add_argument("--ny", type=int, default=1408)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--package-root", default=None)
    args = ap.parse_args()
    other = args.package_root is not None
    sys.path.insert(0, os.path.abspath(args.package_root or ROOT))
    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA device")
        return 1
    from rdycore_tpu_torch.ops.kernels import build
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax
    from rdycore_tpu_torch.ops.kernels import raster_step as rs
    from rdycore_tpu_torch.ops.kernels.raster_step import (
        StructuredPlan, swe_raster_step)

    print(f"card: {card()}; package {os.path.dirname(rs.__file__)}")
    built = build.build_all(["swe_raster_step", "swe_raster_muscl",
                             "courant_argmax"], force=True)
    for name, (secs, report) in built.items():
        lines = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
        print(f"nvcc {name} ({secs:.1f} s):\n  " + "\n  ".join(lines))

    dev = torch.device("cuda")
    nx, ny = args.nx, args.ny
    rng = np.random.default_rng(0)
    h = np.where(np.arange(nx)[None, :] < nx // 2, 0.25, 0.05) * rng.uniform(
        0.9, 1.1, (ny, nx))

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

    flow = [h, h * rng.normal(0, 0.3, h.shape), h * rng.normal(0, 0.3, h.shape)]
    q = t(np.stack(flow).reshape(3, -1))
    q3 = t(np.concatenate([flow, h * rng.uniform(0, 1e-3, (3,) + h.shape)])
           .reshape(6, -1))
    geo = [t(np.zeros((ny, nx))), t(np.zeros((ny, nx))),
           t(np.full((ny, nx), 0.018))]
    plan = StructuredPlan(nx, ny, 1 / 512, 1 / 512, 1e-7, 0.0, 1, 2, 1, 1)
    dt = t(0.0005)
    C, s = nx * ny, 4
    cases = {
        "flow, euler stage with prim": (
            lambda: swe_raster_step(plan, q, *geo, dt, stage=(0.0, 1.0, 1.0),
                                    emit_prim=True), 12),
        "flow, rhs mode with prim": (
            lambda: swe_raster_step(plan, q, *geo, dt, emit_prim=True), 12),
        "NT = 3 (2 sediment classes), euler stage with prim": (
            lambda: swe_raster_step(plan, q3, *geo, dt, stage=(0.0, 1.0, 1.0),
                                    emit_prim=True, num_sediment=2), 21),
    }
    ts = {what: [] for what in cases}
    for _ in range(args.rounds):
        for what, (fn, _) in cases.items():
            ts[what].append(device_ms(fn, args.reps))
    for what, (fn, planes) in cases.items():
        bound = 1e3 * s * (planes * C + fn().cmax.numel() + 1) / (
            HBM_BYTES_PER_S)
        med = float(np.median(ts[what]))
        print(f"K2 {what}, {C} cells: ms "
              f"{', '.join(f'{x:.4f}' for x in ts[what])}; median {med:.4f}"
              f"; bound {bound:.4f} ms ({100 * bound / med:.1f}% of the "
              "median)")
    time_muscl(plan._replace(h_anuga=0.0), q, geo, dt, args.reps,
               args.rounds)
    if other:
        print(f"card: {card()}")
        return 0

    tile = rs.tile_for(0)
    blocks = rs.num_blocks(nx, ny, tile)
    run = (torch.zeros((), device=dev),
           torch.zeros((), dtype=torch.int32, device=dev))
    for what, n in (("unstructured edge values", 5_770_624),
                    ("raster tile maxima", blocks),
                    ("tile maxima of one of 4 strips",
                     rs.num_blocks(nx, ny // 4, tile))):
        x = torch.rand(n, device=dev)
        k, lib = [], []
        for _ in range(args.rounds):
            k.append(device_ms(lambda: courant_argmax(x, dt, *run), args.reps))
            lib.append(device_ms(lambda: torch.max(x, 0), args.reps))
            lib.append(device_ms(lambda: torch.max(x, 0), args.reps))
            k.append(device_ms(lambda: courant_argmax(x, dt, *run), args.reps))
        bound = 1e3 * (4 * n + 8) / HBM_BYTES_PER_S
        print(f"K1c on {n} {what}: ms {', '.join(f'{v:.4f}' for v in k)}; "
              f"torch.max(x, 0) ms {', '.join(f'{v:.4f}' for v in lib)}; "
              f"medians {float(np.median(k)):.4f} / "
              f"{float(np.median(lib)):.4f}; bound {bound:.4f} ms")
    print(f"card: {card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
