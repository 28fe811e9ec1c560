#!/usr/bin/env python3
"""Where a step of rdycore_tpu_torch's main path spends its time on the GPU.

    python3 tools/torch_step_profile.py [--nx 2048] [--ny 1408] [--steps 200]
                                        [--scheme euler] [--f64] [--raster]

Runs the dam break of chip_smoke.py (f32, or f64 with --f64; boundary-flux
accumulators on) through `Simulation` on the CUDA device, on its
unstructured path or, with --raster, on the raster path
(`edge_flux_backend: fused_structured`, float32 whatever --f64 says): one
warm-up interval, then
--steps steps under torch.profiler (CPU and CUDA activities). Prints the
card's name and power limit, the wall time per step, the device time per
step of every kernel (the package's CUDA kernels and PyTorch's own
elementwise kernels of the step loop), and the share of the wall time the
device was idle. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    DT, DX, dam_break_config, device_events, nvidia_smi_line,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=2048)
    ap.add_argument("--ny", type=int, default=1408)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--scheme", default="euler")
    ap.add_argument("--f64", action="store_true", help="double precision")
    ap.add_argument("--raster", action="store_true",
                    help="edge_flux_backend: fused_structured")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 1

    import numpy as np

    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.mesh import structured_quad

    lx, ly = args.nx * DX, args.ny * DX
    mesh = structured_quad(
        args.nx, args.ny, 0.0, lx, 0.0, ly,
        region_fn=lambda cx, cy: np.where(cx < lx / 2, 1, 2),
    )
    cfg = dam_break_config(
        10 * args.steps, "fused_structured" if args.raster else "xla",
        args.scheme)
    if args.f64:
        cfg.numerics.precision = "double"
    cfg.time.coupling_interval = args.steps * DT
    sim = Simulation(cfg, mesh=mesh, device="cuda")
    sim.advance()  # warm-up interval: libraries load, allocator fills
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sim.advance()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = args.steps
    card = nvidia_smi_line()
    rows = sorted(device_events(prof), reverse=True)
    if not rows:
        print("torch_step_profile: the profiler recorded no device time",
              file=sys.stderr)
        return 2
    busy_us = sum(r[0] for r in rows)
    print(f"[{card}] {args.nx}x{args.ny} ({mesh.num_cells} cells) "
          f"{'raster ' if args.raster else ''}{args.scheme} "
          f"{'f64' if args.f64 else 'f32'}: {steps} steps in {wall:.4f} s wall = "
          f"{1e3 * wall / steps:.4f} ms/step, "
          f"{steps * mesh.num_cells / wall:.4e} cell-updates/s")
    print(f"device busy {busy_us / 1e3 / steps:.4f} ms/step; idle share "
          f"{1.0 - busy_us / 1e6 / wall:.3f}")
    print(f"{'device ms/step':>14s} {'launches/step':>13s}  kernel")
    for us, count, key in rows:
        print(f"{us / 1e3 / steps:14.5f} {count / steps:13.2f}  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
