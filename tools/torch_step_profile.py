#!/usr/bin/env python3
"""Where a step of rdycore_tpu_torch's main path spends its time on the GPU.

    python3 tools/torch_step_profile.py [--nx 2048] [--ny 1408] [--steps 200]
                                        [--scheme euler] [--f64] [--raster]
                                        [--strips P] [--tracers | --muscl]
                                        [--wb hr|bs2002]

Runs the dam break of chip_smoke.py (f32, or f64 with --f64; boundary-flux
accumulators on; with --tracers two sediment classes and salinity, the
deck of its phase 5; with --muscl the second-order deck of its phase 6:
MUSCL with minmod and the positivity limiter, a dry floodplain, ssprk2
unless --scheme says otherwise, dt 0.00025 s; with --wb the well-balanced
dam break of its phase 7 on 1448x996 triangles over a bumpy bed,
hydrostatic reconstruction or BS2002, first order or with --muscl (BS2002
only) second order, dt 0.0002 s) through `Simulation` on the
CUDA device, on its
unstructured path or, with --raster, on the raster path
(`edge_flux_backend: fused_structured`, float32 whatever --f64 says),
with --strips P in P row strips all on the one card (the deck's
parallel.n_devices = P and an explicit device list): one warm-up
interval, then
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
    DT, DT_MUSCL, DT_WB, DX, H_FLOODPLAIN, H_WB_SUBMERGED, dam_break_config,
    dam_eta, device_events, muscl_dam_break_config, nvidia_smi_line,
    tracer_dam_break_config, wb_mesh, wb_simulation,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=2048)
    ap.add_argument("--ny", type=int, default=1408)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--scheme", default=None,
                    help="euler (ssprk2 with --muscl)")
    ap.add_argument("--f64", action="store_true", help="double precision")
    ap.add_argument("--raster", action="store_true",
                    help="edge_flux_backend: fused_structured")
    ap.add_argument("--strips", type=int, default=1,
                    help="row strips of the raster, on the one card")
    deck = ap.add_mutually_exclusive_group()
    deck.add_argument("--tracers", action="store_true",
                      help="two sediment classes and salinity")
    deck.add_argument("--muscl", action="store_true",
                      help="second order with the positivity limiter")
    ap.add_argument("--wb", choices=("hr", "bs2002"),
                    help="the well-balanced deck: hydrostatic "
                    "reconstruction or BS2002")
    args = ap.parse_args()
    if args.wb and (args.raster or args.tracers or args.f64
                    or args.muscl and args.wb == "hr"):
        ap.error("--wb runs the unstructured path in f32, flow only; "
                 "--muscl with bs2002 only")
    if args.strips > 1 and not args.raster:
        ap.error("--strips cuts the raster path (--raster)")
    if args.scheme is None:
        args.scheme = "ssprk2" if args.muscl else "euler"
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 1

    import numpy as np

    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.mesh import structured_quad

    if args.wb:
        mesh = wb_mesh()
        wb = {"hr": "hydrostatic_reconstruction"}.get(args.wb, args.wb)
        sim = wb_simulation(
            10 * args.steps, "cuda", mesh,
            dam_eta(H_FLOODPLAIN if args.wb == "hr" else H_WB_SUBMERGED),
            wb=wb, dt=DT_WB, scheme=args.scheme, second_order=args.muscl)
        sim.set_coupling_interval(args.steps * DT_WB)
    else:
        lx, ly = args.nx * DX, args.ny * DX
        mesh = structured_quad(
            args.nx, args.ny, 0.0, lx, 0.0, ly,
            region_fn=lambda cx, cy: np.where(cx < lx / 2, 1, 2),
        )
        config, dt = ((tracer_dam_break_config, DT) if args.tracers else
                      (muscl_dam_break_config, DT_MUSCL) if args.muscl else
                      (dam_break_config, DT))
        cfg = config(
            10 * args.steps, "fused_structured" if args.raster else "xla",
            args.scheme)
        if args.f64:
            cfg.numerics.precision = "double"
        cfg.time.coupling_interval = args.steps * dt
        cfg.parallel.n_devices = args.strips
        sim = Simulation(cfg, mesh=mesh, device="cuda",
                         strip_devices=(["cuda"] * args.strips
                                        if args.strips > 1 else None))
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
    size = "1448x996 triangles" if args.wb else f"{args.nx}x{args.ny}"
    print(f"[{card}] {size} ({mesh.num_cells} cells) "
          f"{'raster ' if args.raster else ''}"
          f"{f'in {args.strips} strips ' if args.strips > 1 else ''}"
          f"{args.scheme} "
          f"{'tracers (ndof 6) ' if args.tracers else ''}"
          f"{'MUSCL minmod ' if args.muscl else ''}"
          f"{'well-balancing ' + args.wb + ' ' if args.wb else ''}"
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
