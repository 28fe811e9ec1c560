#!/usr/bin/env python3
"""How often the positivity limiter acts on the second-order dam break.

    python3 tools/torch_positivity_count.py [--nx 256] [--ny 64]
                                            [--steps 200] [--corner] [--cpu]

Runs the second-order deck of chip_smoke.py's phase 6 (MUSCL with minmod
and the positivity limiter, a dry floodplain, ssprk2, dt 0.00025 s, cells
of 1/512 m) on an nx x ny raster through `Simulation` on the unstructured
path, with the donor factors computed by the plain version of K3b's drain
kernel so that each stage's count of cells with s < 1 can be read. The
reservoir fills x < Lx/2 or, with --corner, only the quarter x < Lx/2,
y < Ly/2 (a 2-D front). Prints the counts of the first steps, the number
of steps in which some cell had s < 1, the largest count, the smallest
depth and the largest Courant number. Runs on the card unless --cpu.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import DX, DT_MUSCL, muscl_dam_break_config  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=256)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--corner", action="store_true",
                    help="the reservoir in one corner of the raster")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.mesh import structured_quad
    from rdycore_tpu_torch.ops.kernels.muscl import (
        positivity_drain_plain, positivity_scale_plain)

    lx, ly = args.nx * DX, args.ny * DX

    def region(cx, cy):
        inside = cx < lx / 2
        if args.corner:
            inside = inside & (cy < ly / 2)
        return np.where(inside, 1, 2)

    mesh = structured_quad(args.nx, args.ny, 0.0, lx, 0.0, ly,
                           region_fn=region)
    cfg = muscl_dam_break_config(args.steps)
    cfg.time.coupling_interval = args.steps * DT_MUSCL
    sim = Simulation(cfg, mesh=mesh, device="cpu" if args.cpu else None)
    counts = []

    def limit_positivity(flux, h, dt):
        s = positivity_drain_plain(sim.operator.arrays, flux, h, dt)
        counts.append(int((s < 1.0).sum()))
        return positivity_scale_plain(sim.operator.arrays, flux, s)

    sim.operator.limit_positivity = limit_positivity
    sim.run()
    per_step = np.array(counts).reshape(sim.step, -1).sum(axis=1)
    print(f"{args.nx}x{args.ny} {'corner' if args.corner else 'straight'} "
          f"dam break, {sim.step} ssprk2 steps of {DT_MUSCL} s on "
          f"{sim.device}: cells with s < 1 in the first steps "
          f"{per_step[:10].tolist()}; steps with some s < 1: "
          f"{int((per_step > 0).sum())}; largest count {int(per_step.max())}"
          f"; min h {float(sim.q[0].min()):.3e}; max Courant "
          f"{sim.prev_max_courant:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
