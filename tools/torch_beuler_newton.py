#!/usr/bin/env python3
"""How far one backward-Euler step's Newton iterations converge on the
raster, at first and second order, and how much the step moves when its
residual is perturbed.

    python3 tools/torch_beuler_newton.py [--nx 256] [--ny 32] [--cpu]

Builds chip_smoke.py's phase-9 raster deck (the dam break in a closed box,
cells of 1/512 m, dt 0.0025 s, a Courant number of about 2) on an nx x ny
raster through `Simulation`, then takes one `newton_beuler_solve` step
from the initial state with the raster path's residual (K2's rhs mode, K2
MUSCL's at second order) and JVPs (the first-order `StructuredSWEOperator`,
as the path takes them at either order). Prints, per order, the residual
norm ||u - u^n - dt F(u)|| at u^n and after the step, and the largest
change of the step's result, relative to 1 + |q|, when F is multiplied by
1 + 1e-7 N(0, 1) (the scale at which kernel and plain residuals differ in
float32). Runs on the card unless --cpu.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    DT_BEULER,
    closed_dam_break_config,
    dam_break_mesh,
    raster_simulation,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=256)
    ap.add_argument("--ny", type=int, default=32)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    from rdycore_tpu_torch.timestepping import newton_beuler_solve

    dev = torch.device("cpu" if args.cpu else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (use --cpu for the CPU)")
    mesh = dam_break_mesh(args.nx, args.ny)
    gen = torch.Generator().manual_seed(0)
    for second_order in (False, True):
        sim = raster_simulation(
            2, dev, mesh, "beuler", False,
            lambda n, b, s: closed_dam_break_config(n, b, s, second_order))
        st = sim._structured
        op, lin, ny, nx = st["op"], st["lin_op"], st["ny"], st["nx"]
        u = sim.q
        dt = torch.tensor(DT_BEULER, dtype=u.dtype, device=dev)
        es3 = torch.zeros((3, ny, nx), dtype=u.dtype, device=dev)
        noise = 1.0 + 1e-7 * torch.randn(u.shape, generator=gen).to(dev)

        def F(x):
            return op.step(x, dt).out

        def F_lin(x):
            return lin.apply(x.reshape(3, ny, nx), dt, es3)[0].reshape(3, -1)

        u1 = newton_beuler_solve(F, F_lin, u, dt)
        u2 = newton_beuler_solve(lambda x: F(x) * noise, F_lin, u, dt)
        r0 = float(torch.linalg.vector_norm(dt * F(u)))
        r1 = float(torch.linalg.vector_norm(u1 - u - dt * F(u1)))
        moved = float(((u1 - u2).abs() / (1.0 + u2.abs())).max())
        print(f"{'second' if second_order else 'first'} order on "
              f"{dev}: residual {r0:.4e} -> {r1:.4e} ({r1 / r0:.3e} of its "
              f"start); a 1e-7 perturbation of F moves the step by "
              f"{moved:.3e} (relative to 1 + |q|)", flush=True)


if __name__ == "__main__":
    main()
