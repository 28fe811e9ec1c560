#!/usr/bin/env python3
"""Thacker's parabolic bowl (tests/test_thacker.py's deck) on the port, in
chunks of steps: where a run stays finite, and where the positivity
limiter acts.

    python3 tools/torch_thacker.py [--n 1696] [--dt 6.6e-4] [--muscl]
        [--scheme euler|ssprk2] [--plain] [--chunk 100] [--cpu]

One period of the bowl on n x n quads over [-2.2, 2.2]^2, f64, from the
analytic state at t = 0, in intervals of --chunk steps (the last one cut
to end at the period). After each chunk it prints the time, whether the
state is finite, min h, the chunk's largest Courant number, and (with
--muscl) the cells whose donor factor fell below 1 in that chunk; at the
end the L1 error of h relative to its mean over the wet cells, as
tests/test_thacker.py measures it. --plain runs the kernels' plain
versions (the operator's linearization twin) on the same device.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

H0, ETA0, HALF_WIDTH = 0.1, 0.02, 2.2  # bowl depth, centre amplitude [m]


def thacker_eta(r2, t, w, A):
    """The free surface at squared radius r2 (the bowl's a = 1 m)."""
    s = np.sqrt(1.0 - A * A)
    c = 1.0 - A * np.cos(w * t)
    return H0 * (s / c - 1.0 - r2 * ((1.0 - A * A) / (c * c) - 1.0))


def thacker_case(n):
    """(mesh, r2, w, A, T, h0) of the bowl on n x n quads."""
    from rdycore_tpu_torch.constants import GRAVITY
    from rdycore_tpu_torch.mesh import structured_quad

    L = HALF_WIDTH
    mesh = structured_quad(n, n, -L, L, -L, L,
                           z_fn=lambda x, y: -H0 * (1.0 - (x * x + y * y)))
    cx, cy = mesh.cell_centroid[:, 0], mesh.cell_centroid[:, 1]
    r2 = cx * cx + cy * cy
    w = np.sqrt(8.0 * GRAVITY * H0)
    A = ((H0 + ETA0) ** 2 - H0 ** 2) / ((H0 + ETA0) ** 2 + H0 ** 2)
    T = 2.0 * np.pi / w
    h0 = np.maximum(thacker_eta(r2, 0.0, w, A) - mesh.cell_z, 0.0)
    return mesh, r2, w, A, T, h0


def counting_operator(op, num_cells, slots=1, slot_of_call=lambda k: 0):
    """op, whose positivity limiter also marks, on the device, the cells
    whose donor factor falls below 1: in `below[slot_of_call(k)]` at its
    k-th call (k from 0, counted in `calls`), and their number in
    `events[...]` (cell-stages)."""
    import torch

    from rdycore_tpu_torch.operator import LinearizationTwin
    from rdycore_tpu_torch.ops.kernels import muscl

    if isinstance(op, LinearizationTwin):
        drain, scale = muscl.positivity_drain_plain, muscl.positivity_scale_plain
    else:
        drain, scale = muscl.swe_positivity_drain, muscl.swe_positivity_scale

    class Counting(type(op)):
        def limit_positivity(self, flux, h, dt):
            s = drain(self.arrays, flux, h, dt)
            k = slot_of_call(self.calls)
            self.calls += 1
            self.below[k] |= s < 1.0
            self.events[k] += (s < 1.0).sum()
            return scale(self.arrays, flux, s)

    out = Counting(**{f.name: getattr(op, f.name)
                      for f in dataclasses.fields(op)})
    dev = op.arrays.area.device
    out.calls = 0
    out.below = torch.zeros((slots, num_cells), dtype=torch.bool, device=dev)
    out.events = torch.zeros(slots, dtype=torch.int64, device=dev)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1696)
    ap.add_argument("--dt", type=float, default=6.6e-4)
    ap.add_argument("--muscl", action="store_true")
    ap.add_argument("--scheme", default="euler")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    from rdycore_tpu_torch.operator import build_operator, linearization_twin
    from rdycore_tpu_torch.timestepping import make_interval_advancer

    dev = torch.device("cpu" if args.cpu else "cuda")
    mesh, r2, w, A, T, h0 = thacker_case(args.n)
    op = build_operator(mesh, mannings_n=np.zeros(mesh.num_cells),
                        second_order=args.muscl, dtype=torch.float64,
                        device=dev)
    if args.plain:
        op = linearization_twin(op)
    if args.muscl:
        op = counting_operator(op, mesh.num_cells)
    adv = make_interval_advancer(op, args.scheme, accumulate=False)
    q = torch.zeros((3, mesh.num_cells), dtype=torch.float64, device=dev)
    q[0] = torch.as_tensor(h0, device=dev)
    n_steps = int(np.ceil(T / args.dt))
    kind = "plain versions" if args.plain else "kernels"
    print(f"Thacker bowl {args.n}x{args.n} ({mesh.num_cells:,} cells), "
          f"{'MUSCL' if args.muscl else 'first order'} {args.scheme} on the "
          f"{kind}, dt {args.dt} s, {n_steps} steps to T = {T:.6f} s, "
          f"device {dev}", flush=True)
    t, done, t0 = 0.0, 0, time.perf_counter()
    while done < n_steps:
        k = min(args.chunk, n_steps - done)
        tt, dt, te = (q.new_full((), v) for v in (t, args.dt, T))
        res = adv(q, tt, dt, k, te, op.zero_boundary_values(),
                  torch.zeros_like(q))
        q, t, done = res.q, float(res.t), done + k
        h = q[0]
        line = (f"  step {done:5d} t {t:.5f}: finite "
                f"{bool(torch.isfinite(q).all())}, min h "
                f"{float(h.min()):.3e}, max Courant "
                f"{float(res.max_courant):.4g}")
        if args.muscl:
            line += f", cells with s < 1: {int(op.below.sum())}"
            op.below.zero_()
            op.events.zero_()
        print(line, flush=True)
        if not bool(torch.isfinite(q).all()):
            break
    h1 = q[0].cpu().numpy()
    wet = (h0 > 1e-4) | (h1 > 1e-4)
    l1 = np.abs(h1 - h0)[wet].mean() / h0[wet].mean()
    print(f"  L1/mean after {done} steps: {l1:.6g}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    sys.exit(main())
