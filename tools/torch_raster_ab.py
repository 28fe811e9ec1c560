#!/usr/bin/env python3
"""Wall ms/step of the single-strip raster decks of two checkouts, in turn.

    python3 tools/torch_raster_ab.py [--trees A [B]] [--rounds 2]
                                     [--steps 1000] [--repeats 3]

Each round runs the trees in the order A, B, B, A (A alone when one tree is
given; default: this checkout), each in a process of its own that imports
`rdycore_tpu_torch` and `chip_smoke` from that tree. A process drives
chip_smoke.py's phase 4 deck (the 2048x1408 dam break, f32, euler,
boundary-flux accumulator on) and phase 6 deck (second order, minmod, the
positivity limiter, ssprk2) through `Simulation` on cuda:0, each --repeats
times, and prints the steady-state wall ms/step and cell-updates/s of every
run (the first interval, where the kernel libraries load, left out). The
end prints the card's name and power limit and, per tree and deck, every
ms/step in run order with their least and median. To compare a change with
its parent, unpack the parent into a directory that .gitignore lists
(`git archive`) and name both trees in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = ("raster euler", "raster MUSCL ssprk2")


def child(tree: str, steps: int, repeats: int) -> int:
    """Times the two decks with the package and chip_smoke of `tree`."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from chip_smoke import (
        dam_break_config, dam_break_mesh, muscl_dam_break_config,
    )
    from rdycore_tpu_torch import Simulation

    mesh = dam_break_mesh()
    for deck, config, scheme in ((DECKS[0], dam_break_config, "euler"),
                                 (DECKS[1], muscl_dam_break_config,
                                  "ssprk2")):
        for _ in range(repeats):
            sim = Simulation(config(steps, "fused_structured", scheme),
                             mesh=mesh, device="cuda:0")
            sim.advance()  # first interval: the kernel libraries load
            torch.cuda.synchronize()
            s0, t0 = sim.step, time.perf_counter()
            sim.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = sim.step - s0
            print("RESULT " + json.dumps(
                {"deck": deck, "ms": 1e3 * wall / n,
                 "rate": n * mesh.num_cells / wall}), flush=True)
            del sim
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=[ROOT])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.steps, args.repeats)
    if len(args.trees) > 2:
        ap.error("--trees takes one or two checkouts")
    order = (args.trees[:1] if len(args.trees) == 1
             else [args.trees[0], args.trees[1], args.trees[1],
                   args.trees[0]])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    ms = {(t, d): [] for t in args.trees for d in DECKS}
    for r in range(args.rounds):
        for tree in order:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", tree,
                 "--steps", str(args.steps), "--repeats", str(args.repeats)],
                capture_output=True, text=True, timeout=1200)
            if out.returncode:
                print(out.stdout[-4000:], out.stderr[-4000:], sep="\n")
                print(f"torch_raster_ab: {tree} failed", file=sys.stderr)
                return 1
            for line in out.stdout.splitlines():
                if line.startswith("RESULT "):
                    res = json.loads(line[7:])
                    ms[tree, res["deck"]].append(res["ms"])
                    print(f"round {r} {tree}: {res['deck']} "
                          f"{res['ms']:.4f} ms/step, {res['rate']:.4e} "
                          "cell-updates/s", flush=True)
    print(card)
    for (tree, deck), v in ms.items():
        print(f"{tree}: {deck}: " + " / ".join(f"{x:.4f}" for x in v)
              + f" ms/step; least {min(v):.4f}, median "
              f"{statistics.median(v):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
