#!/usr/bin/env python3
"""The raster dam break in row strips on several cards, against one strip.

    python3 tools/torch_strip_cards.py [--cards 4] [--steps 500]
                                       [--tracers | --muscl]

Runs the dam break of chip_smoke.py (phase 4's deck: 2048x1408 cells of
1/512 m, f32, euler, boundary-flux accumulator on; with --tracers phase
5's two sediment classes and salinity; with --muscl phase 6's second-order
deck under ssprk2) through `Simulation` with `parallel.n_devices` =
--cards, whose strips go on cuda:0..cards-1 (the halo rows cross between
cards with each stage), and the same deck as one strip on cuda:0. Prints
the cards' names and power limits, whether the strips' end state equals
the single strip's bit for bit (q, t, Courant number, boundary-flux
accumulator), and each run's steady-state wall ms/step and cell-updates/s
(the first interval, where the libraries load, left out). Exits non-zero
without enough cards or when the states differ.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    dam_break_config, dam_break_mesh, final_state, muscl_dam_break_config,
    same_state, tracer_dam_break_config,
)


def run(config, steps, scheme, mesh, n_cards):
    """(end state, steady ms/step, cell-updates/s) of the deck in n_cards
    strips (1: the whole raster on cuda:0)."""
    from rdycore_tpu_torch import Simulation

    cfg = config(steps, "fused_structured", scheme)
    cfg.parallel.n_devices = n_cards
    sim = Simulation(cfg, mesh=mesh, device="cuda:0")
    sim.advance()  # first interval: the kernel libraries load
    torch.cuda.synchronize()
    s0, t0 = sim.step, time.perf_counter()
    sim.run()
    for k in range(n_cards):
        torch.cuda.synchronize(k)
    wall = time.perf_counter() - t0
    n = sim.step - s0
    return (final_state(sim), 1e3 * wall / n,
            n * mesh.num_cells / wall)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--steps", type=int, default=500)
    deck = ap.add_mutually_exclusive_group()
    deck.add_argument("--tracers", action="store_true")
    deck.add_argument("--muscl", action="store_true")
    args = ap.parse_args()
    if torch.cuda.device_count() < args.cards:
        print(f"torch_strip_cards: {torch.cuda.device_count()} cards, "
              f"{args.cards} asked for", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    config, scheme = ((tracer_dam_break_config, "euler") if args.tracers
                      else (muscl_dam_break_config, "ssprk2") if args.muscl
                      else (dam_break_config, "euler"))
    mesh = dam_break_mesh()
    one = run(config, args.steps, scheme, mesh, 1)
    many = run(config, args.steps, scheme, mesh, args.cards)
    same = same_state(one[0], many[0])
    print(f"{args.cards} strips on {args.cards} cards against one strip "
          f"after {args.steps} {scheme} steps: "
          f"{'bit for bit' if same else 'DIFFERENT'}")
    for what, r in (("1 strip on cuda:0", one),
                    (f"{args.cards} strips on {args.cards} cards", many)):
        print(f"  {what}: {r[1]:.4f} ms/step, {r[2]:.4e} cell-updates/s")
    return 0 if same else 2


if __name__ == "__main__":
    sys.exit(main())
