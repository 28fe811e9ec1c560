#!/usr/bin/env python3
"""Phase 13a's four-member ensemble with one member per card, against the
same ensemble on one card.

    python3 tools/torch_ensemble_cards.py [--cards 4] [--steps 200]

Runs the ensemble of chip_smoke.py's phase 13a (phase 3's dam break on
2048x1408 quads of 1/512 m written as an .npz, f32, euler, coupling
intervals of 50 steps; the members' Manning n 0.012-0.030, members 2 and
3 with a reservoir of 0.20 and 0.30 m) through `EnsembleSimulation`: once
with its members placed by default (member i on cuda:i, as there are as
many cards as members) and once with every member on cuda:0. Prints the
cards' names and power limits, whether each member's end state (q, t,
Courant number, boundary-flux accumulator) is the one-card member's bit
for bit, and each run's wall ms per coupling interval (every interval,
and their mean after the first, where the libraries load). Exits
non-zero without enough cards or when a member differs.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    ENSEMBLE_INTERVAL, ENSEMBLE_N, dam_break_mesh, ensemble_dict,
    final_state, same_state,
)


def run(npz, steps, devices):
    """(each member's end state, wall seconds of each interval, the
    members' devices) of the ensemble placed on `devices` (None: the
    default placement)."""
    from rdycore_tpu_torch.config.yaml_input import config_from_dict
    from rdycore_tpu_torch.ensemble import EnsembleSimulation

    ens = EnsembleSimulation(config_from_dict(ensemble_dict(steps, npz))
                             .validate(), devices=devices)
    walls = []
    while not ens.finished:
        for d in set(ens.devices):
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        ens.advance()
        for d in set(ens.devices):
            torch.cuda.synchronize(d)
        walls.append(time.perf_counter() - t0)
    return ([final_state(m) for m in ens.members], walls,
            [str(d) for d in ens.devices])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=len(ENSEMBLE_N))
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    if args.cards != len(ENSEMBLE_N):
        print(f"torch_ensemble_cards: the ensemble has {len(ENSEMBLE_N)} "
              "members, one per card", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < args.cards:
        print(f"torch_ensemble_cards: {torch.cuda.device_count()} cards, "
              f"{args.cards} asked for", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    from rdycore_tpu_torch.mesh import save_mesh_npz

    work = os.path.join(ROOT, "output", "ensemble_cards")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    npz = os.path.join(work, "dam_break.npz")
    save_mesh_npz(dam_break_mesh(), npz)
    one = run(npz, args.steps, ["cuda:0"] * args.cards)
    many = run(npz, args.steps, None)
    shutil.rmtree(work, ignore_errors=True)
    same = [same_state(a, b) for a, b in zip(one[0], many[0])]
    for name, (_, walls, devices) in (("one card", one),
                                      (f"{args.cards} cards", many)):
        steady = walls[1:] or walls
        print(f"{name} ({', '.join(devices)}): wall ms per interval of "
              f"{ENSEMBLE_INTERVAL} steps "
              + ", ".join(f"{1e3 * w:.2f}" for w in walls)
              + f"; mean after the first {1e3 * sum(steady) / len(steady):.2f}"
              f" ms, {1e3 * sum(steady) / len(steady) / (ENSEMBLE_INTERVAL * args.cards):.4f}"
              " ms per member-step")
    ratio = (sum(many[1][1:]) / max(len(many[1]) - 1, 1)) / (
        sum(one[1][1:]) / max(len(one[1]) - 1, 1))
    print(f"members on {args.cards} cards against one card, bit for bit: "
          f"{same}; wall per interval {ratio:.3f} times one card's")
    return 0 if all(same) else 1


if __name__ == "__main__":
    sys.exit(main())
