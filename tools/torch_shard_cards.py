#!/usr/bin/env python3
"""The dam break in one shard or row strip per card, on NCCL ranks.

    python3 tools/torch_shard_cards.py [--cards 4] [--steps 200]
                                       [--raster-steps 500]
                                       [--profile] [--out FILE]
                                       [--only-16b]

On chip_smoke.py's full-size dam break (2048x1408 cells of 1/512 m, f32,
euler, dt 0.0005 s, boundary-flux accumulator on):

- the unstructured path (`parallel.n_devices` = --cards,
  `partitioning: auto`) in --cards ranks joined over NCCL, rank r on
  cuda:r, one shard each (`parallel.comm.spawn`, a FileStore); the same
  deck in --cards shards in this one process on cuda:0..cards-1 (one
  thread per card); and the deck on one card under `cell_ordering: rcm`,
  the shards' cell order;
- the raster path (`fused_structured`, phase 4's deck) in --cards ranks,
  each rank's row strip kept on its card across intervals
  (ops/strips.RankStrip), and as one strip on cuda:0.

- what the shards run since ROADMAP item 16b, in --cards NCCL ranks
  (one spawn, `wb_beuler_rank`): chip_smoke.py phase 7's BS2002 deck
  (2,884,416 triangles over a bumpy bed, `partitioning: auto`) for 10 +
  --steps euler steps, then 24 steps with MUSCL (ssprk2), and phase 9's
  closed dam break under beuler for one step; the one-card runs on the
  RCM order beside them. BS2002 must be bit for bit; beuler within 1e-4
  of |dq| / (1 + |q|) (its inner products add per-rank partials). Per
  rank: ms/step, vertex-ring ghosts, and beuler's wall ms/step and
  collectives a step. --only-16b runs these alone.

Each multi-card run must equal its one-card run bit for bit (q, t,
Courant number, its edge on the unstructured path, boundary-flux
accumulator). Each run's first interval of 10 steps (where the kernel
libraries load) is left out of its time; the rest is one interval of
--steps (--raster-steps) steps, timed per rank between CUDA events. Per
rank: setup seconds, owned cells, ghosts and frontier cells, ms/step and
the halo exchange's ms per stage (`parallel.comm.DistTransport`: under
NCCL one all-gather of every rank's frontier a stage), beside the same
halo by point-to-point buffers (`exchange_p2p`). With --profile, rank 0 of
each rank run prints torch.profiler's table of 20 more steps (host and
device time by operation). Prints the cards' names and power limits;
writes every number as JSON to --out. Exits non-zero without enough
cards or when a run differs from its one-card run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    BEULER_STEPS, DT, DT_WB, H_WB_SUBMERGED, SHARD_WB_MUSCL_STEPS,
    closed_dam_break_config, dam_break_config, dam_break_mesh, dam_eta,
    final_state, rcm_config, run_state, same_run, same_state, sharded_config,
    wb_mesh, wb_rcm_simulation, wb_shard_simulation,
)

WARM = 10  # the first interval's steps, left out of the times
PROFILED = 20  # the steps under the profiler with --profile
RANK_TIMEOUT = 180.0  # a rank waiting longer on a peer fails


def events_ms(fn) -> float:
    """Milliseconds of fn() between CUDA events on the current card."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def timed_run(sim, steps):
    """The first interval (WARM steps), then one interval of `steps`
    steps timed between CUDA events: ms/step."""
    sim.coupling_interval = WARM * DT
    sim.advance()
    sim.coupling_interval = steps * DT
    return events_ms(sim.advance) / steps


def profile_table(sim, steps, record=True):
    """torch.profiler's table of `steps` more steps (one interval; in a
    run of several ranks every rank steps it, and those with `record`
    profile it)."""
    from torch.profiler import ProfilerActivity, profile

    sim.coupling_interval = steps * DT
    if not record:
        sim.advance()
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.advance()
        torch.cuda.synchronize()
    return prof.key_averages().table(sort_by="self_cpu_time_total",
                                     row_limit=14)


def unstructured_rank(rank, world, steps, profiled):
    """One shard of the unstructured deck on the card of this rank."""
    import torch.distributed as dist

    from rdycore_tpu_torch import Simulation

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    mesh = dam_break_mesh()
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = Simulation(sharded_config(WARM + steps + profiled, world),
                     mesh=mesh, device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    sh = sim._sharded
    dist.barrier()
    ms = timed_run(sim, steps)
    u, pl = sh.units[0], sh.plans[rank]
    q = sim._qs[u]
    dist.barrier()
    ex = events_ms(lambda: [sh.transport.exchange(u, q)
                            for _ in range(20)]) / 20
    dist.barrier()
    ex_p2p = events_ms(lambda: [sh.transport.exchange_p2p(q)
                                for _ in range(20)]) / 20
    state = run_state(sim)
    table = profile_table(sim, profiled, rank == 0) if profiled else None
    return dict(rank=rank, state=state, ms_step=ms, table=table,
                exchange_ms=ex, p2p_ms=ex_p2p, mesh_s=t_mesh, setup_s=t_setup,
                owned=pl.nown, ghosts=len(pl.ghosts), frontier=pl.frontier,
                neighbors=sorted(pl.recv), backend=dist.get_backend())


def raster_rank(rank, world, steps, profiled):
    """One row strip of the raster deck on the card of this rank."""
    import torch.distributed as dist

    from rdycore_tpu_torch import Simulation

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = dam_break_config(WARM + steps + profiled, "fused_structured")
    cfg.parallel.n_devices = world
    t0 = time.perf_counter()
    sim = Simulation(cfg, mesh=dam_break_mesh(), device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    rs = sim._rank_strip
    dist.barrier()
    ms = timed_run(sim, steps)
    dist.barrier()
    ex = events_ms(lambda: [rs.exchange([rs.buf]) for _ in range(20)]) / 20
    dist.barrier()
    ex_p2p = events_ms(lambda: [rs.transport.exchange_p2p(rs.buf)
                                for _ in range(20)]) / 20
    state = final_state(sim)
    table = profile_table(sim, profiled, rank == 0) if profiled else None
    return dict(rank=rank, state=state, ms_step=ms, table=table,
                exchange_ms=ex, p2p_ms=ex_p2p, setup_s=t_setup,
                strip=list(rs.strip),
                device_bytes=torch.cuda.max_memory_allocated(dev))


def wb_beuler_rank(rank, world, steps):
    """The BS2002 deck (euler, then MUSCL ssprk2) and the closed dam break
    under beuler, one shard on the card of this rank."""
    import torch.distributed as dist

    from rdycore_tpu_torch import Simulation

    dev = torch.device("cuda", torch.cuda.current_device())
    eta, bs = dam_eta(H_WB_SUBMERGED), dict(wb="bs2002", dt=DT_WB)
    out = dict(rank=rank)
    sim = wb_shard_simulation(WARM + steps, dev, wb_mesh(), world, "auto",
                              eta, **bs)
    pl = sim._sharded.plans[rank]
    out.update(ghosts=len(pl.ghosts), vertex_ghosts=pl.vertex_ghosts,
               owned=pl.nown)
    rmesh = sim.mesh
    dist.barrier()
    sim.coupling_interval = WARM * DT_WB
    sim.advance()
    sim.coupling_interval = steps * DT_WB
    out["bs2002_ms"] = events_ms(sim.advance) / steps
    out["bs2002"] = run_state(sim)
    del sim
    sim = wb_shard_simulation(SHARD_WB_MUSCL_STEPS, dev, rmesh, world, "none",
                              eta, scheme="ssprk2", second_order=True, **bs)
    dist.barrier()
    out["muscl_ms"] = events_ms(sim.run) / SHARD_WB_MUSCL_STEPS
    out["muscl"] = run_state(sim)
    del sim, rmesh
    sim = Simulation(sharded_config(BEULER_STEPS, world,
                                    closed_dam_break_config),
                     mesh=dam_break_mesh(), device=dev)
    sh = sim._sharded
    counts = dict(sh.counts)
    dist.barrier()
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    out["beuler_ms"] = 1e3 * (time.perf_counter() - t0) / BEULER_STEPS
    out["beuler_collectives"] = {k: (sh.counts[k] - counts[k]) / BEULER_STEPS
                                 for k in counts}
    out["beuler"] = run_state(sim)
    return out


def one_card_16b(steps, mesh):
    """The one-card references of `wb_beuler_rank` on the RCM order:
    (BS2002 state, ms/step), (MUSCL state, ms/step), (beuler state, wall
    ms/step)."""
    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.mesh.core import rcm_reorder

    dev = torch.device("cuda", 0)
    eta, bs = dam_eta(H_WB_SUBMERGED), dict(wb="bs2002", dt=DT_WB)
    rwb = rcm_reorder(wb_mesh())
    sim = wb_rcm_simulation(WARM + steps, dev, rwb, eta, **bs)
    sim.coupling_interval = WARM * DT_WB
    sim.advance()
    sim.coupling_interval = steps * DT_WB
    ms = events_ms(sim.advance) / steps
    out = {"bs2002": (run_state(sim), ms)}
    sim = wb_rcm_simulation(SHARD_WB_MUSCL_STEPS, dev, rwb, eta,
                            scheme="ssprk2", second_order=True, **bs)
    ms = events_ms(sim.run) / SHARD_WB_MUSCL_STEPS
    out["muscl"] = (run_state(sim), ms)
    del sim, rwb
    sim = Simulation(rcm_config(BEULER_STEPS, closed_dam_break_config),
                     mesh=mesh, device=dev)
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    out["beuler"] = (run_state(sim),
                     1e3 * (time.perf_counter() - t0) / BEULER_STEPS)
    return out


def run_16b(P, steps, name, mesh, base):
    """`wb_beuler_rank` on P NCCL ranks against `one_card_16b`: printed,
    and (ok, the numbers)."""
    from rdycore_tpu_torch.parallel.comm import spawn

    ref = one_card_16b(steps, mesh)
    with tempfile.TemporaryDirectory(dir=base) as store:
        t0 = time.perf_counter()
        ranks = spawn(wb_beuler_rank, P, "nccl", store, args=(steps,),
                      timeout=RANK_TIMEOUT, device="cuda:{rank}")
        t_spawn = time.perf_counter() - t0
    print(f"[{name}] one card (RCM order): BS2002 {ref['bs2002'][1]:.4f} "
          f"ms/step, BS2002 MUSCL {ref['muscl'][1]:.4f}, beuler "
          f"{ref['beuler'][1]:.1f} ms/step wall; the ranks' runs "
          f"{t_spawn:.1f} s, spawn included")
    ok = True
    for r in ranks:
        same = {k: same_run(r.pop(k), ref[k][0]) for k in ("bs2002", "muscl")}
        qb, qr = r.pop("beuler")[0], ref["beuler"][0][0]
        rel = float(np.max(np.abs(qb - qr) / (1.0 + np.abs(qr))))
        ok &= all(same.values()) and rel <= 1e-4
        r.update(same=same, beuler_rel=rel)
        print(f"  rank {r['rank']}: {r['owned']:,} owned, {r['ghosts']:,} "
              f"ghosts ({r['vertex_ghosts']:,} vertex ring); BS2002 "
              f"{r['bs2002_ms']:.4f} ms/step, MUSCL {r['muscl_ms']:.4f}, "
              f"{same}; beuler {r['beuler_ms']:.1f} ms/step wall, "
              f"collectives a step {r['beuler_collectives']}, max |dq| / "
              f"(1 + |q|) {rel:.3e} against one card")
    return ok, dict(one_card={k: v[1] for k, v in ref.items()},
                    ranks=ranks, spawn_s=t_spawn)


def one_card(config, steps, mesh):
    """(the simulation, ms/step) of the deck on cuda:0."""
    from rdycore_tpu_torch import Simulation

    sim = Simulation(config, mesh=mesh, device="cuda:0")
    ms = timed_run(sim, steps)
    return sim, ms


def main():
    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.parallel.comm import spawn

    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--raster-steps", type=int, default=500)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default="output/torch_shard_cards.json")
    ap.add_argument("--only-16b", action="store_true")
    args = ap.parse_args()
    P = args.cards
    if torch.cuda.device_count() < P:
        print(f"torch_shard_cards: {torch.cuda.device_count()} cards, {P} "
              "asked for", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    name = card.splitlines()[0]
    mesh = dam_break_mesh()
    n, nr = args.steps, args.raster_steps
    prof = PROFILED if args.profile else 0
    out = {"cards": card.splitlines(), "P": P, "steps": n,
           "raster_steps": nr}
    base = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "output")
    os.makedirs(base, exist_ok=True)
    ok, out["16b"] = run_16b(P, n, name, mesh, base)
    if args.only_16b:
        return finish(out, ok, args.out)

    sim, ms1 = one_card(rcm_config(WARM + n + prof), n, mesh)
    if prof:
        print(f"[{name}] unstructured, one card: profile of {prof} steps\n"
              + profile_table(sim, prof))
        sim = one_card(rcm_config(WARM + n), n, mesh)[0]
    ref_u = run_state(sim)
    del sim
    sim, msr1 = one_card(dam_break_config(WARM + nr, "fused_structured"),
                         nr, mesh)
    ref_r = final_state(sim)
    del sim
    t0 = time.perf_counter()
    sim = Simulation(sharded_config(WARM + n, P), mesh=mesh, device="cuda:0")
    t_local_setup = time.perf_counter() - t0
    sim.coupling_interval = WARM * DT
    sim.advance()
    sim.coupling_interval = n * DT
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.advance()
    for k in range(P):
        torch.cuda.synchronize(k)
    ms_local = 1e3 * (time.perf_counter() - t0) / n
    same_local = same_run(run_state(sim), ref_u)
    del sim
    ok &= same_local
    print(f"[{name}] unstructured, one card (RCM order): {ms1:.4f} ms/step; "
          f"{P} shards in one process on {P} cards: {ms_local:.4f} ms/step "
          f"wall (setup {t_local_setup:.2f} s), "
          f"{'bit for bit' if same_local else 'DIFFERENT'}")
    print(f"[{name}] raster, one card: {msr1:.4f} ms/step")
    out.update(unstructured_one_card_ms=ms1, unstructured_local_ms=ms_local,
               unstructured_local_same=same_local, raster_one_card_ms=msr1)

    with tempfile.TemporaryDirectory(dir=base) as store:
        t0 = time.perf_counter()
        ranks_u = spawn(unstructured_rank, P, "nccl", store,
                        args=(n, prof), timeout=RANK_TIMEOUT,
                        device="cuda:{rank}")
        t_u = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks_r = spawn(raster_rank, P, "nccl", store,
                        args=(nr, prof), timeout=RANK_TIMEOUT,
                        device="cuda:{rank}")
        t_r = time.perf_counter() - t0
    print(f"[{name}] the ranks' runs took {t_u:.1f} s (unstructured) and "
          f"{t_r:.1f} s (raster), spawn included")
    for r in ranks_u:
        same = same_run(r.pop("state"), ref_u)
        ok &= same
        print(f"  unstructured rank {r['rank']} ({r['backend']}): "
              f"{r['ms_step']:.4f} ms/step, exchange "
              f"{r['exchange_ms']:.4f} ms per stage (point-to-point "
              f"{r['p2p_ms']:.4f}); mesh "
              f"{r['mesh_s']:.2f} s, setup {r['setup_s']:.2f} s; "
              f"{r['owned']:,} owned, {r['ghosts']:,} ghosts, "
              f"{r['frontier']:,} frontier cells, neighbours "
              f"{r['neighbors']}; {'bit for bit' if same else 'DIFFERENT'}")
        if r["table"]:
            print(r["table"])
    for r in ranks_r:
        same = same_state(r.pop("state"), ref_r)
        ok &= same
        print(f"  raster rank {r['rank']} strip {r['strip']}: "
              f"{r['ms_step']:.4f} ms/step, exchange "
              f"{r['exchange_ms']:.4f} ms per stage (point-to-point "
              f"{r['p2p_ms']:.4f}); setup "
              f"{r['setup_s']:.2f} s; peak device memory "
              f"{r['device_bytes'] / 1e9:.3f} GB; "
              f"{'bit for bit' if same else 'DIFFERENT'}")
        if r["table"]:
            print(r["table"])
    out.update(unstructured_ranks=ranks_u, raster_ranks=ranks_r,
               spawn_s={"unstructured": t_u, "raster": t_r})
    return finish(out, ok, args.out)


def finish(out, ok, path):
    """Write `out` as JSON to `path`, print the verdict; the exit code."""
    out["ok"] = bool(ok)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=float)
    print(json.dumps({"ok": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
