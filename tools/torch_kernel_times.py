#!/usr/bin/env python3
"""The kernels on the GPU at the main paths' shapes, timed in turns: the
raster's K2, K2 MUSCL and K1c, and the gathers of K5, K1a, K1b and K3b.

    python3 tools/torch_kernel_times.py [--cases raster|gathers|all]
                                        [--nx 2048] [--ny 1408] [--reps 50]
                                        [--rounds 3] [--package-root DIR]
                                        [--work DIR] [--outputs FILE]
                                        [--against FILE]

--cases raster (in all): builds the three kernels (printing nvcc's
register, shared-memory and spill report of each instance), then on a
random wet raster of nx x ny cells (f32, made with numpy from a fixed
seed; dam-break depths 0.05-0.25 m with momentum):

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

--cases gathers (in all): the kernels whose time the order of cells and
vertices decides, f32, on a random wet/dry state (made with numpy from a
fixed seed; a third of the cells dry):

- K5 `swe_eta_vertex` on phase 7's 1448x996 triangle mesh over its bumpy
  bed (chip_smoke.py `wb_mesh`) in the generator's order, with the BS2002
  deck's depths; on rank 0's shard of 2 of that deck under RCM (phase
  15a: `rcm_reorder`, `build_partition`; its vertex universe in global-id
  order); and, an ablation, on the same shard with its vertices renumbered
  by their first cell;
- `SWEOperator.apply`'s kernels on rank 0's shard of 2 of phase 14's dam
  break under RCM (the rk4 and ark_imex shards' residual): K1a, K1c and
  K1b in rhs mode with the primitives, each beside its plain version;
- K1a `swe_edge_flux`, K1b `swe_cell_stage` (euler stage with the
  primitives, on K1a's flux) and K3b drain and scale (on that flux, over
  40 steps at Courant 0.4, where donor factors fall below 1) on the
  2,884,416-triangle
  valley of `tools/torch_flood_files.py` in the Exodus file's order
  (written once into --work and read back), under RCM and in the
  generator's order, and on the 2048x1408 dam break.

Each beside its bound as `chip_smoke.py` counts it (`wb_bytes`,
`kernel_bytes`; K3b from the row counts of `muscl_bytes`).

With --package-root, `rdycore_tpu_torch` is imported from DIR (another
checkout, such as the parent commit unpacked with `git archive` into an
ignored directory); the raster cases then time only K2 and K2 MUSCL. Run
it beside a run of this checkout in one call to compare the kernels on
one card. --outputs FILE keeps the gathers' outputs (K5's arrays; a
SHA-256 of every other output), and --against FILE, another run's
--outputs, prints K5's largest difference in ulps and whether each other
output is bit for bit the same.

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


def events_ms(fn, reps: int) -> float:
    """Milliseconds per call of fn() between CUDA events, after a warm-up
    call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in units in the last place between two float32
    or float64 arrays (the integer distance of their bit patterns on the
    ordered line)."""
    it = {4: np.int32, 8: np.int64}[a.dtype.itemsize]

    def ordered(x):
        i = np.ascontiguousarray(x).view(it).astype(np.int64)
        return np.where(i < 0, np.iinfo(it).min - i, i)

    return int(np.abs(ordered(a) - ordered(b)).max()) if a.size else 0


def digest(t: torch.Tensor) -> str:
    """A SHA-256 of a tensor's values in row-major order."""
    import hashlib

    return hashlib.sha256(
        t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def random_state(op, seed, dev):
    """A wet/dry state [3, C] (a third of the cells dry, depths 0.05-1 m
    elsewhere, momentum with them) and zero Dirichlet values, f32."""
    rng = np.random.default_rng(seed)
    C, Eb = op.num_cells, max(op.num_boundary_edges, 1)
    h = rng.uniform(0.05, 1.0, C)
    h = np.where(rng.uniform(size=C) < 1 / 3, 0.0, h)
    q = np.stack([h, h * rng.normal(0, 0.3, C), h * rng.normal(0, 0.3, C)])
    return (torch.as_tensor(q, dtype=torch.float32, device=dev),
            torch.zeros((3, Eb), dtype=torch.float32, device=dev))


def time_gathers(args, dev):
    """K5 on phase 7's mesh, its RCM shard and the shard's vertices in
    first-cell order; K1a, K1b and K3b on the valley in three orders and
    on the dam break. Returns the outputs kept for --against."""
    sys.path.append(ROOT)  # tools/ and chip_smoke.py of this checkout
    import chip_smoke as cs
    from rdycore_tpu_torch.mesh.exodus import read_exodus
    from rdycore_tpu_torch.mesh.core import rcm_reorder
    from rdycore_tpu_torch.operator import build_operator
    from rdycore_tpu_torch.ops.swe.bs2002 import bs2002_arrays_from_numpy
    from rdycore_tpu_torch.parallel.partition import build_partition
    from tools.torch_flood_files import generated_with_labels, \
        write_flood_files

    cs.log = lambda *a: print(*a, flush=True)
    f32, s = torch.float32, 4
    kept, rows = {}, []

    def timed(what, fn, nbytes):
        ts = [device_ms(fn, args.reps) for _ in range(args.rounds)]
        med = float(np.median(ts))
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        rows.append((what, med, bound))
        print(f"{what}: ms {', '.join(f'{x:.4f}' for x in ts)}; median "
              f"{med:.4f}; bound {bound:.4f} ms ({100 * bound / med:.1f}% "
              "of the median)", flush=True)

    # K5 on phase 7's mesh in the generator's order, then rank 0's shard
    mesh = cs.wb_mesh()
    eta = cs.dam_eta(cs.H_WB_SUBMERGED)
    h_np = np.maximum(eta(mesh.cell_centroid[:, 0]) - mesh.cell_z, 0.0)
    op = build_operator(mesh, well_balancing_bs2002=True, dtype=f32,
                        device=dev)
    h = torch.as_tensor(h_np, dtype=f32, device=dev)
    bs, tiny_h = op.arrays.bs2002, op.tiny_h
    NV, K = bs.vertex_cells.shape
    k5_bytes = cs.wb_bytes(op, 3 * op.num_cells * s, s)["swe_eta_vertex"]
    timed(f"K5 phase 7 mesh, generator order ({op.num_cells} cells, {NV} "
          f"vertices, K = {K})", lambda: op.eta_vertices(h), k5_bytes)
    kept["k5 one card"] = op.eta_vertices(h).cpu().numpy()
    del op, bs

    rmesh = rcm_reorder(mesh)
    hr_np = np.maximum(eta(rmesh.cell_centroid[:, 0]) - rmesh.cell_z, 0.0)
    cpu_op = build_operator(rmesh, well_balancing_bs2002=True, dtype=f32,
                            device="cpu")
    plan = build_partition(cpu_op, 2)[0]
    del cpu_op, mesh
    sbs = bs2002_arrays_from_numpy(plan.arrays["bs2002"], dev, f32)
    C_loc = sbs.z1.shape[0]
    hs = torch.as_tensor(np.append(hr_np[plan.local_cells], 0.0), dtype=f32,
                         device=dev)
    NV, K = sbs.vertex_cells.shape
    k5_shard = NV * K * 4 + 2 * NV * s + 4 * C_loc * s
    from rdycore_tpu_torch.ops.kernels.eta_vertex import swe_eta_vertex

    timed(f"K5 shard 0 of 2, RCM cells, vertices in global-id order "
          f"({C_loc} cells with the dummy, {NV} vertices)",
          lambda: swe_eta_vertex(sbs, hs, tiny_h), k5_shard)
    kept["k5 shard"] = swe_eta_vertex(sbs, hs, tiny_h).cpu().numpy()
    order = torch.as_tensor(np.argsort(
        plan.arrays["bs2002"]["vertex_cells"][:, 0], kind="stable"),
        device=dev)
    fbs = sbs._replace(vertex_cells=sbs.vertex_cells[order].contiguous(),
                       vertex_inv_count=sbs.vertex_inv_count[order]
                       .contiguous())
    timed("K5 shard 0 of 2, vertices renumbered by their first cell "
          "(ablation)", lambda: swe_eta_vertex(fbs, hs, tiny_h), k5_shard)
    first = swe_eta_vertex(fbs, hs, tiny_h)
    same = torch.equal(first, torch.as_tensor(kept["k5 shard"],
                                              device=dev)[order])
    print(f"  the ablation's eta is the shard's, permuted: {same}")
    del sbs, fbs, hs, plan

    # `apply` per shard: rank 0's shard of 2 of phase 14's dam break
    # (RCM), K1a, K1c and K1b in rhs mode with the primitives, each beside
    # its plain version (between CUDA events)
    import dataclasses

    from rdycore_tpu_torch.operator import arrays_from_numpy
    from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.parallel.partition import merge_shards

    dmesh = rcm_reorder(cs.dam_break_mesh())
    cpu_op = build_operator(dmesh, mannings_n=np.full(dmesh.num_cells,
                                                      0.018),
                            dtype=f32, device="cpu")
    del dmesh
    g = merge_shards(build_partition(cpu_op, 2), [0])
    op = dataclasses.replace(
        cpu_op, arrays=arrays_from_numpy(g.arrays, dev, f32), segments=(),
        num_cells=g.num_cells, num_internal_edges=g.num_internal_edges,
        num_boundary_edges=g.num_boundary_edges)
    del cpu_op, g
    q, bv = random_state(op, 14, dev)
    dt = torch.tensor(cs.DT, dtype=f32, device=dev)
    a = op.arrays
    kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
              xq2018_threshold=op.xq2018_threshold,
              source_method=op.source_method, emit_prim=True)
    flux, courant = op.edge_flux(q, bv)
    nb = cs.kernel_bytes(op, q.numel() * s, s, rhs=True)
    where = f"shard 0 of 2, phase 14's dam break, RCM ({op.num_cells} cells)"
    for name, fn, plain, nbytes in (
            ("K1a", lambda: op.edge_flux(q, bv),
             lambda: swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga),
             nb["swe_edge_flux"]),
            ("K1c", lambda: op.courant_max(courant),
             lambda: courant_argmax_plain(courant), nb["courant_argmax"]),
            ("K1b rhs mode with prim",
             lambda: op.cell_stage(flux, q, dt, None, emit_prim=True),
             lambda: swe_cell_stage_plain(a, flux, q, dt, None, **kw),
             nb["swe_cell_stage"])):
        timed(f"{name} in apply, {where}", fn, nbytes)
        print(f"  its plain version: {events_ms(plain, 5):.4f} ms "
              "(between CUDA events)")
    del op, q, bv, flux, courant, a

    # K1a, K1b and K3b on the valley in three orders and the dam break
    os.makedirs(args.work, exist_ok=True)
    out = write_flood_files(args.work, gmsh=False)
    exo = read_exodus(out["paths"]["exodus"])
    meshes = {"valley, Exodus file order": exo,
              "valley, RCM": rcm_reorder(exo),
              "valley, generator order": generated_with_labels(out),
              "dam break 2048x1408": cs.dam_break_mesh()}
    del out, exo
    dt = torch.tensor(cs.DT, dtype=f32, device=dev)
    stage = dict(stage=(0.0, 1.0, 1.0), emit_prim=True)
    for name in list(meshes):
        m = meshes.pop(name)
        op = build_operator(m, mannings_n=np.full(m.num_cells, 0.035),
                            dtype=f32, device=dev)
        del m
        q, bv = random_state(op, 16, dev)
        nb = cs.kernel_bytes(op, q.numel() * s, s)
        mb = cs.muscl_bytes(op, q.numel() * s, s)
        flux, courant = op.edge_flux(q, bv)
        # 40 steps at Courant 0.4, where donor factors fall below 1
        dt40 = 40 * 0.4 / courant.max()
        timed(f"K1a {name} ({op.num_edges} edges)",
              lambda: op.edge_flux(q, bv), nb["swe_edge_flux"])
        timed(f"K1b {name} ({op.num_cells} cells), euler stage with prim",
              lambda: op.cell_stage(flux, q, dt, None, **stage),
              nb["swe_cell_stage"])
        from rdycore_tpu_torch.ops.kernels import muscl as mk

        a = op.arrays
        sk = mk.swe_positivity_drain(a, flux, q[0], dt40)
        timed(f"K3b drain {name}, 40 dt",
              lambda: mk.swe_positivity_drain(a, flux, q[0], dt40),
              mb["swe_positivity_drain"])
        work = flux.clone()
        timed(f"K3b scale {name}", lambda: mk.swe_positivity_scale(
            a, work, torch.ones_like(sk)), mb["swe_positivity_scale"])
        o = op.cell_stage(flux, q, dt, None, **stage)
        scaled = mk.swe_positivity_scale(a, flux.clone(), sk)
        print(f"  {name}: {int((sk < 1).sum())} donor factors below 1")
        for what, t in (("flux", flux), ("courant", courant),
                        ("q_out", o.q_out), ("prim", o.prim),
                        ("drain", sk), ("scaled flux", scaled)):
            kept[f"{name} {what}"] = np.array(digest(t))
        del op, q, bv, flux, courant, o, sk, scaled, work
        torch.cuda.empty_cache()
    return kept, rows


def compare(kept, against):
    """Print K5's largest ulp distance and the bitwise equality of every
    other output against another run's --outputs."""
    other = np.load(against)
    for k in sorted(kept):
        if k not in other:
            print(f"against {against}: no {k}")
        elif kept[k].dtype.kind == "f":
            print(f"against {against}: {k} largest difference "
                  f"{ulps(kept[k], other[k])} ulp "
                  f"(max abs {float(np.abs(kept[k] - other[k]).max()):.3e})")
        else:
            print(f"against {against}: {k} "
                  f"{'bit for bit' if str(kept[k]) == str(other[k]) else 'DIFFERS'}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=2048)
    ap.add_argument("--ny", type=int, default=1408)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--package-root", default=None)
    ap.add_argument("--cases", choices=("raster", "gathers", "all"),
                    default="all")
    ap.add_argument("--work", default=os.path.join(ROOT, "output",
                                                   "kernel_times"))
    ap.add_argument("--outputs", default=None)
    ap.add_argument("--against", default=None)
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
    dev = torch.device("cuda")
    if args.cases != "raster":
        built = build.build_all(["swe_eta_vertex", "swe_edge_flux",
                                 "swe_cell_stage", "swe_positivity"],
                                force=True)
        for name, (secs, _) in built.items():
            print(f"nvcc {name} ({secs:.1f} s)")
        kept, _ = time_gathers(args, dev)
        if args.outputs:
            os.makedirs(os.path.dirname(os.path.abspath(args.outputs)),
                        exist_ok=True)
            np.savez(args.outputs, **kept)
        if args.against:
            compare(kept, args.against)
        if args.cases == "gathers":
            print(f"card: {card()}")
            return 0
    built = build.build_all(["swe_raster_step", "swe_raster_muscl",
                             "courant_argmax"], force=True)
    for name, (secs, report) in built.items():
        lines = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
        print(f"nvcc {name} ({secs:.1f} s):\n  " + "\n  ".join(lines))

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
