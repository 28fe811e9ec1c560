#!/usr/bin/env python3
"""Where K2's (or K2 MUSCL's) time goes: the raster step kernel with
phases taken out.

    python3 tools/torch_k2_ablation.py [--nx 2048] [--ny 1408] [--reps 50]
                                       [--rounds 2] [--muscl]

Builds, beside the package's own library, copies of
csrc/swe_raster_step.cu with one part of the kernel taken out (its loop
run zero times, behind a runtime test the compiler cannot fold):

- "no faces": phase B, the Roe solves;
- "cell phase alone": phases A and B (the loads of q, the ghosts and the
  preparation of the cells, and the faces);
- "cached loads": every block loads the first tile's cells, which then
  come from the caches instead of device memory;
- "the other tiles": 32 x 8 flow only and 32 x 16 with tracers, against
  the kernel's choice (a correct kernel).

and times each (an euler stage with the primitives, flow only and with
three tracer rows, on a random wet raster of nx x ny cells made with numpy
from a fixed seed) beside the full kernel, in turns, by torch.profiler's
device time. The variants but the last compute nonsense: only their times
are printed. Prints the card's name and power limit. Needs a CUDA device.

With --muscl, the same for csrc/swe_raster_muscl.cu (K2 MUSCL, minmod,
flow only) and its four phases: "no loads" (A, the stencil and its
ghosts), "no faces" (B, the gradients, MUSCL faces and Roe solves), "no
donors" (C), "no cell phase" (D, the update and its stores), "cell phase
alone" (A to C out), "cached loads"; and, correct kernels, each checked
bit for bit against the kernel (out and prim; the tile maxima, or in
another tile their largest): "gradient phase" (the normal gradients'
extrapolations of every cell that a face reads formed once, in a phase of
their own before the faces, into six more planes of shared memory,
instead of by each face from its cells' states), "32x8" (the other tile),
the launch bounds asking for no number of blocks an SM (the registers
unbounded) and for 6 (fewer registers) instead of the kernel's 5.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.torch_kernel_times import card, device_ms  # noqa: E402

LOAD_A = "  for (int k = tid; k < H; k += kRasterThreads) {\n    const int li = k % W, lj = k / W;"
FACES = "  for (int k = tid; k < T::kFxPad + T::kFy; k += kRasterThreads) {"
NEVER = "(p.rhs_mode == 12345 ? 1 : 0)"
TILE_ROWS = "constexpr int kTileRows = NT == 0 ? 16 : 8;"
# each variant: (source text, its replacement)
VARIANTS = {
    "full kernel": [],
    "no faces": [(FACES, FACES.replace("T::kFxPad + T::kFy", NEVER))],
    "cell phase alone": [(FACES, FACES.replace("T::kFxPad + T::kFy", NEVER)),
                         (LOAD_A, LOAD_A.replace("k < H", "k < " + NEVER))],
    "cached loads": [
        ("    const int64_t i = i0 + li - 1, j = j0 + lj - 1, g = p.row0 + j;",
         "    const int64_t i = li - 1, j = lj - 1, g = p.row0 + j;")],
    "the other tiles": [(TILE_ROWS, TILE_ROWS.replace("16 : 8", "8 : 16"))],
}
# the tile each variant launches with nt tracer rows
TILES = {"the other tiles": lambda nt: (32, 8) if nt == 0 else (32, 16)}

# K2 MUSCL: the loops of its phases A to D
M_LOOPS = {
    "A": "  for (int k = tid; k < NB; k += kRasterThreads) {",
    "B": "  for (int k = tid; k < T::kX + T::kY; k += kRasterThreads) {",
    "C": "  for (int k = tid; k < NS; k += kRasterThreads) {",
    "D": "  for (int ly = threadIdx.y; ly < TY; ly += T::kRowThreads) {",
}
M_BOUNDS = ("__launch_bounds__(kRasterThreads, 5)\n"
            "    swe_raster_muscl_step_kernel")


M_TILE = "constexpr int kTileX = 32, kTileY = 16;"
# the tile each K2 MUSCL variant launches
M_TILES = {"32x8": (32, 8)}
# K2 MUSCL with the gradients in a phase of their own: the box's planes 3-5
# hold the x extrapolations g * hd of its cells, 6-8 the y ones
GRADIENT_PHASE = [
    ("  static constexpr int kFOff = kBoxOff + 3 * kBox;",
     "  static constexpr int kGX = TY * (TX + 4) + 2 * (TX + 2);\n"
     "  static constexpr int kGY = TX * (TY + 4) + 2 * (TY + 2);\n"
     "  static constexpr int kFOff = kBoxOff + 9 * kBox;"),
    ("""  const float half_inv = 0.5f * inv_d;
  // l's weights (its upper neighbour r is on the raster) and r's
  const float cl_hi = has_lo ? half_inv : inv_d;
  const float cl_lo = has_lo ? half_inv : 0.0f;
  const float cr_hi = has_hi ? half_inv : 0.0f;
  const float cr_lo = has_hi ? half_inv : inv_d;
""", "  (void)has_lo, (void)has_hi, (void)inv_d, (void)hd;\n"),
    ("""    const float gl = __fmul_rn(cl_hi, dq) + __fmul_rn(cl_lo, ql - Bw[l - d]);
    const float gr = __fmul_rn(cr_hi, Bw[r + d] - qr) + __fmul_rn(cr_lo, dq);
    const float xl = wall ? 0.0f : __fmul_rn(gl, hd);
    const float xr = wall ? 0.0f : -__fmul_rn(gr, hd);
""", """    const float* Ew = B + ((d == 1 ? 3 : 6) + w) * nb;
    const float xl = wall ? 0.0f : Ew[l];
    const float xr = wall ? 0.0f : -Ew[r];
"""),
    ("  const float hdx = p.hdx, hdy = p.hdy;\n", """  const float hdx = p.hdx, hdy = p.hdy;
  // the extrapolations of the cells that the faces read, x then y: of the
  // tile's lines from -2 to the extent + 1, of the lines beside it from -1
  // to the extent
#pragma unroll 1
  for (int k = tid; k < T::kGX + T::kGY; k += kRasterThreads) {
    const bool x = k < T::kGX;
    const int e = x ? k : k - T::kGX;
    const int la = x ? TX : TY, lc = x ? TY : TX;
    const int ntile = lc * (la + 4), e2 = e - ntile, line = e / (la + 4);
    const int across = e < ntile ? line : (e2 < la + 2 ? -1 : lc);
    const int along = e < ntile ? e - line * (la + 4) - 2
                                : (e2 < la + 2 ? e2 - 1 : e2 - (la + 3));
    const int pos = (x ? i0 : g0) + along, n_axis = x ? nx : ny;
    const int b = x ? T::box(along, across) : T::box(across, along);
    const int d = x ? 1 : T::kBW;
    const bool has_lo = pos > 0, has_hi = pos + 1 < n_axis;
    const float inv_d = x ? inv_dx : inv_dy, hd = x ? hdx : hdy;
    const float half_inv = 0.5f * inv_d;
    const float c_hi = has_hi ? (has_lo ? half_inv : inv_d) : 0.0f;
    const float c_lo = has_lo ? (has_hi ? half_inv : inv_d) : 0.0f;
    float* E = B + (x ? 3 : 6) * NB;
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      const float* Bw = B + w * NB;
      const float qc = Bw[b];
      const float g = __fmul_rn(c_hi, Bw[b + d] - qc)
                      + __fmul_rn(c_lo, qc - Bw[b - d]);
      E[w * NB + b] = __fmul_rn(g, hd);
    }
  }
  __syncthreads();
"""),
]


def never(phase):
    """(the loop of K2 MUSCL's phase, the loop run zero times)"""
    loop = M_LOOPS[phase]
    bound = loop.split(" < ")[1].split(";")[0]
    return loop, loop.replace(bound, NEVER)


MUSCL_VARIANTS = {
    "full kernel": [],
    "no loads": [never("A")],
    "no faces": [never("B")],
    "no donors": [never("C")],
    "no cell phase": [never("D")],
    "cell phase alone": [never(x) for x in "ABC"],
    "cached loads": [
        ("    const int i = i0 + li, j = j0 + lj, g = row0 + j;",
         "    const int i = li, j = lj, g = row0 + j;")],
    "gradient phase": GRADIENT_PHASE,
    "32x8": [(M_TILE, M_TILE.replace("16", "8"))],
    "unbounded registers": [(M_BOUNDS, M_BOUNDS.replace(", 5)", ")"))],
    "6 blocks an SM": [(M_BOUNDS, M_BOUNDS.replace(", 5)", ", 6)"))],
}


def build_variants(out_dir, variants=VARIANTS, source="swe_raster_step"):
    from rdycore_tpu_torch.ops.kernels import build

    src_dir = os.path.join(ROOT, "rdycore_tpu_torch", "ops", "kernels", "csrc")
    procs = {}
    for name, subs in variants.items():
        d = os.path.join(out_dir, name.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        for fn in os.listdir(src_dir):
            shutil.copy(os.path.join(src_dir, fn), d)
        path = os.path.join(d, f"{source}.cu")
        text = open(path).read()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        open(path, "w").write(text)
        lib = os.path.join(d, "lib.so")
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=2048)
    ap.add_argument("--ny", type=int, default=1408)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--muscl", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_ablation: needs a CUDA device")
        return 1
    from rdycore_tpu_torch.ops.kernels import build
    from rdycore_tpu_torch.ops.kernels import raster_step as rs

    print(f"card: {card()}")
    if args.muscl:
        return muscl_ablation(args)
    libs = build_variants(os.path.join(build._BUILD_DIR, "k2_ablation"))
    for lib in libs.values():
        for fn, argtypes in rs._FUNCTIONS.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int

    dev = torch.device("cuda")
    nx, ny = args.nx, args.ny
    rng = np.random.default_rng(0)
    h = np.where(np.arange(nx)[None, :] < nx // 2, 0.25, 0.05) * rng.uniform(
        0.9, 1.1, (ny, nx))

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

    flow = [h, h * rng.normal(0, 0.3, h.shape), h * rng.normal(0, 0.3, h.shape)]
    states = {"flow": t(np.stack(flow).reshape(3, -1)),
              "NT = 3": t(np.concatenate([
                  flow, h * rng.uniform(0, 1e-3, (3,) + h.shape)]).reshape(
                      6, -1))}
    geo = [t(np.zeros((ny, nx))), t(np.zeros((ny, nx))),
           t(np.full((ny, nx), 0.018))]
    plan = rs.StructuredPlan(nx, ny, 1 / 512, 1 / 512, 1e-7, 0.0, 1, 2, 1, 1)
    dt = t(0.0005)
    kernel_tiles = rs.tile_for
    times = {}
    for _ in range(args.rounds):
        for name, lib in list(libs.items()) + list(libs.items())[::-1]:
            # the wrapper launches whichever library is loaded under its
            # name, in the tile its tile_for gives
            build._libs["swe_raster_step"] = lib
            rs.tile_for = TILES.get(name, kernel_tiles)
            for state, q in states.items():
                if state != "flow" and name not in ("full kernel",
                                                    "the other tiles"):
                    continue
                times.setdefault((name, state), []).append(device_ms(
                    lambda: rs.swe_raster_step(
                        plan, q, *geo, dt, stage=(0.0, 1.0, 1.0),
                        emit_prim=True, num_sediment=min(2, q.shape[0] - 3)),
                    args.reps))
            rs.tile_for = kernel_tiles
    for (name, state), ts in times.items():
        print(f"K2 {name}, {state}, euler stage with prim, {nx * ny} cells: "
              f"ms {', '.join(f'{x:.4f}' for x in ts)}; median "
              f"{float(np.median(ts)):.4f}")
    print(f"card: {card()}")
    return 0


def muscl_ablation(args) -> int:
    """K2 MUSCL's variants, an euler stage with the primitives (minmod),
    in turns."""
    from rdycore_tpu_torch.ops.kernels import build
    from rdycore_tpu_torch.ops.kernels import raster_muscl as rm
    from rdycore_tpu_torch.ops.kernels import raster_step as rs

    libs = build_variants(os.path.join(build._BUILD_DIR, "k2_muscl_ablation"),
                          MUSCL_VARIANTS, "swe_raster_muscl")
    for lib in libs.values():
        for fn, argtypes in rm._FUNCTIONS.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    dev = torch.device("cuda")
    nx, ny = args.nx, args.ny
    rng = np.random.default_rng(0)
    h = np.where(np.arange(nx)[None, :] < nx // 2, 0.25, 0.05) * rng.uniform(
        0.9, 1.1, (ny, nx))

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

    q = t(np.stack([h, h * rng.normal(0, 0.3, h.shape),
                    h * rng.normal(0, 0.3, h.shape)]).reshape(3, -1))
    geo = [t(np.zeros((ny, nx))), t(np.zeros((ny, nx))),
           t(np.full((ny, nx), 0.018))]
    plan = rs.StructuredPlan(nx, ny, 1 / 512, 1 / 512, 1e-7, 0.0, 1, 2, 1, 1)
    dt = t(0.00025)
    kernel_tile = rm.TILE
    times, outs = {}, {}
    names = list(libs)
    for _ in range(args.rounds):
        for name in names + names[::-1]:
            # the wrapper launches whichever library is loaded under its
            # name, and sizes the tile maxima by rm.TILE
            build._libs["swe_raster_muscl"] = libs[name]
            rm.TILE = M_TILES.get(name, kernel_tile)
            times.setdefault(name, []).append(device_ms(
                lambda: rm.swe_raster_muscl_step(
                    plan, q, *geo, dt, None, "minmod", stage=(0.0, 1.0, 1.0),
                    emit_prim=True), args.reps))
            outs[name] = rm.swe_raster_muscl_step(
                plan, q, *geo, dt, None, "minmod", stage=(0.0, 1.0, 1.0),
                emit_prim=True)
            rm.TILE = kernel_tile
    want = outs["full kernel"]
    for name, ts in times.items():
        tile = M_TILES.get(name, kernel_tile)
        got = outs[name]
        same = ""
        if name in ("gradient phase", "32x8", "unbounded registers",
                    "6 blocks an SM"):
            cm = (torch.equal(got.cmax, want.cmax) if tile == kernel_tile
                  else torch.equal(got.cmax.max(), want.cmax.max()))
            bits = (torch.equal(got.out, want.out)
                    and torch.equal(got.prim, want.prim) and cm)
            same = f"; bit for bit the kernel: {'yes' if bits else 'NO'}"
        print(f"K2 MUSCL {name}, tile {tile[0]}x{tile[1]}, euler stage with "
              f"prim, {nx * ny} cells: ms {', '.join(f'{x:.4f}' for x in ts)}"
              f"; median {float(np.median(ts)):.4f}{same}")
    print(f"card: {card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
