#!/usr/bin/env python3
"""Where K2's time goes: the raster step kernel with phases taken out.

    python3 tools/torch_k2_ablation.py [--nx 2048] [--ny 1408] [--reps 50]
                                       [--rounds 2]

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


def build_variants(out_dir):
    from rdycore_tpu_torch.ops.kernels import build

    src_dir = os.path.join(ROOT, "rdycore_tpu_torch", "ops", "kernels", "csrc")
    procs = {}
    for name, subs in VARIANTS.items():
        d = os.path.join(out_dir, name.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        for fn in os.listdir(src_dir):
            shutil.copy(os.path.join(src_dir, fn), d)
        path = os.path.join(d, "swe_raster_step.cu")
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_ablation: needs a CUDA device")
        return 1
    from rdycore_tpu_torch.ops.kernels import build
    from rdycore_tpu_torch.ops.kernels import raster_step as rs

    print(f"card: {card()}")
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


if __name__ == "__main__":
    sys.exit(main())
