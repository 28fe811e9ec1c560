"""CLI driver: the analogue of the reference's `rdycore` executable
(driver/main.c): create -> setup -> advance loop -> report.

Usage:
    python -m rdycore_tpu_torch <config.yaml> [--cpu] [--dt SECONDS]
                                [--f32|--f64] [--output-dir DIR]

It runs on the CUDA device, or with --cpu on the CPU (the kernels' plain
PyTorch versions). The JAX package's options for MMS, forcing datasets,
AMR and --pause are accepted and exit with status 2, naming the ROADMAP
item that will port them. Without a CUDA device and without --cpu it fails. A
fused_structured deck with parallel.n_devices = P > 1 runs in P row
strips on cuda:0..P-1 (a ConfigError with fewer cards), or on the CPU
with --cpu. Several strips on one card are asked for through the
library: Simulation(cfg, strip_devices=["cuda:0"] * P).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# The JAX package's CLI options this one lacks, each with the ROADMAP item
# that will port it: given, they exit non-zero naming it (ROADMAP fault 20)
_NOT_PORTED_OPTIONS = (
    ("--mms", dict(action="store_true"), "queue 1 item 8"),
    ("--constant-rain-rate", dict(type=float), "queue 1 item 5d"),
    ("--homogeneous-rain-file", dict(), "queue 1 item 5d"),
    ("--temporally-interpolate-rain", dict(action="store_true"),
     "queue 1 item 5d"),
    ("--raster-rain-dir", dict(), "queue 1 item 5d"),
    ("--homogeneous-bc-file", dict(metavar="BOUNDARY=FILE"),
     "queue 1 item 5d"),
    ("--amr-dataset-dir", dict(), "queue 1 item 14"),
    ("--amr-area-threshold", dict(type=float), "queue 1 item 14"),
    ("--pause", dict(action="store_true"), "queue 1 item 18"),
)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rdycore_tpu_torch")
    ap.add_argument("config", help="YAML configuration file")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--dt", type=float, default=None, help="override time step [config units]")
    ap.add_argument("--f32", action="store_true", help="force single precision")
    ap.add_argument("--f64", action="store_true", help="force double precision")
    ap.add_argument(
        "--output-dir", default=None,
        help="override output.directory (outputs normally land next to the "
             "config file)",
    )
    for opt, kw, item in _NOT_PORTED_OPTIONS:
        ap.add_argument(opt, **kw, help=f"not ported yet (ROADMAP {item})")
    args = ap.parse_args(argv)
    refused = [f"{opt} is not ported to rdycore_tpu_torch yet (ROADMAP "
               f"{item})" for opt, _, item in _NOT_PORTED_OPTIONS
               if getattr(args, opt[2:].replace("-", "_")) not in (None,
                                                                   False)]
    if refused:
        ap.exit(2, "rdycore_tpu_torch: " + "; ".join(refused) + "\n")

    from rdycore_tpu_torch.config.yaml_input import load_config
    from rdycore_tpu_torch.io.writers import attach_output_monitors
    from rdycore_tpu_torch.simulation import Simulation

    cfg = load_config(args.config)
    if args.output_dir is not None:
        cfg.output.directory = os.path.abspath(args.output_dir)
    if args.dt is not None:
        cfg.time.time_step = args.dt
    if args.f32:
        cfg.numerics.precision = "single"
    if args.f64:
        cfg.numerics.precision = "double"

    sim = Simulation(cfg, device="cpu" if args.cpu else None)
    attach_output_monitors(sim)
    sim.log.info(
        f"mesh: {sim.mesh.num_cells} cells, {sim.mesh.num_edges} edges; "
        f"dt = {sim.dt:.6g} s, t_final = {sim.t_final:.6g} s; "
        f"device {sim.device}"
    )
    t0 = time.time()
    prev_t = sim.t
    while not sim.finished:
        sim.advance()
        if not sim.t > prev_t:
            raise RuntimeError("time did not advance")  # main.c sanity check
        prev_t = sim.t
    wall = time.time() - t0
    sim.log.info(
        f"done: {sim.step} steps to t = {sim.t:.6g} s in {wall:.2f} s "
        f"({sim.step * sim.mesh.num_cells / max(wall, 1e-9):.3g} cell-updates/s)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
