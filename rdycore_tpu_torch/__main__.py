"""CLI driver: the analogue of the reference's `rdycore` executable
(driver/main.c): create -> setup -> advance loop -> report.

Usage:
    python -m rdycore_tpu_torch <config.yaml> [--cpu] [--dt SECONDS]
                                [--f32|--f64] [--output-dir DIR] [--mms]
                                [--pause] [forcing options]
                                [--amr-dataset-dir DIR]
                                [--amr-area-threshold AREA]

It runs on the CUDA device, or with --cpu on the CPU (the kernels' plain
PyTorch versions). With --mms the deck's `mms` section runs as the
reference's rdycore_mms does (`mms.MMSDriver`): its error norms, or its
convergence rates against their thresholds, exiting 0 on PASS and 1 on
FAIL. With --pause it prints its process id and waits for Enter before
setup (to attach a debugger, the reference's -pause). The forcing options
(--constant-rain-rate, --homogeneous-rain-file with
--temporally-interpolate-rain, --raster-rain-dir, --homogeneous-bc-file
BOUNDARY=FILE) apply their datasets before every coupling interval, as the
JAX package's CLI does (forcing.py). With --amr-dataset-dir, before
every coupling interval k the PETSc vector of minute k
(forcing.dataset_filename of time.date, else 2011-01-01, plus k minutes)
is read where it exists, mapped from the level-0 base mesh onto the
current mesh, and the cells where it is positive and whose area exceeds
--amr-area-threshold (default 0.125) are refined (amr.py, the reference's
driver/amr.c). Without a CUDA device and without --cpu it fails. A
fused_structured deck with parallel.n_devices = P > 1 runs in P row
strips on cuda:0..P-1 (a ConfigError with fewer cards), or on the CPU
with --cpu. Several strips on one card are asked for through the
library: Simulation(cfg, strip_devices=["cuda:0"] * P). An unstructured
deck with parallel.n_devices = P > 1 runs in P shards in this process
(parallel/sharded.py), on cuda:0..P-1 or with --cpu on the CPU.

Several ranks, one shard or row strip each:

    torchrun --standalone --nproc-per-node P -m rdycore_tpu_torch deck.yaml

joins the ranks (`parallel.comm.init_from_env`: NCCL, each rank on the
card LOCAL_RANK; with --cpu gloo on the CPU) unless a process group
exists already (a caller that made one calls main() in each rank); the
deck's parallel.n_devices must be the world size. Rank 0 writes the
outputs. With --amr-dataset-dir every rank reads the datasets and refines
the same cells (the refined mesh is partitioned again over the ranks);
the deck needs parallel.partitioning: none there (ROADMAP fault 24).
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import time

def main(argv=None):
    ap = argparse.ArgumentParser(prog="rdycore_tpu_torch")
    ap.add_argument("config", help="YAML configuration file")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--dt", type=float, default=None, help="override time step [config units]")
    ap.add_argument("--f32", action="store_true", help="force single precision")
    ap.add_argument("--f64", action="store_true", help="force double precision")
    ap.add_argument("--mms", action="store_true",
                    help="run as an MMS problem (like rdycore_mms)")
    ap.add_argument(
        "--pause", action="store_true",
        help="print the process id and wait for Enter (to attach a "
             "debugger; the reference's -pause, rdysetup.c:1292-1332)")
    ap.add_argument(
        "--output-dir", default=None,
        help="override output.directory (outputs normally land next to the "
             "config file)",
    )
    # forcing options (the F90/E3SM driver's -rain / -bc dataset options,
    # driver/main.F90:197-338)
    ap.add_argument("--constant-rain-rate", type=float, default=None,
                    help="[m/s]")
    ap.add_argument("--homogeneous-rain-file", default=None)
    ap.add_argument("--temporally-interpolate-rain", action="store_true")
    ap.add_argument("--raster-rain-dir", default=None)
    ap.add_argument("--homogeneous-bc-file", default=None,
                    metavar="BOUNDARY=FILE")
    # AMR driver options (driver/amr.c: time-stamped refinement rasters)
    ap.add_argument("--amr-dataset-dir", default=None)
    ap.add_argument("--amr-area-threshold", type=float, default=0.125)
    args = ap.parse_args(argv)

    from rdycore_tpu_torch.config.yaml_input import load_config

    if args.pause:
        print(f"rdycore_tpu_torch pid: {os.getpid()} -- press Enter to "
              "continue", flush=True)
        input()

    cfg = load_config(args.config)
    if args.output_dir is not None:
        cfg.output.directory = os.path.abspath(args.output_dir)
    if args.dt is not None:
        cfg.time.time_step = args.dt
    if args.f32:
        cfg.numerics.precision = "single"
    if args.f64:
        cfg.numerics.precision = "double"

    device = "cpu" if args.cpu else None
    joined = False
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        from rdycore_tpu_torch.parallel.comm import init_from_env

        if not dist.is_initialized():
            init_from_env(cpu=args.cpu)
            joined = True
    try:
        return run_deck(args, cfg, device)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def run_deck(args, cfg, device) -> int:
    """Run the deck as main() parsed it: the MMS driver, or the
    simulation with its outputs and forcing. Returns the exit code."""
    from rdycore_tpu_torch.forcing import attach_forcing
    from rdycore_tpu_torch.io.writers import attach_output_monitors
    from rdycore_tpu_torch.simulation import Simulation

    if args.mms:
        from rdycore_tpu_torch.mms import MMSDriver

        return 0 if MMSDriver(cfg, device=device).run() else 1

    sim = Simulation(cfg, device=device)
    attach_output_monitors(sim)
    if (
        args.constant_rain_rate is not None
        or args.homogeneous_rain_file
        or args.raster_rain_dir
        or args.homogeneous_bc_file
    ):
        attach_forcing(sim, cli_forcing(args, cfg, sim))
    sim.log.info(
        f"mesh: {sim.mesh.num_cells} cells, {sim.mesh.num_edges} edges; "
        f"dt = {sim.dt:.6g} s, t_final = {sim.t_final:.6g} s; "
        f"device {sim.device}"
    )
    amr_next = amr_driver(args, cfg) if args.amr_dataset_dir else None
    t0 = time.time()
    prev_t = sim.t
    while not sim.finished:
        if amr_next is not None:
            amr_next(sim)
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


def amr_driver(args, cfg):
    """The AMR driver's step before each coupling interval
    (driver/amr.c:205-226): it reads the dataset of the next minute, one
    minute per interval from time.date (else 2011-01-01), where the file
    exists; the dataset lives on the level-0 base mesh and reaches the
    current mesh through `sim.amr_base_map`; the cells it marks are
    refined."""
    import numpy as np

    from rdycore_tpu_torch.amr import mark_cells_from_raster
    from rdycore_tpu_torch.forcing import dataset_filename
    from rdycore_tpu_torch.io.petsc_binary import read_petsc_vec

    start = (datetime.datetime.strptime(cfg.time.date, "%Y-%m-%d")
             if cfg.time.date else datetime.datetime(2011, 1, 1))
    minute = [0]

    def amr_next(sim):
        date = start + datetime.timedelta(minutes=minute[0])
        minute[0] += 1
        path = dataset_filename(args.amr_dataset_dir, date)
        if not os.path.exists(path):
            return
        vals = read_petsc_vec(path)
        base_map = getattr(sim, "amr_base_map", None)
        if base_map is None:
            base_map = np.arange(sim.mesh.num_cells)
        marked = mark_cells_from_raster(vals[base_map], sim.mesh.cell_area,
                                        args.amr_area_threshold)
        if marked.any():
            sim.mark_cells_for_amr(marked)
            sim.perform_amr()

    return amr_next


def cli_forcing(args, cfg, sim):
    """The Forcing the forcing options ask for, as the JAX CLI builds it:
    raster rain starts at time.date, else at 2017-08-26."""
    from rdycore_tpu_torch.forcing import (
        ConstantRain,
        Forcing,
        HomogeneousDataset,
        RasterDataset,
    )

    forcing = Forcing()
    if args.constant_rain_rate is not None:
        forcing.constant_rain = ConstantRain(args.constant_rain_rate)
    if args.homogeneous_rain_file:
        forcing.homogeneous_rain = HomogeneousDataset(
            cfg.resolve_path(args.homogeneous_rain_file),
            temporally_interpolate=args.temporally_interpolate_rain,
        )
    if args.raster_rain_dir:
        start = (
            datetime.datetime.strptime(cfg.time.date, "%Y-%m-%d")
            if cfg.time.date
            else datetime.datetime(2017, 8, 26)
        )
        forcing.raster_rain = RasterDataset(
            directory=args.raster_rain_dir,
            start_date=start,
            mesh_xy=sim.mesh.cell_centroid[:, :2],
        )
    if args.homogeneous_bc_file:
        bname, _, fname = args.homogeneous_bc_file.partition("=")
        forcing.homogeneous_bc[bname] = HomogeneousDataset(
            cfg.resolve_path(fname))
    return forcing


if __name__ == "__main__":
    sys.exit(main())
