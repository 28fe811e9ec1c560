"""Output monitors: PETSc-binary output and time series.

The reference registers TSMonitors for output (xdmf_output.c), checkpoints
(checkpoint.c) and time series (time_series.c); here monitors are
per-coupling-interval callbacks on the Simulation. This package writes the
`binary` format only: XDMF and CGNS need h5py, which the CUDA machines this
package targets lack, and raise NotImplementedError.
"""

from __future__ import annotations

import math
import os
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from ..simulation import Simulation


def output_filename(cfg, directory, prefix, step, t, suffix):
    """Reference filename conventions (rdyadvance.c:65-151):

    - when time.date ("YYYY-MM-DD-hh:mm:ss", sscanf'd leniently like
      yaml_input.c:948) is set: '<prefix>.YYYY-MM-DD.hh.mm.ss.<suffix>'
      at simulation date + t seconds (GenerateTimestampedFilename);
    - otherwise '<prefix>-<step 0-padded to digits of stop_n>.<suffix>'
      (GenerateIndexedFilename).
    """
    if cfg.time.date:
        import datetime as _dt
        import re

        nums = [int(x) for x in re.findall(r"\d+", cfg.time.date)[:6]]
        nums += [0] * (6 - len(nums))
        y, mo, d, hh, mm, ss = nums
        stamp = _dt.datetime(y, mo, d, hh, mm, ss) + _dt.timedelta(
            seconds=float(t)
        )
        name = (
            f"{prefix}.{stamp.year:04d}-{stamp.month:02d}-{stamp.day:02d}"
            f".{stamp.hour:02d}.{stamp.minute:02d}.{stamp.second:02d}"
            f".{suffix}"
        )
    else:
        nd = int(math.log10(max(cfg.time.stop_n or 1, 1))) + 1
        name = f"{prefix}-{step:0{nd}d}.{suffix}"
    return os.path.join(directory, name)


def attach_output_monitors(sim: "Simulation") -> None:
    cfg = sim.config
    if cfg.output.format in ("xdmf", "cgns"):
        raise NotImplementedError(
            f"output.format: {cfg.output.format} is not ported to "
            "rdycore_tpu_torch (it needs h5py); use binary or none "
            "(ROADMAP queue 1 item 5b: checkpoints, restart, HDF5 output)"
        )
    if cfg.output.format == "binary":
        sim.add_monitor(BinaryWriter(sim))
    if cfg.output.time_series.boundary_fluxes or (
        cfg.output.time_series.observations.interval
        and cfg.output.time_series.observations.sites.cells
    ):
        from .time_series import TimeSeriesMonitor

        sim.add_monitor(TimeSeriesMonitor(sim))


class BinaryWriter:
    """PETSc-binary output (the reference's OUTPUT_BINARY viewer): one Vec
    per snapshot, solution blocked per cell in natural order, file name
    '<prefix>-<step>.bin' (DetermineOutputFile, rdyadvance.c:65-151)."""

    def __init__(self, sim: "Simulation"):
        cfg = sim.config
        self.dir = os.path.join(cfg.config_dir, cfg.output.directory)
        os.makedirs(self.dir, exist_ok=True)
        self.prefix = cfg.output.prefix or "output"
        self.interval = cfg.output.output_interval or 1
        self._last_step = -1
        self._write(sim)

    def __call__(self, sim: "Simulation"):
        due = sim.step % self.interval == 0 or sim.finished
        if due and sim.step != self._last_step:
            self._last_step = sim.step
            self._write(sim)

    def _write(self, sim: "Simulation"):
        from .petsc_binary import write_petsc_vec

        sol = sim.get_solution()  # [ndof, C]
        nat = np.argsort(sim.get_natural_ids())
        blocked = sol[:, nat].T.reshape(-1)  # cell-blocked, natural order
        path = output_filename(
            sim.config, self.dir, self.prefix, sim.step, sim.t, "bin"
        )
        write_petsc_vec(path, blocked)
