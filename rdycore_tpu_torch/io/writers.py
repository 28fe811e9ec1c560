"""Output monitors: XDMF/HDF5 output, PETSc-binary output, checkpoints
and time series.

The reference registers TSMonitors for output (xdmf_output.c),
checkpoints (checkpoint.c) and time series (time_series.c); here monitors
are per-coupling-interval callbacks on the Simulation. XDMF and CGNS
(io/cgns.py) write HDF5 through h5py, imported when a file is written;
where it is absent a deck asking for them fails at setup with a
ConfigError naming h5py (io/hdf5.py). In a run of several ranks every
rank gathers what a file holds (the getters are collective) and rank 0
alone writes it (`Simulation.is_writer`).
"""

from __future__ import annotations

import math
import os
from typing import TYPE_CHECKING

import numpy as np

from ..config.schema import time_to_seconds
from .hdf5 import require_h5py

if TYPE_CHECKING:
    from ..simulation import Simulation

# output field name -> (array source, component) following the reference's
# field names (ex2b_ic_file.yaml output.fields)
_FIELD_COMPONENTS = {
    "Height": ("sol", 0),
    "MomentumX": ("sol", 1),
    "MomentumY": ("sol", 2),
    "VelocityX": ("prim", 1),
    "VelocityY": ("prim", 2),
    "WaterSource": ("src", 0),
    "MomentumXSource": ("src", 1),
    "MomentumYSource": ("src", 2),
}

DEFAULT_FIELDS = ["Height", "MomentumX", "MomentumY"]


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
    if cfg.output.format == "xdmf":
        sim.add_monitor(XDMFWriter(sim))
    elif cfg.output.format == "binary":
        sim.add_monitor(BinaryWriter(sim))
    elif cfg.output.format == "cgns":
        from .cgns import CGNSWriter

        sim.add_monitor(CGNSWriter(sim))
    if cfg.checkpoint.interval:
        from .checkpoint import CheckpointMonitor

        sim.add_monitor(CheckpointMonitor(sim))
    if cfg.output.time_series.boundary_fluxes or (
        cfg.output.time_series.observations.interval
        and cfg.output.time_series.observations.sites.cells
    ):
        from .time_series import TimeSeriesMonitor

        sim.add_monitor(TimeSeriesMonitor(sim))


def collect_output_fields(sim: "Simulation", fields) -> list:
    """[(name, values over the cells)] of the configured output fields in
    the current state: the reference's field names and their dt-weighted
    '_Mean' variants (xdmf_output.c:179-241)."""
    sol = sim.get_solution()
    src = sim.ext_src.cpu().numpy()
    atime = sim.accum_time
    prim = None
    out = []
    for name in fields:
        mean = name.endswith("_Mean")
        spec = _FIELD_COMPONENTS.get(name[:-5] if mean else name)
        if spec is None:
            continue
        kind, comp = spec
        if kind == "src":
            data = src[comp]
        elif mean and atime > 0:
            acc = sim.accum_sol if kind == "sol" else sim.accum_prim
            data = acc[comp] / atime
        elif kind == "sol":
            data = sol[comp]
        else:
            if prim is None:
                prim = _primitives(sim, sol)
            data = prim[comp]
        out.append((name, np.asarray(data)))
    return out


def _primitives(sim: "Simulation", sol: np.ndarray) -> np.ndarray:
    """(h, u, v) with the reference's regularized velocities."""
    h = sol[0]
    tiny = sim.config.physics.flow.tiny_h
    ha = sim.config.physics.flow.h_anuga_reg_parameter
    denom = h * h + ha * ha
    denom = np.where(denom > 0, denom, 1.0)
    wet = h >= tiny
    return np.stack([h, np.where(wet, sol[1] * h / denom, 0.0),
                     np.where(wet, sol[2] * h / denom, 0.0)])


class SnapshotCadence:
    """When a snapshot is due: every output.time_interval of simulated
    time when it is set, else every output_interval steps, and at the end
    of the run."""

    def __init__(self, cfg):
        self.interval = cfg.output.output_interval or 1
        self.time_interval = (
            time_to_seconds(cfg.output.time_interval, cfg.output.time_unit)
            if cfg.output.time_interval else 0.0)
        self._next_time = self.time_interval
        self._last_step = -1

    def due(self, sim: "Simulation") -> bool:
        if sim.step == self._last_step:
            return False
        if self.time_interval:
            if not (sim.t + 1e-12 >= self._next_time or sim.finished):
                return False
            while self._next_time <= sim.t + 1e-12:
                self._next_time += self.time_interval
        elif not (sim.step % self.interval == 0 or sim.finished):
            return False
        self._last_step = sim.step
        return True


class XDMFWriter:
    """HDF5 heavy data and XMF light XML, in natural cell order
    (xdmf_output.c:254-434): the grid in '<prefix>.grid.h5', the snapshots
    in files of output.batch_size snapshots (or, with batch_size 1 and a
    start date, one timestamped file each), one XMF referencing them."""

    def __init__(self, sim: "Simulation"):
        self.h5py = require_h5py("output.format: xdmf",
                                 "output.format: binary")
        self.sim = sim
        cfg = sim.config
        self.dir = os.path.join(cfg.config_dir, cfg.output.directory)
        os.makedirs(self.dir, exist_ok=True)
        self.prefix = cfg.output.prefix or "output"
        self.fields = cfg.output.fields or DEFAULT_FIELDS
        self.cadence = SnapshotCadence(cfg)
        self.batch_size = max(cfg.output.batch_size, 1)
        self._wrote_grid = False
        self._times = []
        self._opened_batches = set()
        self._write_step()  # the initial condition

    def __call__(self, sim: "Simulation"):
        if self.cadence.due(sim):
            self._write_step()

    def _h5_for_snapshot(self, index: int) -> str:
        if self.batch_size == 1 and self.sim.config.time.date:
            t = self._times[index] if index < len(self._times) else self.sim.t
            return output_filename(
                self.sim.config, self.dir, self.prefix, index, t, "h5")
        batch = index // self.batch_size
        return os.path.join(self.dir, f"{self.prefix}.{batch:03d}.h5")

    def _write_step(self):
        sim, h5py = self.sim, self.h5py
        fields = collect_output_fields(sim, self.fields)  # every rank
        if not sim.is_writer:
            self._times.append(sim.t)
            return
        if not self._wrote_grid:
            grid_path = os.path.join(self.dir, f"{self.prefix}.grid.h5")
            with h5py.File(grid_path, "w") as f:
                grid = f.require_group("grid")
                grid.create_dataset("topology", data=mixed_topology(sim.mesh))
                grid.create_dataset("points", data=sim.mesh.points)
            self._wrote_grid = True
        snap = len(self._times)
        path = self._h5_for_snapshot(snap)
        # a batch file is truncated the first time this run writes it, so
        # no snapshot of an earlier run's file survives
        mode = "a" if path in self._opened_batches else "w"
        self._opened_batches.add(path)
        with h5py.File(path, mode) as f:
            g = f.require_group(f"{snap}")
            for name, data in fields:
                g.create_dataset(name, data=data)
            g.attrs["time"] = sim.t
            g.attrs["step"] = sim.step
        self._times.append(sim.t)
        self._write_xmf()

    def _write_xmf(self):
        mesh = self.sim.mesh
        grid_h5 = f"{self.prefix}.grid.h5"
        ncells, npts = mesh.num_cells, mesh.num_vertices
        topo_len = int(np.sum(mesh.cell_num_vertices)) + ncells
        parts = [
            '<?xml version="1.0" ?>',
            '<Xdmf Version="3.0">',
            "<Domain>",
            '<Grid Name="time_series" GridType="Collection" '
            'CollectionType="Temporal">',
        ]
        for i, t in enumerate(self._times):
            h5 = os.path.basename(self._h5_for_snapshot(i))
            parts += [
                f'<Grid Name="step_{i}" GridType="Uniform">',
                f'<Time Value="{t}"/>',
                f'<Topology TopologyType="Mixed" NumberOfElements="{ncells}">',
                f'<DataItem Format="HDF" Dimensions="{topo_len}">'
                f"{grid_h5}:/grid/topology</DataItem>",
                "</Topology>",
                '<Geometry GeometryType="XYZ">',
                f'<DataItem Format="HDF" Dimensions="{npts} 3">'
                f"{grid_h5}:/grid/points</DataItem>",
                "</Geometry>",
            ]
            for name in self.fields:
                parts += [
                    f'<Attribute Name="{name}" Center="Cell">',
                    f'<DataItem Format="HDF" Dimensions="{ncells}">'
                    f"{h5}:/{i}/{name}</DataItem>",
                    "</Attribute>",
                ]
            parts.append("</Grid>")
        parts += ["</Grid>", "</Domain>", "</Xdmf>"]
        with open(os.path.join(self.dir, f"{self.prefix}.xmf"), "w") as f:
            f.write("\n".join(parts))


def mixed_topology(mesh, codes=(4, 5), offset=0) -> np.ndarray:
    """Each cell's type code (codes[0] for a triangle, codes[1] for a
    quadrilateral) followed by its vertex ids + offset, cell after cell:
    XDMF's mixed element list (Triangle 4, Quadrilateral 5) and, with CGNS's
    codes and 1-based ids, its MIXED connectivity."""
    nv = np.asarray(mesh.cell_num_vertices, dtype=np.int64)
    cv = np.asarray(mesh.cell_vertices, dtype=np.int64)
    width = cv.shape[1] + 1
    table = np.empty((mesh.num_cells, width), dtype=np.int64)
    table[:, 0] = np.where(nv == 3, codes[0], codes[1])
    table[:, 1:] = cv + offset
    keep = np.arange(width)[None, :] <= nv[:, None]
    return table[keep]


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
        if sim.is_writer:
            write_petsc_vec(path, blocked)
