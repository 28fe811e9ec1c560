"""Checkpoint / restart (src/checkpoint.c), the counterpart of
rdycore_tpu/io/checkpoint.py: the files of either package restart the
other.

A checkpoint stores {t, dt, step} and the solution in natural cell order,
so that a restart does not depend on the cell order of the run that wrote
it (checkpoint.c:49-137, 187-203). Two formats, chosen by the path's
extension: `.bin`, the reference's PETSc-binary checkpoint (a metadata Vec
{nproc, t, dt, step}, then the solution blocked per cell), which needs
nothing beyond numpy; any other, HDF5 (attributes t, dt, step, num_cells
and the [ndof, C] dataset `solution`), which needs h5py. E3SM-style names
'<prefix>.rdycore.r.<NNNN>.<h5|bin>' (checkpoint.c:141-151). A restart
takes {t, dt, step} from the file unless restart.reinitialize, which
keeps the deck's (rdyconfigimpl.h:183-186). Neither the Courant number of
the last interval nor the accumulators are stored, as in the JAX package:
a run with adaptive dt does not restart bit for bit. In a run of several
ranks, rank 0 writes and every rank reads a restart file and scatters it.
"""

from __future__ import annotations

import os
import struct
from typing import TYPE_CHECKING

import numpy as np

from .hdf5 import require_h5py
from .petsc_binary import VEC_FILE_CLASSID, read_petsc_vecs

if TYPE_CHECKING:
    from ..simulation import Simulation


def checkpoint_filename(
    directory: str, prefix: str, step: int, fmt: str = "hdf5"
) -> str:
    ext = "h5" if fmt == "hdf5" else "bin"
    return os.path.join(directory, f"{prefix}.rdycore.r.{step:04d}.{ext}")


def _to_natural(sim: "Simulation") -> np.ndarray:
    """The columns of the simulation's cell order, taken in natural order."""
    return np.argsort(sim.get_natural_ids())


def write_checkpoint(sim: "Simulation", path: str) -> None:
    """Write the checkpoint (the state is gathered on every rank of a run
    of several; rank 0 writes)."""
    sol = sim.get_solution()[:, _to_natural(sim)]  # [ndof, C] natural order
    if not sim.is_writer:
        return
    if path.endswith(".bin"):
        meta = np.array([1.0, sim.t, sim.dt, float(sim.step)])
        with open(path, "wb") as f:
            for vec in (meta, sol.T.reshape(-1)):
                f.write(struct.pack(">ii", VEC_FILE_CLASSID, vec.size))
                f.write(vec.astype(">f8").tobytes())
        return
    h5py = require_h5py(f"the HDF5 checkpoint {path}", "a .bin path")
    with h5py.File(path, "w") as f:
        f.attrs["t"] = sim.t
        f.attrs["dt"] = sim.dt
        f.attrs["step"] = sim.step
        f.attrs["num_cells"] = sim.num_cells
        f.create_dataset("solution", data=sol)


def read_checkpoint(path: str):
    """(meta {t, dt, step, num_cells}, solution): [ndof, C] in natural order
    from HDF5; from `.bin` the blocked vector [C * ndof], num_cells None
    (the caller knows its cells)."""
    if path.endswith(".bin"):
        meta_vec, blocked = read_petsc_vecs(path)[:2]
        meta = {"t": float(meta_vec[1]), "dt": float(meta_vec[2]),
                "step": int(meta_vec[3]), "num_cells": None}
        return meta, blocked
    h5py = require_h5py(f"the HDF5 checkpoint {path}", "a .bin checkpoint")
    with h5py.File(path, "r") as f:
        meta = {k: f.attrs[k] for k in ("t", "dt", "step", "num_cells")}
        sol = np.asarray(f["solution"])
    meta = {"t": float(meta["t"]), "dt": float(meta["dt"]),
            "step": int(meta["step"]), "num_cells": int(meta["num_cells"])}
    return meta, sol


def restore_from_checkpoint(sim: "Simulation", path: str,
                            reinitialize: bool = False) -> None:
    """Set the simulation's state (and, unless `reinitialize`, its t, dt
    and step) from a checkpoint. A raster run in strips takes the whole
    state and cuts it into its strips at its next interval."""
    meta, sol = read_checkpoint(path)
    C = sim.num_cells
    if sol.ndim == 1:
        if len(sol) % C:
            raise ValueError(
                f"binary checkpoint {path} has {len(sol)} values; not a "
                f"multiple of {C} cells")
        sol = sol.reshape(C, -1).T
    if meta["num_cells"] not in (None, C):
        raise ValueError(
            f"checkpoint {path} has {meta['num_cells']} cells; the mesh has "
            f"{C}")
    natural = np.empty(C, dtype=np.int64)
    natural[_to_natural(sim)] = np.arange(C)
    sim.set_solution(sol[:, natural])
    if not reinitialize:
        sim.t, sim.dt, sim.step = meta["t"], meta["dt"], meta["step"]


class CheckpointMonitor:
    """Writes a checkpoint every checkpoint.interval steps (the reference's
    checkpoint TSMonitor), into the output directory."""

    def __init__(self, sim: "Simulation"):
        cfg = sim.config
        self.interval = cfg.checkpoint.interval
        self.prefix = cfg.checkpoint.prefix or cfg.output.prefix or "sim"
        self.fmt = cfg.checkpoint.format
        self.dir = os.path.join(cfg.config_dir, cfg.output.directory)
        os.makedirs(self.dir, exist_ok=True)
        self.last_written = -1

    def __call__(self, sim: "Simulation"):
        if (self.interval and sim.step % self.interval == 0
                and sim.step != self.last_written):
            path = checkpoint_filename(self.dir, self.prefix, sim.step,
                                       self.fmt)
            write_checkpoint(sim, path)
            sim.log.detail(f"wrote checkpoint {path}")
            self.last_written = sim.step
