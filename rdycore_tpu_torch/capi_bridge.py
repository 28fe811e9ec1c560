"""Byte-level bridge behind the port's embedded C API (capi/capi.c), the
counterpart of rdycore_tpu/capi_bridge.py with the same functions and the
same contract: scalars and `bytes` in and out, so the C side needs only
the stable CPython API (no NumPy or torch headers). A C or Fortran host
(coupling/rdycore_tpu.F90) drives the reference's lifecycle through it:
create, then per coupling interval set sources and boundary values,
advance and read the fields back (driver/main.F90), then destroy.

`create` builds the Simulation on the CUDA device; RDYTPU_PLATFORM=cpu
asks for the CPU (the kernels' plain versions), as it asks the JAX
bridge's host for JAX's CPU platform. Each handle keeps the host wall time
of each call of its coupling loop (the setters, advance, the field
getters, the checkpoint pair); with RDYTPU_TIMINGS=<path>, `destroy`
appends one JSON line there: those seconds, the kernel launches made since
`create`, the steps, the device and the Python installation.
"""

from __future__ import annotations

import functools
import gc
import json
import os
import sys
from time import perf_counter
from typing import Dict, List

import numpy as np

_sims: Dict[int, "_Coupled"] = {}
_next_handle = [1]


def _launch_counts() -> Dict[str, int]:
    from .ops import kernels

    return {k.__name__: k.launches for k in kernels.KERNELS}


class _Coupled:
    """A simulation behind a handle, the host seconds of each timed bridge
    call on it ({name: [seconds of each call]}) and the launch counts at
    its creation."""

    def __init__(self, sim):
        self.sim = sim
        self.timers: Dict[str, List[float]] = {}
        self.launches0 = _launch_counts()

    def report(self) -> dict:
        import torch

        now = _launch_counts()
        return {
            "timers": self.timers,
            "launches": {k: now[k] - self.launches0[k] for k in now},
            "steps": self.sim.step, "num_cells": self.sim.num_cells,
            "device": str(self.sim.device),
            "python": {"prefix": sys.prefix, "torch": torch.__file__},
        }


def _timed(fn):
    """Append the host wall seconds of each call of fn(h, ...) to h's
    timers."""
    @functools.wraps(fn)
    def call(h: int, *args):
        t0 = perf_counter()
        try:
            return fn(h, *args)
        finally:
            _sims[h].timers.setdefault(fn.__name__, []).append(
                perf_counter() - t0)
    return call


def _sim(h: int):
    return _sims[h].sim


def create(config_path: str) -> int:
    """RDyCreate + RDySetup: returns an opaque handle."""
    from .config.yaml_input import load_config
    from .simulation import Simulation

    plat = os.environ.get("RDYTPU_PLATFORM", "")
    if plat not in ("", "cpu"):
        raise ValueError(f"RDYTPU_PLATFORM={plat}: rdycore_tpu_torch runs on "
                         "the CUDA device (unset) or the CPU (cpu)")
    sim = Simulation(load_config(config_path), device=plat or None)
    h = _next_handle[0]
    _next_handle[0] += 1
    _sims[h] = _Coupled(sim)
    return h


def destroy(h: int) -> None:
    """RDyDestroy: drop the simulation once its device work is done (and
    write its timings where RDYTPU_TIMINGS asks for them)."""
    c = _sims.pop(h, None)
    if c is None:
        return
    path = os.environ.get("RDYTPU_TIMINGS")
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(c.report()) + "\n")
    if c.sim.device.type == "cuda":
        import torch

        torch.cuda.synchronize(c.sim.device)


def finalize() -> None:
    """Before the host's Py_FinalizeEx: destroy what is left, collect it,
    and wait for the device, so that no CUDA work outlives the
    interpreter."""
    for h in list(_sims):
        destroy(h)
    gc.collect()
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@_timed
def advance(h: int) -> None:
    _sim(h).advance()


def finished(h: int) -> bool:
    return bool(_sim(h).finished)


def num_cells(h: int) -> int:
    return int(_sim(h).mesh.num_cells)


def num_boundary_edges(h: int, boundary: str) -> int:
    return int(_sim(h).get_num_boundary_edges(boundary))


def time(h: int) -> float:
    return float(_sim(h).get_time())


def time_step(h: int) -> float:
    return float(_sim(h).get_time_step())


def step(h: int) -> int:
    return int(_sim(h).get_step())


def coupling_interval(h: int) -> float:
    return float(_sim(h).get_coupling_interval())


def set_coupling_interval(h: int, value: float) -> None:
    _sim(h).set_coupling_interval(value)


# ---- state getters (f64 bytes, natural cell order of the config grid) ----

def _bytes(a) -> bytes:
    return np.ascontiguousarray(a, dtype=np.float64).tobytes()


def _f64(buf: bytes) -> np.ndarray:
    return np.frombuffer(buf, dtype=np.float64).copy()


@_timed
def get_height(h: int) -> bytes:
    return _bytes(_sim(h).get_height())


@_timed
def get_x_momentum(h: int) -> bytes:
    return _bytes(_sim(h).get_x_momentum())


@_timed
def get_y_momentum(h: int) -> bytes:
    return _bytes(_sim(h).get_y_momentum())


def get_cell_areas(h: int) -> bytes:
    return _bytes(_sim(h).get_cell_areas())


def get_cell_centroids(h: int) -> bytes:  # [C, 3] row-major
    return _bytes(_sim(h).get_cell_centroids())


def get_natural_ids(h: int) -> bytes:  # int64
    return np.ascontiguousarray(_sim(h).get_natural_ids(),
                                dtype=np.int64).tobytes()


def get_manning_n(h: int) -> bytes:
    return _bytes(_sim(h).get_manning_n())


# ---- coupling setters (the driver/main.F90 pattern) ----------------------

@_timed
def set_domain_water_source(h: int, buf: bytes) -> None:
    _sim(h).set_domain_water_source(_f64(buf))


@_timed
def set_regional_water_source(h: int, region: str, buf: bytes) -> None:
    _sim(h).set_regional_water_source(region, _f64(buf))


@_timed
def set_manning_n(h: int, buf: bytes) -> None:
    _sim(h).set_manning_n(_f64(buf))


@_timed
def set_flow_dirichlet_boundary_values(h: int, boundary: str,
                                       buf: bytes) -> None:
    """buf: n_edges * 3 doubles, edge-major (h, hu, hv per edge, the
    reference's RDySetFlowDirichletBoundaryValues layout)."""
    _sim(h).set_flow_dirichlet_boundary_values(boundary, _f64(buf))


@_timed
def write_checkpoint(h: int, path: str) -> None:
    """RDyWriteHDF5CheckpointFile: `.bin` PETSc binary, else HDF5."""
    _sim(h).write_checkpoint(path)


@_timed
def read_checkpoint(h: int, path: str) -> None:
    """RDyReadHDF5CheckpointFile."""
    _sim(h).read_checkpoint(path)


# ---- misc API parity (RDyConvertTime, boundary metadata, one-DOF IO) -----

def convert_time(value: float, unit_from: str, unit_to: str) -> float:
    """RDyConvertTime."""
    from .simulation import Simulation

    return float(Simulation.convert_time(value, unit_from, unit_to))


def version() -> bytes:
    from . import __version__

    return __version__.encode()


def num_boundary_conditions(h: int) -> int:
    return int(_sim(h).get_num_boundary_conditions())


def boundary_id(h: int, boundary: str) -> int:
    return int(_sim(h).get_boundary_id(boundary))


def boundary_condition_flow_type(h: int, boundary: str) -> int:
    return int(_sim(h).get_boundary_condition_flow_type(boundary))


def get_boundary_edge_centroids(h: int, boundary: str) -> bytes:
    """[n_edges, 3] row-major (RDyGetBoundaryEdge{X,Y,Z}Centroids)."""
    return _bytes(_sim(h).get_boundary_edge_centroids(boundary))


@_timed
def get_solution(h: int) -> bytes:
    """Cell-major interleaved [C, ndof] (a PETSc Vec of block size ndof),
    the reference's RDyGetSolution layout; the simulation's is [ndof, C]."""
    return _bytes(_sim(h).get_solution().T)


def set_initial_conditions(h: int, buf: bytes) -> None:
    """RDySetInitialConditions: ndof * C doubles, cell-major interleaved
    [C, ndof] (see get_solution)."""
    sim = _sim(h)
    q = np.frombuffer(buf, dtype=np.float64).reshape(sim.mesh.num_cells, -1)
    sim.set_initial_conditions(np.ascontiguousarray(q.T))


def read_one_dof_vec(h: int, path: str) -> bytes:
    """RDyReadOneDOFGlobalVecFromBinaryFile: per-cell values in the
    simulation's cell order."""
    return _bytes(_sim(h).read_one_dof_vec_from_binary(path))


def write_one_dof_vec(h: int, path: str, buf: bytes) -> None:
    """RDyWriteOneDOFGlobalVecToBinaryFile."""
    _sim(h).write_one_dof_vec_to_binary(path, _f64(buf))
