"""Forcing: rainfall source datasets and water-level boundary datasets.

Mirrors src/forcing/ (rdyforcing.c, rdyforcing_dataset.c, rdyforcing_map.c):

- CONSTANT: fixed rain rate [m/s] over the whole domain
- HOMOGENEOUS: spatially constant, temporally varying; a PETSc binary Vec of
  (time, value) pairs, with optional linear interpolation in time
  (RDyForcingGetCurrentData, rdyforcing_dataset.c:32-67)
- RASTER: hourly gridded files '<dir>/<YYYY-MM-DD>:<HH>-<MM>.<idtype>.bin'
  with header [ncols, nrows, xlc, ylc, cellsize] then row-major values;
  nearest-cell map raster -> mesh (rdyforcing_dataset.c:105-145)
- UNSTRUCTURED: per-point datasets on another mesh, nearest-neighbor mapped
- MULTI_HOMOGENEOUS: one homogeneous dataset per region / per boundary

Applied between coupling intervals: sources via set_regional_water_source /
set_domain_water_source, water levels via
set_flow_dirichlet_boundary_values (RDyApplyForcing, rdyforcing.c:688-773).

The counterpart of the JAX package's forcing.py: numpy and scipy on the
host, the port's io/petsc_binary.py for the files and its Simulation's
setters for the values, which put them on the simulation's device.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, TYPE_CHECKING

import numpy as np

from .constants import N_FLOW_DOF
from .io.petsc_binary import read_petsc_vec, write_petsc_vec

if TYPE_CHECKING:
    from .simulation import Simulation


def interp_time_series(pairs: np.ndarray, t: float, interpolate: bool) -> float:
    """pairs: [n, 2] (time, value). Piecewise-constant (lower) or linear.
    Past the last time, the last value holds (rdyforcing_dataset.c:55-63)."""
    times = pairs[:, 0]
    vals = pairs[:, 1]
    if t < times[0]:
        return float(vals[0])
    i = int(np.searchsorted(times, t, side="right") - 1)
    if i >= len(times) - 1:
        return float(vals[-1])
    if interpolate:
        t0, t1 = times[i], times[i + 1]
        w = (t - t0) / (t1 - t0)
        return float(vals[i] + w * (vals[i + 1] - vals[i]))
    return float(vals[i])


@dataclasses.dataclass
class ConstantRain:
    rate: float  # [m/s]

    def rate_at(self, t: float) -> float:
        return self.rate


@dataclasses.dataclass
class HomogeneousDataset:
    """Spatially constant, temporally varying series from a PETSc binary."""

    filename: str
    temporally_interpolate: bool = False

    def __post_init__(self):
        vals = read_petsc_vec(self.filename)
        if len(vals) % 2:
            raise ValueError(
                f"{self.filename}: homogeneous dataset must hold (t, v) pairs"
            )
        self.pairs = vals.reshape(-1, 2)

    def value_at(self, t: float) -> float:
        return interp_time_series(self.pairs, t, self.temporally_interpolate)


def dataset_filename(directory: str, date: datetime.datetime, idtype="int32"):
    """'<dir>/<YYYY-MM-DD>:<HH>-<MM>.<idtype>.bin'
    (RDyForcingDetermineDatasetFilename, rdyforcing_dataset.c:108-116)."""
    return os.path.join(
        directory,
        f"{date.year:04d}-{date.month:02d}-{date.day:02d}:"
        f"{date.hour:02d}-{date.minute:02d}.{idtype}.bin",
    )


@dataclasses.dataclass
class RasterDataset:
    """Hourly gridded rain rasters mapped to mesh cells by nearest cell."""

    directory: str
    start_date: datetime.datetime
    mesh_xy: np.ndarray  # [C, 2] mesh cell centroids
    idtype: str = "int32"
    map_file: str = ""  # optional cached data->mesh map

    def __post_init__(self):
        self.current_date = self.start_date
        self._load_current()
        if self.map_file and os.path.exists(self.map_file):
            self.data2mesh = read_petsc_vec(self.map_file).astype(np.int64)
        else:
            col = np.clip(
                np.round((self.mesh_xy[:, 0] - self.xlc) / self.cellsize),
                0, self.ncols - 1,
            ).astype(np.int64)
            row = np.clip(
                np.round((self.mesh_xy[:, 1] - self.ylc) / self.cellsize),
                0, self.nrows - 1,
            ).astype(np.int64)
            self.data2mesh = row * self.ncols + col
            if self.map_file:
                write_petsc_vec(self.map_file, self.data2mesh.astype(np.float64))

    def _load_current(self):
        path = dataset_filename(self.directory, self.current_date, self.idtype)
        vals = read_petsc_vec(path)
        self.ncols = int(vals[0])
        self.nrows = int(vals[1])
        self.xlc = vals[2]
        self.ylc = vals[3]
        self.cellsize = vals[4]
        self.grid_values = vals[5:]

    def advance_to(self, t_hours: float):
        """Advance to the file covering start_date + t_hours (hourly files)."""
        target = self.start_date + datetime.timedelta(hours=int(t_hours))
        if target != self.current_date:
            self.current_date = target
            self._load_current()

    def rates_at(self, t_seconds: float) -> np.ndarray:
        self.advance_to(t_seconds / 3600.0)
        return self.grid_values[self.data2mesh]


@dataclasses.dataclass
class UnstructuredDataset:
    """Per-point hourly datasets on an auxiliary point cloud, mapped to mesh
    elements (cells or boundary edges) by nearest neighbor."""

    directory: str
    start_date: datetime.datetime
    mesh_xy: np.ndarray  # [n, 2] target coordinates
    data_xy: np.ndarray  # [m, 2] dataset point coordinates
    stride: int = 1  # values per data point per record
    idtype: str = "int32"

    def __post_init__(self):
        from scipy.spatial import cKDTree

        self.current_date = self.start_date
        self._tree = cKDTree(self.data_xy)
        _, self.data2mesh = self._tree.query(self.mesh_xy)
        self._load_current()

    def _load_current(self):
        path = dataset_filename(self.directory, self.current_date, self.idtype)
        self.values = read_petsc_vec(path)

    def advance_to(self, t_hours: float):
        target = self.start_date + datetime.timedelta(hours=int(t_hours))
        if target != self.current_date:
            self.current_date = target
            self._load_current()

    def values_at(self, t_seconds: float) -> np.ndarray:
        """[n, stride] values mapped to the mesh elements."""
        self.advance_to(t_seconds / 3600.0)
        vals = self.values.reshape(-1, self.stride)
        return vals[self.data2mesh]


@dataclasses.dataclass
class Forcing:
    """Aggregated forcing: one source dataset + one boundary dataset, or
    per-region / per-boundary multi-homogeneous sets."""

    # sources
    constant_rain: Optional[ConstantRain] = None
    homogeneous_rain: Optional[HomogeneousDataset] = None
    raster_rain: Optional[RasterDataset] = None
    unstructured_rain: Optional[UnstructuredDataset] = None
    regional_rain: Dict[str, HomogeneousDataset] = dataclasses.field(
        default_factory=dict
    )
    # boundary conditions (water level h at Dirichlet boundaries)
    homogeneous_bc: Dict[str, HomogeneousDataset] = dataclasses.field(
        default_factory=dict
    )
    unstructured_bc: Dict[str, UnstructuredDataset] = dataclasses.field(
        default_factory=dict
    )

    def apply(self, sim: "Simulation", t: float) -> None:
        """RDyApplyForcing (rdyforcing.c:688-773): update source vec and
        Dirichlet boundary values for the next coupling interval."""
        if self.constant_rain is not None:
            sim.set_domain_water_source(self.constant_rain.rate_at(t))
        if self.homogeneous_rain is not None:
            sim.set_domain_water_source(self.homogeneous_rain.value_at(t))
        if self.raster_rain is not None:
            sim.set_domain_water_source(self.raster_rain.rates_at(t))
        if self.unstructured_rain is not None:
            sim.set_domain_water_source(
                self.unstructured_rain.values_at(t)[:, 0]
            )
        for region, ds in self.regional_rain.items():
            sim.set_regional_water_source(region, ds.value_at(t))

        for boundary, ds in self.homogeneous_bc.items():
            seg = {s.name: s for s in sim.operator.segments}[boundary]
            vals = np.zeros((N_FLOW_DOF, seg.count))
            vals[0, :] = ds.value_at(t)  # water level h; zero momentum
            sim.set_flow_dirichlet_boundary_values(boundary, vals)
        for boundary, ds in self.unstructured_bc.items():
            vals = ds.values_at(t)  # [n_edges, stride]
            sim.set_flow_dirichlet_boundary_values(boundary, vals.T)


def attach_forcing(sim: "Simulation", forcing: Forcing) -> None:
    """Apply now (t=0 ICs for sources/BCs) and before every coupling
    interval, mirroring RDyAdvance's call site (rdyadvance.c:351)."""
    forcing.apply(sim, sim.t)
    original_advance = sim.advance

    def advance_with_forcing():
        forcing.apply(sim, sim.t)
        original_advance()

    sim.advance = advance_with_forcing  # type: ignore[method-assign]
