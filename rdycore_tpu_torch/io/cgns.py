"""CGNS output written directly in the CGNS/HDF5 (ADF-on-HDF5) file format.

The reference's OUTPUT_CGNS path hands output to PETSc's CGNS viewer
(src/rdyadvance.c:143-146, 195-197: sequential files named
'<prefix>-<step>.cgns', the viewer batching several solution snapshots per
file). A CGNS file *is* an HDF5 file following the ADF node mapping
(every CGNS node = one HDF5 group carrying 33-byte 'name'/'label' and
3-byte 'type' attributes, node data in a dataset named ' data'), so no
CGNS library is needed: this module emits the node tree with h5py,
imported when a file is written (a ConfigError naming h5py where it is
absent). The counterpart of rdycore_tpu/io/cgns.py.

Layout per file (SIDS-standard, readable by ParaView/cgnslib):

    CGNSLibraryVersion                 R4 [4.0]
    Base                  CGNSBase_t   I4 [2, 3]        (cellDim, physDim)
      SimulationType      SimulationType_t  "TimeAccurate"
      BaseIterativeData   BaseIterativeData_t  I4 [nsnaps]
        TimeValues        DataArray_t  R8 [nsnaps]
      Zone                Zone_t       I4 [[nvert, ncell, 0]]
        ZoneType          ZoneType_t   "Unstructured"
        GridCoordinates   GridCoordinates_t
          CoordinateX/Y/Z DataArray_t  R8 [nvert]
        Elements          Elements_t   I4 [elem_type, 0]
          ElementRange          IndexRange_t I4 [1, ncell]
          ElementConnectivity   DataArray_t  I4 (1-based)
          ElementStartOffset    DataArray_t  I4 [ncell+1]   (MIXED only)
        FlowSolutionN     FlowSolution_t   (one per snapshot)
          GridLocation    GridLocation_t  "CellCenter"
          <field>         DataArray_t  R8 [ncell]
        ZoneIterativeData ZoneIterativeData_t
          FlowSolutionPointers  DataArray_t C1 [nsnaps][32]
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING

import numpy as np

from .hdf5 import require_h5py
from .writers import (DEFAULT_FIELDS, SnapshotCadence, collect_output_fields,
                      mixed_topology)

if TYPE_CHECKING:
    from ..simulation import Simulation

# CGNS ElementType_t enum values (cgnslib.h)
TRI_3 = 5
QUAD_4 = 7
MIXED = 20


# --- ADF-on-HDF5 node primitives -------------------------------------------


def _fixed_str(h5py, s: str, n: int) -> np.ndarray:
    """Fixed-length null-padded byte string as an HDF5 scalar attribute."""
    return np.array(s.encode("ascii"), dtype=h5py.string_dtype("ascii", n))


def _node(h5py, parent, name: str, label: str, dtype: str, data=None):
    """One ADF node: a group with name/label/type attributes and its data
    in the dataset ' data'."""
    g = parent.create_group(name, track_order=True)
    g.attrs["name"] = _fixed_str(h5py, name, 33)
    g.attrs["label"] = _fixed_str(h5py, label, 33)
    g.attrs["type"] = _fixed_str(h5py, dtype, 3)
    g.attrs["flags"] = np.int32(0)
    if data is not None:
        # ADF dims are Fortran-order; the HDF5 dataset stores them reversed,
        # so a C-order numpy array of the transposed shape round-trips.
        g.create_dataset(" data", data=data)
    return g


def _c1(h5py, parent, name: str, label: str, text: str):
    data = np.frombuffer(text.encode("ascii"), dtype=np.int8)
    return _node(h5py, parent, name, label, "C1", data)


def _root(h5py, f):
    f.attrs["name"] = _fixed_str(h5py, "HDF5 MotherNode", 33)
    f.attrs["label"] = _fixed_str(h5py, "Root Node of HDF5 File", 33)
    f.attrs["type"] = _fixed_str(h5py, "MT", 3)
    fmt = np.frombuffer(b"IEEE_LITTLE_32\x00", dtype=np.int8)
    f.create_dataset(" format", data=fmt)
    ver = b"HDF5 Version 1.14" + b"\x00" * 16
    f.create_dataset(" hdf5version", data=np.frombuffer(ver, dtype=np.int8))
    _node(h5py, f, "CGNSLibraryVersion", "CGNSLibraryVersion_t", "R4",
          np.array([4.0], dtype=np.float32))


# --- mesh -> CGNS element section -------------------------------------------


def _element_section(mesh):
    """(elem_type, connectivity, start_offsets | None), 1-based vertex ids."""
    nv = np.asarray(mesh.cell_num_vertices)
    cv = np.asarray(mesh.cell_vertices)
    if (nv == 3).all():
        return TRI_3, (cv[:, :3] + 1).astype(np.int32).ravel(), None
    if (nv == 4).all():
        return QUAD_4, (cv[:, :4] + 1).astype(np.int32).ravel(), None
    conn = mixed_topology(mesh, (TRI_3, QUAD_4), 1).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(nv.astype(np.int64) + 1)])
    return MIXED, conn, offsets.astype(np.int32)


class CGNSWriter:
    """Per-coupling-interval monitor writing batched CGNS files.

    File naming follows the reference's CGNS filename template
    '<output_dir>/<prefix>-%d.cgns' (rdyadvance.c:143-146) with %d = the
    step index of the batch's first snapshot, and output.batch_size
    snapshots per file (each with the full grid, as cgnslib requires).
    """

    def __init__(self, sim: "Simulation"):
        self.h5py = require_h5py("output.format: cgns",
                                 "output.format: binary")
        self.sim = sim
        cfg = sim.config
        self.dir = os.path.join(cfg.config_dir, cfg.output.directory)
        os.makedirs(self.dir, exist_ok=True)
        self.prefix = cfg.output.prefix or "output"
        self.fields = cfg.output.fields or DEFAULT_FIELDS
        self.cadence = SnapshotCadence(cfg)
        self.batch_size = max(cfg.output.batch_size, 1)
        self._batch = []  # [(step, t, [(name, values)])]
        self._batch_first_step = 0
        self._write_snapshot()  # initial condition, like the XDMF writer

    def __call__(self, sim: "Simulation"):
        if self.cadence.due(sim):
            self._write_snapshot()
        if sim.finished:
            self.flush()

    def _write_snapshot(self):
        sim = self.sim
        if not self._batch:
            self._batch_first_step = sim.step
        self._batch.append(
            (sim.step, sim.t, collect_output_fields(sim, self.fields)))
        # the open batch file is rewritten at each snapshot, so the file on
        # disk stays valid if the run stops between coupling intervals
        self._write_file()
        if len(self._batch) >= self.batch_size:
            self._batch = []

    def flush(self):
        if self._batch:
            self._write_file()
            self._batch = []

    def _write_file(self):
        if not self.sim.is_writer:
            return
        h5py, mesh = self.h5py, self.sim.mesh
        path = os.path.join(
            self.dir, f"{self.prefix}-{self._batch_first_step}.cgns")
        nvert, ncell = mesh.num_vertices, mesh.num_cells

        def node(*args):
            return _node(h5py, *args)

        with h5py.File(path, "w", track_order=True) as f:
            _root(h5py, f)
            base = node(f, "Base", "CGNSBase_t", "I4",
                        np.array([2, 3], dtype=np.int32))
            _c1(h5py, base, "SimulationType", "SimulationType_t",
                "TimeAccurate")
            bid = node(base, "BaseIterativeData", "BaseIterativeData_t",
                       "I4", np.array([len(self._batch)], dtype=np.int32))
            node(bid, "TimeValues", "DataArray_t", "R8",
                 np.array([t for _, t, _ in self._batch], dtype=np.float64))
            # Zone_t data: ADF dims (IndexDimension=1, 3) -> HDF5 (3, 1)
            zone = node(base, "Zone", "Zone_t", "I4",
                        np.array([[nvert], [ncell], [0]], dtype=np.int32))
            _c1(h5py, zone, "ZoneType", "ZoneType_t", "Unstructured")
            gc = node(zone, "GridCoordinates", "GridCoordinates_t", "MT")
            pts = np.asarray(mesh.points, dtype=np.float64)
            for i, ax in enumerate("XYZ"):
                col = pts[:, i] if pts.shape[1] > i else np.zeros(nvert)
                node(gc, f"Coordinate{ax}", "DataArray_t", "R8",
                     np.ascontiguousarray(col))
            etype, conn, offsets = _element_section(mesh)
            el = node(zone, "Elements", "Elements_t", "I4",
                      np.array([etype, 0], dtype=np.int32))
            node(el, "ElementRange", "IndexRange_t", "I4",
                 np.array([1, ncell], dtype=np.int32))
            node(el, "ElementConnectivity", "DataArray_t", "I4", conn)
            if offsets is not None:
                node(el, "ElementStartOffset", "DataArray_t", "I4", offsets)
            names = []
            for step, _, fields in self._batch:
                sol_name = f"FlowSolution{step}"
                names.append(sol_name)
                fs = node(zone, sol_name, "FlowSolution_t", "MT")
                _c1(h5py, fs, "GridLocation", "GridLocation_t", "CellCenter")
                for fname, values in fields:
                    node(fs, fname, "DataArray_t", "R8",
                         np.asarray(values, dtype=np.float64))
            zid = node(zone, "ZoneIterativeData", "ZoneIterativeData_t", "MT")
            # FlowSolutionPointers: C1 array, ADF dims (32, nsnaps) ->
            # HDF5 (nsnaps, 32), space-padded per SIDS
            ptrs = np.full((len(names), 32), ord(" "), dtype=np.int8)
            for i, n in enumerate(names):
                b = n.encode("ascii")[:32]
                ptrs[i, : len(b)] = np.frombuffer(b, dtype=np.int8)
            node(zid, "FlowSolutionPointers", "DataArray_t", "C1", ptrs)
