"""ctypes bindings of the port's native mesh builder
(mesh/csrc/mesh_builder.cpp, built at first use by mesh/build.py).

Three entry points, each the counterpart of the JAX package's binding of
the same name: `extract_edges`, `rcm_order` and `cell_geometry`. Where the
library cannot be built or loaded they raise NativeBuildError: the numpy
functions of mesh/core.py are the plain versions the tests hold these
against, and no path falls back to them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from .build import NativeBuildError, library

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = library()
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise NativeBuildError(f"native mesh library: cannot load {path}: "
                               f"{e}") from e
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.rdy_extract_edges.restype = ctypes.c_int64
    lib.rdy_extract_edges.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i32p, i32p, i32p, i32p, i32p, i32p,
    ]
    lib.rdy_rcm_order.restype = None
    lib.rdy_rcm_order.argtypes = [ctypes.c_int64, ctypes.c_int64, i32p, i32p,
                                  i32p]
    lib.rdy_cell_geometry.restype = None
    lib.rdy_cell_geometry.argtypes = [
        ctypes.c_int64, f64p, i32p, i32p, f64p, f64p, f64p, f64p, f64p, f64p,
        f64p,
    ]
    _lib = lib
    return lib


def cell_geometry(points, cell_vertices, cell_num_vertices):
    """Cell areas, centroids [C, 3], bed slopes dz/dx and dz/dy, and the
    vertex-averaged elevation, bit for bit the numpy geometry of
    mesh/core.py."""
    lib = _load()
    C = cell_vertices.shape[0]
    pts = np.ascontiguousarray(points, dtype=np.float64)
    cv = np.ascontiguousarray(cell_vertices, dtype=np.int32)
    nv = np.ascontiguousarray(cell_num_vertices, dtype=np.int32)
    out = [np.empty(C, np.float64) for _ in range(7)]
    lib.rdy_cell_geometry(C, pts, cv, nv, *out)
    area, cx, cy, cz, dzdx, dzdy, cellz = out
    return area, np.stack([cx, cy, cz], axis=1), dzdx, dzdy, cellz


def extract_edges(
    num_points: int, cell_vertices: np.ndarray, cell_num_vertices: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(left, right, lslot, rslot) of the unique edges in order of first
    appearance; ValueError on a non-manifold mesh."""
    lib = _load()
    C = cell_vertices.shape[0]
    cv = np.ascontiguousarray(cell_vertices, dtype=np.int32)
    nv = np.ascontiguousarray(cell_num_vertices, dtype=np.int32)
    left, right, lslot, rslot = (np.empty(4 * C, np.int32) for _ in range(4))
    n = lib.rdy_extract_edges(C, num_points, cv, nv, left, right, lslot,
                              rslot)
    if n < 0:
        raise ValueError("non-manifold mesh: an edge is shared by >2 cells")
    return left[:n], right[:n], lslot[:n], rslot[:n]


def rcm_order(num_cells: int, edge_left: np.ndarray,
              edge_right: np.ndarray) -> np.ndarray:
    """The reverse Cuthill-McKee permutation of the cells (new order: old
    cell ids)."""
    lib = _load()
    el = np.ascontiguousarray(edge_left, dtype=np.int32)
    er = np.ascontiguousarray(edge_right, dtype=np.int32)
    perm = np.empty(num_cells, np.int32)
    lib.rdy_rcm_order(num_cells, len(el), el, er, perm)
    return perm
