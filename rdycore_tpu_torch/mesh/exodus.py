"""Exodus II (.exo, .e, .exo2) mesh reader on the NetCDF classic reader.

Maps the Exodus model onto the Mesh the way the reference's DMPlex
pipeline does (rdydm.c + rdysetup.c InitRegions/InitBoundaries):
- element blocks -> cell regions (grid_region_id = block id from eb_prop1)
- side sets     -> boundary edge sets (grid_boundary_id = id from ss_prop1)
- nodal z coordinate (or a 2-D mesh + separate elevation file) -> bed

The counterpart of the JAX package's mesh/exodus.py, with the same Mesh.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..io.netcdf3 import NetCDF3File
from .core import Mesh, build_mesh

# Exodus local side -> (local node a, local node b), 0-based, for 2-D cells:
# side i of a tri/quad connects node i and node (i+1) % n.


def read_exodus(path: str) -> Mesh:
    nc = NetCDF3File(path)
    dims = dict(nc.dims)

    # coordinates
    if "coord" in nc.variables:
        coord = nc.read("coord")  # [ndim, nnodes]
        xs = coord[0]
        ys = coord[1]
        zs = coord[2] if coord.shape[0] > 2 else np.zeros_like(xs)
    else:
        xs = nc.read("coordx")
        ys = nc.read("coordy")
        zs = (
            nc.read("coordz")
            if "coordz" in nc.variables
            else np.zeros_like(xs)
        )
    points = np.stack([xs, ys, zs], axis=1).astype(np.float64)

    # element blocks
    num_blocks = dims.get("num_el_blk", 1)
    block_ids = (
        nc.read("eb_prop1")
        if "eb_prop1" in nc.variables
        else np.arange(1, num_blocks + 1)
    )
    cells = []
    cell_block = []
    for b in range(num_blocks):
        conn = nc.read(f"connect{b + 1}")  # [n_elem, n_nodes_per_elem] 1-based
        n_elem, npe = conn.shape
        if npe == 3:
            block = np.concatenate(
                [conn - 1, -np.ones((n_elem, 1), conn.dtype)], axis=1
            )
        elif npe == 4:
            block = conn - 1
        else:
            raise ValueError(
                f"{path}: unsupported element with {npe} nodes (need tri/quad)"
            )
        cells.append(block.astype(np.int64))
        cell_block.append(np.full(n_elem, block_ids[b], dtype=np.int64))
    cell_vertices = np.concatenate(cells, axis=0)
    cell_block = np.concatenate(cell_block)

    regions: Dict[str, np.ndarray] = {}
    names = _block_names(nc, num_blocks)
    for i, bid in enumerate(np.asarray(block_ids)):
        ids = np.nonzero(cell_block == bid)[0].astype(np.int32)
        regions[f"__id_{int(bid)}"] = ids
        if names[i]:
            regions[names[i]] = ids

    # side sets -> boundary vertex pairs.
    #
    # Exodus has two side-numbering conventions for 2-D cells: planar
    # elements number edges 1..n directly, while SHELL elements (3-D files
    # with num_dim=3, like Houston1km_with_z.exo) use sides 1-2 for the two
    # faces and 3..n+2 for the edges. We detect the convention per side set
    # by checking which mapping lands on actual boundary edges.
    bnd_pairs = _boundary_pair_set(cell_vertices)
    boundary: Dict[str, np.ndarray] = {}
    num_ss = dims.get("num_side_sets", 0)
    ss_ids = (
        nc.read("ss_prop1")
        if "ss_prop1" in nc.variables
        else np.arange(1, num_ss + 1)
    )
    ss_names = _side_set_names(nc, num_ss)
    nvert = (cell_vertices >= 0).sum(axis=1)
    nv_total = points.shape[0]
    for s in range(num_ss):
        elems = nc.read(f"elem_ss{s + 1}") - 1  # 0-based element ids
        sides_raw = nc.read(f"side_ss{s + 1}")  # 1-based side ids
        pairs = None
        for offset in (1, 3):  # planar convention, then shell convention
            local = sides_raw - offset
            nv_e = nvert[elems]
            if (local < 0).any() or (local >= nv_e).any():
                continue
            a = cell_vertices[elems, local]
            b = cell_vertices[elems, (local + 1) % nv_e]
            keys = (
                np.minimum(a, b).astype(np.int64) * nv_total
                + np.maximum(a, b)
            )
            if np.isin(keys, bnd_pairs).all():
                pairs = np.stack([a, b], axis=1)
                break
        if pairs is None:
            # not a boundary side set (e.g. an internal block interface like
            # quad_tri_mesh.exo's side set 5); skip it -- the config layer
            # errors only if a grid_boundary_id actually references it
            continue
        boundary[f"__id_{int(ss_ids[s])}"] = pairs
        if ss_names[s]:
            boundary[ss_names[s]] = pairs

    mesh = build_mesh(
        points, cell_vertices, regions=regions, boundary_edges=boundary
    )
    return mesh


def _boundary_pair_set(cell_vertices: np.ndarray) -> np.ndarray:
    """Sorted-pair keys of edges used by exactly one cell, sorted."""
    nvert = (cell_vertices >= 0).sum(axis=1)
    nv_total = int(cell_vertices.max()) + 1
    keys = []
    for k in range(cell_vertices.shape[1]):
        sel = k < nvert
        a = cell_vertices[sel, k]
        b = cell_vertices[sel, (k + 1) % cell_vertices.shape[1]]
        b = np.where((k + 1) < nvert[sel], b, cell_vertices[sel, 0])
        keys.append(
            np.minimum(a, b).astype(np.int64) * nv_total + np.maximum(a, b)
        )
    keys = np.concatenate(keys)
    uniq, counts = np.unique(keys, return_counts=True)
    return uniq[counts == 1]


def _char_names(nc: NetCDF3File, var: str, count: int):
    names = [""] * count
    if var in nc.variables:
        raw = nc.read(var)
        for i in range(min(count, raw.shape[0])):
            names[i] = (
                raw[i].tobytes().decode("utf-8", "replace").split("\x00")[0].strip()
            )
    return names


def _block_names(nc, count):
    return _char_names(nc, "eb_names", count)


def _side_set_names(nc, count):
    return _char_names(nc, "ss_names", count)
