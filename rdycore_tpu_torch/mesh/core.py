"""Finite-volume mesh: the replacement for DMPlex + RDyMesh.

The reference extracts a struct-of-arrays FV mesh from DMPlex (the
reference's src/rdymesh.c: RDyCells/RDyEdges/RDyVertices). Here we build
the same information directly from (points, cell connectivity) with vectorized
NumPy at setup time, producing *padded index arrays* that the PyTorch/CUDA
compute path consumes:

- ``edge_cells[E, 2]``: left/right local cell ids (right == -1 on boundary)
- ``edge_cn/edge_sn/edge_length[E]``: unit normal components + edge length,
  oriented left -> right (outward on the boundary), matching the reference
  convention (rdymesh.c:600-689: cn = dy/ds, sn = -dx/ds after L->R
  orientation fix)
- ``cell_edges[C, MAX_CE]`` + ``cell_edge_sign[C, MAX_CE]``: the transpose
  (cell -> incident edges) map. This turns the reference's scatter-add of
  edge fluxes into a *gather* per cell -- the "pull" form with a
  deterministic, partition-independent summation order and no atomics.

`build_mesh` takes the cell geometry and the edges from the port's native
builder (mesh/native.py, mesh/csrc/mesh_builder.cpp, compiled at first
use), as rdycore_tpu/mesh/core.py takes them from its own; it raises where
that library cannot be built. The numpy functions below
(`_polygon_areas_centroids`, `_cell_slopes`, `_vertex_mean_z`,
`_extract_edges`) are its plain versions, held against it array for array
by the tests; no path calls them. Edges are numbered in order of first
appearance over cells and their vertex slots, so edge ids agree with the
JAX package's.

Geometry matches the reference:
- cell areas are 2-D projected polygon areas
- dz/dx, dz/dy per cell from the triangle slope formula
  (rdymesh.c:747-782 ComputeXYSlopesForTriangle), area-weighted fan for quads
  (rdymesh.c:799-860)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from . import native

MAX_CELL_EDGES = 4  # triangles and quads only, like the reference


@dataclasses.dataclass
class Mesh:
    """A 2-D unstructured finite-volume mesh of triangles and/or quads."""

    # vertices
    points: np.ndarray  # [NV, 3] x, y, z(bed elevation)

    # cells (CCW vertex order, -1 padded)
    cell_vertices: np.ndarray  # [C, MAX_CELL_EDGES] int32
    cell_num_vertices: np.ndarray  # [C] int32
    cell_area: np.ndarray  # [C] projected 2-D area
    cell_centroid: np.ndarray  # [C, 3] (z = bed elevation at centroid)
    cell_dz_dx: np.ndarray  # [C] bed slope d(z)/dx
    cell_dz_dy: np.ndarray  # [C] bed slope d(z)/dy
    cell_z: np.ndarray  # [C] vertex-averaged bed elevation (HR well-balancing)
    natural_ids: np.ndarray  # [C] stable global cell ids for I/O ordering

    # edges (internal first, then boundary)
    edge_cells: np.ndarray  # [E, 2] int32; right = -1 on boundary
    edge_cn: np.ndarray  # [E] normal x-component
    edge_sn: np.ndarray  # [E] normal y-component
    edge_length: np.ndarray  # [E]
    edge_vertices: np.ndarray  # [E, 2] int32 (oriented: normal = CW rot of v1->v2)
    num_internal_edges: int

    # cell -> edge transpose map (gather form of the flux scatter)
    cell_edges: np.ndarray  # [C, MAX_CELL_EDGES] int32, padded with E (dummy)
    cell_edge_sign: np.ndarray  # [C, MAX_CELL_EDGES] float; +1 left, -1 right, 0 pad

    # named cell regions / boundary edge sets
    regions: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    boundaries: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def num_cells(self) -> int:
        return self.cell_area.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_length.shape[0]

    @property
    def num_boundary_edges(self) -> int:
        return self.num_edges - self.num_internal_edges

    @property
    def num_vertices(self) -> int:
        return self.points.shape[0]

    def min_edge_length(self) -> float:
        return float(self.edge_length.min()) if self.num_edges else 0.0

    def set_cell_elevations(self, z: np.ndarray) -> None:
        """Override cell-center elevations (e.g. pit-filled DEM), like the
        reference's grid.cell_elevation file (rdyconfigimpl.h:238-247).

        Bed slopes are NOT recomputed here (the reference keeps vertex-based
        slopes); cell_z and centroid z are replaced.
        """
        z = np.asarray(z, dtype=np.float64)
        if z.shape != (self.num_cells,):
            raise ValueError(f"elevation override must have shape ({self.num_cells},)")
        self.cell_centroid = self.cell_centroid.copy()
        self.cell_centroid[:, 2] = z
        self.cell_z = z.copy()

    def with_vertex_elevations(self, z: np.ndarray) -> "Mesh":
        """A copy whose vertices lie at bed elevations z [NV], with the
        geometry that reads them (centroid z, bed slopes, cell_z) made anew
        as `build_mesh` makes it. The edges do not read z: the result
        equals `build_mesh` on the new points, but for natural ids, which
        stay, and the labels, which are not resolved again."""
        points = self.points.copy()
        points[:, 2] = np.asarray(z, dtype=np.float64)
        _, centroids, dz_dx, dz_dy, cell_z = native.cell_geometry(
            points, self.cell_vertices, self.cell_num_vertices)
        return dataclasses.replace(
            self, points=points, cell_centroid=centroids, cell_dz_dx=dz_dx,
            cell_dz_dy=dz_dy, cell_z=cell_z)


def reorder_cells(mesh: "Mesh", perm: np.ndarray) -> "Mesh":
    """Reorder cells by `perm` (new index i holds old cell perm[i]).

    Natural ids travel with the cells, so checkpoints and the coupling
    surface's natural order stay stable under reordering -- the DMPlex
    global-to-natural analogue.
    """
    perm = np.asarray(perm)
    C = mesh.num_cells
    if perm.shape != (C,) or not np.array_equal(
            np.sort(perm), np.arange(C)):
        raise ValueError("perm must be a permutation of range(num_cells)")
    inverse = np.argsort(perm)
    return build_mesh(
        mesh.points,
        mesh.cell_vertices[perm],
        mesh.cell_num_vertices[perm],
        regions={
            name: np.sort(inverse[ids]).astype(np.int32)
            for name, ids in mesh.regions.items()
        },
        boundary_edges={
            name: mesh.edge_vertices[eids]
            for name, eids in mesh.boundaries.items()
        },
        natural_ids=mesh.natural_ids[perm],
    )


def rcm_reorder(mesh: "Mesh") -> "Mesh":
    """Reverse Cuthill-McKee cell reordering (bandwidth reduction), by the
    native builder's `rcm_order` only."""
    perm = native.rcm_order(
        mesh.num_cells, mesh.edge_cells[:, 0], mesh.edge_cells[:, 1]
    )
    return reorder_cells(mesh, perm)


def block_order(mesh: "Mesh", px: int, py: int) -> np.ndarray:
    """2-D block ordering: the cells sorted into a px x py grid of spatial
    blocks (cut at centroid quantiles, so the blocks hold equal numbers of
    cells), block-major, each block in the cells' old order. With the
    shards' equal contiguous blocks of the cell order (parallel/
    partition.py) this gives 2-D subdomains, whose ghosts lie on shards
    that are not neighbours in rank order. Apply with `reorder_cells`."""
    cx = mesh.cell_centroid[:, 0]
    cy = mesh.cell_centroid[:, 1]
    qx = np.quantile(cx, np.linspace(0, 1, px + 1)[1:-1]) if px > 1 else []
    qy = np.quantile(cy, np.linspace(0, 1, py + 1)[1:-1]) if py > 1 else []
    block = (np.searchsorted(np.asarray(qy), cy) * px
             + np.searchsorted(np.asarray(qx), cx))
    return np.argsort(block, kind="stable")


def save_mesh_npz(mesh: "Mesh", path: str) -> None:
    """Save a mesh in the native .npz format (points + connectivity +
    labels; geometry is rebuilt on load)."""
    regions = {f"region__{k}": v for k, v in mesh.regions.items()}
    boundaries = {
        f"boundary__{k}": mesh.edge_vertices[v] for k, v in mesh.boundaries.items()
    }
    np.savez_compressed(
        path,
        points=mesh.points,
        cell_vertices=mesh.cell_vertices,
        natural_ids=mesh.natural_ids,
        **regions,
        **boundaries,
    )


def load_mesh_npz(path: str) -> "Mesh":
    data = np.load(path)
    regions = {}
    boundaries = {}
    for k in data.files:
        if k.startswith("region__"):
            regions[k[8:]] = data[k]
        elif k.startswith("boundary__"):
            boundaries[k[10:]] = data[k]
    return build_mesh(
        data["points"],
        data["cell_vertices"],
        regions=regions,
        boundary_edges=boundaries,
        natural_ids=data["natural_ids"] if "natural_ids" in data.files else None,
    )


def named_boundary_sets(mesh: "Mesh") -> Dict[str, np.ndarray]:
    """Boundary sets with duplicates resolved: named sets win; id-only sets
    (``__id_N``) not covered by a named set are kept as ``boundary_N``."""
    out: Dict[str, np.ndarray] = {}
    covered: set = set()
    for name, eids in mesh.boundaries.items():
        if not name.startswith("__id_"):
            out[name] = eids
            covered.update(np.asarray(eids).tolist())
    for name, eids in mesh.boundaries.items():
        if name.startswith("__id_"):
            extra = [e for e in np.asarray(eids).tolist() if e not in covered]
            if extra:
                out[f"boundary_{name[5:]}"] = np.asarray(extra, dtype=np.int32)
                covered.update(extra)
    return out


def _polygon_areas_centroids(points, cell_vertices, cell_num_vertices):
    """Projected 2-D areas and 3-D centroids of tri/quad cells (vectorized)."""
    C = cell_vertices.shape[0]
    areas = np.zeros(C)
    cx = np.zeros(C)
    cy = np.zeros(C)
    cz = np.zeros(C)
    x = points[:, 0]
    y = points[:, 1]
    z = points[:, 2]
    maxv = cell_vertices.shape[1]
    # shoelace over padded polygon (pad repeats first vertex -> no contribution)
    vids = np.where(cell_vertices >= 0, cell_vertices, cell_vertices[:, :1])
    for k in range(maxv):
        k2 = (k + 1) % maxv
        # replace padded slots with wrap to vertex 0 of the cell
        a = vids[:, k]
        b = np.where(k2 < cell_num_vertices, vids[:, k2 % maxv], vids[:, 0])
        b = np.where(k < cell_num_vertices, b, a)  # padded slot: degenerate
        cross = x[a] * y[b] - x[b] * y[a]
        areas += cross
        cx += (x[a] + x[b]) * cross
        cy += (y[a] + y[b]) * cross
    areas *= 0.5
    with np.errstate(divide="ignore", invalid="ignore"):
        cx /= 6.0 * areas
        cy /= 6.0 * areas
    # z centroid: mean of vertex z weighted by fan-triangle areas about (cx, cy)
    zw = np.zeros(C)
    wsum = np.zeros(C)
    for k in range(maxv):
        k2 = (k + 1) % maxv
        a = vids[:, k]
        b = np.where(k2 < cell_num_vertices, vids[:, k2 % maxv], vids[:, 0])
        b = np.where(k < cell_num_vertices, b, a)
        tri_area = 0.5 * np.abs(
            (x[a] - cx) * (y[b] - cy) - (x[b] - cx) * (y[a] - cy)
        )
        zc_tri = (z[a] + z[b]) / 3.0  # + z(centroid)/3, handled below
        zw += tri_area * zc_tri
        wsum += tri_area
    # for a planar cell z(centroid of fan apex) ~ mean vertex z; use simple
    # area-weighted fan with apex z approximated by mean of vertices
    nv = cell_num_vertices.astype(np.float64)
    zmean = np.zeros(C)
    for k in range(maxv):
        zmean += np.where(k < cell_num_vertices, z[vids[:, k]], 0.0)
    zmean /= nv
    with np.errstate(divide="ignore", invalid="ignore"):
        cz = zw / np.maximum(wsum, 1e-300) + zmean / 3.0
    return np.abs(areas), np.stack([cx, cy, cz], axis=1)


def _vertex_mean_z(points, cell_vertices, cell_num_vertices):
    """Vertex-averaged bed elevation of each cell (HR, swe_petsc.c:
    1212-1224)."""
    nv = cell_num_vertices.astype(np.float64)
    vids = np.where(cell_vertices >= 0, cell_vertices, 0)
    zmask = (cell_vertices >= 0).astype(np.float64)
    return (points[vids, 2] * zmask).sum(axis=1) / nv


def _triangle_xy_slopes(p0, p1, p2):
    """Slopes dz/dx, dz/dy of the plane through three points.

    Mirrors ComputeXYSlopesForTriangle (rdymesh.c:747-782), including the CCW
    orientation normalization (the formula is orientation-independent once the
    vertices are consistently ordered; we use the plane-fit form directly).
    """
    x0, y0, z0 = p0[..., 0], p0[..., 1], p0[..., 2]
    x1, y1, z1 = p1[..., 0], p1[..., 1], p1[..., 2]
    x2, y2, z2 = p2[..., 0], p2[..., 1], p2[..., 2]
    # normal = (p1-p0) x (p2-p0); plane: nx (x-x0) + ny (y-y0) + nz (z-z0) = 0
    nx = (y1 - y0) * (z2 - z0) - (z1 - z0) * (y2 - y0)
    ny = (z1 - z0) * (x2 - x0) - (x1 - x0) * (z2 - z0)
    nz = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    with np.errstate(divide="ignore", invalid="ignore"):
        dz_dx = np.where(nz != 0.0, -nx / np.where(nz != 0, nz, 1.0), 0.0)
        dz_dy = np.where(nz != 0.0, -ny / np.where(nz != 0, nz, 1.0), 0.0)
    return dz_dx, dz_dy


def _cell_slopes(points, cell_vertices, cell_num_vertices, centroids):
    """Per-cell bed slopes: triangles directly, quads via area-weighted fan
    around the centroid (rdymesh.c:799-860)."""
    C = cell_vertices.shape[0]
    dz_dx = np.zeros(C)
    dz_dy = np.zeros(C)

    tri = cell_num_vertices == 3
    if tri.any():
        v = cell_vertices[tri]
        sx, sy = _triangle_xy_slopes(points[v[:, 0]], points[v[:, 1]], points[v[:, 2]])
        dz_dx[tri] = sx
        dz_dy[tri] = sy

    quad = cell_num_vertices == 4
    if quad.any():
        v = cell_vertices[quad]
        c = centroids[quad]
        acc_x = np.zeros(v.shape[0])
        acc_y = np.zeros(v.shape[0])
        acc_a = np.zeros(v.shape[0])
        for k in range(4):
            a = points[v[:, k]]
            b = points[v[:, (k + 1) % 4]]
            area_k = 0.5 * np.abs(
                (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
                - (c[:, 0] - a[:, 0]) * (b[:, 1] - a[:, 1])
            )
            sx, sy = _triangle_xy_slopes(a, b, c)
            acc_x += area_k * sx
            acc_y += area_k * sy
            acc_a += area_k
        dz_dx[quad] = acc_x / acc_a
        dz_dy[quad] = acc_y / acc_a

    return dz_dx, dz_dy


def _extract_edges(num_points, cell_vertices, cell_num_vertices):
    """Unique edges of the mesh, numbered in order of first appearance when
    cells are walked in order and each cell's edges in vertex-slot order.

    The left cell of an edge is the cell that lists it first (the smaller
    cell id), as in csrc/mesh_builder.cpp rdy_extract_edges. Returns
    (left, right, lslot, rslot) with right = rslot = -1 on the boundary.
    """
    C = cell_vertices.shape[0]
    k = np.arange(MAX_CELL_EDGES)
    a = cell_vertices.astype(np.int64)
    nxt = np.where(
        (k + 1)[None, :] < cell_num_vertices[:, None],
        np.roll(a, -1, axis=1), a[:, :1],
    )
    valid = (k[None, :] < cell_num_vertices[:, None]).ravel()
    e_from = a.ravel()[valid]
    e_to = nxt.ravel()[valid]
    e_cell = np.repeat(np.arange(C, dtype=np.int32), MAX_CELL_EDGES)[valid]
    e_slot = np.tile(k.astype(np.int32), C)[valid]

    key = np.minimum(e_from, e_to) * num_points + np.maximum(e_from, e_to)
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    _, first, counts = np.unique(key_s, return_index=True, return_counts=True)
    if counts.max() > 2:
        raise ValueError("non-manifold mesh: an edge is shared by >2 cells")
    # the stable sort keeps each key's occurrences in walk order, so the
    # first of a group is the edge's first appearance
    occ_first = order[first]
    two = counts == 2
    occ_second = np.where(two, order[np.minimum(first + 1, len(order) - 1)], -1)
    numbering = np.argsort(occ_first, kind="stable")
    occ_first = occ_first[numbering]
    occ_second = occ_second[numbering]
    two = two[numbering]

    left = e_cell[occ_first]
    lslot = e_slot[occ_first]
    right = np.where(two, e_cell[occ_second], -1).astype(np.int32)
    rslot = np.where(two, e_slot[occ_second], -1).astype(np.int32)
    return left, right, lslot, rslot


def _orient_ccw(points, cell_vertices, cell_num_vertices):
    """Flip cells with negative signed area so all are counterclockwise."""
    x = points[:, 0]
    y = points[:, 1]
    C, maxv = cell_vertices.shape
    signed = np.zeros(C)
    vids = np.where(cell_vertices >= 0, cell_vertices, cell_vertices[:, :1])
    for k in range(maxv):
        k2 = (k + 1) % maxv
        a = vids[:, k]
        b = np.where(k2 < cell_num_vertices, vids[:, k2 % maxv], vids[:, 0])
        b = np.where(k < cell_num_vertices, b, a)
        signed += x[a] * y[b] - x[b] * y[a]
    flip = signed < 0
    out = cell_vertices.copy()
    for nv in np.unique(cell_num_vertices[flip]):
        sel = flip & (cell_num_vertices == nv)
        out[sel, :nv] = cell_vertices[sel, :nv][:, ::-1]
    return out


def build_mesh(
    points: np.ndarray,
    cell_vertices: np.ndarray,
    cell_num_vertices: Optional[np.ndarray] = None,
    regions: Optional[Dict[str, np.ndarray]] = None,
    boundary_edges: Optional[Dict[str, np.ndarray]] = None,
    natural_ids: Optional[np.ndarray] = None,
) -> Mesh:
    """Build a Mesh from raw connectivity.

    Args:
      points: [NV, 2] or [NV, 3] vertex coordinates (z = bed elevation).
      cell_vertices: [C, <=4] vertex ids, -1 padded.
      cell_num_vertices: [C] or inferred from padding.
      regions: name -> cell id array.
      boundary_edges: name -> [n, 2] vertex-pair array. Unlisted boundary
        edges are collected into an implicit "__unassigned__" boundary (the
        reference auto-assigns a reflecting BC to those, rdysetup.c:706-777).
      natural_ids: stable global cell ids; defaults to arange(C).
    """
    points = np.asarray(points, dtype=np.float64)
    if points.shape[1] == 2:
        points = np.concatenate([points, np.zeros((len(points), 1))], axis=1)
    cell_vertices = np.asarray(cell_vertices, dtype=np.int32)
    if cell_vertices.shape[1] < MAX_CELL_EDGES:
        pad = -np.ones(
            (cell_vertices.shape[0], MAX_CELL_EDGES - cell_vertices.shape[1]),
            dtype=np.int32,
        )
        cell_vertices = np.concatenate([cell_vertices, pad], axis=1)
    if cell_num_vertices is None:
        cell_num_vertices = (cell_vertices >= 0).sum(axis=1).astype(np.int32)
    else:
        cell_num_vertices = np.asarray(cell_num_vertices, dtype=np.int32)

    C = cell_vertices.shape[0]
    cell_vertices = _orient_ccw(points, cell_vertices, cell_num_vertices)

    areas, centroids, dz_dx, dz_dy, cell_z = native.cell_geometry(
        points, cell_vertices, cell_num_vertices
    )

    # --- edge extraction ---------------------------------------------------
    left, right, lslot, rslot = native.extract_edges(
        points.shape[0], cell_vertices, cell_num_vertices
    )
    n_unique = len(left)

    # edge endpoint vertices (use left cell's directed edge a->b: cell is on
    # the left of a->b, so the outward/L->R normal is the CW rotation of a->b)
    a = cell_vertices[left, lslot]
    nxt_ok = (lslot + 1) < cell_num_vertices[left]
    b = np.where(
        nxt_ok,
        cell_vertices[left, (lslot + 1) % MAX_CELL_EDGES],
        cell_vertices[left, 0],
    )

    dx = points[b, 0] - points[a, 0]
    dy = points[b, 1] - points[a, 1]
    ds = np.sqrt(dx * dx + dy * dy)
    # CW rotation of (dx, dy) is (dy, -dx): points away from the left cell
    cn = dy / ds
    sn = -dx / ds

    # order edges: internal first, then boundary (reference keeps id lists for
    # both, rdymesh.c:694-712); we physically reorder for contiguous slices
    is_internal = right >= 0
    internal_ids = np.nonzero(is_internal)[0]
    boundary_ids = np.nonzero(~is_internal)[0]
    perm = np.concatenate([internal_ids, boundary_ids])
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(len(perm))

    edge_cells = np.stack([left[perm], right[perm]], axis=1).astype(np.int32)
    edge_cn = cn[perm]
    edge_sn = sn[perm]
    edge_length = ds[perm]
    edge_vertices = np.stack([a[perm], b[perm]], axis=1).astype(np.int32)
    num_internal = int(is_internal.sum())
    E = len(perm)

    # --- cell -> edge transpose map ---------------------------------------
    cell_edges = np.full((C, MAX_CELL_EDGES), E, dtype=np.int32)  # E = dummy
    cell_edge_sign = np.zeros((C, MAX_CELL_EDGES), dtype=np.float64)
    # left cell at slot lslot
    uedge = np.arange(n_unique)
    new_id = inv_perm[uedge]
    cell_edges[left, lslot] = new_id
    cell_edge_sign[left, lslot] = -1.0  # left: -len/area (outflow)
    has_r = right >= 0
    cell_edges[right[has_r], rslot[has_r]] = new_id[has_r]
    cell_edge_sign[right[has_r], rslot[has_r]] = 1.0

    # --- boundary edge sets ------------------------------------------------
    bmap = {}
    if boundary_edges:
        # vertex-pair -> edge id lookup for boundary edges
        bkeys = (
            np.minimum(edge_vertices[num_internal:, 0], edge_vertices[num_internal:, 1]).astype(np.int64)
            * points.shape[0]
            + np.maximum(edge_vertices[num_internal:, 0], edge_vertices[num_internal:, 1])
        )
        lookup = dict(zip(bkeys.tolist(), (np.arange(num_internal, E)).tolist()))
        assigned = np.zeros(E - num_internal, dtype=bool)
        for name, pairs in boundary_edges.items():
            pairs = np.asarray(pairs, dtype=np.int64)
            if pairs.size == 0:
                bmap[name] = np.zeros(0, dtype=np.int32)
                continue
            keys = np.minimum(pairs[:, 0], pairs[:, 1]) * points.shape[0] + np.maximum(
                pairs[:, 0], pairs[:, 1]
            )
            ids = []
            for kk in keys.tolist():
                eid = lookup.get(kk)
                if eid is None:
                    raise ValueError(
                        f"boundary '{name}' lists a vertex pair that is not a boundary edge"
                    )
                ids.append(eid)
                assigned[eid - num_internal] = True
            bmap[name] = np.sort(np.asarray(ids, dtype=np.int32))
        leftover = np.nonzero(~assigned)[0] + num_internal
    else:
        leftover = np.arange(num_internal, E)
    if len(leftover):
        bmap["__unassigned__"] = leftover.astype(np.int32)

    if natural_ids is None:
        natural_ids = np.arange(C, dtype=np.int64)

    return Mesh(
        points=points,
        cell_vertices=cell_vertices,
        cell_num_vertices=cell_num_vertices,
        cell_area=areas,
        cell_centroid=centroids,
        cell_dz_dx=dz_dx,
        cell_dz_dy=dz_dy,
        cell_z=cell_z,
        natural_ids=np.asarray(natural_ids, dtype=np.int64),
        edge_cells=edge_cells,
        edge_cn=edge_cn,
        edge_sn=edge_sn,
        edge_length=edge_length,
        edge_vertices=edge_vertices,
        num_internal_edges=num_internal,
        cell_edges=cell_edges,
        cell_edge_sign=cell_edge_sign,
        regions=dict(regions or {}),
        boundaries=bmap,
    )
