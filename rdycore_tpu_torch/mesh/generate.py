"""Programmatic structured mesh generation and uniform refinement (the
counterpart of rdycore_tpu/mesh/generate.py).

`refine_uniform` is the JAX package's red refinement written in vectorized
numpy: the same points, cells and labels in the same order (and hence the
same edge order), without its per-cell Python loop, so a ladder of
refinements to millions of cells takes seconds of setup."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from .core import Mesh, build_mesh


def structured_quad(
    nx: int,
    ny: int,
    xmin: float = 0.0,
    xmax: float = 1.0,
    ymin: float = 0.0,
    ymax: float = 1.0,
    z_fn: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]] = None,
    region_fn: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]] = None,
) -> Mesh:
    """A structured quad mesh on [xmin,xmax] x [ymin,ymax].

    Boundaries are named 'left', 'right', 'bottom', 'top'. ``z_fn(x, y)``
    gives vertex bed elevation; ``region_fn(cx, cy)`` maps cell centers to
    integer region ids exposed as regions {'region_<id>': cells}.
    """
    xs = np.linspace(xmin, xmax, nx + 1)
    ys = np.linspace(ymin, ymax, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")  # [ny+1, nx+1]
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    if z_fn is not None:
        z = np.asarray(z_fn(pts[:, 0], pts[:, 1]))
    else:
        z = np.zeros(len(pts))
    points = np.concatenate([pts, z[:, None]], axis=1)

    def vid(i, j):  # i: x index, j: y index
        return j * (nx + 1) + i

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    i = I.ravel()
    j = J.ravel()
    # CCW: (i,j), (i+1,j), (i+1,j+1), (i,j+1)
    cells = np.stack(
        [vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)], axis=1
    ).astype(np.int32)

    boundary = {
        "bottom": np.stack([vid(np.arange(nx), 0), vid(np.arange(1, nx + 1), 0)], axis=1),
        "top": np.stack(
            [vid(np.arange(nx), ny), vid(np.arange(1, nx + 1), ny)], axis=1
        ),
        "left": np.stack([vid(0, np.arange(ny)), vid(0, np.arange(1, ny + 1))], axis=1),
        "right": np.stack(
            [vid(nx, np.arange(ny)), vid(nx, np.arange(1, ny + 1))], axis=1
        ),
    }

    regions: Dict[str, np.ndarray] = {}
    if region_fn is not None:
        cx = (xs[i] + xs[i + 1]) / 2.0
        cy = (ys[j] + ys[j + 1]) / 2.0
        rid = np.asarray(region_fn(cx, cy)).astype(np.int64)
        for r in np.unique(rid):
            ids = np.nonzero(rid == r)[0].astype(np.int32)
            regions[f"region_{int(r)}"] = ids
            regions[f"__id_{int(r)}"] = ids  # grid_region_id lookup alias

    return build_mesh(points, cells, regions=regions, boundary_edges=boundary)


def structured_tri(
    nx: int,
    ny: int,
    xmin: float = 0.0,
    xmax: float = 1.0,
    ymin: float = 0.0,
    ymax: float = 1.0,
    z_fn: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]] = None,
) -> Mesh:
    """A structured triangle mesh (each quad split along its diagonal)."""
    xs = np.linspace(xmin, xmax, nx + 1)
    ys = np.linspace(ymin, ymax, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    z = np.asarray(z_fn(pts[:, 0], pts[:, 1])) if z_fn else np.zeros(len(pts))
    points = np.concatenate([pts, z[:, None]], axis=1)

    def vid(i, j):
        return j * (nx + 1) + i

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    i = I.ravel()
    j = J.ravel()
    t1 = np.stack([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)], axis=1)
    t2 = np.stack([vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)], axis=1)
    cells = np.concatenate([t1, t2], axis=0).astype(np.int32)

    boundary = {
        "bottom": np.stack([vid(np.arange(nx), 0), vid(np.arange(1, nx + 1), 0)], axis=1),
        "top": np.stack([vid(np.arange(nx), ny), vid(np.arange(1, nx + 1), ny)], axis=1),
        "left": np.stack([vid(0, np.arange(ny)), vid(0, np.arange(1, ny + 1))], axis=1),
        "right": np.stack([vid(nx, np.arange(ny)), vid(nx, np.arange(1, ny + 1))], axis=1),
    }
    return build_mesh(points, cells, boundary_edges=boundary)


def refine_uniform(mesh: Mesh, times: int = 1) -> Mesh:
    """Uniform red refinement: quads -> 4 quads, triangles -> 4 triangles.

    The analogue of DMPlex runtime refinement (rdydm.c:124-145). Region and
    boundary labels are carried to the children. The result equals the JAX
    package's `refine_uniform` array for array: the new vertices are the
    edge midpoints in edge order, then the quads' centroids in cell order;
    each cell's 4 children follow in cell order.
    """
    out = mesh
    for _ in range(times):
        out = _refine_once(out)
    return out


def _refine_once(mesh: Mesh) -> Mesh:
    pts = mesh.points
    NV = len(pts)
    C = mesh.num_cells
    E = mesh.num_edges

    # a midpoint vertex for every edge, found by its sorted vertex pair
    ev = mesh.edge_vertices.astype(np.int64)
    keys = np.minimum(ev[:, 0], ev[:, 1]) * NV + np.maximum(ev[:, 0], ev[:, 1])
    order = np.argsort(keys)
    sorted_keys = keys[order]
    mid_pts = (pts[ev[:, 0]] + pts[ev[:, 1]]) / 2.0

    def midpoint(a, b):
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        k = np.minimum(a, b) * NV + np.maximum(a, b)
        return NV + order[np.searchsorted(sorted_keys, k)]

    # a centroid vertex for every quad (the polygon centroid, its z the
    # mesh's centroid z)
    nv = mesh.cell_num_vertices
    quad = nv == 4
    quad_cells = np.nonzero(quad)[0]
    centroid_id = np.full(C, -1, np.int64)
    centroid_id[quad_cells] = NV + E + np.arange(len(quad_cells))
    points = np.concatenate([pts, mid_pts, mesh.cell_centroid[quad_cells]],
                            axis=0)

    cv = mesh.cell_vertices.astype(np.int64)
    new_cells = np.full((C, 4, 4), -1, np.int64)
    tri = np.nonzero(nv == 3)[0]
    if len(tri):
        v0, v1, v2 = cv[tri, 0], cv[tri, 1], cv[tri, 2]
        m01, m12, m20 = midpoint(v0, v1), midpoint(v1, v2), midpoint(v2, v0)
        new_cells[tri, 0, :3] = np.stack([v0, m01, m20], axis=1)
        new_cells[tri, 1, :3] = np.stack([v1, m12, m01], axis=1)
        new_cells[tri, 2, :3] = np.stack([v2, m20, m12], axis=1)
        new_cells[tri, 3, :3] = np.stack([m01, m12, m20], axis=1)
    if len(quad_cells):
        q = quad_cells
        v0, v1, v2, v3 = cv[q, 0], cv[q, 1], cv[q, 2], cv[q, 3]
        cc = centroid_id[q]
        m01, m12 = midpoint(v0, v1), midpoint(v1, v2)
        m23, m30 = midpoint(v2, v3), midpoint(v3, v0)
        new_cells[q, 0] = np.stack([v0, m01, cc, m30], axis=1)
        new_cells[q, 1] = np.stack([v1, m12, cc, m01], axis=1)
        new_cells[q, 2] = np.stack([v2, m23, cc, m12], axis=1)
        new_cells[q, 3] = np.stack([v3, m30, cc, m23], axis=1)
    new_cells = new_cells.reshape(4 * C, 4).astype(np.int32)

    # regions: a cell's children, sorted
    regions = {}
    for name, cids in mesh.regions.items():
        cids = np.asarray(cids, np.int64)
        kids = (4 * cids[:, None] + np.arange(4)).ravel()
        regions[name] = np.sort(kids).astype(np.int32)

    # boundaries: each boundary edge (a, b) becomes (a, m) and (m, b)
    boundary = {}
    for name, eids in mesh.boundaries.items():
        va = mesh.edge_vertices[eids, 0].astype(np.int64)
        vb = mesh.edge_vertices[eids, 1].astype(np.int64)
        m = midpoint(va, vb)
        boundary[name] = np.stack(
            [np.stack([va, m], axis=1), np.stack([m, vb], axis=1)],
            axis=1).reshape(-1, 2)

    return build_mesh(points, new_cells, regions=regions,
                      boundary_edges=boundary)
