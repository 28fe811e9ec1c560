"""Programmatic structured mesh generation (a copy of
rdycore_tpu/mesh/generate.py without uniform refinement)."""

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
