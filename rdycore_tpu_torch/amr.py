"""Adaptive mesh refinement (src/rdyamr.c + driver/amr.c).

The counterpart of rdycore_tpu/amr.py. The reference marks owned cells
(from time-stamped refinement rasters: value > 0 and cell area above a
threshold, amr.c:78-110), adapts the DMPlex mesh with transition cells
(DMAdaptLabel), interpolates state through coarse->fine matrices, and
rebuilds the operator/TS (rdyamr.c:482+).

Conforming RED-GREEN refinement on tri / quad / mixed meshes:
  - marked triangles split into 4 similar children (RED); marked quads
    split 1:4 through the edge midpoints and centroid (RED)
  - closure: any cell with >= 2 refined edges is promoted to RED; with
    exactly 1 refined edge a triangle is bisected (GREEN) and a quad is
    fan-triangulated about its centroid (5 transition triangles) -- the
    DMAdaptLabel transition-cell analogue (rdyamr.c:161-223)
  - state transfer is piecewise-constant injection (children inherit the
    parent cell average -- conservative for FV)

`refine_marked` is vectorized numpy (the JAX package walks the cells in
Python) and equals the JAX package's array for array: the new vertices
are the refined edges' midpoints in edge order, then the centroids of the
split and fanned quads in cell order; each cell's children follow in cell
order, in the same vertex order; regions and boundary pairs likewise. Its
mesh comes from the port's `build_mesh` (the native builder). After
refinement the Simulation rebuilds its operator on the new mesh
(`Simulation.rebuild_on_mesh`).
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from .config.schema import ConfigError
from .mesh.core import Mesh, build_mesh, named_boundary_sets


def _children(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The concatenated ranges [starts[i], starts[i] + counts[i])."""
    total = int(counts.sum())
    first = np.repeat(np.cumsum(counts) - counts, counts)
    return np.repeat(starts, counts) + (np.arange(total) - first)


def refine_marked(mesh: Mesh, marked: np.ndarray) -> Tuple[Mesh, np.ndarray]:
    """Red-green refine the marked cells of a tri / quad / mixed mesh.

    Returns (new_mesh, parent): parent[i] = coarse cell id of fine cell i.
    """
    C = mesh.num_cells
    marked = np.asarray(marked, dtype=bool)
    if marked.shape != (C,):
        raise ValueError(f"marked must have shape ({C},)")
    if not marked.any():
        return mesh, np.arange(C)
    nvs = mesh.cell_num_vertices

    # --- closure iteration: decide RED cells -------------------------------
    # cell -> its edges (slot k is the edge (v_k, v_k+1); padding = E, the
    # dummy entry cleared after each scatter so that a triangle's padding
    # slot never counts as a refined edge)
    red = marked.copy()
    ce = mesh.cell_edges[:, :4]
    E = mesh.num_edges
    while True:
        edge_refined = np.zeros(E + 1, dtype=bool)
        edge_refined[ce[red].ravel()] = True
        edge_refined[E] = False
        slot_refined = edge_refined[ce]
        promote = (~red) & (slot_refined.sum(axis=1) >= 2)
        if not promote.any():
            break
        red |= promote
    n1 = (~red) & (slot_refined.sum(axis=1) == 1)
    green_t = n1 & (nvs == 3)  # triangle bisection
    fan_q = n1 & (nvs == 4)  # quad centroid-fan transition

    # --- new vertices: refined-edge midpoints + split-quad centroids -------
    pts = mesh.points
    NV = len(pts)
    refined_edges = np.nonzero(edge_refined[:E])[0]
    mid_of = np.full(E + 1, -1, np.int64)
    mid_of[refined_edges] = NV + np.arange(len(refined_edges))
    ev = mesh.edge_vertices[refined_edges]
    ctr_cells = np.nonzero((red | fan_q) & (nvs == 4))[0]
    ctr_of = np.full(C, -1, np.int64)
    ctr_of[ctr_cells] = NV + len(refined_edges) + np.arange(len(ctr_cells))
    points = np.concatenate([pts, (pts[ev[:, 0]] + pts[ev[:, 1]]) / 2.0,
                             mesh.cell_centroid[ctr_cells]], axis=0)

    # --- children: each cell's in turn -------------------------------------
    counts = np.ones(C, np.int64)
    counts[red] = 4
    counts[green_t] = 2
    counts[fan_q] = 5
    off = np.cumsum(counts) - counts
    parent = np.repeat(np.arange(C), counts)
    cells = np.full((int(counts.sum()), 4), -1, np.int64)
    cv = mesh.cell_vertices.astype(np.int64)
    mid = mid_of[ce]  # [C, 4]: the midpoint vertex of each refined slot

    keep = ~(red | green_t | fan_q)
    cells[off[keep]] = np.where(np.arange(4) < nvs[keep, None], cv[keep], -1)

    c = np.nonzero(red & (nvs == 3))[0]
    v, m, o = cv[c], mid[c], off[c]
    for k, kid in enumerate(([v[:, 0], m[:, 0], m[:, 2]],
                             [v[:, 1], m[:, 1], m[:, 0]],
                             [v[:, 2], m[:, 2], m[:, 1]],
                             [m[:, 0], m[:, 1], m[:, 2]])):
        cells[o + k, :3] = np.stack(kid, axis=1)

    c = np.nonzero(red & (nvs == 4))[0]
    v, m, o, ctr = cv[c], mid[c], off[c], ctr_of[c]
    for k in range(4):  # quad 1:4 through midpoints + centroid
        cells[o + k] = np.stack([v[:, k], m[:, k], ctr, m[:, (k - 1) % 4]],
                                axis=1)

    # bisect a green triangle across its one refined edge
    c = np.nonzero(green_t)[0]
    k = np.argmax(slot_refined[c, :3], axis=1)
    v, o, rows = cv[c], off[c], np.arange(len(c))
    a, b, opp = v[rows, k], v[rows, (k + 1) % 3], v[rows, (k + 2) % 3]
    m = mid[c, k]
    cells[o, :3] = np.stack([a, m, opp], axis=1)
    cells[o + 1, :3] = np.stack([m, b, opp], axis=1)

    # conforming quad transition: fan triangles about the centroid (the
    # refined edge contributes two, the others one each)
    c = np.nonzero(fan_q)[0]
    ks = np.argmax(slot_refined[c], axis=1)
    v, o, ctr = cv[c], off[c], ctr_of[c]
    m = mid[c, ks]
    for k in range(4):
        a, b = v[:, k], v[:, (k + 1) % 4]
        row = o + k + (k > ks)
        at = ks == k
        cells[row, :3] = np.stack([a, np.where(at, m, b), ctr], axis=1)
        cells[row[at] + 1, :3] = np.stack([m[at], b[at], ctr[at]], axis=1)

    # --- propagate regions: each region cell's children, sorted -----------
    regions = {}
    for name, cids in mesh.regions.items():
        cids = np.asarray(cids, np.int64)
        regions[name] = np.sort(_children(off[cids], counts[cids])).astype(
            np.int32)

    # --- propagate boundaries: a refined edge (a, b) -> (a, m), (m, b) -----
    boundary = {}
    for name, eids in named_boundary_sets(mesh).items():
        eids = np.asarray(eids, np.int64)
        split = edge_refined[eids]
        at = np.cumsum(1 + split) - (1 + split)
        va = mesh.edge_vertices[eids, 0]
        vb = mesh.edge_vertices[eids, 1]
        pairs = np.empty((len(eids) + int(split.sum()), 2), np.int64)
        pairs[at, 0] = va
        pairs[at, 1] = np.where(split, mid_of[eids], vb)
        pairs[at[split] + 1] = np.stack([mid_of[eids[split]], vb[split]],
                                        axis=1)
        boundary[name] = pairs

    new_mesh = build_mesh(points, cells, regions=regions,
                          boundary_edges=boundary)
    return new_mesh, parent


def mark_cells_from_raster(
    depth_values: np.ndarray, areas: np.ndarray, area_threshold: float = 1.0 / 8.0
) -> np.ndarray:
    """The AMR driver's marking rule (amr.c:93-103): refine where the
    dataset value is positive and the cell is still coarser than the
    threshold area."""
    return (depth_values > 0.0) & (areas > area_threshold)


def perform_amr(sim, marked: np.ndarray) -> None:
    """RDyPerformAMR (rdyamr.c:482+): refine, transfer state, rebuild.

    The state, the external-source plane, Manning's n and the map to the
    level-0 base mesh (`sim.amr_base_map`, the refine tree of rdyamr.c:95,
    used to inject base-mesh datasets onto the current mesh) pass to the
    children by parent; the source setters' bookkeeping follows the
    injected plane, so a source on the coarse mesh streams on the fine
    one. Under `cell_ordering: rcm`, and in shards under
    `parallel.partitioning: auto`, it is a ConfigError (ROADMAP fault 24):
    the rebuild reorders the refined mesh by RCM, and the JAX package then
    sets the state in the unreordered order.

    In shards (one process or ranks) the state and sources are gathered
    from the shards, injected on the host and scattered to the new
    shards; in ranks it is collective, each rank calling it with the same
    `marked` (`refine_marked` is deterministic, the same mesh on every
    rank)."""
    cfg = sim.config
    if cfg.numerics.cell_ordering == "rcm":
        raise ConfigError(
            "adaptive mesh refinement under numerics.cell_ordering: rcm: "
            "the rebuild reorders the refined mesh and the JAX package "
            "injects the state in the unreordered order, scrambling it "
            "(ROADMAP fault 24); use cell_ordering: file")
    if (sim._sharded is not None and cfg.parallel.n_devices > 1
            and cfg.parallel.partitioning == "auto"):
        raise ConfigError(
            "adaptive mesh refinement in shards under parallel."
            "partitioning: auto: the rebuild reorders the refined mesh by "
            "RCM and the JAX package injects the state in the unreordered "
            "order, scrambling it (ROADMAP fault 24); use partitioning: "
            "none")
    t0 = time.perf_counter()
    new_mesh, parent = refine_marked(sim.mesh, marked)
    if new_mesh is sim.mesh:
        return
    t_refine = time.perf_counter() - t0
    q, src = sim.q, sim.ext_src  # on the host in shards
    q = q[:, torch.as_tensor(parent, device=q.device)]  # injection
    src = src[:, torch.as_tensor(parent, device=src.device)]
    mannings = sim.mannings_n[parent]
    base_map = getattr(sim, "amr_base_map", None)
    if base_map is None:
        base_map = np.arange(sim.mesh.num_cells)
    new_base_map = base_map[parent]

    t0 = time.perf_counter()
    sim.rebuild_on_mesh(new_mesh, mannings)
    sim.amr_base_map = new_base_map
    sim.q = q
    sim.ext_src = src
    sim._src_rows = src.ne(0).any(dim=1).cpu().numpy()
    sim._ext_active = bool(sim._src_rows.any())
    sim.log.info(
        f"AMR: refined {int(np.asarray(marked).sum())} cells -> "
        f"{new_mesh.num_cells} total cells (refine_marked {t_refine:.3f} s, "
        f"rebuild {time.perf_counter() - t0:.3f} s)"
    )
