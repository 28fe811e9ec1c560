"""The partition of an unstructured operator into P shards.

The counterpart of `ShardedSWE._build_partition` (rdycore_tpu/parallel/
sharded.py:448-1240) without its Pallas slot plans: the card gathers, so
each shard holds the operator's plain arrays (`edge_cells` as int_left/
int_right, `cell_edges`, the signed coefficients) over its own local cell
space, computed with vectorized numpy from the global operator's host
arrays.

- Shard p owns the cells [p*B, min((p+1)*B, C)), B = ceil(C / P), so the
  owner of cell c is min(c // B, P - 1).
- Its interior edges are every edge incident to an owned cell
  (partition edges are computed on both sides, so no flux is sent back),
  and its ghosts the 1-deep ring those edges reach. At second order the
  edges grow by those incident to the 1-deep and 2-deep ghosts, and the
  ghosts to three rings (`MUSCL_DEPTH`): the ghosts' gradients and
  positivity drains are computed locally, and no gradient is exchanged
  (the JAX package's 2-deep halo, sharded.py:464-492, leaves the drain of
  a 1-deep ghost short of its outer edges' gradients). For the drains,
  those ghosts' boundary edges join the shard too.
- Local cells: [owned | ghosts ring by ring | 1 dummy], the ghosts in
  global order within each ring. Local edges: the interior edges in
  global order, then the owned boundary edges (those whose cell the shard
  owns) in the operator's segment order, then the inner ghosts' boundary
  edges at second order. Every local edge keeps its global id
  (`edge_gidx`: interior id, or Ei + boundary offset), so the local order
  is the global order on the edges a shard answers for.
- Each owned cell keeps its global `cell_edges` row, mapped to local edge
  ids, so the cell kernel sums its fluxes in the single-device order: the
  shards give the single-device run bit for bit. So does every ghost of
  the inner rings at second order (its gradient and drain). Cells whose
  row is not kept gather only the zero dummy edge; the next exchange
  overwrites them.
- The Courant coefficient is kept only on the edges a shard answers for:
  the interior edges incident to an owned cell and the owned boundary
  edges. Each boundary edge is owned by exactly one shard, which alone
  accumulates its flux.
- Under BS2002 the eta of an edge's endpoint vertex averages every cell
  around the vertex, and the correction it gives an edge's momentum
  fluxes reaches the owned cells through the edges of theirs. The
  endpoints of the owned cells' edges (interior and owned boundary) reach
  a last ring of ghosts, the vertex ring: the cells around them that no
  edge ring holds, in global order (the JAX package's ring,
  sharded.py:503-535). Its cells are exchanged like any other ghost and
  keep no `cell_edges` row. At second order the 1-deep ghosts' positivity
  drains read only the water row of their edges' fluxes, which the
  correction leaves alone, so the ring needs no wider base. Each shard
  keeps the BS2002 arrays of its own vertex universe, the endpoints of
  its local edges in global order: each vertex's `vertex_cells` row in
  the global row's slot order, mapped to local ids, a cell the shard
  does not hold and the padding both taken to C_loc (K5 skips c >= C;
  C_loc - 1 is the dummy cell, which it would read), and the global
  `vertex_inv_count`. So K5 sums the same cells in the same order with
  the same weight at every vertex whose eta a kept flux reads.
- The halo: shard p sends shard r the cells it owns among r's ghosts, in
  r's ghost order (`send[r]`), and r writes them to their ghost rows
  (`recv[p]`), one buffer per pair of shards that border each other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..operator import SWEOperator

# ghost rings at second order: a 1-deep ghost's positivity drain reads the
# MUSCL fluxes of its own edges, whose faces need the gradients of the
# 2-deep ghosts, which read the 3-deep ones (the raster's 3 halo rows)
MUSCL_DEPTH = 3


@dataclasses.dataclass
class ShardPlan:
    """One shard's part of the partition (global ids are the global
    operator's cell and edge numbers)."""

    p: int
    lo: int  # owned global cells [lo, hi)
    hi: int
    ghosts: np.ndarray  # [G] global cell ids, ring by ring
    rings: List[int]  # the number of ghosts in each ring
    int_edges: np.ndarray  # [Ei_loc] global interior edge ids
    bnd_edges: np.ndarray  # [Eb_loc] global boundary offsets
    n_bnd_owned: int  # the first n_bnd_owned of bnd_edges are owned
    send: Dict[int, np.ndarray]  # peer -> local owned cells to send it
    recv: Dict[int, np.ndarray]  # peer -> local ghost rows its buffer fills
    arrays: Dict[str, np.ndarray]  # the shard's operator arrays (host)
    edge_gidx: np.ndarray  # [E_loc] global edge id of each local edge
    vertex_ghosts: int = 0  # the last ghosts: BS2002's vertex ring

    @property
    def nown(self) -> int:
        return self.hi - self.lo

    @property
    def num_cells(self) -> int:
        """C_loc: owned, ghosts and the dummy cell."""
        return self.nown + len(self.ghosts) + 1

    @property
    def num_internal_edges(self) -> int:
        return len(self.int_edges)

    @property
    def num_boundary_edges(self) -> int:
        return len(self.bnd_edges)

    @property
    def owned_bnd_edges(self) -> np.ndarray:
        return self.bnd_edges[:self.n_bnd_owned]

    @property
    def local_cells(self) -> np.ndarray:
        """The global id of each local cell but the dummy."""
        return np.concatenate([np.arange(self.lo, self.hi), self.ghosts])

    @property
    def frontier(self) -> int:
        """Cells this shard sends, each counted once."""
        if not self.send:
            return 0
        return len(np.unique(np.concatenate(list(self.send.values()))))


def owner_of(cells: np.ndarray, B: int, P: int) -> np.ndarray:
    """The shard that owns each global cell."""
    return np.minimum(np.asarray(cells) // B, P - 1)


def _shard_sets(p, P, B, C, il, ir, bl, depth):
    """(interior edge ids, ghosts, the size of each ghost ring, owned
    boundary offsets, the kept ghosts' boundary offsets) of shard p with
    `depth` rings of ghosts."""
    held = np.zeros(C, bool)  # the cells the shard holds
    held[p * B:min((p + 1) * B, C)] = True
    inner = held.copy()  # the cells whose every edge the shard holds
    rings = []
    for _ in range(depth):
        eids = np.nonzero(inner[il] | inner[ir])[0]
        cells = np.concatenate([il[eids], ir[eids]])
        ring = np.unique(cells[~held[cells]])
        rings.append(ring)
        held[ring] = True
        inner[ring] = True
    kept = np.concatenate(rings[:-1]) if depth > 1 else np.zeros(0, np.int64)
    in_kept = np.zeros(C, bool)
    in_kept[kept] = True
    b_own = np.nonzero(owner_of(bl, B, P) == p)[0]
    return (eids, np.concatenate(rings).astype(np.int64),
            [len(r) for r in rings], b_own, np.nonzero(in_kept[bl])[0])


def _vertex_ring(gbs, lo, hi, ghosts, il, ir, eids, be, C):
    """BS2002's vertex ring of the shard owning [lo, hi) (global ids, in
    global order): the cells around the endpoints of the owned cells'
    edges (interior among `eids`, and the owned boundary edges `be`) that
    the edge rings do not hold."""
    own = np.zeros(C, bool)
    own[lo:hi] = True
    ie = eids[own[il[eids]] | own[ir[eids]]]
    verts = np.unique(np.concatenate([
        gbs["int_vbeg"][ie], gbs["int_vend"][ie],
        gbs["bnd_vbeg"][be], gbs["bnd_vend"][be]]).astype(np.int64))
    adj = np.unique(gbs["vertex_cells"][verts])
    held = np.zeros(C + 1, bool)  # C: the padding
    held[lo:hi] = True
    held[ghosts] = True
    held[C] = True
    return adj[~held[adj]].astype(np.int64)


def _shard_bs2002(gbs, lmap, C_loc, eids, bnd, cell_field):
    """The BS2002 arrays of a shard (host arrays) over its vertex
    universe, the endpoints of its local edges (`eids`, `bnd`) in global
    order; lmap maps global cells to local ids (-1: not held)."""
    ends = [gbs[k][eids] for k in ("int_vbeg", "int_vend")] + [
        gbs[k][bnd] for k in ("bnd_vbeg", "bnd_vend")]
    verts = np.unique(np.concatenate(ends).astype(np.int64))
    # a cell the shard does not hold, and the padding C, become C_loc
    to_local = np.append(np.where(lmap >= 0, lmap, C_loc), C_loc)
    out = {k: cell_field(gbs[k], 0.0) for k in ("z1", "z2", "z3")}
    out.update(
        vertex_cells=to_local[gbs["vertex_cells"][verts]],
        vertex_inv_count=gbs["vertex_inv_count"][verts],
        int_zvbeg=gbs["int_zvbeg"][eids], int_zvend=gbs["int_zvend"][eids],
        bnd_zvbeg=gbs["bnd_zvbeg"][bnd], bnd_zvend=gbs["bnd_zvend"][bnd])
    for k, e in zip(("int_vbeg", "int_vend", "bnd_vbeg", "bnd_vend"), ends):
        out[k] = np.searchsorted(verts, e)
    return out


def build_partition(op: SWEOperator, P: int) -> List[ShardPlan]:
    """The P shards of the operator `op` (its arrays are read on the host;
    build it on the CPU). The shards' arrays keep op's dtype, so a shard's
    operator holds exactly the values of the single-device one."""
    g = op.arrays.numpy()
    C, Ei, Eb = op.num_cells, op.num_internal_edges, op.num_boundary_edges
    E = Ei + Eb
    B = -(-C // P)
    if P < 1 or (P - 1) * B >= C:
        raise ValueError(f"{C} cells do not give each of {P} shards a cell")
    il = g["int_left"].astype(np.int64)
    ir = g["int_right"].astype(np.int64)
    bl = g["bnd_left"].astype(np.int64)
    ce = g["cell_edges"].astype(np.int64)
    so = op.second_order
    depth = MUSCL_DEPTH if so else 1

    bs = op.arrays.bs2002
    gbs = ({k: v.cpu().numpy() for k, v in bs._asdict().items()}
           if op.well_balancing_bs2002 else None)
    sets = [_shard_sets(p, P, B, C, il, ir, bl, depth) for p in range(P)]
    plans = []
    for p, (eids, ghosts, rings, b_own, b_extra) in enumerate(sets):
        lo, hi = p * B, min((p + 1) * B, C)
        n_vring = 0
        if gbs is not None:
            ring = _vertex_ring(gbs, lo, hi, ghosts, il, ir, eids, b_own, C)
            ghosts, n_vring = np.concatenate([ghosts, ring]), len(ring)
        nown, G = hi - lo, len(ghosts)
        C_loc = nown + G + 1
        lmap = np.full(C, -1, np.int64)
        lmap[lo:hi] = np.arange(nown)
        lmap[ghosts] = nown + np.arange(G)
        bnd = np.concatenate([b_own, b_extra])
        Ei_l, Eb_l = len(eids), len(bnd)
        E_l = Ei_l + Eb_l
        emap = np.full(E + 1, -1, np.int64)
        emap[eids] = np.arange(Ei_l)
        emap[Ei + bnd] = Ei_l + np.arange(Eb_l)
        emap[E] = E_l

        cells = np.concatenate([np.arange(lo, hi), ghosts])
        # the cells whose cell_edges row is kept: owned, and at second
        # order the ghosts of every ring but the outermost
        kept = nown + sum(rings[:-1])
        ce_l = np.full((C_loc, ce.shape[1]), E_l, np.int64)
        ce_l[:kept] = emap[ce[cells[:kept]]]
        missing = ce_l[:kept] < 0
        if missing.any():
            raise AssertionError(
                f"shard {p}: cells {cells[:kept][missing.any(1)][:5]} lack "
                "an edge of theirs")

        def cell_field(x, fill):
            out = np.full((C_loc,) + x.shape[1:], fill, x.dtype)
            out[:-1] = x[cells]
            return out

        a = {k: cell_field(g[k], 1.0 if k == "area" else 0.0)
             for k in ("area", "dz_dx", "dz_dy", "cell_z", "mannings_n")}
        cec = np.zeros((C_loc, ce.shape[1]), g["cell_edge_coef"].dtype)
        cec[:kept] = g["cell_edge_coef"][cells[:kept]]
        a.update(cell_edges=ce_l.astype(np.int32), cell_edge_coef=cec)
        a.update(
            int_left=lmap[il[eids]].astype(np.int32),
            int_right=lmap[ir[eids]].astype(np.int32),
            int_cn=g["int_cn"][eids], int_sn=g["int_sn"][eids],
            bnd_left=lmap[bl[bnd]].astype(np.int32),
            bnd_cn=g["bnd_cn"][bnd], bnd_sn=g["bnd_sn"][bnd],
            bnd_code=g["bnd_code"][bnd], bnd_len=g["bnd_len"][bnd],
        )
        # the Courant coefficient of the edges this shard answers for
        ccoef = g["edge_courant_coef"]
        answers = (owner_of(il[eids], B, P) == p) | (
            owner_of(ir[eids], B, P) == p)
        a["edge_courant_coef"] = np.concatenate([
            np.where(answers, ccoef[eids], 0.0).astype(ccoef.dtype),
            ccoef[Ei + b_own], np.zeros(len(b_extra), ccoef.dtype)])
        if so:
            for k in ("cell_ls_cx", "cell_ls_cy"):
                x = np.zeros((C_loc, ce.shape[1]), g[k].dtype)
                x[:kept] = g[k][cells[:kept]]
                a[k] = x
            for k in ("int_dxl", "int_dyl", "int_dxr", "int_dyr"):
                a[k] = g[k][eids]
        for k in ("int_left", "int_right", "bnd_left"):
            if (a[k] < 0).any():
                raise AssertionError(f"shard {p}: {k} reaches a cell it "
                                     "does not hold")
        if gbs is not None:
            a["bs2002"] = _shard_bs2002(gbs, lmap, C_loc, eids, bnd,
                                        cell_field)
        plans.append(ShardPlan(
            p=p, lo=lo, hi=hi, ghosts=ghosts, rings=rings, int_edges=eids,
            bnd_edges=bnd, n_bnd_owned=len(b_own), send={}, recv={},
            arrays=a, edge_gidx=np.concatenate([eids, Ei + bnd]),
            vertex_ghosts=n_vring))

    # the halo: r's ghosts that p owns, in r's ghost order
    for r, pr in enumerate(plans):
        ow = owner_of(pr.ghosts, B, P)
        for p in np.unique(ow).tolist():
            rows = np.nonzero(ow == p)[0]
            pr.recv[p] = pr.nown + rows
            plans[p].send[r] = pr.ghosts[rows] - plans[p].lo
    return plans


def neighbor_only(plans: List[ShardPlan]) -> bool:
    """Whether every ghost lies on the shard p - 1 or p + 1 (a banded
    cell order, as RCM gives; sharded.py:916-923)."""
    return all(abs(r - pl.p) <= 1 for pl in plans for r in pl.recv)


def partition_stats(plans: List[ShardPlan]) -> Tuple[List[int], List[int]]:
    """(ghosts, frontier cells) of each shard."""
    return [len(pl.ghosts) for pl in plans], [pl.frontier for pl in plans]



@dataclasses.dataclass
class ShardGroup:
    """Shards that share a device, as one operator: their local cell
    spaces side by side (shard `shards[k]` from `cell_offset[k]`), their
    interior edges merged in global order, then their boundary edges
    merged in global order (a partition edge held by two of them appears
    twice). Each cell keeps its shard's `cell_edges` row, remapped, so the
    group computes what its shards compute, bit for bit, in one launch of
    each kernel; and the edge kernel's Courant maximum falls on the lowest
    global edge among equals, as on one device. The group of one shard is
    that shard."""

    shards: List[int]
    cell_offset: List[int]
    arrays: Dict[str, np.ndarray]
    edge_gidx: np.ndarray  # [E] global edge id of each edge of the group
    owned_rows: np.ndarray  # the group's rows of its owned cells ...
    owned_cells: np.ndarray  # ... and their global ids
    owned_bnd: np.ndarray  # the group's columns of its owned boundary edges
    owned_bnd_gidx: np.ndarray  # ... and their global boundary offsets
    local_cells: np.ndarray  # global id of each cell (-1: a dummy cell)
    bnd_gidx: np.ndarray  # global boundary offset of each boundary edge

    @property
    def num_cells(self) -> int:
        return len(self.local_cells)

    @property
    def num_internal_edges(self) -> int:
        return len(self.arrays["int_left"])

    @property
    def num_boundary_edges(self) -> int:
        return len(self.arrays["bnd_left"])


_CELL_FIELDS = ("area", "dz_dx", "dz_dy", "cell_z", "mannings_n",
                "cell_edge_coef", "cell_ls_cx", "cell_ls_cy")
_INT_FIELDS = ("int_cn", "int_sn", "int_dxl", "int_dyl", "int_dxr",
               "int_dyr")
_BND_FIELDS = ("bnd_cn", "bnd_sn", "bnd_code", "bnd_len")


def _merge_bs2002(ps, offs, order_i, order_b):
    """The BS2002 arrays of the shards `ps` side by side: their vertex
    universes one after the other, each vertex's cells moved by its
    shard's cell offset (a shard's padding C_loc to the group's)."""
    bss = [pl.arrays["bs2002"] for pl in ps]
    voff = np.cumsum([0] + [len(b["vertex_inv_count"]) for b in bss])
    out = {k: np.concatenate([b[k] for b in bss])
           for k in ("z1", "z2", "z3", "vertex_inv_count")}
    out["vertex_cells"] = np.concatenate([
        np.where(b["vertex_cells"] < pl.num_cells, b["vertex_cells"] + o,
                 offs[-1]) for b, pl, o in zip(bss, ps, offs)])
    for side, order in (("int", order_i), ("bnd", order_b)):
        for k in ("vbeg", "vend"):
            out[f"{side}_{k}"] = np.concatenate([
                b[f"{side}_{k}"] + v for b, v in zip(bss, voff)])[order]
            out[f"{side}_z{k}"] = np.concatenate([
                b[f"{side}_z{k}"] for b in bss])[order]
    return out


def merge_shards(plans: List[ShardPlan], shards: List[int]) -> ShardGroup:
    """The ShardGroup of `shards` (indices into plans)."""
    ps = [plans[p] for p in shards]
    offs = np.cumsum([0] + [pl.num_cells for pl in ps])
    ei = np.cumsum([0] + [pl.num_internal_edges for pl in ps])
    eb = np.cumsum([0] + [pl.num_boundary_edges for pl in ps])
    Ei, Eb = int(ei[-1]), int(eb[-1])
    gi = np.concatenate([pl.int_edges for pl in ps])
    gb = np.concatenate([pl.bnd_edges for pl in ps])
    order_i = np.argsort(gi, kind="stable")
    order_b = np.argsort(gb, kind="stable")
    pos_i = np.empty(Ei, np.int64)
    pos_i[order_i] = np.arange(Ei)
    pos_b = np.empty(Eb, np.int64)
    pos_b[order_b] = np.arange(Eb)

    a: Dict[str, np.ndarray] = {}
    first = ps[0].arrays
    for k in _CELL_FIELDS:
        if k in first:
            a[k] = np.concatenate([pl.arrays[k] for pl in ps])
    for k in _INT_FIELDS:
        if k in first:
            a[k] = np.concatenate([pl.arrays[k] for pl in ps])[order_i]
    for k in _BND_FIELDS:
        a[k] = np.concatenate([pl.arrays[k] for pl in ps])[order_b]
    for k in ("int_left", "int_right"):
        a[k] = np.concatenate([pl.arrays[k].astype(np.int64) + o
                               for pl, o in zip(ps, offs)])[order_i]
    a["bnd_left"] = np.concatenate([
        pl.arrays["bnd_left"].astype(np.int64) + o
        for pl, o in zip(ps, offs)])[order_b]
    ces, ccoefs = [], []
    for s, pl in enumerate(ps):
        ni, nb = pl.num_internal_edges, pl.num_boundary_edges
        emap = np.concatenate([pos_i[ei[s]:ei[s] + ni],
                               Ei + pos_b[eb[s]:eb[s] + nb], [Ei + Eb]])
        ces.append(emap[pl.arrays["cell_edges"]])
        ccoefs.append(pl.arrays["edge_courant_coef"])
    a["cell_edges"] = np.concatenate(ces)
    cc = np.concatenate([np.concatenate([c[:pl.num_internal_edges]
                                         for c, pl in zip(ccoefs, ps)])
                         [order_i],
                         np.concatenate([c[pl.num_internal_edges:]
                                         for c, pl in zip(ccoefs, ps)])
                         [order_b]])
    a["edge_courant_coef"] = cc
    for k in ("int_left", "int_right", "bnd_left", "cell_edges"):
        a[k] = a[k].astype(np.int32)
    if "bs2002" in first:
        a["bs2002"] = _merge_bs2002(ps, offs, order_i, order_b)

    owned_bnd = np.concatenate([
        pos_b[eb[s]:eb[s] + pl.n_bnd_owned] for s, pl in enumerate(ps)])
    return ShardGroup(
        shards=list(shards), cell_offset=[int(o) for o in offs[:-1]],
        arrays=a,
        edge_gidx=np.concatenate([
            np.concatenate([pl.edge_gidx[:pl.num_internal_edges]
                            for pl in ps])[order_i],
            np.concatenate([pl.edge_gidx[pl.num_internal_edges:]
                            for pl in ps])[order_b]]),
        owned_rows=np.concatenate([np.arange(pl.nown) + o
                                   for pl, o in zip(ps, offs)]),
        owned_cells=np.concatenate([np.arange(pl.lo, pl.hi) for pl in ps]),
        owned_bnd=owned_bnd,
        owned_bnd_gidx=np.concatenate([pl.owned_bnd_edges for pl in ps]),
        local_cells=np.concatenate([np.append(pl.local_cells, -1)
                                    for pl in ps]),
        bnd_gidx=gb[order_b])
