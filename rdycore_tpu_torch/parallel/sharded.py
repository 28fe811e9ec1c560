"""The unstructured path in P shards: one per torch.distributed rank, or
all P in one process.

The counterpart of the JAX package's `ShardedSWE` (rdycore_tpu/parallel/
sharded.py), with its names (`scatter_state`, `gather_state`,
`courant_location`, `make_interval_fn`), over a transport
(parallel/comm.py) instead of a shard_map:

- the partition (parallel/partition.py) gives each shard the port's plain
  operator arrays over its local cell space, so each shard runs the
  single-device kernels (K1a, K1b, K1c; K3a and K3b at second order; K1a
  and K1b in their HR modes; K5 and K1a's BS2002 correction over the
  shard's vertex ring under BS2002) on its own `SWEOperator`;
- each shard's interval is `timestepping.make_interval_advancer` with its
  hooks: the halo exchange before every edge phase (a dual tensor's
  primal and tangent in one message, `comm.exchange_dual`); ghost rows
  left stale by a stage are overwritten by the next exchange
  (sharded.py:316-320), and only the owned rows are gathered;
- beuler's Newton-GMRES (`newton_beuler_solve`) takes every inner product
  over the owned columns of each shard, then the transport's global sum
  of the P partials in shard order (the JAX package's psum,
  timestepping.py:127-133); its JVPs go through each shard's
  linearization twin with the exchange inside, so the Jacobian is the
  global one;
- the Courant number: each shard folds its own maximum, the step of it
  and the edge (its global id); the P triples are gathered and every
  shard picks the largest maximum, then the earliest step, then the
  lowest edge: the single-device (max, edge) (MPI's MAXLOC, ties to the
  lowest index, `ShardedSWE.courant_location`, sharded.py:1265);
- the boundary-flux accumulator: each boundary edge is owned by the shard
  of its cell, which alone accumulates it. Each unit keeps the totals of
  its owned columns, and of the owned rows of the time-averaged state
  and primitives, on its device (`accumulators`, parallel/comm.
  OwnedAccumulators); they are scattered into the global arrays only
  when read. No sum across shards, no float atomics. (The JAX package's
  sharded path does not accumulate at all, ROADMAP fault 27.)

The shards of a run give the single-device run bit for bit (BS2002
included): state, time, Courant maximum and edge, accumulators, under
euler, ssprk2, ssprk3, rk4 and ark_imex (its friction solve is
cell-local). beuler's global sums add per-shard partials, so it agrees
with the single device to rounding, and repeats bit for bit at a given
P. `counts` tells the collectives this process's first unit entered:
halo exchanges and global sums.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..operator import SWEOperator, arrays_from_numpy
from ..timestepping import make_interval_advancer
from .comm import LocalTransport, OwnedAccumulators, exchange_dual
from .partition import (
    ShardGroup,
    ShardPlan,
    build_partition,
    merge_shards,
    neighbor_only,
)



class ShardedResult(NamedTuple):
    """One interval of the P shards: the shard states stay where they
    are, the accumulators are added to `ShardedSWE.accumulators` on the
    units' devices; the rest is on the host, the same on every rank."""

    qs: Dict[int, torch.Tensor]  # the states of the units held here
    t: float
    max_courant: float
    courant_edge: int  # global edge id (the operator's edge order)
    accum_time: float


class ShardedSWE:
    """The operator `op` (built on the CPU; its arrays are read on the
    host) in n_shards shards over `transport` (a LocalTransport on
    `devices`, one per shard, when none is given). The transport groups
    the shards into units (parallel/comm.py); this process steps the
    units `units`, each with its operator `ops[u]` on its device."""

    def __init__(self, op: SWEOperator, n_shards: int, transport=None,
                 devices: Optional[List[torch.device]] = None):
        self.ref_op = op
        self.P = n_shards
        self.dtype = op.arrays.area.dtype
        self.plans: List[ShardPlan] = build_partition(op, n_shards)
        self.B = self.plans[0].nown
        if transport is None:
            transport = LocalTransport(devices or [torch.device("cpu")]
                                       * n_shards)
        self.transport = tr = transport
        offsets = {}
        for ps in tr.units:
            row = 0
            for p in ps:
                offsets[p] = row
                row += self.plans[p].num_cells
        tr.bind(self.plans, offsets)
        self.units = list(tr.local_units)
        self.neighbor_only = neighbor_only(self.plans)
        self.groups: Dict[int, ShardGroup] = {}
        self.ops: Dict[int, SWEOperator] = {}
        self._gidx: Dict[int, torch.Tensor] = {}
        self._idx: Dict[int, dict] = {}
        for u in self.units:
            g = self.groups[u] = merge_shards(self.plans, tr.units[u])
            dev = tr.device_of(u)
            self.ops[u] = dataclasses.replace(
                op, arrays=arrays_from_numpy(g.arrays, dev, self.dtype),
                segments=(), num_cells=g.num_cells,
                num_internal_edges=g.num_internal_edges,
                num_boundary_edges=g.num_boundary_edges)
            self._gidx[u] = torch.as_tensor(g.edge_gidx, device=dev)
            held = np.nonzero(g.local_cells >= 0)[0]
            self._idx[u] = dict(
                held=torch.as_tensor(held, device=dev),
                cells=torch.as_tensor(g.local_cells[held]),
                bnd=torch.as_tensor(g.bnd_gidx),
                owned=torch.as_tensor(g.owned_rows, device=dev),
                owned_bnd=torch.as_tensor(g.owned_bnd, device=dev))
        # every unit's owned cells and boundary edges, as gathered
        self._owned = [(np.concatenate([np.arange(self.plans[p].lo,
                                                  self.plans[p].hi)
                                        for p in ps]),
                        np.concatenate([self.plans[p].owned_bnd_edges
                                        for p in ps]))
                       for ps in tr.units]
        self.accumulators = OwnedAccumulators(
            tr, self._owned, op.ndof, op.num_cells, op.num_boundary_edges)
        # each unit's shards' owned rows: (first row, count)
        self._spans = {u: [(o, self.plans[p].nown) for p, o in zip(
            self.groups[u].shards, self.groups[u].cell_offset)]
            for u in self.units}
        self.counts = {"exchange": 0, "global_sum": 0}

    def exchange(self, u: int, q: torch.Tensor) -> None:
        """Fill unit u's ghost rows of q in place (a dual tensor's primal
        and tangent alike)."""
        if u == self.units[0]:
            self.counts["exchange"] += 1
        exchange_dual(lambda x: self.transport.exchange(u, x), q)

    def gdot(self, u: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The global inner product of two states of unit u: each shard's
        sum over its owned columns, then the global sum of the P partials
        in shard order (collective)."""
        if u == self.units[0]:
            self.counts["global_sum"] += 1
        parts = torch.stack([(a[:, o:o + n] * b[:, o:o + n]).sum()
                             for o, n in self._spans[u]])
        return self.transport.global_sum(u, parts)

    def device_of(self, u: int) -> torch.device:
        return self.transport.device_of(u)

    # ------------------------------------------------------ scatter/gather
    def scatter_state(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        """A global per-cell array x [n, C] (the operator's cell order) as
        the [n, C_u] of each unit held here: owned and ghost rows filled,
        the dummy cells zero."""
        out = {}
        for u in self.units:
            ix = self._idx[u]
            loc = torch.zeros((x.shape[0], self.groups[u].num_cells),
                              dtype=x.dtype, device=self.device_of(u))
            loc.index_copy_(1, ix["held"], x.index_select(
                1, ix["cells"].to(x.device)).to(loc.device))
            out[u] = loc
        return out

    def scatter_boundary(self, bv: torch.Tensor) -> Dict[int, torch.Tensor]:
        """Global boundary values bv [n, >= Eb] as each unit's [n,
        max(Eb_u, 1)]."""
        out = {}
        for u in self.units:
            nb = self.groups[u].num_boundary_edges
            loc = torch.zeros((bv.shape[0], max(nb, 1)), dtype=bv.dtype,
                              device=self.device_of(u))
            if nb:
                loc[:, :nb] = bv.index_select(
                    1, self._idx[u]["bnd"].to(bv.device)).to(loc.device)
            out[u] = loc
        return out

    def gather_state(self, qs: Dict[int, torch.Tensor],
                     device: torch.device) -> torch.Tensor:
        """The owned rows of every shard, [n, C] on `device` (collective
        over the ranks)."""
        parts = self.transport.all_gather(
            {u: qs[u].index_select(1, self._idx[u]["owned"])
             for u in self.units}, device)
        n = parts[0].shape[0]
        out = torch.empty((n, self.ref_op.num_cells), dtype=parts[0].dtype,
                          device=device)
        for (cells, _), x in zip(self._owned, parts):
            out[:, torch.as_tensor(cells, device=device)] = x
        return out

    def set_cell_field(self, name: str, values: np.ndarray) -> None:
        """Replace the per-cell operator array `name` ([C], global order)
        on every unit held here (Manning's n)."""
        for u in self.units:
            g = self.groups[u]
            a = self.ops[u].arrays
            held = g.local_cells >= 0
            loc = np.zeros(g.num_cells)
            loc[held] = np.asarray(values)[g.local_cells[held]]
            setattr(a, name, torch.as_tensor(loc, dtype=self.dtype,
                                             device=self.device_of(u)))

    @staticmethod
    def courant_location(info: np.ndarray) -> tuple:
        """(max Courant number, global edge id) from the units' [U, 3]
        (max, step of it, global edge) rows: the largest maximum, then the
        earliest step, then the lowest edge (MAXLOC)."""
        info = np.asarray(info, dtype=np.float64)
        best = info[info[:, 0] == info[:, 0].max()]
        row = best[np.lexsort((best[:, 2], best[:, 1]))[0]]
        return float(row[0]), int(row[2])

    # ------------------------------------------------------------ advance
    def make_interval_fn(self, scheme: str = "euler",
                         accumulate: bool = True, ext_sources: bool = True):
        """advance(qs, t0, dt, n_steps, t_end, bvs, ess) -> ShardedResult:
        one interval on every unit held here (qs, bvs, ess: per-unit
        state, boundary values and sources from `scatter_state` /
        `scatter_boundary`). With `accumulate`, each unit's interval is
        added to `accumulators`."""
        tr = self.transport
        advs = {
            u: make_interval_advancer(
                self.ops[u], scheme, accumulate=accumulate,
                ext_sources=ext_sources,
                exchange=lambda q, u=u: self.exchange(u, q),
                gdot=lambda a, b, u=u: self.gdot(u, a, b))
            for u in self.units}
        host = torch.device("cpu")

        def advance(qs, t0, dt, n_steps, t_end, bvs, ess):
            res = tr.run(lambda u: advs[u](qs[u], t0, dt, n_steps, t_end,
                                           bvs[u], ess[u]))
            info = {u: torch.stack([
                r.max_courant.double(), r.courant_step.double(),
                self._gidx[u][r.courant_edge.long()].double()])
                for u, r in res.items()}
            rows = torch.stack(tr.all_gather(info, host)).numpy()
            cmax, cedge = self.courant_location(rows)
            r0 = res[self.units[0]]
            if accumulate:
                for u, r in res.items():
                    ix = self._idx[u]
                    self.accumulators.add(
                        u, r.accum_sol.index_select(1, ix["owned"]),
                        r.accum_prim.index_select(1, ix["owned"]),
                        r.bflux_accum.index_select(1, ix["owned_bnd"]))
            return ShardedResult(
                qs={u: r.q for u, r in res.items()}, t=float(r0.t),
                max_courant=cmax, courant_edge=cedge,
                accum_time=float(r0.accum_time))

        return advance
