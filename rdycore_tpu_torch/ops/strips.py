"""Row strips of a uniform raster: their layout, their buffers and the halo
exchange between them.

The counterpart of the JAX package's row-strip sharding of the fused raster
step (`make_sharded_fused_structured_stepper`,
rdycore_tpu/ops/pallas/structured_step.py:1019-1483), where one controller
runs the raster kernel per shard of a device mesh and moves the strips'
boundary rows with `ppermute`. Here one process holds P strips, each a
buffer on its own device (or several on one card): strip p owns the rows
[row0, row0 + rows) of the raster, with `halo` rows below and above that
copy its neighbours' rows (none beyond the raster's bottom and top walls).
The raster kernels take a strip buffer and its global rows (raster_step.
`Strip`); `exchange` refreshes the halo rows between launches with one
strided `copy_` per strip boundary and direction over every state row.
Between two devices that copy is ordered after the producer's launches
and before the consumer's: PyTorch's cross-device `copy_` records an event
on each side's current stream and makes the other wait on it.

Halo depth: 1 row at first order, 3 at second order (MUSCL with the
positivity limiter), as the TPU stepper's HR (:1144-1148).

Under a process group each rank holds one strip (`RankStrip`): its buffer
stays on the rank's card across intervals, and the halo rows move to and
from the neighbouring ranks through the run's transport (parallel/comm.
DistTransport), one buffer of rows each way per strip boundary. The
whole raster is gathered only where a getter, an output or a checkpoint
asks for it.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .kernels.raster_step import Strip


def strip_layout(ny: int, n_strips: int, halo: int) -> Tuple[Strip, ...]:
    """n_strips strips of ny / n_strips rows each, in row order, with `halo`
    rows on every side that is not the raster's wall."""
    if n_strips < 1 or ny % n_strips:
        raise ValueError(f"{ny} rows do not split into {n_strips} strips")
    rows = ny // n_strips
    if n_strips > 1 and rows < halo:
        raise ValueError(f"strips of {rows} rows are thinner than their "
                         f"{halo} halo rows")
    return tuple(
        Strip(p * rows, rows, halo if p > 0 else 0,
              halo if p < n_strips - 1 else 0)
        for p in range(n_strips))


def _rows(x: torch.Tensor, strip: Strip, nx: int) -> torch.Tensor:
    """The [n, R, nx] view of a strip buffer x [n, R * nx]."""
    return x.reshape(x.shape[0], strip.buffer_rows, nx)


def split_rows(x: torch.Tensor, strips: Sequence[Strip],
               devices: Sequence[torch.device], nx: int) -> List[torch.Tensor]:
    """The strip buffers [n, R * nx] of x [n, ny * nx], halo rows included,
    each on its device. A strip that is the whole raster on x's device is x
    itself."""
    xv = x.reshape(x.shape[0], -1, nx)
    out = []
    for s, d in zip(strips, devices):
        b = xv[:, s.row0 - s.halo_lo:s.row0 + s.rows + s.halo_hi]
        out.append(b.contiguous().to(d).reshape(x.shape[0], -1))
    return out


def gather_rows(bufs: Sequence[torch.Tensor], strips: Sequence[Strip],
                nx: int, device: torch.device) -> torch.Tensor:
    """The owned rows of the strip buffers, in row order, as one [n, ny *
    nx] tensor on `device` (a lone whole-raster buffer is returned as it
    is)."""
    if len(bufs) == 1 and not (strips[0].halo_lo or strips[0].halo_hi):
        return bufs[0].to(device)
    n = bufs[0].shape[0]
    return torch.cat([s.owned(b).to(device)
                      for b, s in zip(bufs, strips)], dim=1).reshape(n, -1)


def exchange(bufs: Sequence[torch.Tensor], strips: Sequence[Strip],
             nx: int) -> None:
    """Fill every halo row of the strip buffers, in place, with the rows
    of the neighbouring strips that it copies: at each strip boundary one
    strided copy of the halo rows of every state row each way."""
    for p in range(len(strips) - 1):
        lo, hi = strips[p], strips[p + 1]
        a, b = _rows(bufs[p], lo, nx), _rows(bufs[p + 1], hi, nx)
        top = lo.halo_lo + lo.rows  # the lower strip's first row above it
        b[:, :hi.halo_lo].copy_(a[:, top - hi.halo_lo:top])
        a[:, top:].copy_(b[:, hi.halo_lo:hi.halo_lo + lo.halo_hi])


def strip_wall_values(bc_vals: Optional[Dict[str, torch.Tensor]],
                      strip: Strip, ny: int,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """The Dirichlet walls' values {side: [ndof, n]} of the raster as one
    strip's launches take them: the left and right walls' rows of its
    buffer, halo rows included (a second-order halo cell's wall face reads
    them), and the bottom and top walls where the strip holds them."""
    out = {}
    for side, v in (bc_vals or {}).items():
        if side in ("left", "right"):
            v = v[:, strip.row0 - strip.halo_lo:
                  strip.row0 + strip.rows + strip.halo_hi]
        elif not (side == "bottom" and strip.row0 == 0
                  or side == "top" and strip.row0 + strip.rows == ny):
            continue
        out[side] = v.contiguous().to(device)
    return out


def strip_boundary_edges(bnd, nx: int, strip: Strip, device: torch.device):
    """(the boundary edges of `bnd` (`structured.boundary_edge_arrays`)
    whose cells the strip owns, their cells numbered in the strip buffer,
    on `device`; their columns in bnd [Eb_strip] int64), or (None, None)
    where it owns none."""
    left = bnd.bnd_left.long()
    row = left // nx
    idx = torch.nonzero((row >= strip.row0)
                        & (row < strip.row0 + strip.rows)).flatten()
    if not idx.numel():
        return None, None
    shift = (strip.halo_lo - strip.row0) * nx
    sub = {"bnd_left": (left[idx] + shift).to(torch.int32)}
    for name in ("bnd_cn", "bnd_sn", "bnd_code", "bnd_len",
                 "edge_courant_coef"):
        sub[name] = getattr(bnd, name)[idx]
    for name in ("int_left", "int_right", "int_cn", "int_sn"):  # empty
        sub[name] = getattr(bnd, name)
    # the fields an edge-flux launch reads; the cell fields stay unread
    return (dataclasses.replace(bnd, **{k: v.to(device)
                                        for k, v in sub.items()}),
            idx.to(device))


def strip_halo(strips: Sequence[Strip], k: int, nx: int):
    """Strip k's halo as a transport binds it: `send[r]`, the columns of
    its buffer that strip r's halo rows copy; `recv[r]`, the columns of
    its halo rows that strip r fills (both in row order)."""
    s = strips[k]

    def cols(r0, n):  # buffer columns of buffer rows [r0, r0 + n)
        return np.arange(r0 * nx, (r0 + n) * nx)

    send, recv = {}, {}
    if s.halo_lo:
        send[k - 1] = cols(s.halo_lo, strips[k - 1].halo_hi)
        recv[k - 1] = cols(0, s.halo_lo)
    if s.halo_hi:
        above = strips[k + 1].halo_lo
        send[k + 1] = cols(s.halo_lo + s.rows - above, above)
        recv[k + 1] = cols(s.halo_lo + s.rows, s.halo_hi)
    return types.SimpleNamespace(send=send, recv=recv)


class RankStrip:
    """Strip `rank` of the P strips of an nx-wide raster held by this
    rank: its buffer [ndof, R * nx] on `device` across intervals, its halo
    moved through `transport` (a DistTransport of P ranks, bound here to
    the strip's rows)."""

    def __init__(self, strips: Sequence[Strip], nx: int, transport,
                 device: torch.device):
        self.rank, self.P = transport.rank, len(strips)
        self.strip = strips[self.rank]
        self.nx, self.device, self.transport = nx, device, transport
        self.buf: Optional[torch.Tensor] = None
        transport.bind([strip_halo(strips, k, nx)
                        for k in range(self.P)], {self.rank: 0})

    def exchange(self, bufs: Sequence[torch.Tensor]) -> None:
        """Refresh the halo rows of this rank's buffer (bufs: [it])."""
        self.transport.exchange(self.rank, bufs[0])

    def set_state(self, q: torch.Tensor) -> None:
        """Cut the strip's rows, halo rows included, from the raster's
        state q [ndof, ny * nx] (every rank holds the same q)."""
        s, nx = self.strip, self.nx
        self.buf = q[:, (s.row0 - s.halo_lo) * nx:
                     (s.row0 + s.rows + s.halo_hi) * nx].contiguous().to(
                         self.device)

    def owned(self, x: torch.Tensor) -> torch.Tensor:
        """The owned rows [n, rows * nx] of a strip buffer x."""
        s = self.strip
        return x[:, s.halo_lo * self.nx:(s.halo_lo + s.rows) * self.nx]

    def gather(self, x: torch.Tensor, device: torch.device) -> torch.Tensor:
        """Every rank's [n, w_rank] in rank (row) order, side by side, on
        `device` (collective)."""
        return torch.cat(self.transport.all_gather({self.rank: x}, device),
                         dim=1)

    def gather_state(self, device: torch.device) -> torch.Tensor:
        """The raster's state [ndof, ny * nx] on `device` (collective)."""
        return self.gather(self.owned(self.buf), device)
