"""The transports between shards: P shards in one process, or one shard
per torch.distributed rank, and how ranks start.

A transport groups the P shards of a run into units (`units[u]`, the
shards of unit u), each stepped as one operator on one device, of which
this process holds `local_units`. It moves each stage's halo
(`exchange(u, q)`: fill unit u's ghost rows of q in place from the
shards that own them), runs a function on each unit it holds (`run`),
and gathers per-unit tensors from all units (`all_gather`).

- `LocalTransport`: all P shards in this process; the shards of one
  device are one unit. The halo within a unit is one `index_select` of
  the owners' rows and one `index_copy_` into the ghost rows
  (ops/strips.exchange does the same with row slices). Units on several
  devices run in one thread each; their exchange is a barrier, the
  copies from each neighbouring unit, and a second barrier, so that no
  unit moves on while another still reads its state. Across cards the
  copy is ordered after the producer's launches by PyTorch's
  cross-device copy (an event on each side's stream); on one card, by
  the stream.
- `DistTransport`: the shard of this rank of a process group. The halo
  moves by the backend's quicker way, both timed on H100s: under NCCL
  one all-gather of every rank's frontier buffer a stage (the JAX
  package's all_gather halo; four cards 0.34-0.35 ms a stage against
  point-to-point's 1.39-1.49, tools/torch_shard_cards.py); under gloo
  `batch_isend_irecv` of one buffer per neighbour each way (two ranks on
  one card 1.60-2.07 ms against the all-gather's 2.40-2.70, chip_smoke.py
  phase 14a). NCCL is the backend for CUDA ranks; gloo takes host
  tensors only, so under gloo a CUDA shard's buffers go through pinned
  host buffers (the only way for two ranks to share one card, which NCCL
  refuses). The group's timeout turns a dead peer into an error; nothing
  carries on with fewer ranks.

Each transport also takes a global sum of per-shard partials
(`global_sum(u, x)`, x the partials of unit u's shards): every shard's
partial is gathered and they are added one after the other in shard
order, the same additions on every rank and in every transport (no
all_reduce, whose order the backend picks), so that every rank holds the
same scalar and a run with a given P repeats bit for bit (the
determinism contract of docs/architecture.md, L1). `exchange_dual`
moves a forward-mode AD dual tensor's halo: its primal and tangent as one
buffer of 2 ndof rows, one message, both written back (neither
torch.distributed nor the copies carry a tangent).

`OwnedAccumulators` holds the accumulators of a run in shards or rank
strips on the units' devices, each unit's owned part, and gathers them
only when they are read.

`init_from_env()` starts the group of a `torchrun` rank; `spawn(fn,
world, backend, store_dir)` starts `world` ranks of fn with the spawn
start method over a FileStore in store_dir (no TCP port to collide on)
and returns what each rank's fn returned.
"""

from __future__ import annotations

import datetime
import os
import threading
import uuid
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
import torch.distributed as dist

# the process group's timeout: a rank that waits longer on a peer fails
DEFAULT_TIMEOUT_S = 600.0
# the most that one all-gather of DistTransport moves over all ranks
GATHER_BYTES = 1 << 28


def ordered_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """parts[0] + parts[1] + ... in that order."""
    acc = parts[0]
    for x in parts[1:]:
        acc = acc + x
    return acc


def exchange_dual(exchange: Callable[[torch.Tensor], None],
                  q: torch.Tensor) -> None:
    """exchange(q) (fill q's ghost rows in place); for a dual tensor of
    forward-mode AD, its primal and tangent stacked into one buffer [2
    ndof, C], exchanged as one message, and both written back into q."""
    primal, tangent = fwAD.unpack_dual(q)
    if tangent is None:
        exchange(q)
        return
    n = q.shape[0]
    buf = torch.cat([primal, tangent])
    exchange(buf)
    with torch.no_grad():
        primal.copy_(buf[:n])
        tangent.copy_(buf[n:])


class LocalTransport:
    """P shards in one process, shard p on devices[p]. The shards of one
    device form one unit (parallel/partition.ShardGroup): one operator,
    one state, one launch of each kernel per stage for all of them."""

    distributed = False

    def __init__(self, devices: Sequence[torch.device],
                 timeout: float = DEFAULT_TIMEOUT_S):
        devices = [torch.device(d) for d in devices]
        self.P = len(devices)
        self.unit_devices = list(dict.fromkeys(devices))
        self.units = [[p for p in range(self.P) if devices[p] == d]
                      for d in self.unit_devices]
        self.local_units = list(range(len(self.units)))
        self._posted: List[Optional[torch.Tensor]] = [None] * len(
            self.units)
        self._barrier = (threading.Barrier(len(self.units), timeout=timeout)
                         if len(self.units) > 1 else None)
        self._pairs: Dict[int, Dict[int, tuple]] = {}

    def device_of(self, u: int) -> torch.device:
        return self.unit_devices[u]

    def bind(self, plans, offsets: Dict[int, int]) -> None:
        """Take the halos of the shards' plans; offsets[p] is shard p's
        first row in its unit's state."""
        unit_of = {p: u for u, ps in enumerate(self.units) for p in ps}
        pairs: Dict[int, Dict[int, list]] = {u: {} for u in self.local_units}
        for r, pr in enumerate(plans):
            for p, rows in sorted(pr.recv.items()):
                src = offsets[p] + plans[p].send[r]
                dst = offsets[r] + rows
                lists = pairs[unit_of[r]].setdefault(unit_of[p], ([], []))
                lists[0].append(src)
                lists[1].append(dst)
        self._pairs = {
            u: {su: (torch.as_tensor(np.concatenate(s), device=self.
                                     unit_devices[su]),
                     torch.as_tensor(np.concatenate(d), device=self.
                                     unit_devices[u]))
                for su, (s, d) in by.items()}
            for u, by in pairs.items()}

    def exchange(self, u: int, q: torch.Tensor) -> None:
        """Fill unit u's ghost rows of q (its stage state) in place."""
        pairs = self._pairs[u]
        if self._barrier is not None:
            self._posted[u] = q
            self._barrier.wait()
        for su, (src, dst) in pairs.items():
            x = q if su == u else self._posted[su]
            q.index_copy_(1, dst, x.index_select(1, src).to(q.device))
        if self._barrier is not None:
            self._barrier.wait()

    def global_sum(self, u: int, x: torch.Tensor) -> torch.Tensor:
        """The sum of every shard's partial (x: unit u's, [len(units[u])]),
        added in shard order, on x's device."""
        if self._barrier is None:
            got = {u: x}
        else:
            self._posted[u] = x
            self._barrier.wait()
            got = {su: self._posted[su].to(x.device)
                   for su in range(len(self.units))}
            self._barrier.wait()
        parts = [None] * self.P
        for su, ps in enumerate(self.units):
            for k, p in enumerate(ps):
                parts[p] = got[su][k]
        return ordered_sum(parts)

    def run(self, fn: Callable[[int], object]) -> Dict[int, object]:
        """fn(u) for every unit: with one unit here, with more (several
        devices) each in its own thread. A unit that raises breaks the
        others' barriers; the first error is raised here."""
        if self._barrier is None:
            return {0: fn(0)}
        out: Dict[int, object] = {}
        errors: List[BaseException] = []

        def body(u):
            try:
                if self.unit_devices[u].type == "cuda":
                    torch.cuda.set_device(self.unit_devices[u])
                out[u] = fn(u)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(u,), daemon=True)
                   for u in self.local_units]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            self._barrier.reset()
            raise next((e for e in errors
                        if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        return out

    def all_gather(self, parts: Dict[int, torch.Tensor],
                   device: torch.device) -> List[torch.Tensor]:
        """Every unit's tensor (shapes may differ), on `device`."""
        return [parts[u].to(device) for u in range(len(self.units))]


class DistTransport:
    """The shard of this rank of the default process group, on `device`:
    unit u is the shard of rank u. Every collective here is entered by
    every rank in the same order."""

    distributed = True

    def __init__(self, device: torch.device):
        if not dist.is_initialized():
            raise RuntimeError("DistTransport needs a process group")
        self.P = dist.get_world_size()
        self.rank = dist.get_rank()
        self.units = [[p] for p in range(self.P)]
        self.local_units = [self.rank]
        self.device = device
        self.backend = dist.get_backend()
        if self.backend == "nccl" and device.type != "cuda":
            raise ValueError("an NCCL group needs CUDA shards")
        # gloo moves host tensors only: CUDA buffers go through host ones
        self.staged = self.backend == "gloo" and device.type == "cuda"
        self._host: Dict[tuple, torch.Tensor] = {}
        # the first collective of a group is entered by all its ranks:
        # make it this one, before any halo traffic
        self.all_gather({self.rank: torch.zeros(1, device=device)}, device)

    def device_of(self, u: int) -> torch.device:
        return self.device

    def bind(self, plans, offsets: Dict[int, int]) -> None:
        """Take this rank's halo from the plans (`send[r]`: the rows rank r
        needs, `recv[p]`: the ghost rows rank p fills), for both ways: one
        buffer per peer, or every rank's sends side by side, peer by peer,
        in one frontier buffer that this rank's ghosts are read from."""
        me = self.rank
        pl = plans[me]

        def idx(x):
            return torch.as_tensor(np.asarray(x, np.int64),
                                   device=self.device)

        self._send = {r: idx(v) for r, v in sorted(pl.send.items())}
        self._recv = {r: idx(v) for r, v in sorted(pl.recv.items())}
        sizes = [sum(len(v) for v in p.send.values()) for p in plans]
        self._width = max(max(sizes), 1)
        self._send_all = idx(np.concatenate(
            [pl.send[r] for r in sorted(pl.send)] or [np.zeros(0)]))
        src, rows = [], []
        for p, rows_p in sorted(pl.recv.items()):
            off = sum(len(plans[p].send[r]) for r in sorted(plans[p].send)
                      if r < me)
            src.append(p * self._width + off + np.arange(len(rows_p)))
            rows.append(rows_p)
        self._ghost_src = idx(np.concatenate(src or [np.zeros(0)]))
        self._ghost_rows = idx(np.concatenate(rows or [np.zeros(0)]))

    def exchange(self, u: int, q: torch.Tensor) -> None:
        """Fill the ghost rows of q in place from the ranks that own them:
        one all-gather under NCCL, point-to-point buffers under gloo."""
        if self.P == 1:
            return
        if self.backend == "nccl":
            self.exchange_gather(q)
        else:
            self.exchange_p2p(q)

    def exchange_p2p(self, q: torch.Tensor) -> None:
        """The halo by `batch_isend_irecv`, one buffer per neighbour each
        way (through pinned host buffers when staged)."""
        ops, recvs = [], []
        for r, idx in self._send.items():
            buf = q.index_select(1, idx)
            if self.staged:
                buf = self._pinned(("s", r), buf.shape, q.dtype).copy_(buf)
            ops.append(dist.P2POp(dist.isend, buf, r))
        for r, rows in self._recv.items():
            shape = (q.shape[0], rows.numel())
            if self.staged:
                buf = self._pinned(("r", r), shape, q.dtype)
            else:
                buf = torch.empty(shape, dtype=q.dtype, device=q.device)
            ops.append(dist.P2POp(dist.irecv, buf, r))
            recvs.append((rows, buf))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for rows, buf in recvs:
            q.index_copy_(1, rows, buf.to(q.device))

    def exchange_gather(self, q: torch.Tensor) -> None:
        """The halo by one all-gather of every rank's frontier buffer,
        padded to the longest (through the host under gloo)."""
        n = q.shape[0]
        buf = q.new_zeros((n, self._width))
        buf[:, :self._send_all.numel()] = q.index_select(1, self._send_all)
        if self.backend == "nccl":
            out = q.new_empty((self.P, n, self._width))
            dist.all_gather_into_tensor(out, buf)
        else:  # gloo: host tensors, a list
            host = buf.cpu()
            parts = [torch.empty_like(host) for _ in range(self.P)]
            dist.all_gather(parts, host)
            out = torch.stack(parts).to(q.device)
        flat = out.permute(1, 0, 2).reshape(n, -1)
        q.index_copy_(1, self._ghost_rows,
                      flat.index_select(1, self._ghost_src))

    def global_sum(self, u: int, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's partial (x: this rank's, [1]), gathered
        and added in rank order on every rank, on x's device."""
        if self.backend == "nccl":
            out = x.new_empty(self.P)
            dist.all_gather_into_tensor(out, x)
        else:
            out = torch.cat(self._gather_equal(x.cpu())).to(x.device)
        return ordered_sum(list(out))

    def _pinned(self, key, shape, dtype) -> torch.Tensor:
        """The pinned host buffer `key` of this shape and dtype (one for
        each number of rows: a state's, and a dual state's twice that)."""
        key = key + (shape[0],)
        buf = self._host.get(key)
        if buf is None or buf.shape != shape or buf.dtype != dtype:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._host[key] = buf
        return buf

    def run(self, fn: Callable[[int], object]) -> Dict[int, object]:
        return {self.rank: fn(self.rank)}

    def all_gather(self, parts: Dict[int, torch.Tensor],
                   device: torch.device) -> List[torch.Tensor]:
        """Every rank's tensor, on `device`: the tensors may differ in
        their last dimension (they are padded to the longest for the
        collective and cut back). The collective moves pieces of at most
        GATHER_BYTES over all ranks, each taken to `device` before the
        next, so an NCCL gather to the host never holds the whole on a
        card."""
        x = parts[self.rank]
        wire = self._wire_device()
        n = torch.tensor([x.shape[-1]], dtype=torch.long)
        lens = self._gather_equal(n.to(wire))
        widths = [int(v) for v in torch.cat(lens).cpu().tolist()]
        w = max(widths)
        pad = x.new_zeros(x.shape[:-1] + (w,))
        pad[..., :x.shape[-1]] = x
        col = max(pad[..., :1].numel() * pad.element_size(), 1) * self.P
        step = max(GATHER_BYTES // col, 1)
        got = [[] for _ in range(self.P)]
        for c in (range(0, w, step) if w else [0]):
            for k, g in enumerate(self._gather_equal(
                    pad[..., c:c + step].to(wire))):
                got[k].append(g.to(device))
        return [torch.cat(g, dim=-1)[..., :k] for g, k in zip(got, widths)]

    def _wire_device(self) -> torch.device:
        return torch.device("cpu") if self.backend == "gloo" else self.device

    def _gather_equal(self, x: torch.Tensor) -> List[torch.Tensor]:
        out = [torch.empty_like(x) for _ in range(self.P)]
        dist.all_gather(out, x.contiguous())
        return out


class OwnedAccumulators:
    """The accumulators of a run in shards or rank strips: the
    time-summed state and primitives ([ndof, C]) and boundary fluxes
    ([ndof, max(Eb, 1)]). Each unit held here keeps the f64 totals of
    its owned cells and boundary edges on its device; `gather` puts every
    unit's into the global host arrays when they are read (collective
    over the ranks), `set` takes them from global host arrays.

    `owned[u]` = (global cells, global boundary edges) of every unit u,
    in the order `add` gives them. An interval's values are summed in
    f64 as the host arrays of a run on one device sum them, so the
    totals are that run's bit for bit."""

    def __init__(self, transport, owned: Sequence[tuple], ndof: int,
                 n_cells: int, n_bnd: int):
        self.transport, self.owned = transport, list(owned)
        self.shape = (ndof, n_cells, max(n_bnd, 1))
        self.totals = {
            u: torch.zeros((ndof, 2 * len(owned[u][0]) + len(owned[u][1])),
                           dtype=torch.float64,
                           device=transport.device_of(u))
            for u in transport.local_units}
        self._host: Optional[list] = None

    def add(self, u: int, sol: torch.Tensor, prim: torch.Tensor,
            bflux: Optional[torch.Tensor]) -> None:
        """Add unit u's interval: sol, prim [ndof, owned cells], bflux
        [ndof, owned boundary edges] or None (no fluxes accumulated)."""
        parts = [sol, prim] + ([] if bflux is None else [bflux])
        x = torch.cat(parts, dim=1).double()
        self.totals[u][:, :x.shape[1]] += x
        self._host = None

    def gather(self) -> list:
        """[accum_sol, accum_prim, bflux_accum], global host f64 arrays
        (gathered once after each `add`; collective over the ranks)."""
        if self._host is None:
            ndof, C, nb = self.shape
            sol, prim = np.zeros((ndof, C)), np.zeros((ndof, C))
            bflux = np.zeros((ndof, nb))
            parts = self.transport.all_gather(self.totals,
                                              torch.device("cpu"))
            for (cells, bnd), x in zip(self.owned, parts):
                x, n = x.numpy(), len(cells)
                sol[:, cells] = x[:, :n]
                prim[:, cells] = x[:, n:2 * n]
                bflux[:, bnd] = x[:, 2 * n:]
            self._host = [sol, prim, bflux]
        return self._host

    def set(self, sol: np.ndarray, prim: np.ndarray,
            bflux: np.ndarray) -> None:
        """Take the totals from the global host arrays (not collective)."""
        self._host = [sol, prim, bflux]
        for u, tot in self.totals.items():
            cells, bnd = self.owned[u]
            tot.copy_(torch.as_tensor(np.concatenate(
                [sol[:, cells], prim[:, cells], bflux[:, bnd]], axis=1)))


def transport_for(n_shards: int, devices: Sequence[torch.device]):
    """The transport of a run of n_shards: one shard per rank when a
    process group exists (its world size must be n_shards; `devices[0]`
    is this rank's device), else all of them here on `devices`."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world != n_shards:
            from ..config.schema import ConfigError

            raise ConfigError(
                f"parallel.n_devices = {n_shards} but the process group "
                f"has {world} ranks; run one rank per shard")
        return DistTransport(devices[0])
    return LocalTransport(devices)


# ----------------------------------------------------------------- ranks

def init_from_env(cpu: bool = False,
                  timeout: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group of a `torchrun` rank (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT in the environment): NCCL on the
    card LOCAL_RANK, or gloo on the CPU with `cpu`. Returns the rank's
    device."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if cpu:
        backend, device = "gloo", torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for this rank; pass --cpu "
                               "to run the ranks on the CPU over gloo")
        torch.cuda.set_device(local)
        backend, device = "nccl", torch.device("cuda", local)
    kw = dict(backend=backend, init_method="env://",
              timeout=datetime.timedelta(seconds=timeout))
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(**kw)
    return device


def _spawn_entry(rank, fn, world, backend, store_path, timeout, args,
                 result_dir, device):
    store = dist.FileStore(store_path, world)
    if device is not None:
        device = torch.device(device.format(rank=rank))
        if device.type == "cuda":
            torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(result_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str, store_dir: str,
          args: tuple = (), timeout: float = DEFAULT_TIMEOUT_S,
          device: Optional[str] = None) -> List[object]:
    """Run fn(rank, world, *args) in `world` new processes (the spawn start
    method: the parent may already hold CUDA), each joined to a process
    group of `backend` over a FileStore in `store_dir`, each on `device`
    where given (its current CUDA device; "cuda:{rank}" gives rank r the
    card r); returns fn's results in rank order (saved with torch.save, so
    tensors and numpy arrays travel).
    A rank that fails makes this raise; the others are stopped."""
    import torch.multiprocessing as mp

    tag = uuid.uuid4().hex
    store_path = os.path.join(store_dir, f"store-{tag}")
    result_dir = os.path.join(store_dir, f"results-{tag}")
    os.makedirs(result_dir)
    mp.start_processes(
        _spawn_entry, args=(fn, world, backend, store_path, timeout, args,
                            result_dir, device),
        nprocs=world, join=True, start_method="spawn")
    return [torch.load(os.path.join(result_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
