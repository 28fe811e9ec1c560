"""Backward Euler (`temporal: beuler`) in P shards in one process
(rdycore_tpu_torch/parallel/sharded.py over a LocalTransport) against the
port's single-device interval, in float64 on the CPU, on the deck of
tests/test_sharded.py's beuler test (structured_quad(32, 8), 4 steps of
5e-3 s). The Newton and GMRES sizes are cut to 2 and 2 (the CPU's
forward-mode AD takes some 45 ms a JVP here); the chip runs 6 and 16.

- 2 and 4 shards agree with the single device to 1e-12 (every inner
  product is a global sum of per-shard partials, so the rounding differs),
  and a run at a given P repeats bit for bit; 4 shards stepped as two
  units in two threads (a forward-mode AD level shared by the threads)
  are the one-unit run bit for bit: both add the same partials in shard
  order.
- The global sum adds the shards' partials in shard order, in every
  unit.
- A JVP through a shard's linearization twin, the exchange inside, has
  the owned rows of the single device's JVP, whatever the tangent's ghost
  rows held; a twin rebuilt from the exchanging operator's fields loses
  the exchange, and its JVP does not. A dual tensor's halo is one message
  of 2 ndof rows.
"""

import numpy as np
import pytest
import torch

from rdycore_tpu_torch import timestepping
from rdycore_tpu_torch.mesh import structured_quad
from rdycore_tpu_torch.operator import build_operator, linearization_twin
from rdycore_tpu_torch.parallel.comm import LocalTransport, exchange_dual
from rdycore_tpu_torch.parallel.sharded import ShardedSWE
from rdycore_tpu_torch.timestepping import (
    jvp,
    make_interval_advancer,
    with_exchange,
)

DT, STEPS = 5e-3, 4


NEWTON, KRYLOV = 2, 2


@pytest.fixture(autouse=True, scope="module")
def small_solver():
    """GMRES(2), 2 Newton iterations, one intra-op thread."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(timestepping, "NEWTON_ITERS", NEWTON)
        mp.setattr(timestepping, "KRYLOV_M", KRYLOV)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def deck(small_solver):
    """The operator, the initial state, its single-device interval and the
    state after it in 4 shards."""
    mesh = structured_quad(32, 8)
    C = mesh.num_cells
    op = build_operator(mesh, mannings_n=np.full(C, 0.02), device="cpu")
    q = np.zeros((3, C))
    q[0] = 1.0 + 0.3 * np.sin(np.arange(C) * 0.1)
    q0 = torch.tensor(q)
    return op, q0, single(op, q0), sharded(op, q0, 4)


def single(op, q0):
    return make_interval_advancer(op, "beuler", accumulate=False)(
        q0.clone(), 0.0, DT, STEPS, 1.0, op.zero_boundary_values(),
        torch.zeros_like(q0))


def sharded(op, q0, P, devices=None, steps=STEPS):
    sh = ShardedSWE(op, P, devices=devices)
    r = sh.make_interval_fn("beuler", accumulate=False)(
        sh.scatter_state(q0), 0.0, DT, steps, 1.0,
        sh.scatter_boundary(op.zero_boundary_values()),
        sh.scatter_state(torch.zeros_like(q0)))
    return sh, r, sh.gather_state(r.qs, torch.device("cpu"))


@pytest.mark.parametrize("P", [2, 4])
def test_shards_are_the_single_device(deck, P):
    op, q0, ref, four = deck
    sh, r, q = four if P == 4 else sharded(op, q0, P)
    assert (q - ref.q).abs().max() < 1e-12
    assert (ref.q - q0).abs().max() > 1e-3  # the steps moved the state
    assert r.t == float(ref.t)
    assert r.max_courant == pytest.approx(float(ref.max_courant), rel=1e-12)
    assert r.courant_edge == int(ref.courant_edge)
    # a step exchanges for its diagnostics' apply, then in each Newton
    # iteration for the residual, each JVP and 3 line-search residuals
    assert sh.counts["exchange"] == STEPS * (1 + NEWTON * (1 + KRYLOV + 3))
    # and sums globally: the residual's norm, beta, per Krylov column j
    # the j + 1 projections and the norm, and 3 line-search norms
    per_newton = 1 + 1 + sum(j + 2 for j in range(KRYLOV)) + 3
    assert sh.counts["global_sum"] == STEPS * NEWTON * per_newton


def test_a_run_repeats_bit_for_bit(deck):
    op, q0, _, four = deck
    assert torch.equal(sharded(op, q0, 4)[2], four[2])


def test_two_units_in_threads_are_one_unit(deck):
    """One step each (the threads wait on each other at every
    collective)."""
    op, q0 = deck[:2]
    one = sharded(op, q0, 4, steps=1)[2]
    cpu, other = torch.device("cpu"), torch.device("cpu", 0)
    sh, _, two = sharded(op, q0, 4, devices=[cpu, other, cpu, other],
                         steps=1)
    assert len(sh.units) == 2
    assert torch.equal(one, two)


def test_global_sums_add_in_shard_order():
    """Partials whose sum depends on the order: ((1e16 + 1) - 1e16) + 1
    = 1 in float64, whichever unit holds which shard."""
    cpu, other = torch.device("cpu"), torch.device("cpu", 0)
    tr = LocalTransport([cpu, other, cpu, other])
    parts = {0: torch.tensor([1e16, -1e16], dtype=torch.float64),
             1: torch.tensor([1.0, 1.0], dtype=torch.float64)}
    got = tr.run(lambda u: tr.global_sum(u, parts[u]))
    assert [float(x) for x in got.values()] == [1.0, 1.0]
    one = LocalTransport([cpu] * 4)
    x = torch.tensor([1e16, 1.0, -1e16, 1.0], dtype=torch.float64)
    assert float(one.global_sum(0, x)) == 1.0
    assert float(one.global_sum(0, x.flip(0))) == 0.0


def test_the_twin_in_shards_exchanges_its_tangent(deck):
    op, q0 = deck[:2]
    rng = np.random.default_rng(1)
    v = torch.tensor(rng.standard_normal(q0.shape))
    dt = torch.tensor(DT, dtype=torch.float64)
    lin = linearization_twin(op)
    bv = op.zero_boundary_values()
    want = jvp(lambda x: lin.rhs(x, dt, bv, None), q0, v)
    sh = ShardedSWE(op, 4)
    u, g = sh.units[0], sh.groups[0]
    bvs = sh.scatter_boundary(bv)[u]
    ghosts = torch.as_tensor(np.nonzero(g.local_cells >= 0)[0])
    ghosts = ghosts[~torch.isin(ghosts, torch.as_tensor(g.owned_rows))]

    def shard_jvp(twin):
        ql, vl = sh.scatter_state(q0)[u], sh.scatter_state(v)[u]
        vl[:, ghosts] = 7.0  # stale tangent rows: the exchange refills
        return jvp(lambda x: twin.rhs(x, dt, bvs, None), ql, vl)

    def exchange(q):
        return sh.exchange(u, q)

    owned = torch.as_tensor(g.owned_rows)
    cells = torch.as_tensor(g.owned_cells)
    twin = with_exchange(linearization_twin(sh.ops[u]), exchange)
    got = shard_jvp(twin)
    assert torch.equal(got[:, owned], want[:, cells])
    lost = linearization_twin(with_exchange(sh.ops[u], exchange))
    assert not torch.equal(shard_jvp(lost)[:, owned], want[:, cells])


def test_a_dual_halo_is_one_message():
    import torch.autograd.forward_ad as fwAD

    calls = []

    def exchange(buf):
        calls.append(tuple(buf.shape))
        buf[:, -1] = buf[:, 0]  # the "ghost" column takes column 0

    p = torch.arange(6.0).reshape(3, 2)
    t = -torch.arange(6.0).reshape(3, 2)
    with fwAD.dual_level():
        d = fwAD.make_dual(p.clone(), t.clone())
        exchange_dual(exchange, d)
        primal, tangent = fwAD.unpack_dual(d)
        assert torch.equal(primal[:, 1], p[:, 0])
        assert torch.equal(tangent[:, 1], t[:, 0])
    assert calls == [(6, 2)]
