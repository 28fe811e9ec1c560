"""Backward Euler in 2 ranks over gloo on the CPU (`parallel.comm.spawn`,
a FileStore in the test's tmp_path), one shard per rank (parallel/comm.
DistTransport), f64, on the dam break of tests/test_torch_dist_gloo_shards.py
(a Newton iteration of GMRES(2), 2 steps):

- bit for bit the same deck's 2 shards in one process (both add the
  same per-shard partials in shard order, the ranks by an all-gather),
  and within 1e-12 of the single device (rank 0 runs both references);
- a JVP through a rank's linearization twin, its tangent's ghost rows
  set stale and then exchanged with the primal's in one message, has the
  single device's rows for the rank's owned cells.

Port only: the ranks import neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from rdycore_tpu_torch import Simulation, load_config, timestepping
from rdycore_tpu_torch.operator import linearization_twin
from rdycore_tpu_torch.parallel.comm import spawn

from test_torch_dist_gloo_shards import run_deck, write_deck

NEWTON, KRYLOV = 1, 2


def tangent(sim):
    return torch.tensor(np.random.default_rng(2).standard_normal(
        tuple(sim.q.shape)))


def ranks(rank, world, path):
    """Each rank: the deck's run in ranks, and its twin's JVP on its shard
    (the tangent's ghost rows set to 7 before the exchange; v from a seed,
    J at the deck's initial state). Rank 0 also runs the references: the
    deck's interval in 2 shards in this process (a LocalTransport) and on
    one device, and the single device's JVP."""
    from rdycore_tpu_torch.parallel.comm import LocalTransport
    from rdycore_tpu_torch.parallel.sharded import ShardedSWE

    torch.set_num_threads(1)
    timestepping.NEWTON_ITERS, timestepping.KRYLOV_M = NEWTON, KRYLOV
    out = dict(run=run_deck(path))
    sim = Simulation(load_config(path), device="cpu")
    q0, v, bv = sim.q, tangent(sim), sim.boundary_values  # collective
    sh, op = sim._sharded, sim.operator
    u = sh.units[0]
    g = sh.groups[u]
    dt = torch.tensor(0.002, dtype=torch.float64)
    twin = timestepping.with_exchange(linearization_twin(sh.ops[u]),
                                      lambda q: sh.exchange(u, q))
    ql, vl = sh.scatter_state(q0)[u], sh.scatter_state(v)[u]
    ghosts = torch.as_tensor(np.setdiff1d(
        np.nonzero(g.local_cells >= 0)[0], g.owned_rows))
    vl[:, ghosts] = 7.0
    got = timestepping.jvp(lambda x: twin.rhs(x, dt, sim._bvs[u], None),
                           ql, vl)
    out["jvp"] = (g.owned_cells, got[:, torch.as_tensor(g.owned_rows)])
    if rank == 0:
        es = torch.zeros_like(q0)
        n = sim.max_steps
        local = ShardedSWE(op, 2, LocalTransport([torch.device("cpu")] * 2))
        r = local.make_interval_fn("beuler")(
            local.scatter_state(q0), 0.0, 0.002, n, n * 0.002,
            local.scatter_boundary(bv), local.scatter_state(es))
        one = timestepping.make_interval_advancer(op, "beuler")(
            q0.clone(), 0.0, 0.002, n, n * 0.002, bv, es)
        lin = linearization_twin(op)
        out["refs"] = dict(
            local=local.gather_state(r.qs, torch.device("cpu")).numpy(),
            single=one.q.numpy(), q0=q0.numpy(),
            jvp=timestepping.jvp(lambda x: lin.rhs(x, dt, bv, None), q0, v))
    return out


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("gloo_beuler"))
    got = spawn(ranks, 2, "gloo", d, args=(write_deck(d, "beuler", 2),),
                timeout=120)
    return dict(got=got, refs=got[0]["refs"])


def test_two_ranks_are_the_one_process_shards(two):
    for rank in two["got"]:
        assert rank["run"]["sharded"]
        np.testing.assert_array_equal(rank["run"]["q"], two["refs"]["local"])
    assert [r["run"]["step"] for r in two["got"]] == [2, 2]


def test_two_ranks_are_the_single_device(two):
    single = two["refs"]["single"]
    assert np.abs(single - two["refs"]["q0"]).max() > 1e-3
    for rank in two["got"]:
        np.testing.assert_allclose(rank["run"]["q"], single, rtol=0,
                                   atol=1e-12)


def test_the_ranks_jvps_are_the_single_devices(two):
    want = two["refs"]["jvp"]
    cells = []
    for rank in two["got"]:
        owned, rows = rank["jvp"]
        assert torch.equal(rows, want[:, torch.as_tensor(owned)])
        cells.append(owned)
    assert sorted(np.concatenate(cells)) == list(range(want.shape[1]))
