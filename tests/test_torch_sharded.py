"""The unstructured path in P shards in one process
(rdycore_tpu_torch/parallel/sharded.py, over a LocalTransport) against
the port's own single-device interval, in float64 on the CPU: bit for
bit the state, the time, the Courant maximum and its global edge, and the
accumulators (boundary fluxes, time-averaged state and primitives).

P = 2, 4 and 8 shards under euler, ssprk2, rk4 and ark_imex, with a
Dirichlet inflow wall and critical outflow; second order (MUSCL with the
positivity limiter; every owned cell's and 1-deep ghost's donor factor
is the single-device one); three tracer rows (two sediment classes);
hydrostatic reconstruction on a bed; and a 2-D block order (`block_order`)
whose ghosts lie on shards that are not neighbours. One case is held
against the JAX package's `ShardedSWE.make_interval_fn` (euler, 4 shards,
atol 1e-13, as tests/test_sharded.py holds it to its single device). Only
an unknown scheme is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as DeviceMesh

from rdycore_tpu.mesh import structured_quad as jax_quad
from rdycore_tpu.parallel.sharded import ShardedSWE as JaxShardedSWE
from rdycore_tpu_torch import timestepping
from rdycore_tpu_torch.mesh import structured_quad, structured_tri
from rdycore_tpu_torch.mesh.core import block_order, reorder_cells
from rdycore_tpu_torch.operator import build_operator
from rdycore_tpu_torch.ops.kernels.muscl import positivity_drain_plain
from rdycore_tpu_torch.ops.swe.boundary import (
    BC_CRITICAL_OUTFLOW,
    BC_DIRICHLET,
)
from rdycore_tpu_torch.parallel.sharded import ShardedSWE
from rdycore_tpu_torch.timestepping import make_interval_advancer

BCS = {"left": BC_DIRICHLET, "right": BC_CRITICAL_OUTFLOW}


def state(mesh, ndof=3, seed=3, dry=0.0):
    rng = np.random.default_rng(seed)
    C = mesh.num_cells
    q = np.zeros((ndof, C))
    q[0] = 0.5 + rng.random(C)
    if dry:
        q[0] *= rng.random(C) > dry
    q[1] = 0.2 * rng.standard_normal(C) * (q[0] > 0)
    q[2] = 0.1 * rng.standard_normal(C) * (q[0] > 0)
    for k in range(3, ndof):
        q[k] = 0.01 * rng.random(C) * q[0]
    return torch.tensor(q)


def inflow(op):
    """Dirichlet values: an inflow on the left wall, zero elsewhere."""
    bv = op.zero_boundary_values()
    for s in op.segments:
        if s.name == "left":
            bv[0, s.start:s.start + s.count] = 1.2
            bv[1, s.start:s.start + s.count] = 0.3
    return bv


def assert_sharded_is_single(op, scheme, q0, P_list=(2, 4, 8), n=12,
                             dt=2e-3, sources=False):
    bv = inflow(op)
    es = torch.zeros_like(q0)
    if sources:
        es[0] = 1e-3
    ref = make_interval_advancer(op, scheme)(q0.clone(), 0.0, dt, n,
                                             n * dt - 0.5 * dt, bv, es)
    for P in P_list:
        sh = ShardedSWE(op, P)
        r = sh.make_interval_fn(scheme)(
            sh.scatter_state(q0), 0.0, dt, n, n * dt - 0.5 * dt,
            sh.scatter_boundary(bv), sh.scatter_state(es))
        q = sh.gather_state(r.qs, torch.device("cpu"))
        assert torch.equal(q, ref.q), (scheme, P)
        assert r.t == float(ref.t)
        assert r.max_courant == float(ref.max_courant) > 0.0
        assert r.courant_edge == int(ref.courant_edge)
        accum_sol, accum_prim, bflux = sh.accumulators.gather()
        np.testing.assert_array_equal(bflux, ref.bflux_accum.numpy())
        np.testing.assert_array_equal(accum_sol, ref.accum_sol.numpy())
        np.testing.assert_array_equal(accum_prim, ref.accum_prim.numpy())
        assert r.accum_time == float(ref.accum_time)
    return ref


@pytest.mark.parametrize("scheme", ["euler", "ssprk2", "rk4", "ark_imex"])
def test_first_order_schemes(scheme):
    mesh = structured_quad(16, 12, 0, 16, 0, 12)
    op = build_operator(mesh, BCS, mannings_n=np.full(mesh.num_cells, 0.02),
                        device="cpu")
    ref = assert_sharded_is_single(op, scheme, state(mesh),
                                   sources=scheme == "rk4")
    assert np.abs(ref.bflux_accum.numpy()).max() > 0.0


@pytest.mark.parametrize("scheme", ["euler", "ssprk2"])
def test_muscl_with_the_positivity_limiter(scheme):
    mesh = structured_tri(14, 10, 0, 14, 0, 10)
    op = build_operator(mesh, BCS, mannings_n=np.full(mesh.num_cells, 0.02),
                        second_order=True, h_anuga=1e-3, device="cpu")
    assert_sharded_is_single(op, scheme, state(mesh, dry=0.3), dt=0.05, n=6)


def test_ghost_drains_are_the_global_ones():
    """The donor factor of every owned cell and every 1-deep ghost, on its
    shard, is the single-device one: the limiter scales each partition
    edge's flux as on one device. A dt of 1 s puts many factors below 1;
    the 1-deep ghosts' factors need the third ring of ghosts."""
    mesh = structured_tri(14, 10, 0, 14, 0, 10)
    op = build_operator(mesh, BCS, second_order=True, h_anuga=1e-3,
                        device="cpu")
    q0 = state(mesh, dry=0.3)
    dt = torch.tensor(1.0, dtype=torch.float64)

    def drains(o, q, bv):
        flux, _ = o.edge_flux(q, bv, o.muscl_grad(q))
        return positivity_drain_plain(o.arrays, flux, q[0], dt)

    want = drains(op, q0, inflow(op))
    assert (want < 1.0).sum() > mesh.num_cells // 4
    for P in (2, 4, 8):
        sh = ShardedSWE(op, P)
        got = drains(sh.ops[0], sh.scatter_state(q0)[0],
                     sh.scatter_boundary(inflow(op))[0])
        g = sh.groups[0]
        for pl, off in zip(sh.plans, g.cell_offset):
            rows = off + np.arange(pl.nown + pl.rings[0])
            assert torch.equal(got[rows], want[g.local_cells[rows]]), P


@pytest.mark.parametrize("scheme", ["euler", "ssprk2"])
def test_tracers(scheme):
    mesh = structured_quad(16, 12, 0, 16, 0, 12)
    op = build_operator(mesh, BCS, mannings_n=np.full(mesh.num_cells, 0.02),
                        num_tracers=3, num_sediment=2, device="cpu")
    assert_sharded_is_single(op, scheme, state(mesh, ndof=6))


def test_hydrostatic_reconstruction():
    mesh = structured_tri(14, 10, 0, 14, 0, 10,
                          z_fn=lambda x, y: 0.05 * x + 0.1 * np.sin(y))
    op = build_operator(mesh, BCS, mannings_n=np.full(mesh.num_cells, 0.02),
                        well_balancing_hr=True, device="cpu")
    assert_sharded_is_single(op, "euler", state(mesh), P_list=(2, 4))


def test_block_order_with_far_ghosts():
    mesh0 = structured_quad(16, 16, 0, 16, 0, 16)
    mesh = reorder_cells(mesh0, block_order(mesh0, 2, 4))
    op = build_operator(mesh, BCS, mannings_n=np.full(mesh.num_cells, 0.02),
                        device="cpu")
    sh = ShardedSWE(op, 8)
    assert not sh.neighbor_only
    assert_sharded_is_single(op, "euler", state(mesh), P_list=(8,))


def test_against_the_jax_sharded_interval():
    mesh = structured_quad(16, 12, 0, 16, 0, 12)
    mann = np.full(mesh.num_cells, 0.02)
    q0 = state(mesh, seed=5)
    dt, n, t_end = 1e-3, 20, 0.02
    jsh = JaxShardedSWE(jax_quad(16, 12, 0, 16, 0, 12), 4, mannings_n=mann,
                        dtype=jnp.float64)
    dm = DeviceMesh(np.array(jax.devices("cpu")[:4]), ("mesh",))
    jq, jt, jcmax, jinfo = jsh.make_interval_fn(dm, "euler")(
        jsh.scatter_state(q0.numpy()), 0.0, dt, n, t_end,
        jnp.zeros((3, jsh.ref_op.num_boundary_edges), jnp.float64),
        jnp.zeros((4, 3, jsh.C_loc), jnp.float64))
    op = build_operator(mesh, mannings_n=mann, device="cpu")
    sh = ShardedSWE(op, 4)
    r = sh.make_interval_fn("euler")(
        sh.scatter_state(q0), 0.0, dt, n, t_end,
        sh.scatter_boundary(op.zero_boundary_values()),
        sh.scatter_state(torch.zeros_like(q0)))
    np.testing.assert_allclose(
        sh.gather_state(r.qs, torch.device("cpu")).numpy(),
        jsh.gather_state(jq), rtol=0, atol=1e-13)
    assert r.t == pytest.approx(float(jt), abs=1e-15)
    assert r.max_courant == pytest.approx(float(jcmax), rel=1e-12)
    assert r.courant_edge == JaxShardedSWE.courant_location(jinfo)[1]


def test_schemes_outside_the_shards_raise(monkeypatch):
    """Only an unknown scheme is refused now: beuler and BS2002, which
    raised NotImplementedError before they were ported, run in shards and
    give the single device (tests/test_torch_sharded_bs2002.py and
    tests/test_torch_sharded_beuler.py hold them fully)."""
    mesh = structured_quad(8, 6, 0, 8, 0, 6)
    op = build_operator(mesh, device="cpu")
    with pytest.raises(ValueError, match="unknown temporal scheme"):
        ShardedSWE(op, 2).make_interval_fn("leapfrog")
    monkeypatch.setattr(timestepping, "NEWTON_ITERS", 1)
    monkeypatch.setattr(timestepping, "KRYLOV_M", 2)
    q0 = state(mesh)
    ref = make_interval_advancer(op, "beuler")(
        q0.clone(), 0.0, 2e-3, 1, 2e-3, op.zero_boundary_values(),
        torch.zeros_like(q0))
    sh = ShardedSWE(op, 2)
    r = sh.make_interval_fn("beuler")(
        sh.scatter_state(q0), 0.0, 2e-3, 1, 2e-3,
        sh.scatter_boundary(op.zero_boundary_values()),
        sh.scatter_state(torch.zeros_like(q0)))
    got = sh.gather_state(r.qs, torch.device("cpu"))
    assert (got - ref.q).abs().max() < 1e-12
    tri = structured_tri(8, 6, 0, 8, 0, 6, z_fn=lambda x, y: 0.1 * np.sin(x))
    bs = build_operator(tri, well_balancing_bs2002=True, device="cpu")
    assert_sharded_is_single(bs, "euler", state(tri), P_list=(2,), n=2)
