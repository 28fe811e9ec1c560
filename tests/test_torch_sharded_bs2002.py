"""BS2002 well-balancing in P shards in one process
(rdycore_tpu_torch/parallel/partition.py's vertex ring, K5 per shard)
against the port's own single-device interval, in float64 on the CPU: bit
for bit the state, the time, the Courant maximum and its global edge, and
the accumulators.

First order in 2, 4 and 8 shards on a bumpy triangle mesh, in 8 shards of
a 2-D block order whose ghosts lie on shards that are not neighbours, and
in 4 shards stepped as two units in two threads (every other shard on a
second CPU device); second order (MUSCL with the positivity limiter
acting) in 2, 4 and 8 shards. Each shard's vertex rows are the global
rows in their slot order, padded with its cell count, with the global
weights. Shards without the vertex ring leave the single device. The ring
is built around the owned cells' edges alone, at second order too: the
1-deep ghosts' positivity drains read only the water row of their edges'
fluxes, which BS2002 does not correct.
"""

import numpy as np
import pytest
import torch

from rdycore_tpu_torch.mesh import structured_quad, structured_tri
from rdycore_tpu_torch.mesh.core import block_order, reorder_cells
from rdycore_tpu_torch.operator import build_operator
from rdycore_tpu_torch.ops.kernels.muscl import positivity_drain_plain
from rdycore_tpu_torch.ops.swe.boundary import (
    BC_CRITICAL_OUTFLOW,
    BC_DIRICHLET,
)
from rdycore_tpu_torch.parallel import partition
from rdycore_tpu_torch.parallel.sharded import ShardedSWE
from rdycore_tpu_torch.timestepping import make_interval_advancer

BCS = {"left": BC_DIRICHLET, "right": BC_CRITICAL_OUTFLOW}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: thousands of small operations, which more
    threads per test worker only slow down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bumpy(x, y):
    return 0.3 * np.sin(x) * np.cos(y) + 0.02 * x


def lake(mesh, seed=7, dry=0.0):
    """A free surface near 1.5 m over the bumpy bed, moving a little; with
    `dry`, that share of the cells dry."""
    rng = np.random.default_rng(seed)
    C = mesh.num_cells
    q = np.zeros((3, C))
    q[0] = np.maximum(1.5 - mesh.cell_z + 0.2 * rng.random(C), 0.0)
    if dry:
        q[0] *= rng.random(C) > dry
    q[1] = 0.2 * rng.standard_normal(C) * (q[0] > 0)
    q[2] = 0.1 * rng.standard_normal(C) * (q[0] > 0)
    return torch.tensor(q)


def inflow(op):
    bv = op.zero_boundary_values()
    for s in op.segments:
        if s.name == "left":
            bv[0, s.start:s.start + s.count] = 1.6
            bv[1, s.start:s.start + s.count] = 0.3
    return bv


def sharded_run(op, scheme, q0, P, n, dt, devices=None):
    bv = inflow(op)
    sh = ShardedSWE(op, P, devices=devices)
    r = sh.make_interval_fn(scheme)(
        sh.scatter_state(q0), 0.0, dt, n, n * dt, sh.scatter_boundary(bv),
        sh.scatter_state(torch.zeros_like(q0)))
    return sh, r


def assert_single(op, scheme, q0, P_list, n=6, dt=2e-3, devices=None):
    bv = inflow(op)
    ref = make_interval_advancer(op, scheme)(
        q0.clone(), 0.0, dt, n, n * dt, bv, torch.zeros_like(q0))
    shards = []
    for P in P_list:
        sh, r = sharded_run(op, scheme, q0, P, n, dt, devices)
        q = sh.gather_state(r.qs, torch.device("cpu"))
        assert torch.equal(q, ref.q), (scheme, P)
        assert r.t == float(ref.t)
        assert r.max_courant == float(ref.max_courant) > 0.0
        assert r.courant_edge == int(ref.courant_edge)
        accum_sol, accum_prim, bflux = sh.accumulators.gather()
        np.testing.assert_array_equal(bflux, ref.bflux_accum.numpy())
        np.testing.assert_array_equal(accum_sol, ref.accum_sol.numpy())
        np.testing.assert_array_equal(accum_prim, ref.accum_prim.numpy())
        shards.append(sh)
    return ref, shards


def bs_operator(mesh, **kw):
    return build_operator(mesh, BCS, mannings_n=np.full(mesh.num_cells, 0.02),
                          well_balancing_bs2002=True, device="cpu", **kw)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_first_order(P):
    mesh = structured_tri(14, 10, 0, 14, 0, 10, z_fn=bumpy)
    ref, (sh,) = assert_single(bs_operator(mesh), "euler", lake(mesh), (P,))
    assert np.abs(ref.bflux_accum.numpy()).max() > 0.0
    if P > 2:  # the edge rings miss some cells around the vertices
        assert sum(pl.vertex_ghosts for pl in sh.plans) > 0


def test_block_order_with_far_ghosts():
    mesh0 = structured_quad(16, 16, 0, 16, 0, 16, z_fn=bumpy)
    mesh = reorder_cells(mesh0, block_order(mesh0, 2, 4))
    op = bs_operator(mesh)
    _, (sh,) = assert_single(op, "euler", lake(mesh), (8,))
    assert not sh.neighbor_only


def test_four_shards_in_two_units():
    """Shards 0 and 2 on one device, 1 and 3 on another: two merged
    operators (their vertex universes side by side) in two threads."""
    mesh = structured_tri(14, 10, 0, 14, 0, 10, z_fn=bumpy)
    cpu, other = torch.device("cpu"), torch.device("cpu", 0)
    _, (sh,) = assert_single(bs_operator(mesh), "euler", lake(mesh), (4,),
                             devices=[cpu, other, cpu, other])
    assert [g.shards for g in sh.groups.values()] == [[0, 2], [1, 3]]


def test_vertex_rows_are_the_global_rows():
    """At every vertex whose eta a kept flux reads, a shard's row is the
    global row, slot for slot, in local ids; padding and cells the shard
    does not hold are C_loc (not the dummy cell C_loc - 1); the weights
    are the global ones."""
    mesh = structured_tri(14, 10, 0, 14, 0, 10, z_fn=bumpy)
    op = bs_operator(mesh, second_order=True)
    g = op.arrays.bs2002
    gvc, ginv = g.vertex_cells.numpy(), g.vertex_inv_count.numpy()
    C = mesh.num_cells
    for pl in partition.build_partition(op, 4):
        b, C_loc = pl.arrays["bs2002"], pl.num_cells
        # local id -> global id (the dummy cell -1, C_loc the padding C)
        cells = np.concatenate([pl.local_cells, [-1, C]])
        vc = b["vertex_cells"]
        assert vc.max() <= C_loc and not (vc == C_loc - 1).any()
        ends = np.concatenate([op.arrays.bs2002.int_vbeg.numpy()[
            pl.int_edges], op.arrays.bs2002.int_vend.numpy()[pl.int_edges]])
        verts = np.unique(ends)
        np.testing.assert_array_equal(
            np.unique(np.concatenate([b["int_vbeg"], b["int_vend"]])),
            np.searchsorted(np.unique(np.concatenate([
                ends, op.arrays.bs2002.bnd_vbeg.numpy()[pl.bnd_edges],
                op.arrays.bs2002.bnd_vend.numpy()[pl.bnd_edges]])), verts))
        # the owned cells' vertices: every row whole
        owned_verts = np.unique(op.arrays.bs2002.int_vbeg.numpy()[
            pl.int_edges[(op.arrays.int_left.numpy()[pl.int_edges] >= pl.lo)
                         & (op.arrays.int_left.numpy()[pl.int_edges]
                            < pl.hi)]])
        all_verts = np.unique(np.concatenate([
            ends, op.arrays.bs2002.bnd_vbeg.numpy()[pl.bnd_edges],
            op.arrays.bs2002.bnd_vend.numpy()[pl.bnd_edges]]))
        rows = np.searchsorted(all_verts, owned_verts)
        np.testing.assert_array_equal(cells[vc[rows]], gvc[owned_verts])
        np.testing.assert_array_equal(b["vertex_inv_count"][rows],
                                      ginv[owned_verts])


def limited_state(mesh):
    """Shallow water over the bumps, where the positivity limiter acts at
    dt = 0.1 s."""
    rng = np.random.default_rng(3)
    C = mesh.num_cells
    q = np.zeros((3, C))
    q[0] = np.maximum(0.3 - mesh.cell_z + 0.2 * rng.random(C), 0.0)
    q[1] = 0.2 * rng.standard_normal(C) * (q[0] > 0)
    return torch.tensor(q)


def test_muscl_with_the_positivity_limiter_acting():
    mesh = structured_tri(14, 10, 0, 14, 0, 10, z_fn=bumpy)
    op = bs_operator(mesh, second_order=True, h_anuga=1e-3)
    q0 = limited_state(mesh)
    dt = torch.tensor(0.1, dtype=torch.float64)
    flux, _ = op.edge_flux(q0, inflow(op), op.muscl_grad(q0),
                           op.eta_vertices(q0[0]))
    factors = positivity_drain_plain(op.arrays, flux, q0[0], dt)
    assert (factors < 1.0).sum() > 5  # the limiter acts
    assert_single(op, "ssprk2", q0, (2, 4, 8), n=4, dt=0.1)


def test_the_drains_read_no_correction():
    """The ring is built around the owned cells' edges alone, as the JAX
    package builds it, also at second order: a 1-deep ghost's drain reads
    only the water row of its edges' fluxes, and BS2002 corrects only the
    momentum rows."""
    mesh = structured_tri(14, 10, 0, 14, 0, 10, z_fn=bumpy)
    op = bs_operator(mesh, second_order=True, h_anuga=1e-3)
    q0 = limited_state(mesh)
    grad = op.muscl_grad(q0)
    with_eta, _ = op.edge_flux(q0, inflow(op), grad, op.eta_vertices(q0[0]))
    zero_eta = torch.zeros_like(op.eta_vertices(q0[0]))
    without, _ = op.edge_flux(q0, inflow(op), grad, zero_eta)
    assert torch.equal(with_eta[0], without[0])
    assert not torch.equal(with_eta[1:], without[1:])


def test_shards_without_the_vertex_ring_differ(monkeypatch):
    mesh = structured_tri(14, 10, 0, 14, 0, 10, z_fn=bumpy)
    op = bs_operator(mesh)
    q0 = lake(mesh)
    ref = make_interval_advancer(op, "euler")(
        q0.clone(), 0.0, 2e-3, 6, 0.012, inflow(op), torch.zeros_like(q0))
    monkeypatch.setattr(partition, "_vertex_ring",
                        lambda *a: np.zeros(0, np.int64))
    sh, r = sharded_run(op, "euler", q0, 8, 6, 2e-3)
    q = sh.gather_state(r.qs, torch.device("cpu"))
    assert (q - ref.q).abs().max() > 1e-6
