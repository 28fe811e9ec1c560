"""The port's partition of the unstructured operator into shards
(rdycore_tpu_torch/parallel/partition.py) against the JAX package's
`ShardedSWE._build_partition`, on the host, with no stepping.

On structured_quad(16, 12) and on an RCM-ordered triangle mesh, in 2, 4
and 8 shards, at first and second order: equal as sets of global cell
ids are the owned blocks, the 1-deep ghosts, the 1- and 2-deep ghosts of
second order (the port adds a third ring there, for the positivity
drains of the 1-deep ghosts; the JAX package's halo stops at two), the
cells each shard sends, each shard's interior edges, and `neighbor_only`.
The JAX ghost lists are read off its halo maps (`ghost_src` into the
frontier, `send_ids` of the owner). Each shard's local arrays hold the
global operator's values: every owned cell its global `cell_edges` row
(as global edge ids, in the same slot order) and coefficients, every
local edge the global edge's cells, normal and Courant coefficient where
the shard answers for it. `block_order` equals the JAX one array for
array.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from rdycore_tpu.mesh import structured_quad as jax_quad
from rdycore_tpu.mesh import structured_tri as jax_tri
from rdycore_tpu.mesh.core import block_order as jax_block_order
from rdycore_tpu.mesh.core import rcm_reorder as jax_rcm
from rdycore_tpu.parallel.sharded import ShardedSWE as JaxShardedSWE
from rdycore_tpu_torch.mesh import structured_quad, structured_tri
from rdycore_tpu_torch.mesh.core import block_order, rcm_reorder
from rdycore_tpu_torch.operator import build_operator
from rdycore_tpu_torch.parallel.partition import (
    MUSCL_DEPTH,
    build_partition,
    merge_shards,
    neighbor_only,
)


def meshes(name):
    if name == "quad":
        return structured_quad(16, 12, 0, 16, 0, 12), jax_quad(
            16, 12, 0, 16, 0, 12)
    return rcm_reorder(structured_tri(9, 7, 0, 9, 0, 7)), jax_rcm(
        jax_tri(9, 7, 0, 9, 0, 7))


def jax_ghosts(sh):
    """Each JAX shard's ghosts (global ids, in its order)."""
    halo = sh.halo
    send = np.asarray(halo.send_ids)
    src = np.asarray(halo.ghost_src)
    out = []
    for p in range(sh.P):
        g = src[p, :int(np.asarray(halo.num_ghosts)[p])]
        owner, k = g // sh.S_max, g % sh.S_max
        out.append(owner * sh.B + send[owner, k])
    return out


def sends_of(ghosts, B, P):
    """{p: the cells p owns among the other shards' ghosts}."""
    out = {p: set() for p in range(P)}
    for g in ghosts:
        for c in g.tolist():
            out[min(c // B, P - 1)].add(c)
    return out


@pytest.mark.parametrize("mesh_name", ["quad", "tri_rcm"])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_partition_matches_jax(mesh_name, P):
    mesh, jmesh = meshes(mesh_name)
    for so in (False, True):
        plans = build_partition(
            build_operator(mesh, second_order=so, device="cpu"), P)
        jsh = JaxShardedSWE(jmesh, P, dtype=jnp.float64, second_order=so)
        jg = jax_ghosts(jsh)
        assert [pl.lo for pl in plans] == [p * jsh.B for p in range(P)]
        assert plans[-1].hi == mesh.num_cells
        gidx = np.asarray(jsh.halo.int_gidx)
        for p, pl in enumerate(plans):
            depth = 2 if so else 1
            inner = pl.ghosts[:sum(pl.rings[:depth])]
            assert set(inner.tolist()) == set(jg[p].tolist())
            # the rings, ring by ring: the 1-deep ring is the first-order
            # ghost set
            assert set(pl.ghosts[:pl.rings[0]].tolist()) <= set(
                jg[p].tolist())
            if not so:
                assert set(pl.int_edges.tolist()) == set(
                    gidx[p][gidx[p] >= 0].tolist())
                assert len(pl.rings) == 1
            else:
                assert len(pl.rings) == MUSCL_DEPTH
        want = sends_of(jg, jsh.B, P)
        ring = 2 if so else 1
        got = sends_of([pl.ghosts[:sum(pl.rings[:ring])] for pl in plans],
                       plans[0].nown, P)
        assert got == want
        # the sends of the plans are exactly the other shards' ghosts
        for p, pl in enumerate(plans):
            sent = set()
            for r, cells in pl.send.items():
                sent |= set((cells + pl.lo).tolist())
            assert sent == sends_of([q.ghosts for q in plans],
                                    plans[0].nown, P)[p]
        if not so:
            assert neighbor_only(plans) == jsh.neighbor_only


@pytest.mark.parametrize("so", [False, True])
def test_local_arrays_are_the_global_ones(so):
    mesh = rcm_reorder(structured_tri(9, 7, 0, 9, 0, 7,
                                      z_fn=lambda x, y: 0.1 * x))
    op = build_operator(mesh, second_order=so, device="cpu",
                        mannings_n=np.linspace(0.01, 0.03, mesh.num_cells))
    g = op.arrays.numpy()
    E = op.num_edges
    for P in (2, 4):
        plans = build_partition(op, P)
        group = merge_shards(plans, list(range(P)))
        for pl in plans + [group]:
            a = pl.arrays
            if pl is group:  # its dummy cells are -1
                cells, owned = pl.local_cells, pl.owned_rows
                n_own_bnd = len(a["bnd_left"])
            else:
                cells, owned = np.append(pl.local_cells, -1), np.arange(
                    pl.nown)
                n_own_bnd = pl.n_bnd_owned
            ids = np.append(pl.edge_gidx, E)  # local edge -> global
            for k in ("area", "dz_dx", "dz_dy", "cell_z", "mannings_n"):
                np.testing.assert_array_equal(a[k][cells >= 0],
                                              g[k][cells[cells >= 0]])
            c = cells[owned]
            np.testing.assert_array_equal(ids[a["cell_edges"][owned]],
                                          g["cell_edges"][c])
            np.testing.assert_array_equal(a["cell_edge_coef"][owned],
                                          g["cell_edge_coef"][c])
            Ei = len(a["int_left"])
            ie = ids[:Ei]
            np.testing.assert_array_equal(cells[a["int_left"]],
                                          g["int_left"][ie])
            np.testing.assert_array_equal(cells[a["int_right"]],
                                          g["int_right"][ie])
            np.testing.assert_array_equal(a["int_cn"], g["int_cn"][ie])
            be = ids[Ei:-1] - op.num_internal_edges
            np.testing.assert_array_equal(cells[a["bnd_left"]],
                                          g["bnd_left"][be])
            np.testing.assert_array_equal(a["bnd_code"], g["bnd_code"][be])
            # a Courant coefficient is the global one or zero
            cc = a["edge_courant_coef"]
            gc = g["edge_courant_coef"][ids[:-1]]
            assert np.all((cc == gc) | (cc == 0.0))
            # the interior edges, and the owned boundary edges, are in
            # global order (a group's boundary edges all are)
            assert np.all(np.diff(ie) >= 0)
            assert np.all(np.diff(be[:n_own_bnd]) >= 0)
            if so:
                np.testing.assert_array_equal(a["cell_ls_cx"][owned],
                                              g["cell_ls_cx"][c])
                np.testing.assert_array_equal(a["int_dxl"], g["int_dxl"][ie])


@pytest.mark.parametrize("px, py", [(2, 4), (3, 2)])
def test_block_order_matches_jax(px, py):
    for mesh, jmesh in (meshes("quad"),
                        (structured_tri(9, 7, 0, 9, 0, 7),
                         jax_tri(9, 7, 0, 9, 0, 7))):
        np.testing.assert_array_equal(block_order(mesh, px, py),
                                      jax_block_order(jmesh, px, py))


def test_too_many_shards_raise():
    op = build_operator(structured_quad(3, 2), device="cpu")
    with pytest.raises(ValueError, match="do not give each of 8 shards"):
        build_partition(op, 8)
