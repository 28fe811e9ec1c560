"""BS2002 in the port's shards against the JAX package's `ShardedSWE.
make_interval_fn` (its shard_map over 4 of tests/conftest.py's 8 host
devices), in float64 on the CPU, on tests/test_sharded.py's BS2002 deck:
the bumpy structured_tri(12, 10), 20 euler steps in 4 shards (the port's
vertex ring against the JAX package's), to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as DeviceMesh

from rdycore_tpu.mesh import structured_tri as jax_tri
from rdycore_tpu.parallel.sharded import ShardedSWE as JaxShardedSWE
from rdycore_tpu_torch.mesh import structured_tri
from rdycore_tpu_torch.operator import build_operator
from rdycore_tpu_torch.parallel.sharded import ShardedSWE


def bumpy(x, y):
    return 0.3 * np.sin(x) * np.cos(y) + 0.02 * x


def jax_interval(jsh, scheme, q0, dt, n, t_end):
    dm = DeviceMesh(np.array(jax.devices("cpu")[:4]), ("mesh",))
    jq, jt, jcmax, jinfo = jsh.make_interval_fn(dm, scheme)(
        jsh.scatter_state(q0), 0.0, dt, n, t_end,
        jnp.zeros((3, max(jsh.ref_op.num_boundary_edges, 1)), jnp.float64),
        jnp.zeros((4, 3, jsh.C_loc), jnp.float64))
    return jsh.gather_state(jq), float(jt), float(jcmax), jinfo


def port_interval(op, scheme, q0, dt, n, t_end):
    sh = ShardedSWE(op, 4)
    r = sh.make_interval_fn(scheme)(
        sh.scatter_state(torch.tensor(q0)), 0.0, dt, n, t_end,
        sh.scatter_boundary(op.zero_boundary_values()),
        sh.scatter_state(torch.zeros(q0.shape, dtype=torch.float64)))
    return sh.gather_state(r.qs, torch.device("cpu")).numpy(), r


def test_bs2002_against_the_jax_shards():
    mesh = structured_tri(12, 10, 0, 12, 0, 10, z_fn=bumpy)
    mann = np.full(mesh.num_cells, 0.02)
    rng = np.random.default_rng(7)
    q0 = np.zeros((3, mesh.num_cells))
    q0[0] = np.maximum(1.5 - mesh.cell_z
                       + 0.2 * rng.random(mesh.num_cells), 0.0)
    dt, n = 1e-3, 20
    jsh = JaxShardedSWE(jax_tri(12, 10, 0, 12, 0, 10, z_fn=bumpy), 4,
                        mannings_n=mann, dtype=jnp.float64,
                        well_balancing_bs2002=True)
    jq, jt, jcmax, jinfo = jax_interval(jsh, "euler", q0, dt, n, n * dt)
    op = build_operator(mesh, mannings_n=mann, well_balancing_bs2002=True,
                        device="cpu")
    q, r = port_interval(op, "euler", q0, dt, n, n * dt)
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-12)
    assert np.abs(q - q0).max() > 1e-4
    assert r.t == pytest.approx(jt, abs=1e-15)
    assert r.max_courant == pytest.approx(jcmax, rel=1e-12)
    assert r.courant_edge == JaxShardedSWE.courant_location(jinfo)[1]
