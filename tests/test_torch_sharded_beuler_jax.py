"""Backward Euler in the port's 4 shards against the JAX package's
sharded beuler (`ShardedSWE.make_interval_fn`, its shard_map over 4 of
tests/conftest.py's 8 host devices), in float64 on the CPU, on
tests/test_sharded.py's beuler deck: structured_quad(32, 8), 4 steps of
5e-3 s, with 2 Newton iterations of GMRES(2) in both packages (the JAX
package's sizes taken from `_beuler_step`'s defaults, which this test
sets), to 1e-12. Marked slow: the JAX package's sharded beuler compiles
for some 16 s on the CPU. tests/test_torch_sharded_beuler.py holds the
port's shards to its single device, which tests/test_torch_beuler*.py
hold to the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as DeviceMesh

from rdycore_tpu import timestepping as jax_timestepping
from rdycore_tpu.mesh import structured_quad as jax_quad
from rdycore_tpu.parallel.sharded import ShardedSWE as JaxShardedSWE
from rdycore_tpu_torch import timestepping
from rdycore_tpu_torch.mesh import structured_quad
from rdycore_tpu_torch.operator import build_operator
from rdycore_tpu_torch.parallel.sharded import ShardedSWE


@pytest.mark.slow
def test_beuler_against_the_jax_shards(monkeypatch):
    monkeypatch.setattr(timestepping, "NEWTON_ITERS", 2)
    monkeypatch.setattr(timestepping, "KRYLOV_M", 2)
    defaults = list(jax_timestepping._beuler_step.__defaults__)
    defaults[:2] = [2, 2]  # newton_iters, krylov_m
    monkeypatch.setattr(jax_timestepping._beuler_step, "__defaults__",
                        tuple(defaults))
    mesh = structured_quad(32, 8)
    C = mesh.num_cells
    mann = np.full(C, 0.02)
    q0 = np.zeros((3, C))
    q0[0] = 1.0 + 0.3 * np.sin(np.arange(C) * 0.1)
    jsh = JaxShardedSWE(jax_quad(32, 8), 4, mannings_n=mann,
                        dtype=jnp.float64)
    dm = DeviceMesh(np.array(jax.devices("cpu")[:4]), ("mesh",))
    jq = jsh.make_interval_fn(dm, "beuler")(
        jsh.scatter_state(q0), 0.0, 5e-3, 4, 1.0,
        jnp.zeros((3, jsh.ref_op.num_boundary_edges), jnp.float64),
        jnp.zeros((4, 3, jsh.C_loc), jnp.float64))[0]
    op = build_operator(mesh, mannings_n=mann, device="cpu")
    sh = ShardedSWE(op, 4)
    qt = torch.tensor(q0)
    r = sh.make_interval_fn("beuler")(
        sh.scatter_state(qt), 0.0, 5e-3, 4, 1.0,
        sh.scatter_boundary(op.zero_boundary_values()),
        sh.scatter_state(torch.zeros_like(qt)))
    q = sh.gather_state(r.qs, torch.device("cpu")).numpy()
    np.testing.assert_allclose(q, jsh.gather_state(jq), rtol=0, atol=1e-12)
    assert np.abs(q - q0).max() > 1e-3
