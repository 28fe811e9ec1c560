"""The interval advancer of rdycore_tpu_torch against the JAX package's, on
the CPU, in f64.

20 steps of euler, ssprk2, ssprk3 and rk4 on structured_quad(24, 16) with
Dirichlet, critical-outflow and reflecting walls, semi-implicit friction
and external sources; t_end cuts the last step in half. Every field of the
interval result agrees to 1e-11 relative to its largest magnitude, and the
Courant edge id is equal. The port runs euler/ssprk* in stage mode (one
edge and one cell-stage call per stage) and rk4 through `apply`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdycore_tpu.mesh import structured_quad
from rdycore_tpu.operator import build_operator as jax_build_operator
from rdycore_tpu.timestepping import make_interval_advancer as jax_advancer
from rdycore_tpu_torch.timestepping import (
    _FUSED_STEP_STAGES,
    adapt_timestep,
    make_interval_advancer,
)

from test_torch_operator import BC_TYPES, assert_rel_close, port_operator


@pytest.mark.parametrize("scheme", ["euler", "ssprk2", "ssprk3", "rk4"])
def test_interval_matches_jax(scheme):
    m = structured_quad(24, 16, 0.0, 2.0, 0.0, 1.0)
    rng = np.random.default_rng(21)
    C = m.num_cells
    jop = jax_build_operator(m, bc_types=BC_TYPES,
                             mannings_n=rng.uniform(0.01, 0.04, C))
    top = port_operator(jop, torch.float64)
    h = np.where(m.cell_centroid[:, 0] < 1.0, 0.5, 0.05)
    h = h * rng.uniform(0.9, 1.1, C)
    q = np.stack([h, h * rng.normal(0, 0.1, C), h * rng.normal(0, 0.1, C)])
    Eb = jop.num_boundary_edges
    bv = np.stack([np.full(Eb, 0.3), np.full(Eb, 0.05), np.zeros(Eb)])
    ext = rng.uniform(0.0, 1e-4, (3, C)) * [[1.0], [0.0], [0.0]]
    dt, n_steps = 0.002, 20
    t0 = 0.1
    t_end = t0 + (n_steps - 0.5) * dt

    rj = jax.jit(jax_advancer(jop, scheme))(
        jop.arrays, jnp.asarray(q), t0, dt, n_steps, t_end, jnp.asarray(bv),
        jnp.asarray(ext),
    )
    rt = make_interval_advancer(top, scheme)(
        torch.as_tensor(q), t0, dt, n_steps, t_end, torch.as_tensor(bv),
        torch.as_tensor(ext),
    )
    assert float(rt.t) == pytest.approx(t_end, abs=1e-15)
    for field in rj._fields:
        if field == "courant_edge":
            assert int(rt.courant_edge) == int(rj.courant_edge)
        else:
            assert_rel_close(getattr(rj, field), getattr(rt, field).numpy(),
                             1e-11, field)


def test_stage_tables_match_jax():
    from rdycore_tpu.timestepping import _FUSED_STEP_STAGES as jax_stages

    assert _FUSED_STEP_STAGES == jax_stages


@pytest.mark.parametrize("cmax", [0.0, 0.2, 0.7, 1.5])
def test_adapt_timestep_matches_jax(cmax):
    from rdycore_tpu.timestepping import adapt_timestep as jax_adapt

    args = (0.01, cmax, 0.7, 1.3, 0.05)
    assert adapt_timestep(*args) == jax_adapt(*args)
