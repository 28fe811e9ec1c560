"""The MMS forcing through rdycore_tpu_torch's interval advancer against
the JAX package's, on the CPU, in f64.

`make_interval_advancer` with the MMS deck's boundary values and sources
(tools/torch_mms_decks.py) as bc_fn and src_fn, evaluated once a step at
the half-step time inside the loop: 20 steps of euler, ssprk2 and ssprk3
(rk4 and ark_imex in tests/test_torch_mms_interval_rk_jax.py) on 96 cells
with a Dirichlet BC on every wall, the last step cut short; every field of
the interval result to 1e-11 relative to its largest magnitude, the
Courant edge id equal. (beuler is held against itself with constant
forcing in tests/test_torch_mms.py: the JAX package's beuler compiles for
some 20 s.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdycore_tpu.config.yaml_input import config_from_dict as jax_config
from rdycore_tpu.mesh import build_mesh as jax_build_mesh
from rdycore_tpu.mesh import generate as jax_generate
from rdycore_tpu.mms import MMSProblem as JaxMMSProblem
from rdycore_tpu.operator import build_operator as jax_build_operator
from rdycore_tpu.ops.swe.boundary import BC_DIRICHLET
from rdycore_tpu.timestepping import make_interval_advancer as jax_advancer
from rdycore_tpu_torch.config.yaml_input import config_from_dict
from rdycore_tpu_torch.mms import MMSProblem
from rdycore_tpu_torch.timestepping import make_interval_advancer

from test_torch_operator import port_operator
from tools.torch_mms_decks import mms_deck


def forcing_case(nx, ny, num_sediment=0):
    """The MMS deck's forcing on an nx x ny quad mesh in both packages,
    on the JAX operator (a Dirichlet BC on every wall) and the port's copy
    of it: (jop, top, JAX (bc_fn, src_fn, q0), port (bc_fn, src_fn, q0))."""
    deck = mms_deck("unused.npz", 0.002, 0.04, 0, num_sediment=num_sediment)
    jprob = JaxMMSProblem(jax_config(deck).validate())
    tprob = MMSProblem(config_from_dict(deck).validate())
    m = jax_generate.structured_quad(nx, ny, 0.0, 4.0, 0.0, 2.75)
    pts = m.points.copy()
    pts[:, 2] = np.asarray(jprob.fns["z"](pts[:, 0], pts[:, 1], 0.0))
    m = jax_build_mesh(pts, m.cell_vertices, regions=m.regions,
                       boundary_edges={n: m.edge_vertices[e]
                                       for n, e in m.boundaries.items()})
    cx, cy = m.cell_centroid[:, 0], m.cell_centroid[:, 1]
    jop = jax_build_operator(
        m, bc_types={n: BC_DIRICHLET for n in m.boundaries},
        mannings_n=np.asarray(jprob.fns["n"](cx, cy, 0.0)),
        num_tracers=num_sediment, num_sediment=num_sediment)
    top = port_operator(jop, torch.float64)
    ev = np.concatenate([m.edge_vertices[s.edge_ids] for s in jop.segments])
    mid = (m.points[ev[:, 0], :2] + m.points[ev[:, 1], :2]) / 2.0
    jx, jy, jbx, jby = (jnp.asarray(a) for a in (cx, cy, mid[:, 0],
                                                 mid[:, 1]))
    tx, ty, tbx, tby = (torch.as_tensor(a) for a in (cx, cy, mid[:, 0],
                                                     mid[:, 1]))
    jax_side = (lambda t: jprob.boundary_values(jbx, jby, t),
                lambda t: jprob.source_terms(jx, jy, t),
                jprob.solution(jx, jy, 0.0))
    port_side = (lambda t: tprob.boundary_values(tbx, tby, t),
                 tprob.forcing(tx, ty), tprob.solution(tx, ty, 0.0))
    return jop, top, jax_side, port_side


def assert_interval_close(rt, rj):
    for field in rj._fields:
        got = getattr(rt, field).double().numpy()
        want = np.asarray(getattr(rj, field), np.float64)
        if field == "courant_edge":
            assert int(got) == int(want)
            continue
        scale = max(float(np.abs(want).max()), 1e-300)
        assert float(np.abs(got - want).max()) <= 1e-11 * scale, field


def forced_interval_matches_jax(scheme):
    """20 steps under the MMS forcing, the last one cut short."""
    jop, top, (jbc, jsrc, jq0), (tbc, tsrc, tq0) = forcing_case(12, 8)
    dt, n, t_end = 0.004, 20, 0.078
    rj = jax.jit(jax_advancer(jop, scheme, bc_fn=jbc, src_fn=jsrc),
                 static_argnums=4)(
        jop.arrays, jq0, 0.0, dt, n, t_end, jop.zero_boundary_values(),
        jnp.zeros_like(jq0))
    rt = make_interval_advancer(top, scheme, bc_fn=tbc, src_fn=tsrc)(
        tq0, 0.0, dt, n, t_end, top.zero_boundary_values(),
        torch.zeros_like(tq0))
    assert float(rt.t) == pytest.approx(t_end, abs=1e-15)
    assert_interval_close(rt, rj)


@pytest.mark.parametrize("scheme", ["euler", "ssprk2", "ssprk3"])
def test_forced_interval_matches_jax(scheme):
    forced_interval_matches_jax(scheme)
