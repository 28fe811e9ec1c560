"""Steady subcritical flow over a bump (SWASHES; tests/test_bump_steady.py)
on rdycore_tpu_torch's interval advancer on the CPU, in f64, at the JAX
test's size and thresholds: q = 4.42 m^2/s over z(x) = max(0, 0.2 - 0.05
(x - 10)^2), downstream depth 2 m; from the analytic state (Bernoulli)
with exact Dirichlet ends, the solver must hold it for 20 s. The
transcritical case: tests/test_torch_oracles_bump_trans.py.
"""

import numpy as np

from rdycore_tpu_torch.mesh import structured_quad
from rdycore_tpu_torch.ops.swe.boundary import BC_DIRICHLET

from test_torch_oracles import (  # noqa: F401  (an autouse fixture)
    G, advance, cpu_operator, one_torch_thread)

Q = 4.42
H_OUT = 2.0


def _z(x):
    return np.maximum(0.0, 0.2 - 0.05 * (x - 10.0) ** 2)


def _h_analytic(x):
    z = _z(x)
    Htot = Q**2 / (2 * G * H_OUT**2) + H_OUT  # energy head (z_out = 0)
    h = np.full_like(x, H_OUT)
    for _ in range(60):  # Newton on  q^2/(2 g h^2) + h + z - Htot = 0
        f = Q**2 / (2 * G * h**2) + h + z - Htot
        df = 1.0 - Q**2 / (G * h**3)
        h = np.maximum(h - f / df, 0.5)
    return h


def bump_run(h_of_x, q_in, dt, n_steps):
    """From the analytic state (h_of_x, discharge q_in) with that state on
    both Dirichlet ends: (x, h0, h1, hu1)."""
    mesh = structured_quad(200, 4, 0.0, 25.0, 0.0, 1.0,
                           z_fn=lambda x, y: _z(x))
    x = mesh.cell_centroid[:, 0]
    h0 = h_of_x(x)
    q0 = np.zeros((3, mesh.num_cells))
    q0[0], q0[1] = h0, q_in
    op = cpu_operator(mesh, bc_types={"left": BC_DIRICHLET,
                                      "right": BC_DIRICHLET})
    bv = np.zeros((3, op.num_boundary_edges))
    bnd_left = op.arrays.bnd_left.numpy()
    for seg in op.segments:
        if seg.bc_type != BC_DIRICHLET:
            continue
        sl = slice(seg.start, seg.start + seg.count)
        bv[0, sl] = h_of_x(x[bnd_left[sl]])
        bv[1, sl] = q_in
    q1 = advance(op, q0, dt, n_steps, 1e9, bv)
    return x, h0, q1[0], q1[1]


def test_subcritical_bump_holds_steady():
    """q = 4.42 m^2/s over the bump, downstream depth 2 m: the bed-slope
    source balances the momentum flux in motion for 20 s."""
    _, h0, h1, hu1 = bump_run(_h_analytic, Q, 0.005, 4000)
    assert np.isfinite(h1).all()
    rel = np.abs(h1 - h0) / h0
    assert rel.max() < 0.02, f"max rel depth drift {rel.max():.4f}"
    assert np.abs(hu1 - Q).max() / Q < 0.02
