"""Backward Euler (`temporal: beuler`) of rdycore_tpu_torch: its pieces
against the JAX package's, on the CPU, in f64.

The JAX beuler interval advancer compiles 16 unrolled JVPs of the whole
operator and its line search (about a minute), so the counted tests hold
the port to the JAX package piece by piece:

- `newton_beuler_solve` (6 Newton iterations, GMRES(16)) against the
  jitted JAX one on the same cheap nonlinear F written in both frameworks
  (one compile for all cases), the iterate to 1e-12: a general case, a
  fixed point (beta = 0: the state comes back unchanged) and an F whose
  Krylov space closes at once (h_10 = 0 exactly: a rank-1 Hessenberg,
  whose least-squares solve must take the JAX package's minimum-norm
  answer and stay finite);
- the least-squares solve on the Hessenberg (`lstsq_min_norm`, Givens
  rotations) against jnp.linalg.lstsq on the singular Hessenbergs of an
  Arnoldi breakdown and on a general one, to 1e-12;
- a beuler step of the port's interval advancer on structured_quad(16,
  12) (the JAX package's tests/test_temporal_order.py:75-90 setup, dt =
  0.01), closed box: it must drive ||u - u^n - dt F(u)|| below 1e-8 of its
  value at u^n, and keep the volume to 1e-12. One step: a step's 96 JVPs
  take about 5 s of forward-mode AD on the CPU.

The twin's JVPs, and `safe_sqrt` and `safe_cbrt`, are held against
jax.jvp in tests/test_torch_beuler_jvp*.py. The whole-interval oracle against the
jitted JAX advancer is `test_beuler_interval_matches_jax`, marked slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdycore_tpu.mesh import structured_quad as jax_quad
from rdycore_tpu.operator import build_operator as jax_build_operator
from rdycore_tpu.timestepping import make_interval_advancer as jax_advancer
from rdycore_tpu.timestepping import (
    newton_beuler_solve as jax_newton_beuler_solve,
)
from rdycore_tpu_torch.timestepping import (
    lstsq_min_norm,
    make_interval_advancer,
    newton_beuler_solve,
)

from test_torch_operator import port_operator


# the cheap nonlinear F of the Newton tests, in both frameworks:
# F(u) = -lam (u - c) - kap (u - c)^3, elementwise
def jax_F(u, c, lam, kap):
    d = u - c
    return -lam * d - kap * d * d * d


def port_F(u, c, lam, kap):
    d = u - c
    return -lam * d - kap * d * d * d


def newton_cases():
    """(name, q, c, lam, kap, dt) of each case, [3, 17] arrays."""
    rng = np.random.default_rng(9)
    shape = (3, 17)
    c = rng.normal(size=shape)
    lam = rng.uniform(0.5, 3.0, shape)
    kap = rng.uniform(0.0, 2.0, shape)
    general = c + rng.normal(0, 0.5, shape)
    # Krylov space closed at once: linear F with one lam, R = -dt F(q)
    # nonzero in one entry, so V_0 = e_k and h_10 = 0 exactly
    closing = c.copy()
    closing[1, 5] += 0.7
    return [("general", general, c, lam, kap, 0.3),
            ("fixed point", c.copy(), c, lam, kap, 0.3),
            ("krylov closes", closing, c, np.full(shape, 1.7),
             np.zeros(shape), 0.3)]


@pytest.fixture(scope="module")
def jax_newton():
    """The JAX newton_beuler_solve, compiled once, on every case."""
    @jax.jit
    def solve(q, c, lam, kap, dt):
        def F(u):
            return jax_F(u, c, lam, kap)
        return jax_newton_beuler_solve(F, F, q, dt)

    return {name: np.asarray(solve(*map(jnp.asarray, (q, c, lam, kap)),
                                   jnp.asarray(dt)))
            for name, q, c, lam, kap, dt in newton_cases()}


@pytest.mark.parametrize("case", range(3),
                         ids=[c[0] for c in newton_cases()])
def test_newton_beuler_solve_matches_jax(jax_newton, case):
    name, q, c, lam, kap, dt = newton_cases()[case]
    T = torch.as_tensor
    c_, lam_, kap_ = T(c), T(lam), T(kap)

    def F(u):
        return port_F(u, c_, lam_, kap_)

    u = newton_beuler_solve(F, F, T(q), T(np.float64(dt)))
    assert torch.isfinite(u).all()
    np.testing.assert_allclose(u.numpy(), jax_newton[name], rtol=0,
                               atol=1e-12 * max(1.0, np.abs(q).max()))
    R = u - T(q) - dt * F(u)
    if name == "fixed point":
        assert torch.equal(u, T(q))
    else:
        assert float(R.abs().max()) < 1e-12


def hessenbergs():
    """(name, H, b) of 17x16 Hessenbergs as Arnoldi leaves them: after a
    zero residual (H = 0, b = 0), a Krylov space closed at once (rank 1)
    or after 5 steps (h_54 = 0, the columns after it zero), and a general
    one."""
    rng = np.random.default_rng(11)
    general = np.triu(rng.normal(size=(17, 16)), -1)
    closed5 = general.copy()
    closed5[5, 4] = 0.0
    closed5[:, 5:] = 0.0
    rank1 = np.zeros((17, 16))
    rank1[0, 0] = 1.51
    b = np.zeros(17)
    b[0] = 0.8
    return [("zero", np.zeros((17, 16)), np.zeros(17)),
            ("rank 1", rank1, b), ("closed after 5", closed5, b),
            ("general", general, b)]


@pytest.mark.parametrize("case", range(4),
                         ids=[c[0] for c in hessenbergs()])
def test_lstsq_min_norm_matches_jax(case):
    """The Givens least-squares solve of GMRES's Hessenberg against
    jnp.linalg.lstsq (SVD, minimum norm), which the JAX package's GMRES
    calls: finite, and the same answer on the singular Hessenbergs of an
    Arnoldi breakdown."""
    _, H, b = hessenbergs()[case]
    y = lstsq_min_norm(torch.as_tensor(H), torch.as_tensor(b))
    want = np.asarray(jnp.linalg.lstsq(jnp.asarray(H), jnp.asarray(b))[0])
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-12)


def beuler_deck():
    """The JAX package's beuler order-test deck (its
    tests/test_temporal_order.py:75-90): a smooth wave in a closed box."""
    mesh = jax_quad(16, 12, 0.0, 4.0, 0.0, 3.0)
    x = mesh.cell_centroid[:, 0]
    q0 = np.zeros((3, mesh.num_cells))
    q0[0] = 2.0 + 0.1 * np.sin(np.pi * x / 2.0)
    jop = jax_build_operator(mesh, mannings_n=np.full(mesh.num_cells, 0.03))
    return jop, q0


def test_beuler_step_converges():
    jop, q0 = beuler_deck()
    op = port_operator(jop, torch.float64)
    adv = make_interval_advancer(op, "beuler")
    bv, dt = op.zero_boundary_values(), 0.01
    ext = torch.zeros((3, op.num_cells), dtype=torch.float64)
    area = op.arrays.area
    q = torch.as_tensor(q0)
    res = adv(q, 0.0, dt, 1, dt, bv, ext)

    def residual(u):
        return float(torch.linalg.vector_norm(
            u - q - dt * op.rhs(u, dt, bv, None)))

    r0, r1 = residual(q), residual(res.q)
    assert r1 < 1e-8 * r0, (r0, r1)
    assert float(((res.q[0] - q[0]) * area).sum()) == pytest.approx(
        0.0, abs=1e-12 * float((q[0] * area).sum()))
    assert float(res.max_courant) > 0.0
    assert float((res.q - q).abs().max()) > 1e-4


@pytest.mark.slow
def test_beuler_interval_matches_jax():
    """The whole-interval oracle: 3 beuler steps of the port against the
    jitted JAX advancer (about a minute of compile) on the deck above."""
    jop, q0 = beuler_deck()
    op = port_operator(jop, torch.float64)
    dt, n = 0.01, 3
    bv = np.zeros((3, jop.num_boundary_edges))
    ext = np.zeros_like(q0)
    rj = jax.jit(jax_advancer(jop, "beuler"))(
        jop.arrays, jnp.asarray(q0), 0.0, dt, n, n * dt, jnp.asarray(bv),
        jnp.asarray(ext))
    rt = make_interval_advancer(op, "beuler")(
        torch.as_tensor(q0), 0.0, dt, n, n * dt, torch.as_tensor(bv),
        torch.as_tensor(ext))
    for field in ("q", "bflux_accum", "accum_sol", "accum_prim"):
        a, b = np.asarray(getattr(rj, field)), getattr(rt, field).numpy()
        assert np.abs(a - b).max() <= 1e-11 * max(np.abs(a).max(), 1.0), \
            field
    assert float(rt.max_courant) == pytest.approx(float(rj.max_courant),
                                                  rel=1e-12)
    assert int(rt.courant_edge) == int(rj.courant_edge)
