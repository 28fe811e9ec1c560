"""The JVPs of backward Euler: forward-mode AD through the port's
linearization twin (`operator.linearization_twin`) against `jax.jvp` of
the JAX package's XLA operator, on the CPU, in f64; and `safe_sqrt` and
`safe_cbrt`, primal and tangent, against `jax.jvp` of the JAX package's
at 0 and above, the primal torch.sqrt (and `cbrt`) bit for bit.

J v of the right-hand side (`apply(q, dt, bv, ext).rhs`) at a random
state with dry cells (some exactly h = 0, where the JAX package's
maximum(h, 0) and its safe_sqrt pick their subgradients), with
Dirichlet (non-zero values), critical-outflow and reflecting walls and
external sources, on one small triangle mesh over a bumpy bed; the JAX
JVPs of each file come from one jitted call. Tolerance 1e-12 relative to
each output's largest magnitude. Variants here: first order, and two
tracer rows (one sediment class) with upwind-Roe; MUSCL with the
positivity limiter, hydrostatic reconstruction and BS2002 are in
tests/test_torch_beuler_jvp_wb.py.

The tangent v is N(0, 1) times max(|q|, 1e-7): a relative perturbation,
the dry cells' at the dry depths' own scale. At sub-tiny_h depths the
rhs is steep (the velocity regularization), and a tangent of 1e-3 there
amplifies the rounding of XLA's fused (FMA-contracted) jit code beyond
1e-12 of the field under hydrostatic reconstruction, where the port
follows JAX's unfused op-by-op evaluation to rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdycore_tpu.mesh import structured_tri
from rdycore_tpu.operator import build_operator as jax_build_operator
from rdycore_tpu.ops.math import safe_cbrt as jax_safe_cbrt
from rdycore_tpu.ops.math import safe_sqrt as jax_safe_sqrt
from rdycore_tpu_torch.operator import linearization_twin
from rdycore_tpu_torch.ops.math import cbrt, safe_cbrt, safe_sqrt
from rdycore_tpu_torch.timestepping import jvp

from test_torch_muscl_operator import front_state
from test_torch_operator import BC_TYPES, assert_rel_close, random_inputs
from test_torch_wb_operator import bumpy, port_wb_operator

DT = 0.002
NT, NS = 2, 1
CASES = {
    "first_order": (dict(), "flow"),
    "tracers_upwind": (dict(num_tracers=NT, num_sediment=NS,
                            riemann="upwind_roe"), "tracers"),
}


def case_inputs(jop, kind, seed):
    """(q, bv, ext, v) of a case."""
    if kind == "front":
        q, bv, ext = front_state(jop, seed)
    else:
        q, bv, ext = random_inputs(jop, seed)
    rng = np.random.default_rng(seed + 50)
    if kind == "tracers":
        C, Eb = jop.num_cells, jop.num_boundary_edges
        q = np.concatenate([q, q[0] * rng.uniform(0.0, 0.5, (NT, C))])
        bv = np.concatenate([bv, bv[0] * rng.uniform(0.0, 0.5, (NT, Eb))])
        ext = np.concatenate([ext, rng.normal(0.0, 1e-4, (NT, C))])
    v = rng.normal(size=q.shape) * np.maximum(np.abs(q), 1e-7)
    return q, bv, ext, v


def jax_jvps(cases):
    """The JAX operators of `cases` ({name: (build_operator keywords,
    input kind)}), their inputs, and (rhs, J v) of each from one jitted
    call."""
    m = structured_tri(12, 10, 0.0, 2.0, 0.0, 1.0, z_fn=bumpy)
    n = np.random.default_rng(3).uniform(0.01, 0.05, m.num_cells)
    jops = {k: jax_build_operator(m, bc_types=BC_TYPES, mannings_n=n,
                                  dtype=jnp.float64, **kw)
            for k, (kw, _) in cases.items()}
    inputs = {k: case_inputs(jops[k], kind, seed)
              for seed, (k, (_, kind)) in enumerate(cases.items())}

    def run(args):
        out = {}
        for k, (q, bv, ext, v) in args.items():
            def rhs(x, jop=jops[k], bv=bv, ext=ext):
                return jop.apply(x, jnp.asarray(DT), bv, ext).rhs
            out[k] = jax.jvp(rhs, (q,), (v,))
        return out

    args = {k: tuple(map(jnp.asarray, x)) for k, x in inputs.items()}
    return jops, inputs, jax.jit(run)(args)


def check_jvp(jops, inputs, results, case):
    twin = linearization_twin(port_wb_operator(jops[case]))
    q, bv, ext, v = (torch.as_tensor(x) for x in inputs[case])
    dt = torch.tensor(DT, dtype=torch.float64)

    def rhs(x):
        return twin.apply(x, dt, bv, ext).rhs

    got = jvp(rhs, q, v)
    assert torch.isfinite(got).all()
    pj, tj = (np.asarray(x) for x in results[case])
    assert_rel_close(pj, twin.rhs(q, dt, bv, ext).numpy(), 1e-12, "rhs")
    for k in range(q.shape[0]):
        assert_rel_close(tj[k], got[k].numpy(), 1e-12, f"J v row {k}")
    assert float(got.abs().max()) > 0.0


@pytest.fixture(scope="module")
def reference():
    return jax_jvps(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_jvp_matches_jax(reference, case):
    check_jvp(*reference, case)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["sqrt", "cbrt"])
def test_safe_roots_match_jax(name, dtype):
    x = np.concatenate([[0.0, 0.0, 1e-30, 5e-8], np.geomspace(1e-9, 50, 60)])
    v = np.random.default_rng(1).normal(size=x.shape)
    jf, tf, plain = {"sqrt": (jax_safe_sqrt, safe_sqrt, torch.sqrt),
                     "cbrt": (jax_safe_cbrt, safe_cbrt, cbrt)}[name]
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    yj, tj = jax.jvp(jf, (jnp.asarray(x, jd),), (jnp.asarray(v, jd),))
    xt, vt = torch.as_tensor(x, dtype=dtype), torch.as_tensor(v, dtype=dtype)
    y, t = tf(xt), jvp(tf, xt, vt)
    assert torch.equal(y, plain(xt))
    assert torch.equal(torch.func.jvp(tf, (xt,), (vt,))[1], t)
    assert not t[:2].any() and torch.isfinite(t).all()
    # XLA's float32 cbrt is a few ulps from the float64 root rounded, and
    # the tangent 1 / (3 y^2) doubles that
    rtol = 1e-15 if dtype == torch.float64 else 4e-6
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=rtol, atol=0)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), rtol=rtol, atol=0)
