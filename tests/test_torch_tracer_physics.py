"""Pointwise tracer physics of rdycore_tpu_torch against the JAX package, in
f64.

The same random wet, dry and zero-depth states, with three tracers, made
with numpy from a seed, go through both packages: `roe_flux` with tracer
concentrations (exact and fast, Roe and upwind-Roe), `tracer_roe_flux`
(Roe and upwind-Roe) and `tracer_source_terms` with two sediment classes
of three tracers, under the semi-implicit source method and the method
none (no friction). Tolerance 1e-12 relative to each output's largest
magnitude (XLA contracts multiply-adds into FMAs on the CPU and PyTorch
does not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdycore_tpu.ops.swe import riemann as jriemann
from rdycore_tpu.ops.tracer import flux as jflux
from rdycore_tpu.ops.tracer import sources as jsrc
from rdycore_tpu_torch.ops.swe import riemann as triemann
from rdycore_tpu_torch.ops.tracer import flux as tflux
from rdycore_tpu_torch.ops.tracer import sources as tsrc

TOL = 1e-12
TINY_H, H_ANUGA = 1e-7, 0.0
N, NT = 500, 3


def close(a, b, what):
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape, what
    assert np.all(np.isfinite(a)) and np.all(np.isfinite(b)), what
    scale = max(float(np.max(np.abs(a))), 1e-30)
    err = float(np.max(np.abs(a - b)))
    assert err <= TOL * scale, f"{what}: {err} > {TOL} * {scale}"


def depths(rng, n):
    """A third wet, a third dry (below tiny_h), a third exactly zero."""
    h = rng.uniform(0.0, 2.0, n)
    kind = rng.integers(0, 3, n)
    h = np.where(kind == 1, rng.uniform(0.0, 0.5 * TINY_H, n), h)
    return np.where(kind == 2, 0.0, h)


def edge_states(seed):
    """Regularized left/right states, normals and concentrations."""
    rng = np.random.default_rng(seed)
    hl, hr = depths(rng, N), depths(rng, N)
    ul, vl, ur, vr = (rng.normal(0.0, 0.5, N) for _ in range(4))
    theta = rng.uniform(0.0, 2.0 * np.pi, N)
    cil = rng.uniform(0.0, 2.0, (NT, N)) * (hl > TINY_H)
    cir = rng.uniform(0.0, 2.0, (NT, N)) * (hr > TINY_H)
    return (hl, ul, vl, cil, hr, ur, vr, cir, np.sin(theta), np.cos(theta))


@pytest.mark.parametrize("upwind", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_roe_flux_with_tracers(fast, upwind):
    hl, ul, vl, cil, hr, ur, vr, cir, sn, cn = edge_states(1)
    want = jax.jit(jriemann.roe_flux, static_argnames=("fast", "upwind"))(
        *map(jnp.asarray, (hl, ul, vl, hr, ur, vr, sn, cn)), fast=fast,
        cil=jnp.asarray(cil), cir=jnp.asarray(cir), upwind=upwind)
    t = [torch.as_tensor(x) for x in (hl, ul, vl, hr, ur, vr, sn, cn)]
    got = triemann.roe_flux(*t, fast=fast, cil=torch.as_tensor(cil),
                            cir=torch.as_tensor(cir), upwind=upwind)
    assert len(got) == 5
    for name, a, b in zip(("f_h", "f_hu", "f_hv", "amax", "f_tracer"), want,
                          got):
        close(a, b, name)


@pytest.mark.parametrize("upwind", [False, True])
def test_tracer_roe_flux(upwind):
    args = edge_states(2)
    want = jax.jit(jflux.tracer_roe_flux, static_argnames=("upwind",))(
        *map(jnp.asarray, args), upwind=upwind)
    got = tflux.tracer_roe_flux(*(torch.as_tensor(x) for x in args), upwind)
    for name, a, b in zip(("f_flow", "f_tracer", "amax"), want, got):
        close(a, b, name)
    # safe_div guards by the wet depth and divides by 1 for b == 0
    h = args[0]
    close(jflux.safe_div(jnp.asarray(args[3]), jnp.asarray(h),
                         jnp.asarray(h), TINY_H),
          tflux.safe_div(torch.as_tensor(args[3]), torch.as_tensor(h),
                         torch.as_tensor(h), TINY_H), "safe_div")


@pytest.mark.parametrize("friction", [True, False])
def test_tracer_source_terms(friction):
    rng = np.random.default_rng(3 + friction)
    C, ndof = N, 3 + NT
    h = depths(rng, C)
    q = np.concatenate([
        [h, h * rng.normal(0, 0.8, C), h * rng.normal(0, 0.8, C)],
        h * rng.uniform(0.0, 0.3, (NT, C))])
    flux_div = rng.normal(0.0, 1.0, (ndof, C))
    ext = rng.normal(0.0, 1e-3, (ndof, C))
    geo = (rng.uniform(0.01, 0.1, C), rng.normal(0, 0.05, C),
           rng.normal(0, 0.05, C))
    dt = 0.01

    def jfn(*a):
        return jsrc.tracer_source_terms(
            *a, dt, TINY_H, H_ANUGA, 2, jsrc.SedimentParams(),
            include_friction=friction)

    want = jax.jit(jfn)(*map(jnp.asarray, (q, flux_div, ext) + geo))
    got = tsrc.tracer_source_terms(
        *(torch.as_tensor(x) for x in (q, flux_div, ext) + geo), dt, TINY_H,
        H_ANUGA, 2, tsrc.SedimentParams(), include_friction=friction)
    close(want[0], got[0], "rhs")
    close(want[1], got[1], "prim")
    # erosion acts on the two sediment rows only
    wet = h > TINY_H
    assert np.any(np.asarray(want[0])[3:5, wet] != ext[3:5, wet])
    assert np.array_equal(got[0][5].numpy(), ext[5])
    assert tuple(tsrc.SedimentParams()) == tuple(jsrc.SedimentParams())
