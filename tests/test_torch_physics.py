"""Pointwise physics of rdycore_tpu_torch against the JAX package, in f64.

The Roe flux, the velocity regularization, the three ghost states and the
three source methods get the same random wet, dry and zero-depth states
(made with numpy from a seed) in both packages and must agree to 1e-13,
relative to the largest magnitude (XLA contracts multiply-adds into FMAs
on the CPU and PyTorch does not, so agreement is to rounding, not bitwise).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdycore_tpu.ops.swe import boundary as jbc
from rdycore_tpu.ops.swe import riemann as jriemann
from rdycore_tpu.ops.swe import sources as jsrc
from rdycore_tpu_torch.ops.swe import boundary as tbc
from rdycore_tpu_torch.ops.swe import riemann as triemann
from rdycore_tpu_torch.ops.swe import sources as tsrc

TOL = 1e-13
TINY_H, H_ANUGA = 1e-7, 0.0
N = 600


def _close(a, b, tol=TOL):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    scale = max(1.0, float(np.max(np.abs(a)))) if a.size else 1.0
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert np.all(np.isfinite(b) == np.isfinite(a))
    assert err <= tol * scale, f"max abs err {err} > {tol} * {scale}"


def _depths(rng, n):
    """A third wet, a third dry (below tiny_h) and a third exactly zero."""
    h = rng.uniform(0.0, 2.0, n)
    kind = rng.integers(0, 3, n)
    h = np.where(kind == 1, rng.uniform(0.0, 0.5 * TINY_H, n), h)
    return np.where(kind == 2, 0.0, h)


def _states(seed):
    rng = np.random.default_rng(seed)
    hl, hr = _depths(rng, N), _depths(rng, N)
    hul, hvl, hur, hvr = (rng.normal(0.0, 0.5, N) for _ in range(4))
    theta = rng.uniform(0.0, 2.0 * np.pi, N)
    return hl, hul, hvl, hr, hur, hvr, np.sin(theta), np.cos(theta)


def _t(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("h_anuga", [0.0, 1e-3])
def test_regularized_velocity(h_anuga):
    hl, hul, hvl, *_ = _states(0)
    uj = jriemann.regularized_velocity(*_j(hl, hul, hvl), TINY_H, h_anuga)
    ut = triemann.regularized_velocity(*_t(hl, hul, hvl), TINY_H, h_anuga)
    for a, b in zip(uj, ut):
        _close(a, b)


def test_roe_flux():
    hl, hul, hvl, hr, hur, hvr, sn, cn = _states(1)
    ul, vl = jriemann.regularized_velocity(*_j(hl, hul, hvl), TINY_H, H_ANUGA)
    ur, vr = jriemann.regularized_velocity(*_j(hr, hur, hvr), TINY_H, H_ANUGA)
    args = [np.asarray(x) for x in (hl, ul, vl, hr, ur, vr, sn, cn)]
    fj = jriemann.roe_flux(*_j(*args))
    ft = triemann.roe_flux(*_t(*args))
    assert len(fj) == len(ft) == 4
    for a, b in zip(fj, ft):
        _close(a, b)


@pytest.mark.parametrize(
    "code", [jbc.BC_DIRICHLET, jbc.BC_REFLECTING, jbc.BC_CRITICAL_OUTFLOW]
)
def test_ghost_states(code):
    hl, hul, hvl, hr, hur, hvr, sn, cn = _states(2 + code)
    ul, vl = (np.asarray(x) for x in jriemann.regularized_velocity(
        *_j(hl, hul, hvl), TINY_H, H_ANUGA))
    bvals = np.stack([hr, hur, hvr])
    gj = jbc.ghost_states(code, *_j(hl, ul, vl, sn, cn, bvals), TINY_H, H_ANUGA)
    codes = torch.full((N,), code, dtype=torch.int8)
    gt = tbc.ghost_states(codes, *_t(hl, ul, vl, sn, cn, bvals), TINY_H,
                          H_ANUGA)
    for side_j, side_t in zip(gj, gt):
        for a, b in zip(side_j, side_t):
            _close(a, b)


def test_ghost_states_mixed_codes():
    """Per-edge codes pick, edge by edge, the ghost of the JAX package's
    per-segment function."""
    hl, hul, hvl, hr, hur, hvr, sn, cn = _states(7)
    ul, vl = (np.asarray(x) for x in jriemann.regularized_velocity(
        *_j(hl, hul, hvl), TINY_H, H_ANUGA))
    bvals = np.stack([hr, hur, hvr])
    codes = np.random.default_rng(8).integers(0, 3, N).astype(np.int8)
    gt = tbc.ghost_states(torch.as_tensor(codes),
                          *_t(hl, ul, vl, sn, cn, bvals), TINY_H, H_ANUGA)
    for code in range(3):
        sel = codes == code
        gj = jbc.ghost_states(code, *_j(hl, ul, vl, sn, cn, bvals), TINY_H,
                              H_ANUGA)
        for side_j, side_t in zip(gj, gt):
            for a, b in zip(side_j, side_t):
                _close(np.asarray(a)[sel], b[torch.as_tensor(sel)])


@pytest.mark.parametrize("method", ["semi_implicit", "xq2018", "none"])
def test_sources(method):
    rng = np.random.default_rng(11)
    h = _depths(rng, N)
    q = np.stack([h, rng.normal(0, 0.5, N), rng.normal(0, 0.5, N)])
    flux_div = rng.normal(0.0, 1.0, (3, N))
    ext = rng.normal(0.0, 1e-3, (3, N))
    n = rng.uniform(0.0, 0.05, N)
    dzx, dzy = rng.normal(0, 0.01, N), rng.normal(0, 0.01, N)
    dt = 0.01
    common = (q, flux_div, ext, n, dzx, dzy)
    if method == "xq2018":
        rj = jsrc.apply_source_xq2018(*_j(*common), dt, TINY_H, H_ANUGA, 1e-10)
        rt = tsrc.apply_source_xq2018(*_t(*common), dt, TINY_H, H_ANUGA, 1e-10)
    elif method == "none":
        rj = jsrc.apply_source_none(*_j(*common), dt, TINY_H, H_ANUGA)
        rt = tsrc.apply_source_none(*_t(*common), dt, TINY_H, H_ANUGA)
    else:
        rj = jsrc.apply_source_semi_implicit(*_j(*common), dt, TINY_H, H_ANUGA)
        rt = tsrc.apply_source_semi_implicit(*_t(*common), dt, TINY_H, H_ANUGA)
    _close(rj.rhs, rt.rhs)
    _close(rj.prim, rt.prim)
