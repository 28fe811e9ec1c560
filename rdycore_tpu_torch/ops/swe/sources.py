"""SWE source terms: bed slope, Manning friction, external (rain) sources
(plain PyTorch).

The numerics of rdycore_tpu/ops/swe/sources.py, which mirror the
reference source operators:
- semi-implicit friction tb/(1 + dt*tb): swe_petsc.c:704-804 /
  swe_sources_ceed.h:37-63
- implicit XQ2018 closed form:           swe_petsc.c:816-932 /
  swe_sources_ceed.h:69-105
- none: bed slope + external sources only.
Each returns the source part of the RHS and the primitive variables
(h, u, v) for time-averaged output. include_bed_slope=False drops the
bed-slope term, as hydrostatic reconstruction does (its pressure
correction takes its place). The CUDA cell kernel
(ops/kernels/csrc/swe_physics.cuh) repeats this arithmetic.

dt is a tensor (0-dim, possibly on the device) or a Python float; tiny_h,
h_anuga and the XQ2018 threshold are Python floats.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...constants import GRAVITY
from ..math import power, safe_sqrt

SOURCE_SEMI_IMPLICIT = 0
SOURCE_IMPLICIT_XQ2018 = 1
SOURCE_NONE = 2


class SourceResult(NamedTuple):
    rhs: torch.Tensor  # [3, C] source contribution to add to the RHS
    prim: torch.Tensor  # [3, C] primitive variables (h, u, v)


def _primitives(h, hu, hv, tiny_h, h_anuga):
    denom = h * h + h_anuga * h_anuga
    denom_safe = torch.where(denom > 0.0, denom, 1.0)
    wet = h >= tiny_h
    u = torch.where(wet, hu * h / denom_safe, 0.0)
    v = torch.where(wet, hv * h / denom_safe, 0.0)
    return u, v


def _bed(q, dz_dx, dz_dy, include_bed_slope=True):
    h = q[0]
    if not include_bed_slope:
        return torch.zeros_like(h), torch.zeros_like(h)
    g = torch.tensor(GRAVITY, dtype=q.dtype)
    return dz_dx * g * h, dz_dy * g * h


def _result(q, bedx, bedy, tbx, tby, ext_src, tiny_h, h_anuga):
    h, hu, hv = q[0], q[1], q[2]
    rhs = torch.stack(
        [ext_src[0], -bedx - tbx + ext_src[1], -bedy - tby + ext_src[2]]
    )
    pu, pv = _primitives(h, hu, hv, tiny_h, h_anuga)
    return SourceResult(rhs=rhs, prim=torch.stack([h, pu, pv]))


def apply_source_none(
    q, flux_div, ext_src, mannings_n, dz_dx, dz_dy, dt, tiny_h, h_anuga,
    include_bed_slope=True,
) -> SourceResult:
    """Bed slope + external sources, no friction."""
    bedx, bedy = _bed(q, dz_dx, dz_dy, include_bed_slope)
    return _result(q, bedx, bedy, 0.0, 0.0, ext_src, tiny_h, h_anuga)


def apply_source_semi_implicit(
    q, flux_div, ext_src, mannings_n, dz_dx, dz_dy, dt, tiny_h, h_anuga,
    include_bed_slope=True,
) -> SourceResult:
    """Semi-implicit bed-slope + friction source."""
    g = torch.tensor(GRAVITY, dtype=q.dtype)
    h, hu, hv = q[0], q[1], q[2]
    bedx, bedy = _bed(q, dz_dx, dz_dy, include_bed_slope)

    wet = h >= tiny_h
    h_safe = torch.where(wet, h, 1.0)
    u = hu / h_safe
    v = hv / h_safe
    cd = g * mannings_n * mannings_n * power(h_safe, -1.0 / 3.0)
    speed = safe_sqrt(u * u + v * v)
    tb = cd * speed / h_safe
    factor = tb / (1.0 + dt * tb)

    tbx = torch.where(wet, (hu + dt * flux_div[1] - dt * bedx) * factor, 0.0)
    tby = torch.where(wet, (hv + dt * flux_div[2] - dt * bedy) * factor, 0.0)
    return _result(q, bedx, bedy, tbx, tby, ext_src, tiny_h, h_anuga)


def friction_implicit_stage_solve(m, mannings_n, dt_imp, tiny_h: float):
    """Exact per-cell solve of the implicit friction stage equation

        q + dt_imp * tau(q) = m,   tau(q) = n^2 g h^{-7/3} q |q|

    of the ARK-IMEX integrator's DIRK stages (rdycore_tpu/ops/swe/
    sources.py:106-146). Friction acts on the momentum only and is
    colinear with it, so with K = dt_imp n^2 g h^{-7/3} and M = |m| the
    stage reduces to s + K s^2 = M, s/M = 2 / (1 + sqrt(1 + 4KM)) (no
    cancellation as KM -> 0). Dry cells (h < tiny_h) keep m. Returns
    (q_stage [ndof, C], F_I = (q_stage - m) / dt_imp [ndof, C]); the h and
    tracer rows pass through with F_I = 0, and dt_imp <= 0 divides by 1.
    dt_imp is a 0-dim tensor or a float."""
    g = torch.tensor(GRAVITY, dtype=m.dtype)
    h, mx, my = m[0], m[1], m[2]
    wet = h >= tiny_h
    h_safe = torch.where(wet, h, 1.0)
    K = dt_imp * g * mannings_n * mannings_n * power(h_safe, -7.0 / 3.0)
    M = safe_sqrt(mx * mx + my * my)
    ratio = 2.0 / (1.0 + torch.sqrt(1.0 + 4.0 * (K * M)))
    ratio = torch.where(wet, ratio, 1.0)
    qx = mx * ratio
    qy = my * ratio
    dt_imp = torch.as_tensor(dt_imp, dtype=m.dtype, device=m.device)
    dt_safe = torch.where(dt_imp > 0.0, dt_imp, 1.0)
    zero = torch.zeros_like(m[:1])
    fi = torch.cat([zero, ((qx - mx) / dt_safe)[None],
                    ((qy - my) / dt_safe)[None],
                    torch.zeros_like(m[3:])])
    q_stage = torch.cat([m[:1], qx[None], qy[None], m[3:]])
    return q_stage, fi


def apply_source_xq2018(
    q, flux_div, ext_src, mannings_n, dz_dx, dz_dy, dt, tiny_h, h_anuga,
    xq2018_threshold, include_bed_slope=True,
) -> SourceResult:
    """Implicit friction via the Xia & Liang (2018) closed form
    (eqs 21-37)."""
    g = torch.tensor(GRAVITY, dtype=q.dtype)
    h, hu, hv = q[0], q[1], q[2]
    bedx, bedy = _bed(q, dz_dx, dz_dy, include_bed_slope)

    wet = h >= tiny_h
    h_safe = torch.where(wet, h, 1.0)

    ax = flux_div[1] - bedx
    ay = flux_div[2] - bedy
    mx = hu + ax * dt
    my = hv + ay * dt

    n2g = g * mannings_n * mannings_n
    ux = mx / h_safe
    uy = my / h_safe
    lam = (n2g * power(h_safe, -4.0 / 3.0)
           * safe_sqrt(ux * ux + uy * uy))

    dtlam = dt * lam
    dtlam_safe = torch.where(dtlam > 0.0, dtlam, 1.0)
    root = torch.sqrt(1.0 + 4.0 * dtlam)
    qx_impl = (mx - mx * root) / (-2.0 * dtlam_safe)
    qy_impl = (my - my * root) / (-2.0 * dtlam_safe)
    small = dtlam < xq2018_threshold
    qx1 = torch.where(small, mx, qx_impl)
    qy1 = torch.where(small, my, qy_impl)

    qmag = safe_sqrt(qx1 * qx1 + qy1 * qy1)
    h73 = n2g * power(h_safe, -7.0 / 3.0)
    tbx = torch.where(wet, h73 * qx1 * qmag, 0.0)
    tby = torch.where(wet, h73 * qy1 * qmag, 0.0)
    return _result(q, bedx, bedy, tbx, tby, ext_src, tiny_h, h_anuga)


def apply_source(method, q, flux_div, ext_src, mannings_n, dz_dx, dz_dy, dt,
                 tiny_h, h_anuga, xq2018_threshold,
                 include_bed_slope=True) -> SourceResult:
    """Dispatch on the SOURCE_* code."""
    if method == SOURCE_IMPLICIT_XQ2018:
        return apply_source_xq2018(
            q, flux_div, ext_src, mannings_n, dz_dx, dz_dy, dt, tiny_h,
            h_anuga, xq2018_threshold, include_bed_slope,
        )
    fn = apply_source_none if method == SOURCE_NONE else (
        apply_source_semi_implicit
    )
    return fn(q, flux_div, ext_src, mannings_n, dz_dx, dz_dy, dt, tiny_h,
              h_anuga, include_bed_slope)
