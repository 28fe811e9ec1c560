"""Vectorized SWE Roe Riemann solver (plain PyTorch).

The numerics of rdycore_tpu/ops/swe/riemann.py (`roe_flux`,
`regularized_velocity`), which mirror the reference's Roe
eigenspectrum with critical-flow (entropy) fix and flux
0.5*(FL + FR - R |Lambda| dW) (src/swe/swe_roe_flux_petsc.h:15-132).
The CUDA edge kernel (ops/kernels/csrc/swe_physics.cuh) repeats this
arithmetic operation for operation.

Every division is guarded so that dry states form no NaN.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...constants import GRAVITY
from ..math import maximum0, safe_sqrt


def roe_eigenspectrum(hl, ul, vl, hr, ur, vr, sn, cn):
    """Roe-average eigenspectrum with the critical-flow fix, as a dict of
    the pieces the flow and tracer flux assemblies share (the JAX package's
    `roe_eigenspectrum`, which divides by the Roe denominator and by c_hat
    where `roe_flux` multiplies by their inverses)."""
    g = torch.tensor(GRAVITY, dtype=hl.dtype)
    sqrt_g = torch.sqrt(g)

    hl_s = maximum0(hl)
    hr_s = maximum0(hr)
    duml = safe_sqrt(hl_s)
    dumr = safe_sqrt(hr_s)
    cl = sqrt_g * duml
    cr = sqrt_g * dumr
    hhat = duml * dumr
    denom = duml + dumr
    denom_safe = torch.where(denom > 0.0, denom, 1.0)
    uhat = (duml * ul + dumr * ur) / denom_safe
    vhat = (duml * vl + dumr * vr) / denom_safe
    chat = safe_sqrt(0.5 * g * (hl_s + hr_s))
    chat_safe = torch.where(chat > 0.0, chat, 1.0)
    uperp = uhat * cn + vhat * sn

    dh = hr - hl
    du = ur - ul
    dv = vr - vl
    dupar = -du * sn + dv * cn
    duperp = du * cn + dv * sn

    uperpl = ul * cn + vl * sn
    uperpr = ur * cn + vr * sn
    a1 = torch.abs(uperp - chat)
    a2 = torch.abs(uperp)
    a3 = torch.abs(uperp + chat)

    al1 = uperpl - cl
    ar1 = uperpr - cr
    da1 = maximum0(2.0 * (ar1 - al1))
    da1_safe = torch.where(da1 > 0.0, da1, 1.0)
    a1 = torch.where(a1 < da1, 0.5 * (a1 * a1 / da1_safe + da1), a1)

    al3 = uperpl + cl
    ar3 = uperpr + cr
    da3 = maximum0(2.0 * (ar3 - al3))
    da3_safe = torch.where(da3 > 0.0, da3, 1.0)
    a3 = torch.where(a3 < da3, 0.5 * (a3 * a3 / da3_safe + da3), a3)

    dW0 = 0.5 * (dh - hhat * duperp / chat_safe)
    dW1 = hhat * dupar
    dW2 = 0.5 * (dh + hhat * duperp / chat_safe)

    return {
        "a1": a1, "a2": a2, "a3": a3,
        "dW0": dW0, "dW1": dW1, "dW2": dW2,
        "uhat": uhat, "vhat": vhat, "chat": chat,
        "duml": duml, "dumr": dumr, "denom_safe": denom_safe,
        "dh": dh, "uperp": uperp, "uperpl": uperpl, "uperpr": uperpr,
        "hl_s": hl_s, "hr_s": hr_s, "g": g,
        "amax": chat + torch.abs(uperp),
    }


def roe_flux(
    hl, ul, vl, hr, ur, vr, sn, cn, fast=False, cil=None, cir=None,
    upwind=False,
) -> Tuple[torch.Tensor, ...]:
    """Roe flux through edges for the 2-D shallow water equations.

    All inputs are tensors of one shape (sn and cn may be floats);
    velocities must already be regularized (`regularized_velocity`).
    Returns (f_h, f_hu, f_hv, amax) with amax = |u_perp| + c_hat, the
    largest wave speed. fast=True takes 1/c_hat from rsqrt, as the raster
    kernel does.

    cil/cir ([nt, ...] tracer concentrations): also return the tracer flux
    [nt, ...] as a 5th element, on this eigensystem: Roe advected waves,
    or with upwind=True the h-flux times the upwind concentration (the
    same as `ops.tracer.flux.tracer_roe_flux`, with the inverses of this
    function).
    """
    g = torch.tensor(GRAVITY, dtype=hl.dtype)
    sqrt_g = torch.sqrt(g)

    hl_s = maximum0(hl)
    hr_s = maximum0(hr)
    duml = safe_sqrt(hl_s)
    dumr = safe_sqrt(hr_s)
    cl = sqrt_g * duml
    cr = sqrt_g * dumr
    hhat = duml * dumr
    denom = duml + dumr
    inv_denom = 1.0 / torch.where(denom > 0.0, denom, 1.0)
    uhat = (duml * ul + dumr * ur) * inv_denom
    vhat = (duml * vl + dumr * vr) * inv_denom
    c2 = 0.5 * g * (hl_s + hr_s)
    if fast:
        inv_chat = torch.rsqrt(torch.where(c2 > 0.0, c2, 1.0))
        chat = c2 * inv_chat
    else:
        chat = safe_sqrt(c2)
        inv_chat = 1.0 / torch.where(chat > 0.0, chat, 1.0)
    uperp = uhat * cn + vhat * sn

    dh = hr - hl
    du = ur - ul
    dv = vr - vl
    dupar = -du * sn + dv * cn
    duperp = du * cn + dv * sn

    # eigenvalues with critical-flow (entropy) fix
    uperpl = ul * cn + vl * sn
    uperpr = ur * cn + vr * sn
    a1 = torch.abs(uperp - chat)
    a2 = torch.abs(uperp)
    a3 = torch.abs(uperp + chat)

    al1 = uperpl - cl
    ar1 = uperpr - cr
    da1 = maximum0(2.0 * (ar1 - al1))
    da1_safe = torch.where(da1 > 0.0, da1, 1.0)
    a1 = torch.where(a1 < da1, 0.5 * (a1 * a1 / da1_safe + da1), a1)

    al3 = uperpl + cl
    ar3 = uperpr + cr
    da3 = maximum0(2.0 * (ar3 - al3))
    da3_safe = torch.where(da3 > 0.0, da3, 1.0)
    a3 = torch.where(a3 < da3, 0.5 * (a3 * a3 / da3_safe + da3), a3)

    # wave strengths
    hdup_c = hhat * duperp * inv_chat
    dW0 = 0.5 * (dh - hdup_c)
    dW1 = hhat * dupar
    dW2 = 0.5 * (dh + hdup_c)

    # physical fluxes
    fl_h = uperpl * hl_s
    fl_hu = ul * uperpl * hl_s + 0.5 * g * hl_s * hl_s * cn
    fl_hv = vl * uperpl * hl_s + 0.5 * g * hl_s * hl_s * sn
    fr_h = uperpr * hr_s
    fr_hu = ur * uperpr * hr_s + 0.5 * g * hr_s * hr_s * cn
    fr_hv = vr * uperpr * hr_s + 0.5 * g * hr_s * hr_s * sn

    A0dW0 = a1 * dW0
    A1dW1 = a2 * dW1
    A2dW2 = a3 * dW2

    # right eigenvectors: (1, uhat -+ chat cn, vhat -+ chat sn), (0, -sn, cn)
    f_h = 0.5 * (fl_h + fr_h - A0dW0 - A2dW2)
    f_hu = 0.5 * (
        fl_hu
        + fr_hu
        - (uhat - chat * cn) * A0dW0
        - (-sn) * A1dW1
        - (uhat + chat * cn) * A2dW2
    )
    f_hv = 0.5 * (
        fl_hv
        + fr_hv
        - (vhat - chat * sn) * A0dW0
        - cn * A1dW1
        - (vhat + chat * sn) * A2dW2
    )
    amax = chat + torch.abs(uperp)
    if cil is None:
        return f_h, f_hu, f_hv, amax

    if upwind:
        f_tracer = f_h * torch.where(f_h >= 0.0, cil, cir)
    else:
        fl_c = hl_s * uperpl * cil
        fr_c = hr_s * uperpr * cir
        cihat = (duml * cil + dumr * cir) * inv_denom
        dch = cir * hr_s - cil * hl_s
        dW_c = dch - cihat * dh
        f_tracer = 0.5 * (fl_c + fr_c - cihat * (A0dW0 + A2dW2) - a2 * dW_c)
    return f_h, f_hu, f_hv, amax, f_tracer


def regularized_velocity(h, hu, hv, tiny_h, h_anuga):
    """ANUGA velocity regularization u = hu*h/(h^2 + h_anuga^2), zero when
    dry (ComputeRiemannVelocities, swe_petsc.c:57-73). tiny_h and h_anuga
    are Python floats."""
    denom = h * h + h_anuga * h_anuga
    denom_safe = torch.where(denom > 0.0, denom, 1.0)
    wet = h >= tiny_h
    scale = torch.where(wet, h / denom_safe, 0.0)
    return hu * scale, hv * scale
