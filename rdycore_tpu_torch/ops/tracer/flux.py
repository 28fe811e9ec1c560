"""Coupled flow + tracer Riemann fluxes, Roe and upwind-Roe (plain PyTorch).

The numerics of rdycore_tpu/ops/tracer/flux.py, which mirror the
reference's tracer kernels:
- TracerRiemannFlux_Roe (tracer_roe_flux_ceed.h:18-110): the SWE Roe
  eigensystem with one advected wave per tracer, A[3+j] = |uperp| and
  dW[3+j] = d(h c_j) - cihat dh;
- TracerRiemannFlux_UpwindRoe (:115-170): the Roe flow flux, and the
  tracer flux upwinded by the sign of the Roe h-flux;
- concentrations by `safe_div` guarded by the wet depth. The reference
  guards the right concentration with the LEFT depth; the JAX package,
  and so this one, guards it with the right depth.
The CUDA edge kernel computes the same fluxes with the tracer waves of
ops/kernels/csrc/swe_physics.cuh `roe_flux_sqrt`, which multiplies by the
inverses of the Roe denominator and of chat where this divides by them
(equal to rounding).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..swe.riemann import roe_eigenspectrum


def safe_div(a, b, cond, tiny):
    """a / b where cond > tiny, else 0 (b = 0 divides by 1 instead)."""
    b_safe = torch.where(torch.abs(b) > 0.0, b, 1.0)
    return torch.where(cond > tiny, a / b_safe, 0.0)


def tracer_roe_flux(
    hl, ul, vl, cil, hr, ur, vr, cir, sn, cn, upwind: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flow + tracer flux; cil/cir [nt, E] concentrations. Returns
    (f_flow [3, E], f_tracer [nt, E], amax [E])."""
    s = roe_eigenspectrum(hl, ul, vl, hr, ur, vr, sn, cn)
    g = s["g"]
    hl_s, hr_s = s["hl_s"], s["hr_s"]
    uperpl, uperpr = s["uperpl"], s["uperpr"]
    a1, a2, a3 = s["a1"], s["a2"], s["a3"]
    dW0, dW1, dW2 = s["dW0"], s["dW1"], s["dW2"]
    uhat, vhat, chat = s["uhat"], s["vhat"], s["chat"]

    fl_h = uperpl * hl_s
    fl_hu = ul * uperpl * hl_s + 0.5 * g * hl_s * hl_s * cn
    fl_hv = vl * uperpl * hl_s + 0.5 * g * hl_s * hl_s * sn
    fr_h = uperpr * hr_s
    fr_hu = ur * uperpr * hr_s + 0.5 * g * hr_s * hr_s * cn
    fr_hv = vr * uperpr * hr_s + 0.5 * g * hr_s * hr_s * sn

    A0dW0 = a1 * dW0
    A1dW1 = a2 * dW1
    A2dW2 = a3 * dW2

    f_h = 0.5 * (fl_h + fr_h - A0dW0 - A2dW2)
    f_hu = 0.5 * (
        fl_hu + fr_hu
        - (uhat - chat * cn) * A0dW0 - (-sn) * A1dW1 - (uhat + chat * cn) * A2dW2
    )
    f_hv = 0.5 * (
        fl_hv + fr_hv
        - (vhat - chat * sn) * A0dW0 - cn * A1dW1 - (vhat + chat * sn) * A2dW2
    )
    f_flow = torch.stack([f_h, f_hu, f_hv])

    if upwind:
        f_tracer = f_h * torch.where(f_h >= 0.0, cil, cir)
    else:
        fl_c = hl_s * uperpl * cil
        fr_c = hr_s * uperpr * cir
        cihat = (s["duml"] * cil + s["dumr"] * cir) / s["denom_safe"]
        dch = cir * hr_s - cil * hl_s
        dW_c = dch - cihat * s["dh"]
        f_tracer = 0.5 * (fl_c + fr_c - cihat * (A0dW0 + A2dW2) - a2 * dW_c)

    return f_flow, f_tracer, s["amax"]
