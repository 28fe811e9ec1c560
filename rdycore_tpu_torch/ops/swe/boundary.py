"""SWE boundary-condition ghost states (plain PyTorch).

The "right" Riemann state of a boundary edge per BC type, as in
rdycore_tpu/ops/swe/boundary.py and the reference kernels:
- Dirichlet:        swe_petsc.c:552-559 / swe_fluxes_ceed.h:104-156
- Reflecting:       swe_petsc.c:434-461 / swe_fluxes_ceed.h:158-212
- Critical outflow: swe_petsc.c:465-503 / swe_fluxes_ceed.h:214-271
"""

from __future__ import annotations

import torch

from ...constants import GRAVITY
from ..math import safe_cbrt, safe_sqrt
from .riemann import regularized_velocity

# BC type codes (the JAX package's; also the per-edge codes the CUDA edge
# kernel reads from bnd_code)
BC_DIRICHLET = 0
BC_REFLECTING = 1
BC_CRITICAL_OUTFLOW = 2


def reflecting_ghost(h, u, v, sn, cn):
    """Mirror the velocity about the edge: same h, normal velocity negated."""
    dum1 = sn * sn - cn * cn
    dum2 = 2.0 * sn * cn
    return h, u * dum1 - v * dum2, -u * dum2 - v * dum1


def critical_outflow_ghost(h, u, v, sn, cn):
    """Critical-depth outflow: ghost state at Froude number 1. When the flow
    is *into* the domain, both sides become dry so no flux crosses."""
    g = torch.tensor(GRAVITY, dtype=h.dtype)
    uperp = u * cn + v * sn
    outgoing = uperp >= 0.0

    q = h * torch.abs(uperp)
    h_crit = safe_cbrt(q * q / g)
    vel = safe_sqrt(g * h_crit)

    hl = torch.where(outgoing, h, 0.0)
    ul = torch.where(outgoing, u, 0.0)
    vl = torch.where(outgoing, v, 0.0)
    hr = torch.where(outgoing, h_crit, 0.0)
    ur = torch.where(outgoing, vel * cn, 0.0)
    vr = torch.where(outgoing, vel * sn, 0.0)
    return (hl, ul, vl), (hr, ur, vr)


def ghost_states(bc_code, hl, ul, vl, sn, cn, bvals, tiny_h, h_anuga):
    """Left state (critical outflow may modify it) and ghost right state of
    boundary edges. bc_code is a per-edge int tensor of BC_* codes; bvals
    the [3, n] Dirichlet (h, hu, hv) values (read on Dirichlet edges)."""
    hd = bvals[0]
    ud, vd = regularized_velocity(hd, bvals[1], bvals[2], tiny_h, h_anuga)
    hf, uf, vf = reflecting_ghost(hl, ul, vl, sn, cn)
    (hlc, ulc, vlc), (hc, uc, vc) = critical_outflow_ghost(hl, ul, vl, sn, cn)
    is_d = bc_code == BC_DIRICHLET
    is_c = bc_code == BC_CRITICAL_OUTFLOW

    def pick(d, f, c):
        return torch.where(is_d, d, torch.where(is_c, c, f))

    left = (
        torch.where(is_c, hlc, hl),
        torch.where(is_c, ulc, ul),
        torch.where(is_c, vlc, vl),
    )
    right = (pick(hd, hf, hc), pick(ud, uf, uc), pick(vd, vf, vc))
    return left, right
