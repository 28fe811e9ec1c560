"""Tracer (sediment, salinity, heat) source terms (plain PyTorch).

The numerics of rdycore_tpu/ops/tracer/sources.py, which mirror
TracerSources / TracerSemiImplicitBedFrictionRoughness
(tracer_sources_ceed.h:37-160): semi-implicit Manning friction on the flow
rows, and Hairsine-Rose erosion and deposition on the sediment classes
(docs/theory/sediment.md):
    tau_b = 0.5 rho_w Cd (u^2 + v^2)
    e_j   = kp (tau_b - tau_ce) / tau_ce
    d_j   = w_s c_j (1 - tau_b / tau_cd)
Salinity and heat take only their external sources. Parameter defaults
from tracer_ceed.c:40-44. The CUDA cell kernel
(ops/kernels/csrc/swe_physics.cuh `tracer_sources`) repeats this
arithmetic.

Unlike the flow-only sources (ops/swe/sources.py) a cell is wet when
h > tiny_h (strict), u and v are 0 where it is dry, and the friction
groups dt * (div - bed).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...constants import GRAVITY
from ..math import power, safe_sqrt

DENSITY_OF_WATER = 1000.0
DEFAULT_KP_CONSTANT = 0.001
DEFAULT_SETTLING_VELOCITY = 0.01
DEFAULT_TAU_CRITICAL_EROSION = 0.1
DEFAULT_TAU_CRITICAL_DEPOSITION = 1000.0


class SedimentParams(NamedTuple):
    kp_constant: float = DEFAULT_KP_CONSTANT
    settling_velocity: float = DEFAULT_SETTLING_VELOCITY
    tau_critical_erosion: float = DEFAULT_TAU_CRITICAL_EROSION
    tau_critical_deposition: float = DEFAULT_TAU_CRITICAL_DEPOSITION
    rhow: float = DENSITY_OF_WATER


def tracer_source_terms(
    q,  # [3+nt, C]
    flux_div,  # [3+nt, C]
    ext_src,  # [3+nt, C]
    mannings_n,  # [C]
    dz_dx,
    dz_dy,
    dt,
    tiny_h: float,
    h_anuga: float,
    num_sediment: int,
    params: SedimentParams = SedimentParams(),
    include_friction: bool = True,
    include_bed_slope: bool = True,
):
    """(rhs_src [3+nt, C], prim [3+nt, C]); rhs_src excludes the flux
    divergence, as the flow sources do. include_friction=False drops the
    Manning term (the source method `none`, ARK-IMEX's explicit part);
    include_bed_slope=False the bed-slope term (hydrostatic
    reconstruction)."""
    g = torch.tensor(GRAVITY, dtype=q.dtype)
    h, hu, hv = q[0], q[1], q[2]
    hci = q[3:]
    nt = hci.shape[0]

    if include_bed_slope:
        bedx = dz_dx * g * h
        bedy = dz_dy * g * h
    else:
        bedx = bedy = torch.zeros_like(h)

    wet = h > tiny_h
    h_safe = torch.where(wet, h, 1.0)
    u = torch.where(wet, hu / h_safe, 0.0)
    v = torch.where(wet, hv / h_safe, 0.0)
    ci = torch.where(wet, hci / h_safe, 0.0)

    cd = g * mannings_n * mannings_n * power(h_safe, -1.0 / 3.0)
    speed = safe_sqrt(u * u + v * v)
    tb = cd * speed / h_safe
    factor = tb / (1.0 + dt * tb)
    if include_friction:
        tbx = torch.where(wet, (hu + dt * (flux_div[1] - bedx)) * factor, 0.0)
        tby = torch.where(wet, (hv + dt * (flux_div[2] - bedy)) * factor, 0.0)
    else:
        tbx = tby = torch.zeros_like(h)

    tau_b = 0.5 * params.rhow * cd * (u * u + v * v)
    e = (
        params.kp_constant
        * (tau_b - params.tau_critical_erosion)
        / params.tau_critical_erosion
    )
    d = params.settling_velocity * ci * (
        1.0 - tau_b / params.tau_critical_deposition
    )
    ed = torch.where(wet, e[None, :] - d, 0.0)
    if num_sediment < nt:
        mask = (torch.arange(nt, device=q.device) < num_sediment).to(q.dtype)
        ed = ed * mask[:, None]

    rhs_flow = torch.stack(
        [ext_src[0], -bedx - tbx + ext_src[1], -bedy - tby + ext_src[2]]
    )
    rhs = torch.cat([rhs_flow, ed + ext_src[3:]], dim=0)

    denom = h * h + h_anuga * h_anuga
    denom_safe = torch.where(denom > 0.0, denom, 1.0)
    pu = torch.where(wet, hu * h / denom_safe, 0.0)
    pv = torch.where(wet, hv * h / denom_safe, 0.0)
    prim = torch.cat([torch.stack([h, pu, pv]), ci], dim=0)
    return rhs, prim
