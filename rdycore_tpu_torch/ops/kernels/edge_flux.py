"""K1a `swe_edge_flux`: Roe flux and Courant coefficient of every edge.

`swe_edge_flux` launches csrc/swe_edge_flux.cu for CUDA tensors and takes
the plain PyTorch version `swe_edge_flux_plain` for CPU tensors. The
kernel replaces the edge phase of the TPU kernels in
rdycore_tpu/ops/pallas/slotted.py (`_fused_step_kernel`, `_fused_kernel`,
`_edge_kernel`); see the source's header for its bound and design.

A state q with more than 3 rows carries tracers: the flux then has a row
per tracer (Roe, or upwind-Roe with `upwind`), and every row, like amax,
is kept where either side is wet (h > tiny_h), as the JAX package's
coupled operator keeps it; the flow-only flux is zeroed where both sides
are below tiny_h.

Given the LS gradients `grad` [6, C] of K3a (`ops/kernels/muscl.py`), the
launch runs in MUSCL mode (flow only): each interior edge solves Roe on
the limited second-order face states (`ops/swe/muscl.py`), and the both-dry
mask and amax see those reconstructed depths; boundary edges stay first
order on the raw state. This replaces the TPU kernel `_muscl_flux_kernel`
(slotted.py:3180) without its BS2002 correction.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..swe.boundary import BC_DIRICHLET, ghost_states
from ..swe.muscl import LIMITERS, reconstruct_interior_states
from ..swe.riemann import regularized_velocity, roe_flux
from ..tracer.flux import safe_div, tracer_roe_flux
from . import build

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _argtypes(real):
    return [_P, _I64, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _I64, _I64,
            _P, real, real, _P, _P, _INT, _INT, _P, _P, _P, _P, _P, _INT, _P]


_FUNCTIONS = {
    "rdy_swe_edge_flux_f32": _argtypes(ctypes.c_float),
    "rdy_swe_edge_flux_f64": _argtypes(ctypes.c_double),
}


def _masked(f_h, f_hu, f_hv, amax, dry):
    mask = (~dry).to(f_h.dtype)
    return torch.stack([f_h, f_hu, f_hv]) * mask, amax * mask


def _masked_tracer(f_flow, f_tracer, amax, wet):
    mask = wet.to(f_flow.dtype)
    return torch.cat([f_flow, f_tracer]) * mask, amax * mask


def boundary_flux_plain(a, q, bvals, tiny_h: float, h_anuga: float,
                        upwind: bool = False):
    """Masked Roe fluxes fb [ndof, Eb] and wave speeds amax_b [Eb] of the
    boundary edges (the JAX package's `SWEOperator.boundary_fluxes`,
    operator.py:1023, and with tracers `boundary_fluxes_nd` :957, with the
    ghost state picked per edge by bnd_code)."""
    h, hu, hv = q[0], q[1], q[2]
    Eb = a.bnd_left.shape[0]
    hb = h[a.bnd_left]
    ub, vb = regularized_velocity(
        hb, hu[a.bnd_left], hv[a.bnd_left], tiny_h, h_anuga
    )
    (hl_b, ul_b, vl_b), (hr_b, ur_b, vr_b) = ghost_states(
        a.bnd_code, hb, ub, vb, a.bnd_sn, a.bnd_cn, bvals[:, :Eb], tiny_h,
        h_anuga,
    )
    if q.shape[0] == 3:
        return _masked(
            *roe_flux(hl_b, ul_b, vl_b, hr_b, ur_b, vr_b, a.bnd_sn, a.bnd_cn),
            (hl_b < tiny_h) & (hr_b < tiny_h),
        )
    # Dirichlet ghosts take the prescribed tracer masses; reflecting and
    # critical-outflow ghosts keep the interior concentration
    cib = safe_div(q[3:, a.bnd_left], hb, hb, tiny_h)
    hd = bvals[0, :Eb]
    cid = safe_div(bvals[3:q.shape[0], :Eb], hd, hd, tiny_h)
    cir = torch.where(a.bnd_code == BC_DIRICHLET, cid, cib)
    return _masked_tracer(
        *tracer_roe_flux(hl_b, ul_b, vl_b, cib, hr_b, ur_b, vr_b, cir,
                         a.bnd_sn, a.bnd_cn, upwind),
        (hl_b > tiny_h) | (hr_b > tiny_h),
    )


def swe_edge_flux_plain(a, q, bvals, tiny_h: float, h_anuga: float,
                        upwind: bool = False, grad=None,
                        limiter: str = "minmod"):
    """Plain version of the kernel (the JAX package's XLA gather twin,
    operator.py:387-467 and boundary_fluxes :1023, or with tracers
    :721-777 and :796-845; with `grad`, the MUSCL branch :388-391).
    Returns (flux [ndof, E + 1] with a zero column E, courant [E])."""
    h, hu, hv = q[0], q[1], q[2]
    if grad is not None:
        (hl, hul, hvl), (hr, hur, hvr) = reconstruct_interior_states(
            a, q, grad, limiter)
    else:
        hl, hul, hvl = h[a.int_left], hu[a.int_left], hv[a.int_left]
        hr, hur, hvr = h[a.int_right], hu[a.int_right], hv[a.int_right]
    ul, vl = regularized_velocity(hl, hul, hvl, tiny_h, h_anuga)
    ur, vr = regularized_velocity(hr, hur, hvr, tiny_h, h_anuga)
    if q.shape[0] == 3:
        fi, amax_i = _masked(
            *roe_flux(hl, ul, vl, hr, ur, vr, a.int_sn, a.int_cn),
            (hl < tiny_h) & (hr < tiny_h),
        )
    else:
        cil = safe_div(q[3:, a.int_left], hl, hl, tiny_h)
        cir = safe_div(q[3:, a.int_right], hr, hr, tiny_h)
        fi, amax_i = _masked_tracer(
            *tracer_roe_flux(hl, ul, vl, cil, hr, ur, vr, cir, a.int_sn,
                             a.int_cn, upwind),
            (hl > tiny_h) | (hr > tiny_h),
        )
    fb, amax_b = boundary_flux_plain(a, q, bvals, tiny_h, h_anuga, upwind)
    flux = torch.cat([fi, fb, fb.new_zeros((q.shape[0], 1))], dim=1)
    courant = torch.cat([amax_i, amax_b]) * a.edge_courant_coef
    return flux, courant


def swe_edge_flux(
    a, q: torch.Tensor, bvals: torch.Tensor, tiny_h: float, h_anuga: float,
    upwind: bool = False, grad: Optional[torch.Tensor] = None,
    limiter: str = "minmod",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flux [ndof, E + 1] (column E zero) and courant [E] = amax * coef of
    all edges of operator arrays `a` for the state q [ndof, C] (ndof = 3,
    or 3 + the tracers). bvals [ndof, >= Eb] holds the Dirichlet (h, hu,
    hv and tracer masses) of each boundary edge. upwind: upwind-Roe tracer
    fluxes. grad [6, C]: the LS gradients of q, for MUSCL faces limited by
    `limiter` (minmod, van_leer or none; flow only)."""
    if grad is not None and q.shape[0] != 3:
        raise ValueError("swe_edge_flux: MUSCL faces are flow only")
    if q.device.type == "cpu":
        return swe_edge_flux_plain(a, q, bvals, tiny_h, h_anuga, upwind,
                                   grad, limiter)
    dev, dt = q.device, q.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"swe_edge_flux: unsupported dtype {dt}")
    ndof, C = q.shape
    if not 3 <= ndof <= 3 + build.MAX_TRACERS:
        raise ValueError(f"swe_edge_flux: {ndof} state rows")
    Ei, Eb = a.int_left.shape[0], a.bnd_left.shape[0]
    E = Ei + Eb
    ck = build.check
    ck(q, "q", dt, (ndof, C), dev)
    for name in ("int_left", "int_right"):
        ck(getattr(a, name), name, torch.int32, (Ei,), dev)
    for name in ("int_cn", "int_sn"):
        ck(getattr(a, name), name, dt, (Ei,), dev)
    ck(a.bnd_left, "bnd_left", torch.int32, (Eb,), dev)
    ck(a.bnd_code, "bnd_code", torch.int8, (Eb,), dev)
    for name in ("bnd_cn", "bnd_sn"):
        ck(getattr(a, name), name, dt, (Eb,), dev)
    ck(a.edge_courant_coef, "edge_courant_coef", dt, (E,), dev)
    ck(bvals, "bvals", dt, (ndof, None), dev)
    if bvals.shape[1] < Eb:
        raise ValueError(f"bvals: {bvals.shape[1]} columns for {Eb} edges")
    lim, offsets = 0, [None] * 4
    if grad is not None:
        lim = LIMITERS[limiter]
        ck(grad, "grad", dt, (6, C), dev)
        offsets = [a.int_dxl, a.int_dyl, a.int_dxr, a.int_dyr]
        for name, t in zip(("int_dxl", "int_dyl", "int_dxr", "int_dyr"),
                           offsets):
            ck(t, name, dt, (Ei,), dev)

    flux = torch.empty((ndof, E + 1), dtype=dt, device=dev)
    courant = torch.empty((E,), dtype=dt, device=dev)
    lib = build.load("swe_edge_flux", _FUNCTIONS)
    fn = (lib.rdy_swe_edge_flux_f32 if dt == torch.float32
          else lib.rdy_swe_edge_flux_f64)
    with torch.cuda.device(dev):
        status = fn(
            q.data_ptr(), C, a.int_left.data_ptr(), a.int_right.data_ptr(),
            a.int_cn.data_ptr(), a.int_sn.data_ptr(), Ei,
            a.bnd_left.data_ptr(), a.bnd_cn.data_ptr(), a.bnd_sn.data_ptr(),
            a.bnd_code.data_ptr(), bvals.data_ptr(), bvals.shape[1], Eb,
            a.edge_courant_coef.data_ptr(), tiny_h, h_anuga,
            flux.data_ptr(), courant.data_ptr(), ndof - 3, int(upwind),
            None if grad is None else grad.data_ptr(),
            *(None if t is None else t.data_ptr() for t in offsets), lim,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check_status(status, "swe_edge_flux")
    swe_edge_flux.launches += 1
    return flux, courant


swe_edge_flux.launches = 0
