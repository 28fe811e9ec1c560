"""K1a `swe_edge_flux`: Roe flux and Courant coefficient of every edge.

`swe_edge_flux` launches csrc/swe_edge_flux.cu for CUDA tensors and takes
the plain PyTorch version `swe_edge_flux_plain` for CPU tensors. The
kernel replaces the edge phase of the TPU kernels in
rdycore_tpu/ops/pallas/slotted.py (`_fused_step_kernel`, `_fused_kernel`,
`_edge_kernel`); see the source's header for its bound and design.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..swe.boundary import ghost_states
from ..swe.riemann import regularized_velocity, roe_flux
from . import build

_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def _argtypes(real):
    return [_P, _I64, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _I64, _I64,
            _P, real, real, _P, _P, _P]


_FUNCTIONS = {
    "rdy_swe_edge_flux_f32": _argtypes(ctypes.c_float),
    "rdy_swe_edge_flux_f64": _argtypes(ctypes.c_double),
}


def _masked(f_h, f_hu, f_hv, amax, dry):
    mask = (~dry).to(f_h.dtype)
    return torch.stack([f_h, f_hu, f_hv]) * mask, amax * mask


def boundary_flux_plain(a, q, bvals, tiny_h: float, h_anuga: float):
    """Masked Roe fluxes fb [3, Eb] and wave speeds amax_b [Eb] of the
    boundary edges (the JAX package's `SWEOperator.boundary_fluxes`,
    operator.py:1023, with the ghost state picked per edge by bnd_code)."""
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
    return _masked(
        *roe_flux(hl_b, ul_b, vl_b, hr_b, ur_b, vr_b, a.bnd_sn, a.bnd_cn),
        (hl_b < tiny_h) & (hr_b < tiny_h),
    )


def swe_edge_flux_plain(a, q, bvals, tiny_h: float, h_anuga: float):
    """Plain version of the kernel (the JAX package's XLA gather twin,
    operator.py:387-467 and boundary_fluxes :1023). Returns
    (flux [3, E + 1] with a zero column E, courant [E])."""
    h, hu, hv = q[0], q[1], q[2]
    hl, hr = h[a.int_left], h[a.int_right]
    ul, vl = regularized_velocity(
        hl, hu[a.int_left], hv[a.int_left], tiny_h, h_anuga
    )
    ur, vr = regularized_velocity(
        hr, hu[a.int_right], hv[a.int_right], tiny_h, h_anuga
    )
    fi, amax_i = _masked(
        *roe_flux(hl, ul, vl, hr, ur, vr, a.int_sn, a.int_cn),
        (hl < tiny_h) & (hr < tiny_h),
    )
    fb, amax_b = boundary_flux_plain(a, q, bvals, tiny_h, h_anuga)
    flux = torch.cat([fi, fb, fb.new_zeros((3, 1))], dim=1)
    courant = torch.cat([amax_i, amax_b]) * a.edge_courant_coef
    return flux, courant


def swe_edge_flux(
    a, q: torch.Tensor, bvals: torch.Tensor, tiny_h: float, h_anuga: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flux [3, E + 1] (column E zero) and courant [E] = amax * coef of all
    edges of operator arrays `a` for the state q [3, C]. bvals [3, >= Eb]
    holds the Dirichlet (h, hu, hv) of each boundary edge."""
    if q.device.type == "cpu":
        return swe_edge_flux_plain(a, q, bvals, tiny_h, h_anuga)
    dev, dt = q.device, q.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"swe_edge_flux: unsupported dtype {dt}")
    C = q.shape[1]
    Ei, Eb = a.int_left.shape[0], a.bnd_left.shape[0]
    E = Ei + Eb
    ck = build.check
    ck(q, "q", dt, (3, C), dev)
    for name in ("int_left", "int_right"):
        ck(getattr(a, name), name, torch.int32, (Ei,), dev)
    for name in ("int_cn", "int_sn"):
        ck(getattr(a, name), name, dt, (Ei,), dev)
    ck(a.bnd_left, "bnd_left", torch.int32, (Eb,), dev)
    ck(a.bnd_code, "bnd_code", torch.int8, (Eb,), dev)
    for name in ("bnd_cn", "bnd_sn"):
        ck(getattr(a, name), name, dt, (Eb,), dev)
    ck(a.edge_courant_coef, "edge_courant_coef", dt, (E,), dev)
    ck(bvals, "bvals", dt, (3, None), dev)
    if bvals.shape[1] < Eb:
        raise ValueError(f"bvals: {bvals.shape[1]} columns for {Eb} edges")

    flux = torch.empty((3, E + 1), dtype=dt, device=dev)
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
            flux.data_ptr(), courant.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check_status(status, "swe_edge_flux")
    swe_edge_flux.launches += 1
    return flux, courant


swe_edge_flux.launches = 0
