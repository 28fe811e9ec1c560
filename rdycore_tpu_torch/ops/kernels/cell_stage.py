"""K1b `swe_cell_stage`: flux divergence, sources and RK stage per cell.

`swe_cell_stage` launches csrc/swe_cell_stage.cu for CUDA tensors and
takes the plain PyTorch version `swe_cell_stage_plain` for CPU tensors.
The kernel replaces the cell phase of the TPU kernel `_fused_step_kernel`
and the divergence of `_fused_kernel` and `_cell_kernel`
(rdycore_tpu/ops/pallas/slotted.py); see the source's header for its
bound and design.

Two modes:
- stage mode (`stage=(alpha, beta, gamma)`): q_out = alpha*qA +
  beta*(q + dt*rhs), or q itself where dt <= 0. This is the fused-step
  kernel's alpha*qA + beta*q + gamma*dt*(div + src) for gamma = beta, which
  holds in every tableau of timestepping.py, grouped as the JAX package's
  `_rk_step` groups it (so the CPU path agrees with it to rounding);
- rhs mode (`stage=None`): flux_div and rhs = flux_div + sources.
Either mode also returns the primitives of q when `emit_prim`: (h, u, v),
and the concentrations when q carries tracer rows, whose sources are
those of ops/tracer/sources.py (Hairsine-Rose on the sediment classes).

With `hr` (hydrostatic reconstruction) the sources drop the bed-slope term
and the divergence gains the HR pressure correction on its momentum rows
(`hr_pressure_correction`, the JAX package's `_hr_pressure_correction`,
operator.py:1117-1151), which the kernel forms in its slot loop.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ...constants import GRAVITY
from ..math import maximum0
from ..swe.sources import SOURCE_NONE, apply_source
from ..tracer.sources import SedimentParams, tracer_source_terms
from . import build

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _argtypes(real):
    return [_P, _I64, _P, _P, _INT, _P, _P, _P, _P, _P, _P, _P, _I64,
            real, real, real, _INT, _INT, _INT, real, real, real, real, real,
            real, real, _P, _P, _P, _P, _INT, _P, _P, _P, _P, _I64, _P, _P,
            _P, _P]


_FUNCTIONS = {
    "rdy_swe_cell_stage_f32": _argtypes(ctypes.c_float),
    "rdy_swe_cell_stage_f64": _argtypes(ctypes.c_double),
}


class CellStageOut(NamedTuple):
    q_out: Optional[torch.Tensor]  # [ndof, C] stage mode
    flux_div: Optional[torch.Tensor]  # [ndof, C] rhs mode
    rhs: Optional[torch.Tensor]  # [ndof, C] rhs mode
    prim: Optional[torch.Tensor]  # [ndof, C] when emit_prim


def _alpha_beta(stage: Tuple[float, float, float]) -> Tuple[float, float]:
    alpha, beta, gamma = stage
    if gamma != beta:
        raise ValueError(
            f"swe_cell_stage: stage {stage} has gamma != beta, which the "
            "grouping alpha*qA + beta*(q + dt*rhs) cannot express"
        )
    return alpha, beta


def hr_slots(a, C: int):
    """(neighbour [C, K] int64, cn, sn [C, K]) of every slot of
    cell_edges, from its edge id: across an interior edge the other cell
    (int_left + int_right - c) and the edge's normal; across a boundary
    edge the cell itself and the edge's normal; on the dummy slot the cell
    and 0. The JAX package keeps the same values as per-slot tables
    (hr_nbr_cell, hr_cn, hr_sn, operator.py:1283-1305)."""
    Ei = a.int_left.shape[0]
    e = a.cell_edges.long()
    cell = torch.arange(C, device=e.device)[:, None]
    interior = e < Ei
    ei = torch.where(interior, e, 0)
    nbr = torch.where(interior, a.int_left[ei].long() + a.int_right[ei]
                      - cell, cell)
    zero = a.int_cn.new_zeros(1)
    return (nbr, torch.cat([a.int_cn, a.bnd_cn, zero])[e],
            torch.cat([a.int_sn, a.bnd_sn, zero])[e])


def hr_pressure_correction(a, h, tiny_h: float):
    """The momentum rows (dcx, dcy) [C] of the hydrostatic pressure
    correction of the depths h (the JAX package's `_hr_pressure_correction`,
    operator.py:1117-1151): per slot of cell_edges (`hr_slots`),
    0.5*g*(h^2 - h*^2) with h* = max(0, h + z - max(z, z_nbr)), zero where
    h and h_nbr are both below tiny_h, times (cn, sn) and the slot's
    coefficient."""
    nbr, cn, sn = hr_slots(a, h.shape[0])
    z_self, z_nbr = a.cell_z[:, None], a.cell_z[nbr]
    h_self, h_nbr = h[:, None], h[nbr]
    h_rec = maximum0(h_self + z_self - torch.maximum(z_self, z_nbr))
    corr = 0.5 * GRAVITY * (h_self * h_self - h_rec * h_rec)
    corr = torch.where((h_self < tiny_h) & (h_nbr < tiny_h), 0.0, corr)
    coef = a.cell_edge_coef
    return (corr * cn * coef).sum(dim=-1), (corr * sn * coef).sum(dim=-1)


def swe_cell_stage_plain(
    a, flux, q, dt, ext_src, *, tiny_h, h_anuga, xq2018_threshold,
    source_method, num_sediment=0, stage=None, qA=None, emit_prim=False,
    hr=False,
) -> CellStageOut:
    """Plain version of the kernel (the JAX package's XLA cell gather and
    sources, operator.py:552-557 and :613-633 (flow) or :879-883 and
    :940-947 (tracers, q with more than 3 rows), with `hr` the pressure
    correction :559-560 and :885-891, and the `_rk_step` stage)."""
    flux_div = (flux[:, a.cell_edges] * a.cell_edge_coef).sum(dim=-1)
    if hr:
        dcx, dcy = hr_pressure_correction(a, q[0], tiny_h)
        flux_div[1] += dcx
        flux_div[2] += dcy
    ext = ext_src if ext_src is not None else torch.zeros_like(q)
    if q.shape[0] > 3:
        src_rhs, src_prim = tracer_source_terms(
            q, flux_div, ext, a.mannings_n, a.dz_dx, a.dz_dy, dt, tiny_h,
            h_anuga, num_sediment,
            include_friction=source_method != SOURCE_NONE,
            include_bed_slope=not hr,
        )
    else:
        src_rhs, src_prim = apply_source(
            source_method, q, flux_div, ext, a.mannings_n, a.dz_dx, a.dz_dy,
            dt, tiny_h, h_anuga, xq2018_threshold, include_bed_slope=not hr,
        )
    rhs = flux_div + src_rhs
    prim = src_prim if emit_prim else None
    if stage is None:
        return CellStageOut(None, flux_div, rhs, prim)
    alpha, beta = _alpha_beta(stage)
    q_new = beta * (q + dt * rhs)
    if qA is not None:
        q_new = alpha * qA + q_new
    return CellStageOut(torch.where(dt > 0.0, q_new, q), None, None, prim)


def swe_cell_stage(
    a, flux: torch.Tensor, q: torch.Tensor, dt: torch.Tensor,
    ext_src: Optional[torch.Tensor], *, tiny_h: float, h_anuga: float,
    xq2018_threshold: float, source_method: int, num_sediment: int = 0,
    stage: Optional[Tuple[float, float, float]] = None,
    qA: Optional[torch.Tensor] = None, emit_prim: bool = False,
    hr: bool = False,
) -> CellStageOut:
    """One launch over all cells. flux [ndof, E + 1] from `swe_edge_flux`,
    q [ndof, C] the stage input (ndof = 3, or 3 + the tracers, of which the
    first num_sediment are sediment classes), dt a 0-dim tensor (the step
    dt, read on the device), ext_src [ndof, C] or None for no external
    sources, hr: hydrostatic-reconstruction mode."""
    if q.device.type == "cpu":
        return swe_cell_stage_plain(
            a, flux, q, dt, ext_src, tiny_h=tiny_h, h_anuga=h_anuga,
            xq2018_threshold=xq2018_threshold, source_method=source_method,
            num_sediment=num_sediment, stage=stage, qA=qA,
            emit_prim=emit_prim, hr=hr,
        )
    dev, dtype = q.device, q.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"swe_cell_stage: unsupported dtype {dtype}")
    ndof, C = q.shape
    nt = ndof - 3
    if not 0 <= nt <= build.MAX_TRACERS:
        raise ValueError(f"swe_cell_stage: {ndof} state rows")
    if not 0 <= num_sediment <= nt:
        raise ValueError(f"swe_cell_stage: {num_sediment} sediment classes "
                         f"of {nt} tracers")
    K = a.cell_edges.shape[1]
    ck = build.check
    ck(q, "q", dtype, (ndof, C), dev)
    E = a.int_left.shape[0] + a.bnd_left.shape[0]
    ck(flux, "flux", dtype, (ndof, E + 1), dev)
    ck(a.cell_edges, "cell_edges", torch.int32, (C, K), dev)
    ck(a.cell_edge_coef, "cell_edge_coef", dtype, (C, K), dev)
    ck(dt, "dt", dtype, (), dev)
    for name in ("mannings_n", "dz_dx", "dz_dy"):
        ck(getattr(a, name), name, dtype, (C,), dev)
    if ext_src is not None:
        ck(ext_src, "ext_src", dtype, (ndof, C), dev)
    if qA is not None:
        ck(qA, "qA", dtype, (ndof, C), dev)
    if source_method not in (0, 1, 2):
        raise ValueError(f"swe_cell_stage: source method {source_method}")
    Ei, Eb = a.int_left.shape[0], a.bnd_left.shape[0]
    hr_args = [None] * 4 + [Ei] + [None] * 3
    if hr:
        for name in ("int_left", "int_right"):
            ck(getattr(a, name), name, torch.int32, (Ei,), dev)
        for name in ("int_cn", "int_sn"):
            ck(getattr(a, name), name, dtype, (Ei,), dev)
        for name in ("bnd_cn", "bnd_sn"):
            ck(getattr(a, name), name, dtype, (Eb,), dev)
        ck(a.cell_z, "cell_z", dtype, (C,), dev)
        hr_args = [a.int_left.data_ptr(), a.int_right.data_ptr(),
                   a.int_cn.data_ptr(), a.int_sn.data_ptr(), Ei,
                   a.bnd_cn.data_ptr(), a.bnd_sn.data_ptr(),
                   a.cell_z.data_ptr()]
    sp = SedimentParams()

    def new():
        return torch.empty((ndof, C), dtype=dtype, device=dev)

    q_out = new() if stage is not None else None
    flux_div = new() if stage is None else None
    rhs = new() if stage is None else None
    prim = new() if emit_prim else None
    alpha, beta = _alpha_beta(stage) if stage is not None else (0.0, 0.0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = build.load("swe_cell_stage", _FUNCTIONS)
    fn = (lib.rdy_swe_cell_stage_f32 if dtype == torch.float32
          else lib.rdy_swe_cell_stage_f64)
    with torch.cuda.device(dev):
        status = fn(
            flux.data_ptr(), flux.shape[1], a.cell_edges.data_ptr(),
            a.cell_edge_coef.data_ptr(), K, q.data_ptr(), ptr(qA),
            dt.data_ptr(), ptr(ext_src), a.mannings_n.data_ptr(),
            a.dz_dx.data_ptr(), a.dz_dy.data_ptr(), C, tiny_h, h_anuga,
            xq2018_threshold, source_method, nt, num_sediment, *sp,
            alpha, beta, ptr(q_out),
            ptr(flux_div), ptr(rhs), ptr(prim), int(hr), *hr_args,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check_status(status, "swe_cell_stage")
    swe_cell_stage.launches += 1
    return CellStageOut(q_out, flux_div, rhs, prim)


swe_cell_stage.launches = 0
