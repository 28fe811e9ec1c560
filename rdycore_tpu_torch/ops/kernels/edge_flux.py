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
(slotted.py:3180).

The flux comes back as [ndof, E + 1], the transpose of a contiguous
[E + 1, ndof] buffer: one record per edge, its ndof fluxes side by side,
record E zero (the dummy slot of cell_edges). That is the layout K1b and
K3b take on the card (`check_records`; `flux_records` makes it from any
[ndof, E + 1] flux), and the plain version returns it too; PyTorch
indexing sees the same shape and values as in a row-major flux.

Two well-balancing modes (the JAX package's `well_balancing_hr` and
`well_balancing_bs2002`, operator.py:417-460):
- `hr=True` (first order, any tracer count): hydrostatic reconstruction
  on the interior edges, depths max(0, h + z - max(zl, zr)) from the
  cells' `cell_z`, velocities and concentrations from the raw states, and
  the masks of both (flow only: zero where both raw depths are < tiny_h or
  both reconstructed depths <= tiny_h; with tracers: kept where a raw and
  a reconstructed depth are > tiny_h); boundary edges unchanged;
- `bs` with `eta_v` (flow only, first order or MUSCL): the BS2002
  momentum correction g*dhv^2/24*(cn, sn) of every edge, interior and
  boundary, from the vertex eta `eta_v` [NV] of K5
  (`ops/kernels/eta_vertex.py`) at the edge's two endpoints, before the
  dry mask.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..math import maximum0
from ..swe.boundary import BC_DIRICHLET, ghost_states
from ..swe.bs2002 import BS2002Arrays, dhv_correction
from ..swe.muscl import LIMITERS, reconstruct_interior_states
from ..swe.riemann import regularized_velocity, roe_flux
from ..tracer.flux import safe_div, tracer_roe_flux
from . import build

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


# well-balancing modes of the kernel (kWb in csrc/swe_edge_flux.cu)
WB_NONE, WB_HR, WB_BS2002 = 0, 1, 2


def _argtypes(real):
    return [_P, _I64, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _I64, _I64,
            _P, real, real, _P, _P, _INT, _INT, _P, _P, _P, _P, _P, _INT,
            _INT] + [_P] * 10 + [_P]


_FUNCTIONS = {
    "rdy_swe_edge_flux_f32": _argtypes(ctypes.c_float),
    "rdy_swe_edge_flux_f64": _argtypes(ctypes.c_double),
}


def is_records(flux: torch.Tensor) -> bool:
    """Whether flux [ndof, E + 1] is the transpose of a contiguous
    [E + 1, ndof] buffer of edge records."""
    return flux.dim() == 2 and flux.t().is_contiguous()


def flux_records(flux: torch.Tensor, num_edges: int) -> torch.Tensor:
    """flux [ndof, num_edges + 1] (3 <= ndof <= 3 + the kernels' tracer
    rows) in the record layout K1b and K3b take on the card: itself where
    it is in it already, else a copy. Raises on any other shape."""
    if (flux.dim() != 2 or flux.shape[1] != num_edges + 1
            or not 3 <= flux.shape[0] <= 3 + build.MAX_TRACERS):
        raise ValueError(f"flux of shape {tuple(flux.shape)}: expected "
                         f"[ndof, {num_edges + 1}], 3 <= ndof <= "
                         f"{3 + build.MAX_TRACERS}")
    return flux if is_records(flux) else flux.t().contiguous().t()


def check_records(flux, ndof, num_edges: int, dtype, device,
                  what: str) -> None:
    """Raise unless flux is K1a's output layout: [ndof, num_edges + 1]
    (ndof None: any row count) of dtype on device, the transpose of a
    contiguous [num_edges + 1, ndof] buffer. A kernel reading records never
    copies another layout, and never falls back."""
    build.check(flux.t(), f"{what}: flux records (flux.t())", dtype,
                (num_edges + 1, ndof), device)


def _records(fi, fb):
    """The [ndof, E + 1] records of the interior and boundary fluxes fi
    [ndof, Ei] and fb [ndof, Eb], a zero dummy record appended."""
    dummy = fb.new_zeros((1, fb.shape[0]))
    return torch.cat([fi.t(), fb.t(), dummy]).t()


def _masked(f_h, f_hu, f_hv, amax, dry):
    mask = (~dry).to(f_h.dtype)
    return torch.stack([f_h, f_hu, f_hv]) * mask, amax * mask


def _masked_tracer(f_flow, f_tracer, amax, wet):
    mask = wet.to(f_flow.dtype)
    return torch.cat([f_flow, f_tracer]) * mask, amax * mask


def boundary_flux_plain(a, q, bvals, tiny_h: float, h_anuga: float,
                        upwind: bool = False,
                        bs: Optional[BS2002Arrays] = None, eta_v=None):
    """Masked Roe fluxes fb [ndof, Eb] and wave speeds amax_b [Eb] of the
    boundary edges (the JAX package's `SWEOperator.boundary_fluxes`,
    operator.py:1023, and with tracers `boundary_fluxes_nd` :957, with the
    ghost state picked per edge by bnd_code). With the vertex eta `eta_v`
    (flow only) each momentum flux gains its BS2002 correction before the
    mask (operator.py:1060-1070)."""
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
        f_h, f_hu, f_hv, amax = roe_flux(hl_b, ul_b, vl_b, hr_b, ur_b, vr_b,
                                         a.bnd_sn, a.bnd_cn)
        if eta_v is not None:
            dfu, dfv = dhv_correction(eta_v, bs.bnd_vbeg, bs.bnd_vend,
                                      bs.bnd_zvbeg, bs.bnd_zvend, a.bnd_cn,
                                      a.bnd_sn)
            f_hu, f_hv = f_hu + dfu, f_hv + dfv
        return _masked(f_h, f_hu, f_hv, amax,
                       (hl_b < tiny_h) & (hr_b < tiny_h))
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
                        limiter: str = "minmod", hr: bool = False,
                        bs: Optional[BS2002Arrays] = None, eta_v=None):
    """Plain version of the kernel (the JAX package's XLA gather twin,
    operator.py:387-467 and boundary_fluxes :1023, or with tracers
    :721-777 and :796-845; with `grad`, the MUSCL branch :388-391; with
    `hr`, hydrostatic reconstruction :417-427 and :752-767; with `eta_v`,
    the BS2002 correction :436-447). Returns (flux [ndof, E + 1] with a
    zero column E, in the record layout of the kernel, courant [E])."""
    _check_modes(q, grad, hr, bs, eta_v)
    h, hu, hv = q[0], q[1], q[2]
    il, ir = a.int_left, a.int_right
    if grad is not None:
        (hl, hul, hvl), (hr_, hur, hvr) = reconstruct_interior_states(
            a, q, grad, limiter)
    else:
        hl, hul, hvl = h[il], hu[il], hv[il]
        hr_, hur, hvr = h[ir], hu[ir], hv[ir]
    ul, vl = regularized_velocity(hl, hul, hvl, tiny_h, h_anuga)
    ur, vr = regularized_velocity(hr_, hur, hvr, tiny_h, h_anuga)
    if q.shape[0] > 3:
        cil = safe_div(q[3:, il], hl, hl, tiny_h)
        cir = safe_div(q[3:, ir], hr_, hr_, tiny_h)
    hl_raw, hr_raw = hl, hr_
    if hr:
        # depths from eta - max(z); velocities and concentrations raw
        zl, zr = a.cell_z[il], a.cell_z[ir]
        zmax = torch.maximum(zl, zr)
        hl = maximum0(hl + zl - zmax)
        hr_ = maximum0(hr_ + zr - zmax)
    if q.shape[0] == 3:
        f_h, f_hu, f_hv, amax_i = roe_flux(hl, ul, vl, hr_, ur, vr,
                                           a.int_sn, a.int_cn)
        if eta_v is not None:
            dfu, dfv = dhv_correction(eta_v, bs.int_vbeg, bs.int_vend,
                                      bs.int_zvbeg, bs.int_zvend, a.int_cn,
                                      a.int_sn)
            f_hu, f_hv = f_hu + dfu, f_hv + dfv
        dry = (hl_raw < tiny_h) & (hr_raw < tiny_h)
        if hr:
            dry = dry | ((hl <= tiny_h) & (hr_ <= tiny_h))
        fi, amax_i = _masked(f_h, f_hu, f_hv, amax_i, dry)
    else:
        wet = (hl_raw > tiny_h) | (hr_raw > tiny_h)
        if hr:
            wet = wet & ((hl > tiny_h) | (hr_ > tiny_h))
        fi, amax_i = _masked_tracer(
            *tracer_roe_flux(hl, ul, vl, cil, hr_, ur, vr, cir, a.int_sn,
                             a.int_cn, upwind),
            wet,
        )
    fb, amax_b = boundary_flux_plain(a, q, bvals, tiny_h, h_anuga, upwind,
                                     bs, eta_v)
    flux = _records(fi, fb)
    courant = torch.cat([amax_i, amax_b]) * a.edge_courant_coef
    return flux, courant


def _check_modes(q, grad, hr, bs, eta_v):
    """Raise for a combination of modes the kernel has no instance of."""
    if grad is not None and q.shape[0] != 3:
        raise ValueError("swe_edge_flux: MUSCL faces are flow only")
    if hr and grad is not None:
        raise ValueError("swe_edge_flux: hydrostatic reconstruction is "
                         "first order only")
    if hr and eta_v is not None:
        raise ValueError("swe_edge_flux: hydrostatic reconstruction and "
                         "BS2002 exclude each other")
    if eta_v is not None and bs is None:
        raise ValueError("swe_edge_flux: BS2002 needs its arrays")
    if eta_v is not None and q.shape[0] != 3:
        # the JAX package's coupled operator drops the correction
        # (ROADMAP fault 18)
        raise ValueError("swe_edge_flux: BS2002 is flow only")


def swe_edge_flux(
    a, q: torch.Tensor, bvals: torch.Tensor, tiny_h: float, h_anuga: float,
    upwind: bool = False, grad: Optional[torch.Tensor] = None,
    limiter: str = "minmod", hr: bool = False,
    bs: Optional[BS2002Arrays] = None, eta_v: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flux [ndof, E + 1] (column E zero; the transpose of [E + 1, ndof]
    edge records) and courant [E] = amax * coef of
    all edges of operator arrays `a` for the state q [ndof, C] (ndof = 3,
    or 3 + the tracers). bvals [ndof, >= Eb] holds the Dirichlet (h, hu,
    hv and tracer masses) of each boundary edge. upwind: upwind-Roe tracer
    fluxes. grad [6, C]: the LS gradients of q, for MUSCL faces limited by
    `limiter` (minmod, van_leer or none; flow only). hr: hydrostatic
    reconstruction on a.cell_z (first order). bs, eta_v [NV]: the BS2002
    correction from the vertex eta (flow only)."""
    _check_modes(q, grad, hr, bs, eta_v)
    if q.device.type == "cpu":
        return swe_edge_flux_plain(a, q, bvals, tiny_h, h_anuga, upwind,
                                   grad, limiter, hr, bs, eta_v)
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
    wb, wb_args = WB_NONE, [None] * 10
    if hr:
        wb = WB_HR
        ck(a.cell_z, "cell_z", dt, (C,), dev)
        wb_args[0] = a.cell_z
    elif eta_v is not None:
        wb = WB_BS2002
        ck(eta_v, "eta_v", dt, (bs.vertex_inv_count.shape[0],), dev)
        wb_args[1] = eta_v
        for i, name in enumerate(("int_vbeg", "int_vend", "int_zvbeg",
                                  "int_zvend", "bnd_vbeg", "bnd_vend",
                                  "bnd_zvbeg", "bnd_zvend")):
            t = getattr(bs, name)
            ck(t, f"bs2002.{name}", torch.int32 if "zv" not in name else dt,
               (Ei if name.startswith("int") else Eb,), dev)
            wb_args[2 + i] = t

    records = torch.empty((E + 1, ndof), dtype=dt, device=dev)
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
            records.data_ptr(), courant.data_ptr(), ndof - 3, int(upwind),
            None if grad is None else grad.data_ptr(),
            *(None if t is None else t.data_ptr() for t in offsets), lim,
            wb, *(None if t is None else t.data_ptr() for t in wb_args),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check_status(status, "swe_edge_flux")
    swe_edge_flux.launches += 1
    return records.t(), courant


swe_edge_flux.launches = 0
