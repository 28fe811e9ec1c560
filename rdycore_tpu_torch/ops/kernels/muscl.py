"""K3a `swe_muscl_grad` and K3b `swe_positivity_drain` /
`swe_positivity_scale`: the second-order unstructured path's gradient and
positivity kernels.

Each wrapper launches its kernel (csrc/swe_muscl_grad.cu,
csrc/swe_positivity.cu) for CUDA tensors and takes its plain PyTorch
version for CPU tensors; see the sources' headers for the TPU kernels they
replace, their bounds and designs.

- `swe_muscl_grad(a, q)`: the LS gradients grad [6, C] of (h, hu, hv)
  (ops/swe/muscl.py `ls_gradients`), which K1a's MUSCL mode reads;
- `swe_positivity_drain(a, flux, h, dt)`: each cell's donor factor
  s = clip(h / (dt * drain), 0, 1) (1 where drain = 0), drain the
  cell's outgoing h-flux rate over its cell_edges slots
  (operator.py:1084-1105); dt <= 0 divides by 1 instead;
- `swe_positivity_scale(a, flux, s)`: every edge's flux scaled in place
  by its donor's factor (operator.py:1106-1115).
"""

from __future__ import annotations

import ctypes

import torch

from ..math import clip01, minimum0
from ..swe.muscl import ls_gradients
from . import build
from .edge_flux import check_records

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_GRAD = [_P, _I64, _P, _P, _I64, _P, _P, _P, _INT, _P, _P]
_DRAIN = [_P, _INT, _P, _P, _INT, _P, _P, _I64, _P, _P]
_SCALE = [_P, _INT, _P, _P, _I64, _P, _I64, _P, _P]
_GRAD_FUNCTIONS = {"rdy_swe_muscl_grad_f32": _GRAD,
                   "rdy_swe_muscl_grad_f64": _GRAD}
_POS_FUNCTIONS = {
    "rdy_swe_positivity_drain_f32": _DRAIN,
    "rdy_swe_positivity_drain_f64": _DRAIN,
    "rdy_swe_positivity_scale_f32": _SCALE,
    "rdy_swe_positivity_scale_f64": _SCALE,
}


def _suffix(dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"unsupported dtype {dtype}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def swe_muscl_grad(a, q: torch.Tensor) -> torch.Tensor:
    """LS gradients [6, C] of the state q [3, C] on operator arrays `a`
    (which carry cell_ls_cx/cy)."""
    if q.device.type == "cpu":
        return ls_gradients(a, q)
    dev, dt = q.device, q.dtype
    sfx = _suffix(dt)
    C = q.shape[1]
    Ei = a.int_left.shape[0]
    K = a.cell_edges.shape[1]
    ck = build.check
    ck(q, "q", dt, (3, C), dev)
    for name in ("int_left", "int_right"):
        ck(getattr(a, name), name, torch.int32, (Ei,), dev)
    ck(a.cell_edges, "cell_edges", torch.int32, (C, K), dev)
    for name in ("cell_ls_cx", "cell_ls_cy"):
        ck(getattr(a, name), name, dt, (C, K), dev)
    grad = torch.empty((6, C), dtype=dt, device=dev)
    fn = getattr(build.load("swe_muscl_grad", _GRAD_FUNCTIONS),
                 f"rdy_swe_muscl_grad_{sfx}")
    with torch.cuda.device(dev):
        status = fn(q.data_ptr(), C, a.int_left.data_ptr(),
                    a.int_right.data_ptr(), Ei, a.cell_edges.data_ptr(),
                    a.cell_ls_cx.data_ptr(), a.cell_ls_cy.data_ptr(), K,
                    grad.data_ptr(), _stream(dev))
    build.check_status(status, "swe_muscl_grad")
    swe_muscl_grad.launches += 1
    return grad


swe_muscl_grad.launches = 0


def positivity_drain_plain(a, flux, h, dt):
    """Plain version of the drain kernel: s [C]."""
    contrib = flux[0, a.cell_edges] * a.cell_edge_coef  # [C, K] dh/dt
    drain = -minimum0(contrib).sum(dim=-1)
    drain_safe = torch.where(drain > 0.0, drain, 1.0)
    dt_s = torch.where(dt > 0.0, dt, 1.0)
    return torch.where(drain > 0.0,
                       clip01(h / (dt_s * drain_safe)), 1.0)


def positivity_scale_plain(a, flux, s):
    """Plain version of the scale kernel: flux scaled in place."""
    Ei, Eb = a.int_left.shape[0], a.bnd_left.shape[0]
    fh = flux[0]
    flux[:, :Ei] *= torch.where(fh[:Ei] > 0.0, s[a.int_left], s[a.int_right])
    flux[:, Ei:Ei + Eb] *= torch.where(fh[Ei:Ei + Eb] > 0.0, s[a.bnd_left],
                                       1.0)
    return flux


def swe_positivity_drain(a, flux: torch.Tensor, h: torch.Tensor,
                         dt: torch.Tensor) -> torch.Tensor:
    """Donor factors s [C] of the fluxes flux [ndof, E + 1] (column E
    zero; on the card K1a's record layout only, `edge_flux.check_records`)
    for the depths h [C] over a step dt (0-dim, read on the device)."""
    if flux.device.type == "cpu":
        return positivity_drain_plain(a, flux, h, dt)
    dev, dtype = flux.device, flux.dtype
    sfx = _suffix(dtype)
    C = h.shape[0]
    E = a.int_left.shape[0] + a.bnd_left.shape[0]
    K = a.cell_edges.shape[1]
    ck = build.check
    check_records(flux, None, E, dtype, dev, "swe_positivity_drain")
    ck(h, "h", dtype, (C,), dev)
    ck(dt, "dt", dtype, (), dev)
    ck(a.cell_edges, "cell_edges", torch.int32, (C, K), dev)
    ck(a.cell_edge_coef, "cell_edge_coef", dtype, (C, K), dev)
    s = torch.empty((C,), dtype=dtype, device=dev)
    fn = getattr(build.load("swe_positivity", _POS_FUNCTIONS),
                 f"rdy_swe_positivity_drain_{sfx}")
    with torch.cuda.device(dev):
        status = fn(flux.data_ptr(), flux.shape[0], a.cell_edges.data_ptr(),
                    a.cell_edge_coef.data_ptr(), K, h.data_ptr(),
                    dt.data_ptr(), C, s.data_ptr(), _stream(dev))
    build.check_status(status, "swe_positivity_drain")
    swe_positivity_drain.launches += 1
    return s


swe_positivity_drain.launches = 0


def swe_positivity_scale(a, flux: torch.Tensor,
                         s: torch.Tensor) -> torch.Tensor:
    """flux [ndof, E + 1] (on the card K1a's record layout only) scaled in
    place by the donor factors s [C]; returns flux."""
    if flux.device.type == "cpu":
        return positivity_scale_plain(a, flux, s)
    dev, dtype = flux.device, flux.dtype
    sfx = _suffix(dtype)
    Ei, Eb = a.int_left.shape[0], a.bnd_left.shape[0]
    ck = build.check
    check_records(flux, None, Ei + Eb, dtype, dev, "swe_positivity_scale")
    ck(s, "s", dtype, (None,), dev)
    for name in ("int_left", "int_right"):
        ck(getattr(a, name), name, torch.int32, (Ei,), dev)
    ck(a.bnd_left, "bnd_left", torch.int32, (Eb,), dev)
    fn = getattr(build.load("swe_positivity", _POS_FUNCTIONS),
                 f"rdy_swe_positivity_scale_{sfx}")
    with torch.cuda.device(dev):
        status = fn(flux.data_ptr(), flux.shape[0], a.int_left.data_ptr(),
                    a.int_right.data_ptr(), Ei, a.bnd_left.data_ptr(), Eb,
                    s.data_ptr(), _stream(dev))
    build.check_status(status, "swe_positivity_scale")
    swe_positivity_scale.launches += 1
    return flux


swe_positivity_scale.launches = 0
