"""K2 `swe_raster_step`: one step, RK stage or RHS of the raster, per launch.

`swe_raster_step` launches csrc/swe_raster_step.cu for CUDA tensors and
takes the plain PyTorch version `swe_raster_step_plain` for CPU tensors.
The kernel replaces the TPU kernel `_kernel` of
rdycore_tpu/ops/pallas/structured_step.py (:172) in its modes base,
`emit_rhs` and `with_src`; see the source's header for its bound and
design.

The state stays the package's [3, ny*nx] (row-major cells, viewed
[3, ny, nx]). The TPU kernel's padded planes, its 128-lane ghost columns and
8-row tiles exist for the TPU's (8, 128) tiling and are not ported; the
wall ghost states that `fill_ghost_frame` writes into the padding
(structured_step.py:60-169, flow rows) are formed at the wall faces:

- Dirichlet: the prescribed (h, hu, hv) at that position along the wall;
- reflecting: the cell's state with its normal momentum negated;
- critical outflow: the critical-depth ghost only. The interior state is
  left as it is on inflow, unlike the unstructured operator's boundary
  edges (the TPU kernel's approximation, structured_step.py:76-79).

The ghost cell's velocity is then regularized like any cell's. Faces follow
the TPU kernel: x faces roe(west, east) with normal +x and y faces
roe(south, north) with normal +y, walls included, the pure-flow dry mask
(both sides below tiny_h) and 1/c_hat by rsqrt.

Modes, as K1b's:
- stage (`stage=(alpha, beta, gamma)`, gamma = beta, optional `qA`):
  out = alpha*qA + beta*(q + dt*rhs); (0, 1, 1) without qA is the euler
  step q + dt*rhs;
- rhs (`stage=None`): out = rhs.
`emit_prim` adds the primitives (h, u, v) of q. `cmax` holds the largest
Courant coefficient amax/dx, amax/dy of each block of BLOCK cells' faces.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...constants import GRAVITY
from ..swe import boundary as bc_mod
from ..swe.riemann import regularized_velocity, roe_flux
from . import build
from .cell_stage import _alpha_beta

# threads per block along x and y; one Courant maximum per block
BLOCK = (32, 8)

_P, _I64, _INT, _F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_float)
_FUNCTIONS = {
    "rdy_swe_raster_step_f32": [_P] * 7 + [_INT] * 4 + [_P] * 4
    + [_I64, _I64, _F, _F, _F, _F, _INT, _F, _F, _P, _P, _P, _INT, _INT, _P],
}


class StructuredPlan(NamedTuple):
    """A uniform raster of nx x ny cells (cell c at row c // nx, column
    c % nx) with its wall BC codes (structured_step.py:41, less the TPU's
    ghost-row count)."""

    nx: int
    ny: int
    dx: float
    dy: float
    tiny_h: float
    h_anuga: float
    bc_left: int
    bc_right: int
    bc_bottom: int
    bc_top: int


# side -> (outward normal (sn, cn), its cells in [ny, nx], its ghost cells
# in the [ny + 2, nx + 2] frame)
_SIDES = {
    "left": (0.0, -1.0, (slice(None), 0), (slice(1, -1), 0)),
    "right": (0.0, 1.0, (slice(None), -1), (slice(1, -1), -1)),
    "bottom": (-1.0, 0.0, (0, slice(None)), (0, slice(1, -1))),
    "top": (1.0, 0.0, (-1, slice(None)), (-1, slice(1, -1))),
}


class RasterStepOut(NamedTuple):
    out: torch.Tensor  # [3, ny*nx] the stage's state (stage mode) or rhs
    prim: Optional[torch.Tensor]  # [3, ny*nx] (h, u, v) of q, emit_prim
    cmax: torch.Tensor  # [blocks] largest amax/dx, amax/dy per block


def num_blocks(nx: int, ny: int) -> int:
    """Number of Courant maxima a launch writes."""
    return -(-nx // BLOCK[0]) * -(-ny // BLOCK[1])


def f32(x: float) -> float:
    """x rounded to float32, as the kernel receives it."""
    return float(np.float32(x))


def wall_ghost(bc: int, h, hu, hv, sn: float, cn: float, tiny_h: float,
               h_anuga: float, dirichlet=None):
    """Ghost (h, hu, hv) beyond the wall cells (h, hu, hv) with outward
    normal (sn, cn) (structured_step.py `_ghost`). dirichlet: [3, n]
    prescribed values, read for BC_DIRICHLET."""
    if bc == bc_mod.BC_DIRICHLET:
        if dirichlet is None:
            raise ValueError("a Dirichlet wall needs its bc_vals")
        return dirichlet[0], dirichlet[1], dirichlet[2]
    u, v = regularized_velocity(h, hu, hv, tiny_h, h_anuga)
    if bc == bc_mod.BC_REFLECTING:
        hg, ug, vg = bc_mod.reflecting_ghost(h, u, v, sn, cn)
    elif bc == bc_mod.BC_CRITICAL_OUTFLOW:
        _, (hg, ug, vg) = bc_mod.critical_outflow_ghost(h, u, v, sn, cn)
    else:
        raise ValueError(f"unsupported wall BC {bc} for the raster step")
    return hg, hg * ug, hg * vg


def swe_raster_step_plain(
    plan: StructuredPlan, q, dz_dx, dz_dy, mannings_n, dt, *, src=None,
    bc_vals: Optional[Dict[str, torch.Tensor]] = None,
    stage: Optional[Tuple[float, float, float]] = None, qA=None,
    emit_prim: bool = False,
) -> RasterStepOut:
    """Plain version of the kernel: the ghost frame of `fill_ghost_frame`
    around the raster, then the TPU kernel's faces, divergence, sources and
    update (structured_step.py:269-656) on whole planes."""
    nx, ny, th, ta = plan.nx, plan.ny, plan.tiny_h, plan.h_anuga
    inv_dx, inv_dy = f32(1.0 / plan.dx), f32(1.0 / plan.dy)
    q3 = q.reshape(3, ny, nx)
    h, hu, hv = q3
    bc_vals = bc_vals or {}
    frame = q3.new_zeros((3, ny + 2, nx + 2))
    frame[:, 1:-1, 1:-1] = q3
    for side, (sn, cn, cells, ghosts) in _SIDES.items():
        g = wall_ghost(getattr(plan, f"bc_{side}"), h[cells], hu[cells],
                       hv[cells], sn, cn, th, ta, bc_vals.get(side))
        for k in range(3):
            frame[k][ghosts] = g[k]
    H, HU, HV = frame
    U, V = regularized_velocity(H, HU, HV, th, ta)

    def faces(lo, hi, sn, cn):
        f_h, f_hu, f_hv, a = roe_flux(
            H[lo], U[lo], V[lo], H[hi], U[hi], V[hi], sn, cn, fast=True,
        )
        m = (~((H[lo] < th) & (H[hi] < th))).to(H.dtype)
        return torch.stack([f_h, f_hu, f_hv]) * m, a * m

    inner = slice(1, -1)
    fx, ax = faces((inner, slice(0, -1)), (inner, slice(1, None)), 0.0, 1.0)
    fy, ay = faces((slice(0, -1), inner), (slice(1, None), inner), 1.0, 0.0)
    div = -((fx[:, :, 1:] - fx[:, :, :-1]) * inv_dx
            + (fy[:, 1:] - fy[:, :-1]) * inv_dy)

    # per-cell Courant coefficient, then its maximum over each block
    cx, cy = ax * inv_dx, ay * inv_dy
    cell = torch.maximum(torch.maximum(cx[:, :-1], cx[:, 1:]),
                         torch.maximum(cy[:-1], cy[1:]))
    bx, by = BLOCK
    gx, gy = -(-nx // bx), -(-ny // by)
    tiles = cell.new_zeros((gy * by, gx * bx))
    tiles[:ny, :nx] = cell
    cmax = tiles.reshape(gy, by, gx, bx).amax(dim=(1, 3)).reshape(-1)

    # semi-implicit bed slope and Manning friction (_kernel :579-599)
    g = torch.tensor(GRAVITY, dtype=q.dtype)
    bedx = dz_dx * g * h
    bedy = dz_dy * g * h
    wet = h >= th
    h_safe = torch.where(wet, h, 1.0)
    inv_h = 1.0 / h_safe
    uu, vv = hu * inv_h, hv * inv_h
    cd = g * mannings_n * mannings_n * torch.pow(h_safe, -1.0 / 3.0)
    tb = cd * torch.sqrt(uu * uu + vv * vv) * inv_h
    factor = tb / (1.0 + dt * tb)
    tbx = torch.where(wet, (hu + dt * div[1] - dt * bedx) * factor, 0.0)
    tby = torch.where(wet, (hv + dt * div[2] - dt * bedy) * factor, 0.0)
    rh = div[0] if src is None else div[0] + src
    rhs = torch.stack([rh, div[1] - bedx - tbx, div[2] - bedy - tby])

    if stage is None:
        out = rhs
    else:
        alpha, beta = _alpha_beta(stage)
        out = beta * (q3 + dt * rhs)
        if qA is not None:
            out = alpha * qA.reshape(3, ny, nx) + out
    prim = None
    if emit_prim:
        prim = torch.stack([h, U[inner, inner], V[inner, inner]]).reshape(3, -1)
    return RasterStepOut(out.reshape(3, -1), prim, cmax)


def swe_raster_step(
    plan: StructuredPlan, q: torch.Tensor, dz_dx: torch.Tensor,
    dz_dy: torch.Tensor, mannings_n: torch.Tensor, dt: torch.Tensor, *,
    src: Optional[torch.Tensor] = None,
    bc_vals: Optional[Dict[str, torch.Tensor]] = None,
    stage: Optional[Tuple[float, float, float]] = None,
    qA: Optional[torch.Tensor] = None, emit_prim: bool = False,
) -> RasterStepOut:
    """One launch over the raster of `plan`. q [3, ny*nx] float32 (qA the
    same), dz_dx, dz_dy, mannings_n and the rain plane src [ny, nx], dt a
    0-dim tensor read on the device, bc_vals {side: [3, n]} the prescribed
    (h, hu, hv) along each Dirichlet wall (n = ny for left/right, nx for
    bottom/top)."""
    if q.device.type == "cpu":
        return swe_raster_step_plain(
            plan, q, dz_dx, dz_dy, mannings_n, dt, src=src, bc_vals=bc_vals,
            stage=stage, qA=qA, emit_prim=emit_prim,
        )
    dev, f = q.device, torch.float32
    nx, ny = plan.nx, plan.ny
    C = nx * ny
    ck = build.check
    ck(q, "q", f, (3, C), dev)
    for name, t in (("dz_dx", dz_dx), ("dz_dy", dz_dy),
                    ("mannings_n", mannings_n)):
        ck(t, name, f, (ny, nx), dev)
    ck(dt, "dt", f, (), dev)
    if src is not None:
        ck(src, "src", f, (ny, nx), dev)
    if qA is not None:
        ck(qA, "qA", f, (3, C), dev)
    bc_vals = bc_vals or {}
    codes, walls = [], []
    for side in _SIDES:
        bc = getattr(plan, f"bc_{side}")
        if bc not in (bc_mod.BC_DIRICHLET, bc_mod.BC_REFLECTING,
                      bc_mod.BC_CRITICAL_OUTFLOW):
            raise ValueError(f"swe_raster_step: {side} wall BC code {bc}")
        wall = None
        if bc == bc_mod.BC_DIRICHLET:
            wall = bc_vals.get(side)
            if wall is None:
                raise ValueError(f"swe_raster_step: Dirichlet {side} wall "
                                 "without bc_vals")
            ck(wall, f"bc_vals[{side!r}]", f,
               (3, ny if side in ("left", "right") else nx), dev)
        codes.append(bc)
        walls.append(wall)
    alpha, beta = _alpha_beta(stage) if stage is not None else (0.0, 0.0)

    out = torch.empty((3, C), dtype=f, device=dev)
    prim = torch.empty((3, C), dtype=f, device=dev) if emit_prim else None
    cmax = torch.empty((num_blocks(nx, ny),), dtype=f, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = build.load("swe_raster_step", _FUNCTIONS)
    with torch.cuda.device(dev):
        status = lib.rdy_swe_raster_step_f32(
            q.data_ptr(), ptr(qA), dz_dx.data_ptr(), dz_dy.data_ptr(),
            mannings_n.data_ptr(), ptr(src), dt.data_ptr(), *codes,
            *(ptr(w) for w in walls), nx, ny, plan.tiny_h, plan.h_anuga,
            f32(1.0 / plan.dx), f32(1.0 / plan.dy), int(stage is None),
            alpha, beta, out.data_ptr(), ptr(prim), cmax.data_ptr(),
            BLOCK[0], BLOCK[1], torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check_status(status, "swe_raster_step")
    swe_raster_step.launches += 1
    return RasterStepOut(out, prim, cmax)


swe_raster_step.launches = 0
