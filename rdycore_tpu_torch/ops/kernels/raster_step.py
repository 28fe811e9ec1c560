"""K2 `swe_raster_step`: one step, RK stage or RHS of the raster, per launch.

`swe_raster_step` launches csrc/swe_raster_step.cu for CUDA tensors and
takes the plain PyTorch version `swe_raster_step_plain` for CPU tensors.
The kernel replaces the TPU kernel `_kernel` of
rdycore_tpu/ops/pallas/structured_step.py (:172) in its modes base,
`emit_rhs`, `with_src` and `nt`; see the source's header for its bound and
design.

The state stays the package's [ndof, ny*nx] (row-major cells, viewed
[ndof, ny, nx]; rows 3.. hold the tracer masses of the nt mode). The TPU kernel's padded planes, its 128-lane ghost columns and
8-row tiles exist for the TPU's (8, 128) tiling and are not ported; the
wall ghost states that `fill_ghost_frame` writes into the padding
(structured_step.py:60-169, flow rows) are formed at the wall faces:

- Dirichlet: the prescribed (h, hu, hv) at that position along the wall;
- reflecting: the cell's state with its normal momentum negated;
- critical outflow: the critical-depth ghost only. The interior state is
  left as it is on inflow, unlike the unstructured operator's boundary
  edges (the TPU kernel's approximation, structured_step.py:76-79).

A ghost's tracer masses are the prescribed rows of a Dirichlet wall, else
the ghost depth times the wall cell's concentration. The ghost cell's
velocity is then regularized like any cell's. Faces follow the TPU kernel:
x faces roe(west, east) with normal +x and y faces roe(south, north) with
normal +y, walls included, 1/c_hat by rsqrt, and the pure-flow dry mask
(both sides below tiny_h) or, with tracers, the coupled system's (either
side above tiny_h). The sediment classes get Hairsine-Rose sources.

Strips (`strip`, a `Strip`): a launch may own the rows [row0, row0 + rows)
of the raster alone, its state held in a strip buffer [ndof, (halo_lo +
rows + halo_hi) * nx] whose halo rows below and above copy the
neighbouring strips' rows (ops/strips.py makes them). Where the strip's
bottom or top is not the raster's wall, the faces there read the halo row
instead of a ghost. The geometry and rain planes and the primitives hold
the owned rows; `out` is a strip buffer of which the owned rows are
written. This is the per-shard kernel of the JAX package's row-strip
sharded stepper (`make_sharded_fused_structured_stepper`,
structured_step.py:1019, its `pallas_call` :1211); None is the whole
raster, whose buffer is the state itself.

Modes, as K1b's:
- stage (`stage=(alpha, beta, gamma)`, gamma = beta, optional `qA`):
  out = alpha*qA + beta*(q + dt*rhs); (0, 1, 1) without qA is the euler
  step q + dt*rhs;
- rhs (`stage=None`): out = rhs.
`emit_prim` adds the primitives (h, u, v and the concentrations) of q.
`cmax` holds the largest Courant coefficient amax/dx, amax/dy of the faces
of each tile of cells (the kernel's blocks, `tile_for(nt)`), row-major by
tile.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...constants import GRAVITY
from ..swe import boundary as bc_mod
from ..swe.riemann import regularized_velocity, roe_flux
from ..tracer.sources import SedimentParams
from . import build
from .cell_stage import _alpha_beta


def tile_for(nt: int) -> Tuple[int, int]:
    """The cells along x and y of a tile, one block of the kernel and one
    Courant maximum, with nt tracer rows: 32 x 16 flow only, 32 x 8 with
    tracers, whose shared memory per cell is larger (csrc kTileRows)."""
    return (32, 16) if nt == 0 else (32, 8)


_P, _I64, _INT, _F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_float)
_FUNCTIONS = {
    "rdy_swe_raster_step_f32": [_P] * 7 + [_INT] * 4 + [_P] * 4
    + [_I64] * 4 + [_INT, _INT]
    + [_F, _F, _F, _F, _INT, _F, _F, _INT, _INT, _INT]
    + [_F] * 5 + [_P, _P, _P, _INT, _INT, _P],
    "rdy_swe_raster_step_smem": [_INT],
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


class Strip(NamedTuple):
    """The rows [row0, row0 + rows) of a raster, held in a strip buffer of
    halo_lo + rows + halo_hi rows: halo_lo rows below the owned ones, copies
    of the strip beneath (0 where the strip's bottom is the raster's wall),
    and halo_hi above (raster_common.cuh `strip_ok`)."""

    row0: int
    rows: int
    halo_lo: int = 0
    halo_hi: int = 0

    @property
    def buffer_rows(self) -> int:
        return self.halo_lo + self.rows + self.halo_hi

    def owned(self, x: torch.Tensor) -> torch.Tensor:
        """The owned rows [n, rows, nx] of a strip buffer x [n, R * nx], a
        view."""
        return x.reshape(x.shape[0], self.buffer_rows, -1)[
            :, self.halo_lo:self.halo_lo + self.rows]

    def to_buffer(self, x: torch.Tensor) -> torch.Tensor:
        """The owned rows x [n, rows * nx] in a strip buffer whose halo rows
        are zero (x itself when the strip has no halo rows)."""
        if not (self.halo_lo or self.halo_hi):
            return x
        n = x.shape[0]
        buf = x.new_zeros((n, self.buffer_rows, x.shape[1] // self.rows))
        buf[:, self.halo_lo:self.halo_lo + self.rows] = x.reshape(
            n, self.rows, -1)
        return buf.reshape(n, -1)


def check_strip(plan: StructuredPlan, strip: Optional[Strip], depth: int,
                what: str) -> Strip:
    """`strip`, or the whole raster of `plan` when None; raises unless its
    rows lie on the raster and it has at least `depth` halo rows wherever
    its bottom or top is not the raster's wall, and none where it is."""
    if strip is None:
        return Strip(0, plan.ny)
    r0, rows, lo, hi = strip
    if not (r0 >= 0 and rows >= 1 and r0 + rows <= plan.ny
            and (lo == 0 if r0 == 0 else lo >= depth)
            and (hi == 0 if r0 + rows == plan.ny else hi >= depth)):
        raise ValueError(f"{what}: strip {strip} on a raster of {plan.ny} "
                         f"rows (halo rows >= {depth} off the walls, 0 on "
                         "them)")
    return strip


# side -> (outward normal (sn, cn), its cells in [ny, nx], its ghost cells
# in the [ny + 2, nx + 2] frame)
_SIDES = {
    "left": (0.0, -1.0, (slice(None), 0), (slice(1, -1), 0)),
    "right": (0.0, 1.0, (slice(None), -1), (slice(1, -1), -1)),
    "bottom": (-1.0, 0.0, (0, slice(None)), (0, slice(1, -1))),
    "top": (1.0, 0.0, (-1, slice(None)), (-1, slice(1, -1))),
}


class RasterStepOut(NamedTuple):
    out: torch.Tensor  # [ndof, ny*nx] the stage's state (stage mode) or rhs
    prim: Optional[torch.Tensor]  # [ndof, ny*nx] primitives of q, emit_prim
    cmax: torch.Tensor  # [blocks] largest amax/dx, amax/dy per block


def num_blocks(nx: int, ny: int, block: Tuple[int, int]) -> int:
    """Number of Courant maxima a launch over nx x ny cells in blocks of
    `block` cells writes."""
    return -(-nx // block[0]) * -(-ny // block[1])


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


def wall_ghost_hc(bc: int, h, hc, hg, tiny_h: float, dirichlet=None):
    """Ghost tracer masses beyond the wall cells (h, hc [nt, n]) whose
    ghost depth is hg (structured_step.py `_ghost_hc`): the prescribed rows
    3.. of a Dirichlet wall, else hg times the interior concentration."""
    if bc == bc_mod.BC_DIRICHLET:
        return dirichlet[3:]
    hden = torch.where(torch.abs(h) > 0.0, h, 1.0)
    return hg * torch.where(h > tiny_h, hc / hden, 0.0)


def ghost_frame(plan: StructuredPlan, q, bc_vals=None,
                strip: Optional[Strip] = None):
    """The strip buffer q [ndof, R*nx] (R rows; the whole raster when
    strip is None) in a [ndof, R + 2, nx + 2] frame whose border holds the
    wall ghosts of `fill_ghost_frame` (structured_step.py:60-169): left and
    right of every buffer row (Dirichlet values [ndof, R] by buffer row),
    below and above the buffer where the strip's bottom or top is the
    raster's wall. The rest of the border stays zero."""
    strip = strip or Strip(0, plan.ny)
    nx, th, ta = plan.nx, plan.tiny_h, plan.h_anuga
    ndof = q.shape[0]
    qn = q.reshape(ndof, strip.buffer_rows, nx)
    h, hu, hv = qn[:3]
    bc_vals = bc_vals or {}
    frame = q.new_zeros((ndof, strip.buffer_rows + 2, nx + 2))
    frame[:, 1:-1, 1:-1] = qn
    for side, (sn, cn, cells, ghosts) in _SIDES.items():
        if (side == "bottom" and strip.halo_lo
                or side == "top" and strip.halo_hi):
            continue
        bc = getattr(plan, f"bc_{side}")
        g = wall_ghost(bc, h[cells], hu[cells], hv[cells], sn, cn, th, ta,
                       bc_vals.get(side))
        for k in range(3):
            frame[k][ghosts] = g[k]
        if ndof > 3:
            frame[3:][(slice(None),) + ghosts] = wall_ghost_hc(
                bc, h[cells], qn[3:][(slice(None),) + cells], g[0], th,
                bc_vals.get(side))
    return frame


def block_max(cell, nx: int, ny: int, block: Tuple[int, int]):
    """The maximum of cell [ny, nx] over each `block` of cells (row-major
    by block), as the kernels write it."""
    bx, by = block
    gx, gy = -(-nx // bx), -(-ny // by)
    tiles = cell.new_zeros((gy * by, gx * bx))
    tiles[:ny, :nx] = cell
    return tiles.reshape(gy, by, gx, bx).amax(dim=(1, 3)).reshape(-1)


def cell_update(plan: StructuredPlan, q, div, dz_dx, dz_dy, mannings_n, dt,
                src=None, stage=None, qA=None, emit_prim=False,
                num_sediment=0):
    """The cell phase of the TPU kernel on whole planes (_kernel
    :579-656): the semi-implicit bed slope and Manning friction on the
    raw state q [ndof, ny*nx], the rain plane, Hairsine-Rose on the
    sediment classes, then the stage or rhs output and the primitives.
    div [ndof, ny, nx] is the flux divergence (ny: the rows it covers, all
    or a strip's)."""
    nx, ny, th = plan.nx, div.shape[1], plan.tiny_h
    ndof = q.shape[0]
    nt = ndof - 3
    qn = q.reshape(ndof, ny, nx)
    h, hu, hv = qn[:3]
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
    rows = [rh, div[1] - bedx - tbx, div[2] - bedy - tby]
    if nt:
        # Hairsine-Rose on the sediment classes, strict wet test
        # (_kernel :601-626)
        wet_t = h > th
        cc = torch.where(wet_t, qn[3:] / torch.where(wet_t, h, 1.0), 0.0)
        rhc = div[3:]
        if num_sediment:
            kp, ws, tau_ce, tau_cd, rhow = (f32(x) for x in SedimentParams())
            tau_b = 0.5 * rhow * cd * (uu * uu + vv * vv)
            e = kp * (tau_b - tau_ce) / tau_ce
            d = ws * cc * (1.0 - tau_b / tau_cd)
            ed = torch.where(wet_t, e[None] - d, 0.0)
            if num_sediment < nt:
                ed = ed * (torch.arange(nt) < num_sediment).to(
                    q.dtype).to(q.device)[:, None, None]
            rhc = rhc + ed
        rows += list(rhc)
    rhs = torch.stack(rows)

    if stage is None:
        out = rhs
    else:
        alpha, beta = _alpha_beta(stage)
        out = beta * (qn + dt * rhs)
        if qA is not None:
            out = alpha * qA.reshape(ndof, ny, nx) + out
    prim = None
    if emit_prim:
        prim_rows = [h, *regularized_velocity(h, hu, hv, th, plan.h_anuga)]
        if nt:
            prim_rows += list(cc)
        prim = torch.stack(prim_rows).reshape(ndof, -1)
    return out.reshape(ndof, -1), prim


def swe_raster_step_plain(
    plan: StructuredPlan, q, dz_dx, dz_dy, mannings_n, dt, *, src=None,
    bc_vals: Optional[Dict[str, torch.Tensor]] = None,
    stage: Optional[Tuple[float, float, float]] = None, qA=None,
    emit_prim: bool = False, num_sediment: int = 0, upwind: bool = False,
    strip: Optional[Strip] = None,
) -> RasterStepOut:
    """Plain version of the kernel: the ghost frame of `fill_ghost_frame`
    around the raster (around the strip, with its halo rows beyond its
    bottom and top off the walls), then the TPU kernel's faces, divergence,
    sources and update (structured_step.py:269-656) on whole planes. q with
    more than 3 rows carries tracers (the kernel's nt mode). The halo rows
    of a strip's `out` are zero."""
    strip = check_strip(plan, strip, 1, "swe_raster_step")
    nx, ny, th, ta = plan.nx, strip.rows, plan.tiny_h, plan.h_anuga
    nt = q.shape[0] - 3
    inv_dx, inv_dy = f32(1.0 / plan.dx), f32(1.0 / plan.dy)
    frame = ghost_frame(plan, q, bc_vals, strip)[
        :, strip.halo_lo:strip.halo_lo + ny + 2]
    H, HU, HV = frame[:3]
    U, V = regularized_velocity(H, HU, HV, th, ta)
    if nt:
        hden = torch.where(torch.abs(H) > 0.0, H, 1.0)
        CT = torch.where(H > th, frame[3:] / hden, 0.0)

    def faces(lo, hi, sn, cn):
        tr = dict(cil=CT[(slice(None),) + lo], cir=CT[(slice(None),) + hi],
                  upwind=upwind) if nt else {}
        fl = roe_flux(H[lo], U[lo], V[lo], H[hi], U[hi], V[hi], sn, cn,
                      fast=True, **tr)
        if nt:
            m = ((H[lo] > th) | (H[hi] > th)).to(H.dtype)
            rows = torch.cat([torch.stack(fl[:3]), fl[4]])
        else:
            m = (~((H[lo] < th) & (H[hi] < th))).to(H.dtype)
            rows = torch.stack(fl[:3])
        return rows * m, fl[3] * m

    inner = slice(1, -1)
    fx, ax = faces((inner, slice(0, -1)), (inner, slice(1, None)), 0.0, 1.0)
    fy, ay = faces((slice(0, -1), inner), (slice(1, None), inner), 1.0, 0.0)
    div = -((fx[:, :, 1:] - fx[:, :, :-1]) * inv_dx
            + (fy[:, 1:] - fy[:, :-1]) * inv_dy)

    # per-cell Courant coefficient, then its maximum over each block
    cx, cy = ax * inv_dx, ay * inv_dy
    cell = torch.maximum(torch.maximum(cx[:, :-1], cx[:, 1:]),
                         torch.maximum(cy[:-1], cy[1:]))
    n = q.shape[0]
    out, prim = cell_update(plan, strip.owned(q).reshape(n, -1), div, dz_dx,
                            dz_dy, mannings_n, dt, src=src, stage=stage,
                            qA=None if qA is None
                            else strip.owned(qA).reshape(n, -1),
                            emit_prim=emit_prim, num_sediment=num_sediment)
    return RasterStepOut(strip.to_buffer(out), prim,
                         block_max(cell, nx, ny, tile_for(nt)))


def wall_args(plan: StructuredPlan, bc_vals, ndof: int, dev, what: str,
              strip: Strip):
    """The four wall BC codes of `plan` (left, right, bottom, top) and the
    Dirichlet walls' value planes of `bc_vals` ([ndof, R] by buffer row on
    the left and right, [ndof, nx] below and above; None for the other
    walls, and for a bottom or top that is not the strip's), checked as
    the raster kernels take them."""
    bc_vals = bc_vals or {}
    holds = {"left": True, "right": True, "bottom": strip.row0 == 0,
             "top": strip.row0 + strip.rows == plan.ny}
    codes, walls = [], []
    for side in _SIDES:
        bc = getattr(plan, f"bc_{side}")
        if bc not in (bc_mod.BC_DIRICHLET, bc_mod.BC_REFLECTING,
                      bc_mod.BC_CRITICAL_OUTFLOW):
            raise ValueError(f"{what}: {side} wall BC code {bc}")
        wall = None
        if bc == bc_mod.BC_DIRICHLET and holds[side]:
            wall = bc_vals.get(side)
            if wall is None:
                raise ValueError(f"{what}: Dirichlet {side} wall without "
                                 "bc_vals")
            n = strip.buffer_rows if side in ("left", "right") else plan.nx
            build.check(wall, f"bc_vals[{side!r}]", torch.float32,
                        (ndof, n), dev)
        codes.append(bc)
        walls.append(wall)
    return codes, walls


def swe_raster_step(
    plan: StructuredPlan, q: torch.Tensor, dz_dx: torch.Tensor,
    dz_dy: torch.Tensor, mannings_n: torch.Tensor, dt: torch.Tensor, *,
    src: Optional[torch.Tensor] = None,
    bc_vals: Optional[Dict[str, torch.Tensor]] = None,
    stage: Optional[Tuple[float, float, float]] = None,
    qA: Optional[torch.Tensor] = None, emit_prim: bool = False,
    num_sediment: int = 0, upwind: bool = False,
    strip: Optional[Strip] = None,
) -> RasterStepOut:
    """One launch over the raster of `plan`, or over the owned rows of
    `strip`. q [ndof, R*nx] float32, the strip buffer (R = ny on the whole
    raster; qA the same; ndof = 3, or 3 + the tracers of which the first
    num_sediment are sediment classes), dz_dx, dz_dy, mannings_n and the
    rain plane src [rows, nx], dt a 0-dim tensor read on the device,
    bc_vals {side: [ndof, n]} the prescribed (h, hu, hv and tracer masses)
    along each Dirichlet wall (n = R for left/right, by buffer row, nx for
    bottom/top). upwind: upwind-Roe tracer fluxes. `out` is a strip buffer
    like q, of which the owned rows are written; prim [ndof, rows*nx];
    cmax one maximum per tile_for(nt) of cells."""
    if q.device.type == "cpu":
        return swe_raster_step_plain(
            plan, q, dz_dx, dz_dy, mannings_n, dt, src=src, bc_vals=bc_vals,
            stage=stage, qA=qA, emit_prim=emit_prim,
            num_sediment=num_sediment, upwind=upwind, strip=strip,
        )
    strip = check_strip(plan, strip, 1, "swe_raster_step")
    dev, f = q.device, torch.float32
    nx, ny = plan.nx, strip.rows
    C = nx * strip.buffer_rows
    ndof = q.shape[0]
    nt = ndof - 3
    if not 0 <= nt <= build.MAX_TRACERS:
        raise ValueError(f"swe_raster_step: {ndof} state rows")
    if not 0 <= num_sediment <= nt:
        raise ValueError(f"swe_raster_step: {num_sediment} sediment classes "
                         f"of {nt} tracers")
    tile = tile_for(nt)
    ck = build.check
    ck(q, "q", f, (ndof, C), dev)
    for name, t in (("dz_dx", dz_dx), ("dz_dy", dz_dy),
                    ("mannings_n", mannings_n)):
        ck(t, name, f, (ny, nx), dev)
    ck(dt, "dt", f, (), dev)
    if src is not None:
        ck(src, "src", f, (ny, nx), dev)
    if qA is not None:
        ck(qA, "qA", f, (ndof, C), dev)
    codes, walls = wall_args(plan, bc_vals, ndof, dev, "swe_raster_step",
                             strip)
    alpha, beta = _alpha_beta(stage) if stage is not None else (0.0, 0.0)

    out = torch.empty((ndof, C), dtype=f, device=dev)
    prim = (torch.empty((ndof, nx * ny), dtype=f, device=dev) if emit_prim
            else None)
    cmax = torch.empty((num_blocks(nx, ny, tile),), dtype=f, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = build.load("swe_raster_step", _FUNCTIONS)
    with torch.cuda.device(dev):
        status = lib.rdy_swe_raster_step_f32(
            q.data_ptr(), ptr(qA), dz_dx.data_ptr(), dz_dy.data_ptr(),
            mannings_n.data_ptr(), ptr(src), dt.data_ptr(), *codes,
            *(ptr(w) for w in walls), nx, plan.ny, *strip, plan.tiny_h,
            plan.h_anuga,
            f32(1.0 / plan.dx), f32(1.0 / plan.dy), int(stage is None),
            alpha, beta, nt, int(upwind), num_sediment, *SedimentParams(),
            out.data_ptr(), ptr(prim), cmax.data_ptr(), *tile,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check_status(status, "swe_raster_step")
    swe_raster_step.launches += 1
    return RasterStepOut(out, prim, cmax)


swe_raster_step.launches = 0


def smem_bytes(nt: int) -> int:
    """Dynamic shared memory of one block of the kernel with nt tracer rows
    (builds the library)."""
    return build.load("swe_raster_step", _FUNCTIONS).rdy_swe_raster_step_smem(
        nt)
