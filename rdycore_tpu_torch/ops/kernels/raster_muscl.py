"""K2 MUSCL `swe_raster_muscl_step`: one second-order step, RK stage or
RHS of the raster per launch, flow only.

`swe_raster_muscl_step` launches csrc/swe_raster_muscl.cu for CUDA tensors
and takes the plain PyTorch version `raster_muscl_step_plain` for CPU
tensors. The kernel replaces the `second_order` mode of the TPU kernel
`_kernel` (rdycore_tpu/ops/pallas/structured_step.py:341-559), which does
the step in one row tile with a 3-row halo; here a block owns a tile of
cells (`TILE`, 32 x 16) and keeps everything between the state and the
output in shared memory: the stencil with its wall ghosts, every face the
tile needs (its own and those of the ring of cells around it, each solved
once in the tile from its cells' normal gradients), the donor factors of
the tile and the ring, then the cell update. See the source's header for
the phases, the bound, what binds on the H100 and why neighbouring tiles
agree bit for bit.

The plain version is the composition of its parts, each a function of its
own here:
- `raster_muscl_faces_plain`: the limited MUSCL face states and Roe fluxes
  of every face, fx [3, face rows, nx + 1] (x face i is the west face of
  column i, face nx the right wall) and fy [3, face rows + 1, nx] (y face
  j the south face of row j), and the Courant coefficient of each owned
  cell over the faces it owns (the east and north face, and the west or
  south wall face where the cell has one). The gradients are the TPU
  kernel's masked central or one-sided differences (:366-410, in float32
  as it forms them); wall faces stay first order on the inline ghost,
  with h clamped >= 0 like every face.
- `donor_factors`: the Audusse donor factors s = clip(h / (dt * drain), 0,
  1) of each cell of the face rows from the face h-fluxes (dt <= 0
  divides by 1, :495-533).
- `raster_muscl_update_plain`: each face scaled by its donor's s (a ghost
  donor keeps s = 1; :548-559), then the divergence, the semi-implicit
  sources on the raw state, the rain plane and the stage or rhs output
  with the primitives, as K2 (`raster_step.cell_update`).
`raster_muscl_step_plain` composes them and takes the Courant maximum of
each tile (`raster_step.block_max`), the layout the kernel writes.

With `strip` (raster_step.Strip), a launch owns the rows of a row strip,
the per-shard kernel of the JAX package's sharded stepper
(`make_sharded_fused_structured_stepper(second_order=True)`,
structured_step.py:1019): the strip buffer carries MUSCL_HALO = 3 halo
rows off the walls (the TPU stepper's HR = 3), what a tile's stencil
reaches, and every mask tests the global row. In the plain parts the face
rows are the owned rows and one halo row below (x_lo = 1) and above (x_hi
= 1) where the strip has halo rows there, whose faces the donor factors
of the halo cells next to the owned ones need.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..swe.muscl import LIMITERS, limit_slope
from ..swe.riemann import regularized_velocity, roe_flux
from . import build
from .cell_stage import _alpha_beta
from .raster_step import (
    RasterStepOut,
    Strip,
    StructuredPlan,
    block_max,
    cell_update,
    check_strip,
    f32,
    ghost_frame,
    num_blocks,
    wall_args,
)

_P, _I64, _INT, _F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_float)
_FUNCTIONS = {
    "rdy_swe_raster_muscl_step_f32": [_P] * 7 + [_INT] * 4 + [_P] * 4
    + [_I64] * 4 + [_INT, _INT] + [_F] * 6 + [_INT, _F, _F, _INT]
    + [_P, _P, _P, _P],
    "rdy_swe_raster_muscl_step_smem": [],
}
# halo rows a second-order strip needs off the walls
MUSCL_HALO = 3
# the cells along x and y of a tile, one block of the kernel and one
# Courant maximum
TILE = (32, 16)


def face_rows(strip: Strip):
    """(x_lo, the number of face rows, x_hi) of a strip: its owned rows
    and one halo row below (x_lo = 1) and above (x_hi = 1) where it has
    halo rows there."""
    x_lo, x_hi = int(strip.halo_lo > 0), int(strip.halo_hi > 0)
    return x_lo, x_lo + strip.rows + x_hi, x_hi


def _half_steps(plan: StructuredPlan):
    """1/dx, 1/dy and the centre-to-face distances hdx = 0.5/(1/dx), hdy
    in float32, as the TPU kernel forms them."""
    inv_dx, inv_dy = f32(1.0 / plan.dx), f32(1.0 / plan.dy)
    half = np.float32(0.5)
    return (inv_dx, inv_dy, float(half / np.float32(inv_dx)),
            float(half / np.float32(inv_dy)))


def _gradient(qi, lo, hi, idx, n: int, inv_d: float, dim: int):
    """Masked central / one-sided differences along `dim` of the cells qi
    [3, rows, nx], lo/hi their neighbours (ghosts beyond the walls, which
    take a zero weight), idx the cells' positions along `dim` on the raster
    of n cells that way (structured_step.py:366-410)."""
    has_hi, has_lo = idx < n - 1, idx > 0
    c_hi = torch.where(has_hi, torch.where(has_lo, f32(0.5 * inv_d), inv_d),
                       0.0).to(qi.dtype)
    c_lo = torch.where(has_lo, torch.where(has_hi, f32(0.5 * inv_d), inv_d),
                       0.0).to(qi.dtype)
    shape = [1, 1, 1]
    shape[dim] = idx.numel()
    return (c_hi.reshape(shape) * (hi - qi)
            + c_lo.reshape(shape) * (qi - lo))


def _faces(ql, qr, gl, gr, vf, hd: float, limiter: str, sn: float,
           cn: float, tiny_h: float, h_anuga: float):
    """Limited MUSCL states and masked Roe fluxes of faces with raw
    states ql/qr [3, ...], the normal gradients gl/gr of their cells (zero
    for a ghost) and vf = 1 on interior faces, 0 on wall faces."""
    dq = qr - ql
    q_l = ql + limit_slope(limiter, gl * hd * vf, 0.5 * dq)
    q_r = qr + limit_slope(limiter, -gr * hd * vf, -0.5 * dq)
    hl, hr = torch.clamp_min(q_l[0], 0.0), torch.clamp_min(q_r[0], 0.0)
    ul, vl = regularized_velocity(hl, q_l[1], q_l[2], tiny_h, h_anuga)
    ur, vr = regularized_velocity(hr, q_r[1], q_r[2], tiny_h, h_anuga)
    fh, fhu, fhv, a = roe_flux(hl, ul, vl, hr, ur, vr, sn, cn, fast=True)
    m = (~((hl < tiny_h) & (hr < tiny_h))).to(hl.dtype)
    return torch.stack([fh, fhu, fhv]) * m, a * m


def raster_muscl_faces_plain(plan: StructuredPlan, q, bc_vals=None,
                             limiter: str = "minmod",
                             strip: Optional[Strip] = None):
    """The MUSCL faces of the flow state q [3, R*nx]: (fx, fy, own), own
    [rows, nx] the largest amax/dx, amax/dy of the faces each owned cell
    owns. The faces of every buffer row are solved, those of the face rows
    returned."""
    strip = check_strip(plan, strip, MUSCL_HALO, "swe_raster_muscl_step")
    nx, ny, R = plan.nx, plan.ny, strip.buffer_rows
    lo, rows = strip.halo_lo, strip.rows
    x_lo, n_face, _ = face_rows(strip)
    inv_dx, inv_dy, hdx, hdy = _half_steps(plan)
    fr = ghost_frame(plan, q[:3], bc_vals, strip)
    qi = fr[:, 1:-1, 1:-1]
    dev = q.device
    gx = _gradient(qi, fr[:, 1:-1, :-2], fr[:, 1:-1, 2:],
                   torch.arange(nx, device=dev), nx, inv_dx, 2)
    # the buffer rows' global rows (the outermost halo rows' gradients,
    # which read the frame's zero border, feed no returned face)
    gy = _gradient(qi, fr[:, :-2, 1:-1], fr[:, 2:, 1:-1],
                   torch.arange(R, device=dev) + (strip.row0 - lo), ny,
                   inv_dy, 1)
    gx, gy = F.pad(gx, (1, 1)), F.pad(gy, (0, 0, 1, 1))  # ghosts: zero
    vfx = torch.ones(nx + 1, dtype=q.dtype, device=dev)
    vfy = torch.ones(R + 1, 1, dtype=q.dtype, device=dev)
    vfx[[0, -1]] = 0.0
    vfy[[0, -1]] = 0.0  # the walls' faces (off the walls: not returned)
    th, ta = plan.tiny_h, plan.h_anuga
    fx, ax = _faces(fr[:, 1:-1, :-1], fr[:, 1:-1, 1:], gx[..., :-1],
                    gx[..., 1:], vfx, hdx, limiter, 0.0, 1.0, th, ta)
    fy, ay = _faces(fr[:, :-1, 1:-1], fr[:, 1:, 1:-1], gy[:, :-1],
                    gy[:, 1:], vfy, hdy, limiter, 1.0, 0.0, th, ta)
    # each owned cell's own faces: east and north, and a wall's west or
    # south; the halo face rows count nothing
    ax, ay = ax[lo:lo + rows], ay[lo:lo + rows + 1]
    own = torch.maximum(ax[:, 1:] * inv_dx, ay[1:] * inv_dy)
    own[:, 0] = torch.maximum(own[:, 0], ax[:, 0] * inv_dx)
    if strip.row0 == 0:
        own[0] = torch.maximum(own[0], ay[0] * inv_dy)
    b0 = lo - x_lo
    return (fx[:, b0:b0 + n_face].contiguous(),
            fy[:, b0:b0 + n_face + 1].contiguous(), own)


def donor_factors(plan: StructuredPlan, q, fx, fy, dt,
                  strip: Optional[Strip] = None):
    """The donor factor s [face rows, nx] of each cell of the face rows
    of the state q [3, R*nx] for the faces fx, fy over a step dt (1 where
    nothing drains; dt <= 0 divides by 1)."""
    strip = check_strip(plan, strip, MUSCL_HALO, "donor_factors")
    x_lo, n_face, _ = face_rows(strip)
    inv_dx, inv_dy, _, _ = _half_steps(plan)
    b0 = strip.halo_lo - x_lo
    h = q[0].reshape(strip.buffer_rows, plan.nx)[b0:b0 + n_face]
    fxh, fyh = fx[0], fy[0]
    relu = torch.relu
    drain = ((relu(fxh[:, 1:]) + relu(-fxh[:, :-1])) * inv_dx
             + (relu(fyh[1:]) + relu(-fyh[:-1])) * inv_dy)
    dsafe = torch.where(drain > 0.0, drain, 1.0)
    dt_s = torch.where(dt > 0.0, dt, 1.0)
    return torch.where(drain > 0.0,
                       torch.clamp(h / (dt_s * dsafe), 0.0, 1.0), 1.0)


def raster_muscl_update_plain(
    plan: StructuredPlan, q, fx, fy, dz_dx, dz_dy, mannings_n, dt, *,
    src=None, stage=None, qA=None, emit_prim=False,
    strip: Optional[Strip] = None,
):
    """The positivity scaling, divergence, sources and stage or rhs
    output of q from the faces of `raster_muscl_faces_plain`: (out, prim);
    the halo rows of a strip's `out` are zero."""
    strip = check_strip(plan, strip, MUSCL_HALO, "swe_raster_muscl_step")
    x_lo, _, x_hi = face_rows(strip)
    rows = strip.rows
    inv_dx, inv_dy, _, _ = _half_steps(plan)
    # ghost donors keep s = 1; beyond a strip's bottom or top off the
    # walls, the halo face row's cells donate
    sp = F.pad(donor_factors(plan, q, fx, fy, dt, strip),
               (1, 1, 1 - x_lo, 1 - x_hi), value=1.0)
    fx, fy = fx[:, x_lo:x_lo + rows], fy[:, x_lo:x_lo + rows + 1]
    fxh, fyh = fx[0], fy[0]
    fx = fx * torch.where(fxh > 0.0, sp[1:-1, :-1], sp[1:-1, 1:])
    fy = fy * torch.where(fyh > 0.0, sp[:-1, 1:-1], sp[1:, 1:-1])
    div = -((fx[:, :, 1:] - fx[:, :, :-1]) * inv_dx
            + (fy[:, 1:] - fy[:, :-1]) * inv_dy)
    out, prim = cell_update(plan, strip.owned(q).reshape(3, -1), div,
                            dz_dx, dz_dy, mannings_n, dt, src=src,
                            stage=stage,
                            qA=None if qA is None
                            else strip.owned(qA).reshape(3, -1),
                            emit_prim=emit_prim)
    return strip.to_buffer(out), prim


def raster_muscl_step_plain(
    plan: StructuredPlan, q, dz_dx, dz_dy, mannings_n, dt, bc_vals=None,
    limiter: str = "minmod", strip: Optional[Strip] = None, *, src=None,
    stage=None, qA=None, emit_prim: bool = False,
) -> RasterStepOut:
    """Plain version of the kernel: the faces, the donor factors and the
    update of its parts above, and the Courant maximum of each tile of
    owned cells."""
    fx, fy, own = raster_muscl_faces_plain(plan, q, bc_vals, limiter, strip)
    out, prim = raster_muscl_update_plain(
        plan, q, fx, fy, dz_dx, dz_dy, mannings_n, dt, src=src, stage=stage,
        qA=qA, emit_prim=emit_prim, strip=strip)
    return RasterStepOut(out, prim, block_max(own, plan.nx, own.shape[0],
                                              TILE))


def swe_raster_muscl_step(
    plan: StructuredPlan, q: torch.Tensor, dz_dx: torch.Tensor,
    dz_dy: torch.Tensor, mannings_n: torch.Tensor, dt: torch.Tensor,
    bc_vals: Optional[Dict[str, torch.Tensor]] = None,
    limiter: str = "minmod", strip: Optional[Strip] = None, *,
    src: Optional[torch.Tensor] = None,
    stage: Optional[Tuple[float, float, float]] = None,
    qA: Optional[torch.Tensor] = None, emit_prim: bool = False,
) -> RasterStepOut:
    """One second-order launch over the raster of `plan`, or over the
    owned rows of `strip`, with K2's stage and rhs modes (raster_step.py).
    q [3, R*nx] float32, the strip buffer (R = ny on the whole raster; qA
    the same), dz_dx, dz_dy, mannings_n and the rain plane src [rows, nx],
    dt a 0-dim tensor read on the device, bc_vals {side: [3, n]} the
    Dirichlet walls' (h, hu, hv) (n = R by buffer row on the left and
    right, nx below and above). `out` is a strip buffer like q, of which
    the owned rows are written; prim [3, rows*nx]; cmax one maximum per
    TILE of owned cells, row-major by tile."""
    if q.device.type == "cpu":
        return raster_muscl_step_plain(
            plan, q, dz_dx, dz_dy, mannings_n, dt, bc_vals, limiter, strip,
            src=src, stage=stage, qA=qA, emit_prim=emit_prim)
    strip = check_strip(plan, strip, MUSCL_HALO, "swe_raster_muscl_step")
    dev, f = q.device, torch.float32
    nx, ny = plan.nx, strip.rows
    C = nx * strip.buffer_rows
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
    codes, walls = wall_args(plan, bc_vals, 3, dev, "swe_raster_muscl_step",
                             strip)
    alpha, beta = _alpha_beta(stage) if stage is not None else (0.0, 0.0)
    out = torch.empty((3, C), dtype=f, device=dev)
    prim = (torch.empty((3, nx * ny), dtype=f, device=dev) if emit_prim
            else None)
    cmax = torch.empty((num_blocks(nx, ny, TILE),), dtype=f, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    inv_dx, inv_dy, hdx, hdy = _half_steps(plan)
    lib = build.load("swe_raster_muscl", _FUNCTIONS)
    with torch.cuda.device(dev):
        status = lib.rdy_swe_raster_muscl_step_f32(
            q.data_ptr(), ptr(qA), dz_dx.data_ptr(), dz_dy.data_ptr(),
            mannings_n.data_ptr(), ptr(src), dt.data_ptr(), *codes,
            *(ptr(w) for w in walls), nx, plan.ny, *strip, plan.tiny_h,
            plan.h_anuga, inv_dx, inv_dy, hdx, hdy, int(stage is None), alpha,
            beta, LIMITERS[limiter], out.data_ptr(), ptr(prim),
            cmax.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check_status(status, "swe_raster_muscl_step")
    swe_raster_muscl_step.launches += 1
    return RasterStepOut(out, prim, cmax)


swe_raster_muscl_step.launches = 0


def smem_bytes() -> int:
    """Dynamic shared memory of one block of the kernel (builds the
    library)."""
    return build.load("swe_raster_muscl",
                      _FUNCTIONS).rdy_swe_raster_muscl_step_smem()
