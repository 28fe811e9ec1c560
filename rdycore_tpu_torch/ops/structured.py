"""Uniform quad rasters: the zero-gather operator and the interval advancers.

The counterpart of rdycore_tpu/ops/structured.py (the XLA raster twin,
backend `structured`) and of the single-device caller of the fused raster
kernel, `make_fused_structured_stepper` (rdycore_tpu/ops/pallas/
structured_step.py:659, backend `fused_structured`), for the flow equations
at first order, with tracers, or (flow only) at second order.

- `StructuredSWEOperator` is the `structured` backend in plain PyTorch: the
  JAX package computes it with array slicing outside any Pallas kernel. It
  uses the unstructured operator's wall ghosts (critical outflow also dries
  the interior on inflow) and source functions, and is the f64 reference of
  the tests.
- `make_fused_structured_stepper` runs the kernel K2 `swe_raster_step`
  (with tracer rows in its nt mode), or at second order K2 MUSCL
  `swe_raster_muscl_step`, once per stage (euler, ssprk2 and ssprk3 in
  stage mode, rk4 from rhs-mode calls; beuler's residuals from rhs-mode
  calls, its JVPs through `StructuredSWEOperator`), folds the Courant
  maxima with K1c, and takes the boundary-flux
  accumulator from K1a on the operator's boundary edges alone. That
  accumulator is first order and unscaled also at second order, as the
  JAX package's raster stepper takes it from the unstructured
  `boundary_fluxes` (ROADMAP fault 16). Like the TPU
  stepper it runs in float32 with the time kept in float32, and nothing is
  read back to the host until the interval ends.
- Over P row strips (`fused_strip_operators`, one operator per strip, each
  on its own device or several on one card), the same stepper is the
  counterpart of the JAX package's row-strip sharded stepper
  (`make_sharded_fused_structured_stepper`, structured_step.py:1019): each
  stage launches the raster kernels once per strip on its strip buffer
  after the halo exchange (ops/strips.py), each strip folds its own
  Courant maxima (K1c) and boundary fluxes (K1a on the boundary edges of
  its owned cells), and the read-back gathers the strips in row order.
  Every cell does the arithmetic of the single launch, so the strips give
  its result bit for bit.

State layout: q[3, ny, nx] for the operator, the package's [ndof, ny*nx]
for the fused stepper; cell c sits at row c // nx, column c % nx.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..constants import DEFAULT_H_ANUGA, DEFAULT_TINY_H
from ..device import DeviceLike, resolve_device
from ..operator import OperatorArrays
from ..timestepping import IntervalResult, newton_beuler_solve
from .kernels.courant import courant_argmax
from .kernels.edge_flux import swe_edge_flux
from .kernels.raster_muscl import MUSCL_HALO, swe_raster_muscl_step
from .kernels.raster_step import (
    Strip,
    StructuredPlan,
    f32,
    swe_raster_step,
)
from .strips import (
    exchange,
    gather_rows,
    split_rows,
    strip_boundary_edges,
    strip_layout,
    strip_wall_values,
)
from .swe import boundary as bc_mod
from .swe.riemann import regularized_velocity, roe_flux
from .swe.sources import (
    SOURCE_IMPLICIT_XQ2018,
    apply_source_semi_implicit,
    apply_source_xq2018,
)


class StructuredArrays(NamedTuple):
    dz_dx: torch.Tensor  # [ny, nx]
    dz_dy: torch.Tensor
    mannings_n: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class StructuredSWEOperator:
    """SWE RHS on a uniform [ny, nx] grid with spacing (dx, dy)."""

    arrays: StructuredArrays
    nx: int
    ny: int
    dx: float
    dy: float
    # wall BCs: bc_mod codes for (left, right, bottom, top)
    bc_left: int = bc_mod.BC_REFLECTING
    bc_right: int = bc_mod.BC_REFLECTING
    bc_bottom: int = bc_mod.BC_REFLECTING
    bc_top: int = bc_mod.BC_REFLECTING
    tiny_h: float = DEFAULT_TINY_H
    h_anuga: float = DEFAULT_H_ANUGA
    source_method: int = 0
    xq2018_threshold: float = 1.0e-10

    def apply(self, q: torch.Tensor, dt, ext_src: torch.Tensor):
        """q: [3, ny, nx] -> (rhs [3, ny, nx], max_courant_per_dt 0-dim)."""
        a = self.arrays
        th, ta = self.tiny_h, self.h_anuga
        h, hu, hv = q[0], q[1], q[2]
        u, v = regularized_velocity(h, hu, hv, th, ta)

        def masked(flux, dry):
            f_h, f_hu, f_hv, am = flux
            m = (~dry).to(q.dtype)
            return torch.stack([f_h * m, f_hu * m, f_hv * m]), am * m

        # interior x-edges between columns i-1 | i (normal +x), y-edges
        # between rows j-1 | j (normal +y)
        hl, hr = h[:, :-1], h[:, 1:]
        fx, ax = masked(roe_flux(hl, u[:, :-1], v[:, :-1], hr, u[:, 1:],
                                 v[:, 1:], 0.0, 1.0),
                        (hl < th) & (hr < th))
        hb, ht = h[:-1, :], h[1:, :]
        fy, ay = masked(roe_flux(hb, u[:-1, :], v[:-1, :], ht, u[1:, :],
                                 v[1:, :], 1.0, 0.0),
                        (hb < th) & (ht < th))

        def wall_flux(hs, us, vs, sn, cn, bc):
            (hl_s, ul_s, vl_s), (hr_s, ur_s, vr_s) = bc_mod.ghost_states(
                torch.full((), bc, device=q.device), hs, us, vs, sn, cn,
                q.new_zeros((3,) + hs.shape), th, ta,
            )
            return masked(roe_flux(hl_s, ul_s, vl_s, hr_s, ur_s, vr_s, sn,
                                   cn),
                          (hl_s < th) & (hr_s < th))

        # outward normals: left (-1, 0), right (+1, 0), bottom (0, -1),
        # top (0, +1)
        fxl, al = wall_flux(h[:, 0], u[:, 0], v[:, 0], 0.0, -1.0,
                            self.bc_left)
        fxr, ar = wall_flux(h[:, -1], u[:, -1], v[:, -1], 0.0, 1.0,
                            self.bc_right)
        fyb, ab = wall_flux(h[0, :], u[0, :], v[0, :], -1.0, 0.0,
                            self.bc_bottom)
        fyt, at = wall_flux(h[-1, :], u[-1, :], v[-1, :], 1.0, 0.0,
                            self.bc_top)

        # divergence; wall fluxes with outward normals enter as -F/length
        # filled on the device: a blocking copy from the host would wait
        # for the work queued on it
        inv_dx = 1.0 / torch.full((), self.dx, dtype=q.dtype, device=q.device)
        inv_dy = 1.0 / torch.full((), self.dy, dtype=q.dtype, device=q.device)
        fx_full = torch.cat([(-fxl)[:, :, None], fx, fxr[:, :, None]], dim=2)
        div_x = -(fx_full[:, :, 1:] - fx_full[:, :, :-1]) * inv_dx
        fy_full = torch.cat([(-fyb)[:, None, :], fy, fyt[:, None, :]], dim=1)
        div_y = -(fy_full[:, 1:, :] - fy_full[:, :-1, :]) * inv_dy
        flux_div = div_x + div_y

        cmax = torch.maximum(
            torch.maximum(ax.max() * inv_dx, ay.max() * inv_dy),
            torch.maximum(
                torch.maximum(al.max(), ar.max()) * inv_dx,
                torch.maximum(ab.max(), at.max()) * inv_dy,
            ),
        )

        shp = (3, self.ny * self.nx)
        args = (q.reshape(shp), flux_div.reshape(shp), ext_src.reshape(shp),
                a.mannings_n.reshape(-1), a.dz_dx.reshape(-1),
                a.dz_dy.reshape(-1), dt, th, ta)
        if self.source_method == SOURCE_IMPLICIT_XQ2018:
            src = apply_source_xq2018(*args, self.xq2018_threshold)
        else:
            src = apply_source_semi_implicit(*args)
        return flux_div + src.rhs.reshape(q.shape), cmax


def detect_uniform_raster(mesh, rtol: float = 1e-9):
    """Detect a uniform row-major quad raster: returns (nx, ny, dx, dy) or
    None. The raster paths require exactly this layout (cell c at row
    c // nx, column c % nx) with exactly repeated centroid coordinates;
    meshes from `structured_quad` qualify when their spacings are exact in
    binary (1/512 m does, 0.002 m does not), RCM-reordered or unstructured
    meshes do not."""
    C = mesh.num_cells
    if (np.asarray(mesh.cell_num_vertices) != 4).any():
        return None
    cx = np.asarray(mesh.cell_centroid[:, 0])
    cy = np.asarray(mesh.cell_centroid[:, 1])
    ux = np.unique(cx)
    uy = np.unique(cy)
    nx, ny = len(ux), len(uy)
    if nx * ny != C or nx < 2 or ny < 2:
        return None
    ddx = np.diff(ux)
    ddy = np.diff(uy)
    dx = float(ddx[0])
    dy = float(ddy[0])
    span = max(abs(ux[-1] - ux[0]), abs(uy[-1] - uy[0]), 1.0)
    if (abs(ddx - dx) > rtol * span).any() or (abs(ddy - dy) > rtol * span).any():
        return None
    ix = np.searchsorted(ux, cx)
    iy = np.searchsorted(uy, cy)
    if not np.array_equal(iy * nx + ix, np.arange(C)):
        return None
    return nx, ny, dx, dy


def build_structured_operator(
    nx: int,
    ny: int,
    dx: float,
    dy: float,
    z: Optional[np.ndarray] = None,  # [ny, nx] cell-center bed elevation
    mannings_n: Optional[np.ndarray] = None,
    dtype: torch.dtype = torch.float32,
    dz_dx: Optional[np.ndarray] = None,  # [ny, nx] overrides z-derived slopes
    dz_dy: Optional[np.ndarray] = None,
    device: DeviceLike = None,
    **kwargs,
) -> StructuredSWEOperator:
    """A StructuredSWEOperator on `device` (CUDA unless "cpu")."""
    device = resolve_device(device)
    if dz_dx is not None or dz_dy is not None:
        dz_dx = np.zeros((ny, nx)) if dz_dx is None else np.asarray(dz_dx)
        dz_dy = np.zeros((ny, nx)) if dz_dy is None else np.asarray(dz_dy)
    elif z is None:
        dz_dx = np.zeros((ny, nx))
        dz_dy = np.zeros((ny, nx))
    else:
        dz_dy, dz_dx = np.gradient(np.asarray(z), dy, dx)
    if mannings_n is None:
        mannings_n = np.zeros((ny, nx))

    def t(x):
        return torch.as_tensor(np.array(np.broadcast_to(x, (ny, nx))),
                               dtype=dtype, device=device)

    arrays = StructuredArrays(dz_dx=t(dz_dx), dz_dy=t(dz_dy),
                              mannings_n=t(mannings_n))
    return StructuredSWEOperator(
        arrays=arrays, nx=nx, ny=ny, dx=dx, dy=dy, **kwargs
    )


STRUCTURED_SCHEMES = ("euler", "ssprk2", "rk4")


def make_structured_stepper(op: StructuredSWEOperator, scheme: str = "euler"):
    """Interval advancer of the operator: advance(arrays, q [3, ny, nx], t0,
    dt, n_steps, t_end, ext_src [3, ny, nx]) -> (q, t, max Courant), the
    time kept in q's dtype. A step past t_end (dt_i == 0) leaves q."""
    if scheme not in STRUCTURED_SCHEMES:
        raise ValueError(f"structured: unsupported scheme '{scheme}'")

    def advance(arrays, q, t0, dt, n_steps, t_end, ext_src):
        bound = dataclasses.replace(op, arrays=arrays)

        def scalar(x):
            return torch.as_tensor(x, dtype=q.dtype, device=q.device)

        dt, t_end, tt = scalar(dt), scalar(t_end), scalar(t0)
        cmax = scalar(0.0)
        qq = q
        for _ in range(int(n_steps)):
            dt_i = torch.clamp_min(torch.minimum(dt, t_end - tt), 0.0)
            if scheme == "euler":
                rhs, cm = bound.apply(qq, dt_i, ext_src)
                q_new = qq + dt_i * rhs
            elif scheme == "ssprk2":
                rhs, cm = bound.apply(qq, dt_i, ext_src)
                q1 = qq + dt_i * rhs
                rhs2, _ = bound.apply(q1, dt_i, ext_src)
                q_new = 0.5 * qq + 0.5 * (q1 + dt_i * rhs2)
            else:  # rk4
                r1, cm = bound.apply(qq, dt_i, ext_src)
                r2, _ = bound.apply(qq + 0.5 * dt_i * r1, dt_i, ext_src)
                r3, _ = bound.apply(qq + 0.5 * dt_i * r2, dt_i, ext_src)
                r4, _ = bound.apply(qq + dt_i * r3, dt_i, ext_src)
                q_new = qq + (dt_i / 6.0) * (r1 + 2 * r2 + 2 * r3 + r4)
            cmax = torch.maximum(cmax, cm * dt_i)
            qq = torch.where(dt_i > 0.0, q_new, qq)
            tt = tt + dt_i
        return qq, tt, cmax

    return advance


# ------------------------------------------------------------ fused raster

def boundary_edge_arrays(a: OperatorArrays) -> OperatorArrays:
    """The boundary edges of operator arrays `a` alone, float32: an edge
    kernel (K1a) launch over them computes exactly the boundary fluxes
    [3, Eb] (its interior-edge block is empty)."""
    f = torch.float32
    empty_i = a.int_left[:0]
    empty_f = torch.zeros((0,), dtype=f, device=a.bnd_cn.device)
    Eb = a.bnd_left.shape[0]
    return dataclasses.replace(
        a, int_left=empty_i, int_right=empty_i, int_cn=empty_f,
        int_sn=empty_f, bnd_cn=a.bnd_cn.to(f), bnd_sn=a.bnd_sn.to(f),
        edge_courant_coef=a.edge_courant_coef[-Eb:].to(f) if Eb else empty_f,
    )


@dataclasses.dataclass(eq=False)
class FusedStructuredOperator:
    """The kernels of the fused raster path on one raster, or on one row
    strip of it (`strip`): K2 for each step or stage (K2 MUSCL with
    `second_order`, limited by `limiter`, flow only), K1c for the Courant
    fold and, given `bnd` (the boundary edges from `boundary_edge_arrays`,
    on a strip those of its owned cells from `strip_boundary_edges`, whose
    columns among the raster's are `bnd_idx`), K1a for the boundary fluxes.
    num_tracers rows follow (h, hu, hv) in the state, the first
    num_sediment of them sediment classes; riemann "upwind_roe" upwinds
    their fluxes."""

    plan: StructuredPlan
    dz_dx: torch.Tensor  # [ny, nx] float32 (a strip's: [rows, nx])
    dz_dy: torch.Tensor
    mannings_n: torch.Tensor
    bnd: Optional[OperatorArrays] = None
    num_tracers: int = 0
    num_sediment: int = 0
    riemann: str = "roe"
    second_order: bool = False
    limiter: str = "minmod"
    strip: Optional[Strip] = None  # None: the whole raster
    bnd_idx: Optional[torch.Tensor] = None  # None: all the raster's

    def __post_init__(self):
        if self.second_order and self.num_tracers:
            raise ValueError("fused raster MUSCL is flow-only")
        if self.strip is None:
            self.strip = Strip(0, self.plan.ny)

    @property
    def ndof(self) -> int:
        return 3 + self.num_tracers

    def step(self, q, dt, src=None, bc_vals=None, **mode):
        """K2, or K2 MUSCL, on the strip buffer q [ndof, R*nx] (the state
        [ndof, ny*nx] on the whole raster; mode: stage=, qA=,
        emit_prim=)."""
        if self.second_order:
            return swe_raster_muscl_step(
                self.plan, q, self.dz_dx, self.dz_dy, self.mannings_n, dt,
                bc_vals, self.limiter, self.strip, src=src, **mode)
        return swe_raster_step(self.plan, q, self.dz_dx, self.dz_dy,
                               self.mannings_n, dt, src=src, bc_vals=bc_vals,
                               num_sediment=self.num_sediment,
                               upwind=self.riemann == "upwind_roe",
                               strip=self.strip, **mode)

    def courant_max(self, cmax_blocks, dt, run_max, run_idx):
        """K1c: fold max(cmax_blocks) * dt into run_max in place."""
        return courant_argmax(cmax_blocks, dt, run_max, run_idx)

    def boundary_fluxes(self, q, bv_edges):
        """K1a on the boundary edges: the flow-only Roe fluxes [3, Eb] of
        the flow rows q [3, R*nx] (bv_edges [3, >= Eb], the edges' own
        columns)."""
        flux, _ = swe_edge_flux(self.bnd, q, bv_edges, self.plan.tiny_h,
                                self.plan.h_anuga)
        return flux[:, :-1]


def fused_strip_operators(
    plan: StructuredPlan, dz_dx: torch.Tensor, dz_dy: torch.Tensor,
    mannings_n: torch.Tensor, devices, bnd: Optional[OperatorArrays] = None,
    **kw,
):
    """One FusedStructuredOperator per row strip of the raster, in row
    order, strip p on devices[p] (a card may be named more than once): the
    [ny, nx] planes cut to the strips' rows, the boundary edges `bnd` to
    those of each strip's owned cells, the strips' halo rows as the
    operator needs them (kw: FusedStructuredOperator's options)."""
    halo = MUSCL_HALO if kw.get("second_order") else 1
    ops = []
    for s, d in zip(strip_layout(plan.ny, len(devices), halo), devices):
        rows = slice(s.row0, s.row0 + s.rows)
        sb, idx = (None, None) if bnd is None else strip_boundary_edges(
            bnd, plan.nx, s, d)
        ops.append(FusedStructuredOperator(
            plan, *(x[rows].contiguous().to(d)
                    for x in (dz_dx, dz_dy, mannings_n)),
            sb, strip=s, bnd_idx=idx, **kw))
    return ops


_THIRD = f32(1.0 / 3.0)
# stage tables (alpha, beta, gamma = beta) of the fused stepper's schemes
# (structured_step.py:907-920); ssprk3's last stage is
# lin(st, third, st3, 1 - third) in float32
FUSED_STAGES = {
    "euler": ((0.0, 1.0, 1.0),),
    "ssprk2": ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5)),
    "ssprk3": ((0.0, 1.0, 1.0), (0.75, 0.25, 0.25),
               (_THIRD, f32(1.0 - _THIRD), f32(1.0 - _THIRD))),
}
FUSED_SCHEMES = tuple(FUSED_STAGES) + ("rk4",)


def make_fused_structured_stepper(
    op, scheme: str = "euler", accumulate: bool = False,
    lin_op: Optional[StructuredSWEOperator] = None,
    exchange_halo: Optional[Callable] = None,
) -> Callable[..., IntervalResult]:
    """advance(q [ndof, ny*nx] float32, t0, dt, n_steps, t_end, src=None,
    bc_vals=None, bv_edges=None) -> IntervalResult, all of it float32 on
    q's device. src: the rain plane [ny, nx] or None; bc_vals: {side:
    [ndof, n]} Dirichlet wall values; bv_edges: [ndof, >= Eb] boundary
    values for the boundary-flux accumulator.

    `op` is a FusedStructuredOperator, or the sequence of one per row strip
    from `fused_strip_operators`. Over strips, advance cuts q, src, bc_vals
    and bv_edges to the strips (q into strip buffers on the strips'
    devices), refreshes the halo rows before every stage, keeps a clock,
    Courant maximum and accumulators per strip (the clock once per device,
    each doing the same float32 arithmetic), and returns the strips'
    owned rows and accumulators gathered in the raster's order on the first
    strip's device, with the Courant number the maximum over the strips.

    dt_i = max(min(dt, t_end - t), 0) and t advance in float32; the Courant
    number max(cmax, cm*dt_i) takes cm from the first stage (from k1 for
    rk4). accumulate=True adds the dt-weighted accounting of each pre-step
    state (asol, aprim, atime, and bflux_accum when `op.bnd` is given);
    otherwise those fields are None, as is courant_edge (a raster Courant
    maximum has no edge id). The accumulator's tracer rows stay zero: the
    JAX package's raster stepper takes its boundary fluxes from the
    flow-only `boundary_fluxes` (structured_step.py:899-906), and so does
    this one.

    beuler (backward Euler, one strip, flow only; structured_step.py:
    715-730, :921-960): the Courant number from one rhs-mode launch on the
    pre-step state, then `newton_beuler_solve` with its residuals F from
    K2's rhs mode (K2 MUSCL's with `second_order`) and its JVPs through
    `lin_op`, the first-order `StructuredSWEOperator` in float32 with zero
    Dirichlet ghosts (its external sources the rain plane in row 0), as
    the JAX package's `lin_op`.

    advance.strips(qq, t0, dt, n_steps, t_end, srcs, bcs, bves) runs the
    interval on strip buffers that stay where they are (advance cuts and
    gathers around it). With exchange_halo(buffers) the halo rows are
    refreshed by it instead of between the strips here: the one strip of
    a rank, its neighbours on other ranks (ops/strips.RankStrip)."""
    if scheme not in FUSED_SCHEMES + ("beuler",):
        raise ValueError(f"fused_structured: unsupported scheme '{scheme}'")
    stages = FUSED_STAGES.get(scheme)
    ops = list(op) if isinstance(op, (list, tuple)) else [op]
    if scheme == "beuler":
        if lin_op is None:
            raise ValueError(
                "scheme 'beuler' needs lin_op (the StructuredSWEOperator "
                "twin for Newton-GMRES JVPs)")
        if ops[0].num_tracers:
            raise ValueError("fused raster beuler is flow-only")
        if len(ops) > 1:
            raise ValueError("fused raster beuler runs on one strip")
    strips = [o.strip for o in ops]
    devs = [o.dz_dx.device for o in ops]
    uniq = list(dict.fromkeys(devs))  # the strips' devices, each once
    slot = [uniq.index(d) for d in devs]  # strip -> its device's clock
    nx, ny, ndof = ops[0].plan.nx, ops[0].plan.ny, ops[0].ndof
    P = len(ops)
    no_qA = [None] * P

    halo = exchange_halo
    if halo is None and P > 1:
        def halo(states):
            exchange(states, strips, nx)

    def advance_strips(qq, t0, dt, n_steps, t_end, srcs, bcs, bves):
        """The interval on the strip buffers qq (one per strip, on its
        device, halo rows included; srcs, bcs, bves: each strip's rain
        rows, wall values and boundary values, or Nones). Returns
        {q: buffers, t, cmax: per strip, bfa: per strip or None, asol:
        per strip buffer, aprim: per strip owned rows, atime}."""
        f = torch.float32

        def scalar(x, d):
            return torch.as_tensor(x, dtype=f, device=d)

        # one clock (dt, t_end, t) per device of the strips
        clocks = [[scalar(dt, d), scalar(t_end, d), scalar(t0, d)]
                  for d in uniq]
        cmax = [torch.zeros((), dtype=f, device=d) for d in devs]
        cidx = [torch.zeros((), dtype=torch.int32, device=d) for d in devs]
        parts = list(zip(ops, slot, srcs, bcs))
        bfa = asol = aprim = atime = None
        if accumulate:
            bfa = [None if o.bnd is None else
                   torch.zeros((ndof, b.shape[1]), dtype=f, device=d)
                   for o, b, d in zip(ops, bves, devs)]
            # strip buffers: their halo rows add up copies, never read
            asol = [torch.zeros_like(x) for x in qq]
            aprim = [torch.zeros((ndof, s.rows * nx), dtype=f, device=d)
                     for s, d in zip(strips, devs)]
            atime = torch.zeros((), dtype=f, device=devs[0])

        def step(states, dts, qA=None, **mode):
            if halo is not None:
                halo(states)
            return [o.step(x, dts[k], src=sr, bc_vals=bc, qA=a, **mode)
                    for (o, k, sr, bc), x, a in zip(parts, states,
                                                    qA or no_qA)]

        def outs(res):
            return [r.out for r in res]

        def beuler(o, u0, dt_i, src_s, bc):
            es3 = torch.zeros((3, ny, nx), dtype=f, device=u0.device)
            if src_s is not None:
                es3[0] = src_s

            def F_k(u):
                return o.step(u, dt_i, src=src_s, bc_vals=bc).out

            def F_l(u):
                rhs3, _ = lin_op.apply(u.reshape(3, ny, nx), dt_i, es3)
                return rhs3.reshape(3, -1)

            return newton_beuler_solve(F_k, F_l, u0, dt_i)

        def lin(a, b, w):  # a + b * w, strip by strip
            return [x + y * w[k] for x, y, k in zip(a, b, slot)]

        for _ in range(int(n_steps)):
            dts = [torch.clamp_min(torch.minimum(c[0], c[1] - c[2]), 0.0)
                   for c in clocks]
            if stages is not None:
                first = step(qq, dts, stage=stages[0], emit_prim=accumulate)
                qs = outs(first)
                for coeffs in stages[1:]:
                    qs = outs(step(qs, dts, stage=coeffs, qA=qq))
            elif scheme == "beuler":
                # the Courant diagnostic (and the primitives) of u^n
                first = step(qq, dts, emit_prim=accumulate)
                qs = [beuler(ops[0], qq[0], dts[0], srcs[0], bcs[0])]
            else:  # rk4 from rhs-mode launches
                first = step(qq, dts, emit_prim=accumulate)
                k1 = outs(first)
                hdt = [0.5 * x for x in dts]
                k2 = outs(step(lin(qq, k1, hdt), dts))
                k3 = outs(step(lin(qq, k2, hdt), dts))
                k4 = outs(step(lin(qq, k3, dts), dts))
                qs = [x + (dts[k] / 6.0) * (a + 2 * b + 2 * c + e)
                      for x, a, b, c, e, k in zip(qq, k1, k2, k3, k4, slot)]
            for o, r, k, m, i in zip(ops, first, slot, cmax, cidx):
                o.courant_max(r.cmax, dts[k], m, i)
            if accumulate:
                for p, (o, k, _, _) in enumerate(parts):
                    if bfa[p] is not None:
                        bfa[p][:3] += dts[k] * o.boundary_fluxes(
                            qq[p][:3], bves[p][:3])
                    asol[p] += dts[k] * qq[p]
                    aprim[p] += dts[k] * first[p].prim
                atime += dts[0]
            for c, x in zip(clocks, dts):
                c[2] = c[2] + x
            qq = qs
        return dict(q=qq, t=clocks[0][2], cmax=cmax, bfa=bfa, asol=asol,
                    aprim=aprim, atime=atime)

    def advance(q, t0, dt, n_steps, t_end, src=None, bc_vals=None,
                bv_edges=None):
        dev, f = q.device, torch.float32
        srcs = [None if src is None else
                src[s.row0:s.row0 + s.rows].to(d)
                for s, d in zip(strips, devs)]
        bcs = [strip_wall_values(bc_vals, s, ny, d)
               for s, d in zip(strips, devs)]
        bves = [None] * P
        if accumulate:
            bves = [None if o.bnd is None else
                    (bv_edges if o.bnd_idx is None
                     else bv_edges[:, o.bnd_idx.to(bv_edges.device)]).to(d)
                    for o, d in zip(ops, devs)]
        r = advance_strips(split_rows(q, strips, devs, nx), t0, dt,
                           n_steps, t_end, srcs, bcs, bves)
        bfa, asol, aprim = r["bfa"], r["asol"], r["aprim"]
        if accumulate:
            if all(b is None for b in bfa):
                bfa = None
            elif P == 1:
                bfa = bfa[0]
            else:  # each strip's edges into the raster's edge order
                whole = torch.zeros((ndof, bv_edges.shape[1]), dtype=f,
                                    device=dev)
                for o, b in zip(ops, bfa):
                    if b is not None:
                        whole[:, o.bnd_idx.to(dev)] = b.to(dev)
                bfa = whole
            asol = gather_rows(asol, strips, nx, dev)
            aprim = torch.cat([a.to(dev) for a in aprim], dim=1) if P > 1 \
                else aprim[0].to(dev)
        cmax = r["cmax"]
        return IntervalResult(
            q=gather_rows(r["q"], strips, nx, dev), t=r["t"].to(dev),
            max_courant=(cmax[0] if P == 1 else torch.stack(
                [m.to(dev) for m in cmax]).amax()),
            courant_edge=None, bflux_accum=bfa, accum_sol=asol,
            accum_prim=aprim, accum_time=r["atime"],
        )

    advance.strips = advance_strips
    return advance
