"""Explicit time integration over one coupling interval.

The counterpart of rdycore_tpu/timestepping.py for euler, ssprk2, ssprk3
and rk4. The JAX package runs an interval as one jitted `lax.fori_loop`;
here it is a Python loop of kernel launches that never reads a device value
back to the host: dt_i, the time, the Courant maximum and its edge, and the
accumulators all stay on the device until the interval ends. The last step
is shortened to land exactly on the interval end, with the time
accumulated in the state dtype (timestepping.py:325-326).

euler/ssprk2/ssprk3 run in stage mode, the counterpart of the JAX
package's fused full-step tier (`_advance_fused_step`): each stage is one
edge-flux launch and one cell-stage launch computing
q_out = alpha*q^n + beta*(q_s + dt*F(q_s)) with (alpha, beta, gamma) from
`_FUSED_STEP_STAGES`. rk4 goes through `SWEOperator.apply` (the cell
kernel's rhs mode) and `_rk4_step`.

A second-order operator keeps stage mode: its edge phase (`SWEOperator.
fluxes`) puts the gradient kernel in front of the edge launch and the
positivity kernels behind it. The JAX package runs such an operator
through `_rk_step` and `apply` instead (its fused step takes first order
only, timestepping.py:285-296); both give every stage's positivity limiter
the step's full dt_i, rk4's half-steps included (timestepping.py:333-334).
A well-balanced operator keeps stage mode too: its edge phase puts K5 in
front of every K1a launch under BS2002 (once per stage), and K1a and K1b
run in their HR modes under hydrostatic reconstruction; the JAX package
keeps such operators off its fused step (timestepping.py:294-295).

The state has ndof = 3 + num_tracers rows, and so do the boundary-flux
accumulator and the stage kernels' outputs: unlike the JAX package, whose
fused tier computes no tracer boundary fluxes and falls back to its
two-kernel tier when accumulating (timestepping.py:285-297), stage mode
keeps every row.

ark_imex (ARS(2,2,2), `_ark_imex_step`) and beuler (backward Euler by
matrix-free Newton-GMRES, `_beuler_step` and `newton_beuler_solve`) go
through `SWEOperator.apply` and `SWEOperator.rhs`, so their residuals run
on the kernels in every operator mode. beuler takes its Jacobian-vector
products by forward-mode AD (`jvp`, `torch.autograd.forward_ad`) through
the operator's linearization twin (`operator.linearization_twin`, its
kernels' plain versions), where the JAX package differentiates its XLA
twin (timestepping.py:270-278). Neither reads a device value back inside
the interval: the Newton iterations, the GMRES cycle, its least-squares
solve and the line search are a fixed sequence of device operations.

Adaptive dt stays *between* intervals, on the host (`adapt_timestep`),
exactly like the reference (rdyadvance.c:303-343).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
from typing import Callable, NamedTuple, Optional

import torch
import torch.autograd.forward_ad as fwAD

from .operator import RHSResult, SWEOperator, linearization_twin
from .ops.swe.sources import SOURCE_NONE, friction_implicit_stage_solve

TEMPORAL_EULER = "euler"
TEMPORAL_RK4 = "rk4"
TEMPORAL_SSPRK2 = "ssprk2"
TEMPORAL_SSPRK3 = "ssprk3"
TEMPORAL_ARK_IMEX = "ark_imex"
TEMPORAL_BEULER = "beuler"
SCHEMES = (TEMPORAL_EULER, TEMPORAL_SSPRK2, TEMPORAL_SSPRK3, TEMPORAL_RK4,
           TEMPORAL_ARK_IMEX, TEMPORAL_BEULER)

# ARS(2,2,2) additive RK coefficients (Ascher, Ruuth & Spiteri 1997 2.6)
ARS222_GAMMA = 1.0 - 0.5 * 2.0**0.5
ARS222_DELTA = 1.0 - 1.0 / (2.0 * ARS222_GAMMA)
# beuler: Newton iterations per step and the GMRES cycle's Krylov size
NEWTON_ITERS = 6
KRYLOV_M = 16

# stage tables: each stage computes
# q_out = alpha * q^n + beta * q_stage + gfac * dt * F(q_stage)
_FUSED_STEP_STAGES = {
    TEMPORAL_EULER: ((0.0, 1.0, 1.0),),
    TEMPORAL_SSPRK2: ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5)),
    TEMPORAL_SSPRK3: (
        (0.0, 1.0, 1.0), (0.75, 0.25, 0.25), (1.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0),
    ),
}


class IntervalResult(NamedTuple):
    q: torch.Tensor  # [ndof, C] final state
    t: torch.Tensor  # final time (seconds)
    max_courant: torch.Tensor  # max Courant number over the interval
    courant_edge: torch.Tensor  # edge index achieving it
    bflux_accum: torch.Tensor  # [ndof, Eb] sum of dt * boundary flux
    accum_sol: torch.Tensor  # [ndof, C] sum of dt * q (time-averaged output)
    accum_prim: torch.Tensor  # [ndof, C] sum of dt * primitives
    accum_time: torch.Tensor  # total time accumulated
    # with an exchange hook: the step (0-based) whose Courant number is
    # max_courant, for the shards' MAXLOC (parallel/sharded.py)
    courant_step: Optional[torch.Tensor] = None


def _rk4_step(rhs_fn: Callable, q, t, dt):
    """One classical RK4 step (the rk4 branch of the JAX package's
    `_rk_step`; the other schemes run in stage mode). rhs_fn(q, t, dt) ->
    RHSResult. Returns the new q and the first-stage RHSResult, whose
    Courant and boundary fluxes feed the diagnostics."""
    r1: RHSResult = rhs_fn(q, t, dt)
    r2 = rhs_fn(q + 0.5 * dt * r1.rhs, t + 0.5 * dt, dt)
    r3 = rhs_fn(q + 0.5 * dt * r2.rhs, t + 0.5 * dt, dt)
    r4 = rhs_fn(q + dt * r3.rhs, t + dt, dt)
    q_new = q + (dt / 6.0) * (r1.rhs + 2.0 * r2.rhs + 2.0 * r3.rhs + r4.rhs)
    return q_new, r1


def _ark_imex_step(op: SWEOperator, q, dt, bv, es, mannings_n):
    """One ARS(2,2,2) additive IMEX-RK step (rdycore_tpu/timestepping.py:
    60-80): explicit fluxes, bed slope and external sources from the
    friction-free operator `op` (source_method SOURCE_NONE), implicit
    Manning friction solved per cell in closed form at each DIRK stage
    (`friction_implicit_stage_solve`). Returns the new q and the first
    `apply`'s RHSResult, whose Courant number, boundary fluxes and
    primitives feed the diagnostics. The second explicit evaluation takes
    the rhs alone (`op.rhs`: no Courant reduction, no primitives)."""
    g_, d_ = ARS222_GAMMA, ARS222_DELTA
    r1 = op.apply(q, dt, bv, es)
    fe0 = r1.rhs
    # stage 1: U1 = u^n + dt*g*F_E(u^n) + dt*g*F_I(U1)
    U1, fi1 = friction_implicit_stage_solve(q + dt * g_ * fe0, mannings_n,
                                            dt * g_, op.tiny_h)
    # stage 2: U2 = u^n + dt*(d*F_E(u^n) + (1-d)*F_E(U1))
    #               + dt*((1-g)*F_I(U1) + g*F_I(U2))
    fe1 = op.rhs(U1, dt, bv, es)
    m2 = q + dt * (d_ * fe0 + (1.0 - d_) * fe1) + dt * (1.0 - g_) * fi1
    q_new, _ = friction_implicit_stage_solve(m2, mannings_n, dt * g_,
                                             op.tiny_h)
    return q_new, r1


def _beuler_step(op: SWEOperator, lin_op: SWEOperator, q, dt, bv, es,
                 gdot: Optional[Callable] = None):
    """One backward-Euler step (rdycore_tpu/timestepping.py:83-119): R(u) =
    u - u^n - dt*F(u) driven to zero by `newton_beuler_solve`, F the
    operator's rhs on the kernels, its JVPs through `lin_op` (the
    linearization twin), its inner products `gdot`. Returns the new q and
    the first `apply`'s RHSResult (the step's diagnostics, at u^n)."""
    r1 = op.apply(q, dt, bv, es)
    q_new = newton_beuler_solve(
        lambda u: op.rhs(u, dt, bv, es),
        lambda u: lin_op.rhs(u, dt, bv, es), q, dt, gdot)
    return q_new, r1


_LEVEL_LOCK = threading.Lock()
_LEVEL_USERS = [0]


@contextlib.contextmanager
def shared_dual_level():
    """A forward-mode AD level shared by the threads of this process:
    PyTorch holds one level at a time in a process, so shards stepped in
    threads (one per card, parallel/comm.LocalTransport) could not each
    enter their own. The first thread in opens it, the last out closes
    it."""
    with _LEVEL_LOCK:
        if _LEVEL_USERS[0] == 0:
            fwAD.enter_dual_level()
        _LEVEL_USERS[0] += 1
    try:
        yield
    finally:
        with _LEVEL_LOCK:
            _LEVEL_USERS[0] -= 1
            if _LEVEL_USERS[0] == 0:
                fwAD.exit_dual_level()


def jvp(F: Callable, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """J v, J the Jacobian of F at u, by forward-mode AD: the tangent of
    F on the dual tensor (u, v). The same tangent as torch.func.jvp(F,
    (u,), (v,))[1], through `torch.autograd.forward_ad` directly, which
    spends a quarter less host time per operation."""
    with shared_dual_level():
        return fwAD.unpack_dual(F(fwAD.make_dual(u, v))).tangent


def lstsq_min_norm(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The minimum-norm least-squares solution x of H x = b for GMRES's
    (m + 1) x m upper Hessenberg H, by Givens rotations and back
    substitution in plain tensor operations on H's device: the answer of
    jnp.linalg.lstsq (SVD, singular values below eps * max(H's shape) *
    sigma_max taken as zero), without torch.linalg.svd's read-back of its
    error code on CUDA. Arnoldi's Hessenberg is rank-deficient only where
    it broke down (a zero residual, an exact Krylov space): every column
    after the breakdown is zero, so its pivot is exactly zero, while every
    other pivot lies between H's smallest and largest singular values. A
    pivot below eps * max(H's shape) * the largest pivot is taken as zero
    and its unknown set to zero, which is the minimum-norm answer there."""
    m = H.shape[1]
    rows, g = list(H), list(b)
    for j in range(m):
        a, c_ = rows[j][j], rows[j + 1][j]
        r = torch.hypot(a, c_)
        nz = r > 0.0
        r_safe = torch.where(nz, r, 1.0)
        cos = torch.where(nz, a / r_safe, 1.0)
        sin = torch.where(nz, c_ / r_safe, 0.0)
        rows[j], rows[j + 1] = (cos * rows[j] + sin * rows[j + 1],
                                cos * rows[j + 1] - sin * rows[j])
        g[j], g[j + 1] = (cos * g[j] + sin * g[j + 1],
                          cos * g[j + 1] - sin * g[j])
    piv = torch.stack([rows[j][j] for j in range(m)])
    cut = torch.finfo(H.dtype).eps * max(H.shape) * piv.abs().max()
    keep = piv.abs() > cut
    piv_safe = torch.where(keep, piv, 1.0)
    x = [None] * m
    for j in reversed(range(m)):
        acc = g[j]
        if j + 1 < m:
            acc = acc - torch.dot(rows[j][j + 1:], torch.stack(x[j + 1:]))
        x[j] = torch.where(keep[j], acc / piv_safe[j], 0.0)
    return torch.stack(x)


def newton_beuler_solve(F: Callable, F_lin: Callable, q: torch.Tensor,
                        dt, gdot: Optional[Callable] = None) -> torch.Tensor:
    """Newton-GMRES core of the backward-Euler step
    (rdycore_tpu/timestepping.py:122-188): drives R(u) = u - q - dt*F(u)
    to zero from u = q with NEWTON_ITERS Newton iterations, each one
    GMRES(KRYLOV_M) cycle (modified Gram-Schmidt Arnoldi, global inner
    products) on (I - dt*J) du = -R, J v by forward-mode AD through F_lin
    (`jvp`), then backtracking over alpha in (1, 1/2, 1/4) that keeps the
    candidate of least residual norm (a NaN norm compares False, so a
    diverged candidate is dropped). Shared by the unstructured path and
    the raster (`ops/structured.make_fused_structured_stepper`). Every
    branch is a torch.where: nothing is read back to the host. The sizes
    are read at the call (the JAX package's 6 and 16). gdot(a, b) is the
    global inner product, torch.sum(a * b) by default; a shard passes its
    own (parallel/sharded.ShardedSWE.gdot: the owned columns, then a
    global sum), the same scalar on every shard, so that every shard
    takes the same line-search branch."""
    newton_iters, krylov_m = NEWTON_ITERS, KRYLOV_M
    if gdot is None:
        def gdot(a, b):
            return torch.sum(a * b)

    def res_norm(u):
        R = u - q - dt * F(u)
        return R, torch.sqrt(gdot(R, R))

    def gmres(Av, b):
        beta = torch.sqrt(gdot(b, b))
        V = [b / torch.where(beta > 0.0, beta, 1.0)]
        cols = []
        for j in range(krylov_m):
            w = Av(V[j])
            col = []
            for i in range(j + 1):
                hij = gdot(w, V[i])
                col.append(hij)
                w = w - hij * V[i]
            hn = torch.sqrt(gdot(w, w))
            col.append(hn)
            cols.append(torch.stack(
                col + [hn.new_zeros(())] * (krylov_m - 1 - j)))
            V.append(w / torch.where(hn > 0.0, hn, 1.0))
        H = torch.stack(cols, dim=1)  # [m + 1, m]
        e1 = torch.cat([beta[None], beta.new_zeros(krylov_m)])
        y = lstsq_min_norm(H, e1)
        dq = V[0] * y[0]
        for j in range(1, krylov_m):
            dq = dq + y[j] * V[j]
        return dq

    u = q
    for _ in range(newton_iters):
        R, rn = res_norm(u)

        def Av(v, u=u):
            return v - dt * jvp(F_lin, u, v)

        dq = gmres(Av, -R)
        best_q, best_n = u, rn
        for alpha in (1.0, 0.5, 0.25):
            q_c = u + alpha * dq
            _, n_c = res_norm(q_c)
            take = n_c < best_n
            best_q = torch.where(take, q_c, best_q)
            best_n = torch.where(take, n_c, best_n)
        u = best_q
    return u


def make_interval_advancer(
    op: SWEOperator,
    scheme: str = TEMPORAL_EULER,
    bc_fn: Optional[Callable] = None,
    src_fn: Optional[Callable] = None,
    accumulate: bool = True,
    ext_sources: bool = True,
    exchange: Optional[Callable[[torch.Tensor], None]] = None,
    gdot: Optional[Callable] = None,
):
    """Build a function advancing one coupling interval.

    bc_fn(t) -> [ndof, Eb] Dirichlet values (in the operator's segment
    order) and src_fn(t) -> [ndof, C] external sources take the place of
    the interval's bnd_values and ext_src, evaluated once a step at the
    half-step time t + dt_i / 2 (dt_i the step's, already clamped to the
    interval's end) and held over the step's stages: the MMS driver's
    analytic forcing, as the reference re-applies it in a TS PreStep hook
    (rdymms.c:139-151) and the JAX package inside its step loop
    (timestepping.py:227-243). Each is called with a 0-d tensor on q's
    device and must read nothing back to the host.

    accumulate=False drops the per-step time-averaged/boundary-flux
    accumulators; zero-valued ones are still returned for a stable result
    shape. ext_sources=False skips the external-source stream (the caller
    guarantees it is zero; src_fn overrides it).

    exchange(q) is the one hook of a shard's loop (parallel/sharded.py): it
    fills the ghost rows of a stage's state q in place before every edge
    phase of the operator (each stage of every scheme; rk4's and
    ark_imex's evaluations alike). With it the result also carries
    `courant_step`, the step of the Courant maximum, so that the shards'
    maxima combine into the single-device one and its edge. gdot(a, b),
    beuler's global inner product (`newton_beuler_solve`), is a shard's
    other hook.

    Returns advance(q, t0, dt, n_steps, t_end, bnd_values, ext_src)
    -> IntervalResult, all of it on q's device.
    """
    if scheme not in SCHEMES:
        raise ValueError(f"unknown temporal scheme '{scheme}'")
    stages = _FUSED_STEP_STAGES.get(scheme)
    base_op = op
    if scheme == TEMPORAL_ARK_IMEX:
        # the explicit part has no friction: the DIRK stages own it. Tracer
        # rows advance explicitly (the friction solve passes them through)
        base_op = dataclasses.replace(op, source_method=SOURCE_NONE)
    track = exchange is not None
    # the twin is built from the unwrapped operator (it rebuilds it from
    # its dataclass fields, which would drop the exchange), then wrapped
    lin_op = linearization_twin(op) if scheme == TEMPORAL_BEULER else None
    if track:
        op, base_op = (with_exchange(o, exchange) for o in (op, base_op))
        if lin_op is not None:
            lin_op = with_exchange(lin_op, exchange)

    def step(q, t, dt, bv, es):
        """(q_new, the first apply's RHSResult) of an rk4, ark_imex or
        beuler step."""
        if scheme == TEMPORAL_ARK_IMEX:
            return _ark_imex_step(base_op, q, dt, bv, es,
                                  op.arrays.mannings_n)
        if scheme == TEMPORAL_BEULER:
            return _beuler_step(op, lin_op, q, dt, bv, es, gdot)
        return _rk4_step(lambda q_s, t_s, dt_s: op.apply(q_s, dt_s, bv, es),
                         q, t, dt)

    Ei, E = op.num_internal_edges, op.num_edges

    def advance(q, t0, dt, n_steps: int, t_end, bnd_values, ext_src):
        dev, dtype = q.device, q.dtype

        def scalar(x):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        dt, t_end, tt = scalar(dt), scalar(t_end), scalar(t0)
        cmax = torch.zeros((), dtype=dtype, device=dev)
        cedge = torch.zeros((), dtype=torch.int32, device=dev)
        cstep = cedge.clone() if track else None
        bfa = torch.zeros((op.ndof, max(op.num_boundary_edges, 1)),
                          dtype=dtype, device=dev)
        asol = torch.zeros_like(q)
        aprim = torch.zeros_like(q)
        atime = torch.zeros((), dtype=dtype, device=dev)
        bv = bnd_values
        es = ext_src if ext_sources else None
        qq = q

        for i in range(int(n_steps)):
            dt_i = torch.clamp(torch.minimum(dt, t_end - tt), min=0.0)
            if bc_fn is not None or src_fn is not None:
                # the step's forcing, frozen across its stages
                t_half = tt + 0.5 * dt_i
                if bc_fn is not None:
                    bv = bc_fn(t_half)
                if src_fn is not None:
                    es = src_fn(t_half)
            if stages is not None:
                flux, courant = op.fluxes(qq, bv, dt_i)
                prev = cmax.clone() if track else None
                op.courant_max(courant, dt_i, cmax, cedge)
                if track:
                    cstep = torch.where(cmax > prev, i, cstep)
                out1 = op.cell_stage(flux, qq, dt_i, es, stage=stages[0],
                                     emit_prim=accumulate)
                qs = out1.q_out
                for coeffs in stages[1:]:
                    flux_s, _ = op.fluxes(qs, bv, dt_i)
                    qs = op.cell_stage(flux_s, qs, dt_i, es, stage=coeffs,
                                       qA=qq).q_out
                fb, prim = flux[:, Ei:E], out1.prim
            else:
                q_new, r1 = step(qq, tt, dt_i, bv, es)
                step_courant = r1.max_courant_per_dt * dt_i
                bigger = step_courant > cmax
                cmax = torch.where(bigger, step_courant, cmax)
                cedge = torch.where(bigger, r1.courant_edge, cedge)
                if track:
                    cstep = torch.where(bigger, i, cstep)
                # a step past t_end (dt_i == 0) leaves the state unchanged
                qs = torch.where(dt_i > 0.0, q_new, qq)
                fb, prim = r1.boundary_fluxes, r1.prim
            if accumulate:
                if op.num_boundary_edges:
                    bfa += dt_i * fb
                asol += dt_i * qq
                aprim += dt_i * prim
                atime += dt_i
            tt = tt + dt_i
            qq = qs

        return IntervalResult(
            q=qq, t=tt, max_courant=cmax, courant_edge=cedge,
            bflux_accum=bfa, accum_sol=asol, accum_prim=aprim,
            accum_time=atime, courant_step=cstep,
        )

    return advance


def with_exchange(op: SWEOperator, exchange: Callable) -> SWEOperator:
    """A shallow copy of a shard's operator (its class kept, so a
    linearization twin stays one) whose edge phase `fluxes`, which
    `apply`, `rhs` and stage mode all go through, first fills the ghost
    rows of q in place by exchange(q)."""
    out = copy.copy(op)
    inner = op.fluxes

    def fluxes(q, boundary_values, dt):
        exchange(q)
        return inner(q, boundary_values, dt)

    out.fluxes = fluxes
    return out


def adapt_timestep(
    dt: float,
    max_courant: float,
    target_courant: float,
    max_increase_factor: float,
    coupling_interval: float,
) -> float:
    """Host-side adaptive dt between coupling intervals (rdyadvance.c:303-343)."""
    if max_courant <= 0.0:
        return dt
    if max_courant < target_courant:
        factor = min(target_courant / max_courant, max_increase_factor)
        dt = dt * factor
        if dt > coupling_interval:
            dt = coupling_interval
    else:
        dt = dt * (target_courant / max_courant)
    return dt
