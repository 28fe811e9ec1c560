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

Adaptive dt stays *between* intervals, on the host (`adapt_timestep`),
exactly like the reference (rdyadvance.c:303-343).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .operator import RHSResult, SWEOperator

TEMPORAL_EULER = "euler"
TEMPORAL_RK4 = "rk4"
TEMPORAL_SSPRK2 = "ssprk2"
TEMPORAL_SSPRK3 = "ssprk3"

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


def make_interval_advancer(
    op: SWEOperator,
    scheme: str = TEMPORAL_EULER,
    accumulate: bool = True,
    ext_sources: bool = True,
):
    """Build a function advancing one coupling interval.

    accumulate=False drops the per-step time-averaged/boundary-flux
    accumulators; zero-valued ones are still returned for a stable result
    shape. ext_sources=False skips the external-source stream (the caller
    guarantees it is zero).

    Returns advance(q, t0, dt, n_steps, t_end, bnd_values, ext_src)
    -> IntervalResult, all of it on q's device.
    """
    if scheme not in (TEMPORAL_EULER, TEMPORAL_SSPRK2, TEMPORAL_SSPRK3,
                      TEMPORAL_RK4):
        raise NotImplementedError(
            f"temporal scheme '{scheme}' is not ported yet (ROADMAP queue 1 "
            "item 13: IMEX and implicit schemes)"
        )
    stages = _FUSED_STEP_STAGES.get(scheme)
    Ei, E = op.num_internal_edges, op.num_edges

    def advance(q, t0, dt, n_steps: int, t_end, bnd_values, ext_src):
        dev, dtype = q.device, q.dtype

        def scalar(x):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        dt, t_end, tt = scalar(dt), scalar(t_end), scalar(t0)
        cmax = torch.zeros((), dtype=dtype, device=dev)
        cedge = torch.zeros((), dtype=torch.int32, device=dev)
        bfa = torch.zeros((op.ndof, max(op.num_boundary_edges, 1)),
                          dtype=dtype, device=dev)
        asol = torch.zeros_like(q)
        aprim = torch.zeros_like(q)
        atime = torch.zeros((), dtype=dtype, device=dev)
        es = ext_src if ext_sources else None
        qq = q

        for _ in range(int(n_steps)):
            dt_i = torch.clamp(torch.minimum(dt, t_end - tt), min=0.0)
            if stages is not None:
                flux, courant = op.fluxes(qq, bnd_values, dt_i)
                op.courant_max(courant, dt_i, cmax, cedge)
                out1 = op.cell_stage(flux, qq, dt_i, es, stage=stages[0],
                                     emit_prim=accumulate)
                qs = out1.q_out
                for coeffs in stages[1:]:
                    flux_s, _ = op.fluxes(qs, bnd_values, dt_i)
                    qs = op.cell_stage(flux_s, qs, dt_i, es, stage=coeffs,
                                       qA=qq).q_out
                fb, prim = flux[:, Ei:E], out1.prim
            else:
                def rhs_fn(q_s, t_s, dt_s):
                    return op.apply(q_s, dt_s, bnd_values, es)

                q_new, r1 = _rk4_step(rhs_fn, qq, tt, dt_i)
                step_courant = r1.max_courant_per_dt * dt_i
                bigger = step_courant > cmax
                cmax = torch.where(bigger, step_courant, cmax)
                cedge = torch.where(bigger, r1.courant_edge, cedge)
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
            accum_time=atime,
        )

    return advance


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
