"""Profiling / timing harness.

The counterpart of rdycore_tpu/profiling.py. The reference instruments
every operator apply with PETSc logging events and GPU timers
(`RDY_CeedOperatorApp`, operator.c:148-151) and offers a `-preload`
warm-up step so that cold-start cost does not pollute timings
(rdyadvance.c:240-257). Here:

- `preload(sim)`: run one throwaway coupling interval to warm the path,
  then restore everything it changed, so that later advances measure
  steady-state throughput
- `StepTimer`: per-interval wall times with the first (warm-up) interval
  split out; cell-updates/s summary. `Simulation.advance` reads the
  device back once per monitor chunk, so each interval's wall time holds
  its device work
- `trace(logdir)`: context manager around `torch.profiler` (CPU and, on a
  CUDA machine, CUDA activities) writing a Chrome trace into `logdir`
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import List, Optional

import torch


def preload(sim) -> float:
    """Warm the advance path without perturbing the simulation: one
    coupling interval, then q (a clone: a later kernel may write in place),
    t, step, dt, the last Courant number and its edge, the four
    accumulators and the monitors are put back as they were. Returns the
    warm-up's wall seconds. On a CUDA device they include loading the
    kernels, and building them with nvcc where no build of their sources
    is cached yet (tens of seconds)."""
    state = (sim.q.clone(), sim.t, sim.step, sim.dt, sim.prev_max_courant,
             sim.prev_courant_edge)
    accum = (
        sim.bflux_accum.copy(),
        sim.accum_sol.copy(),
        sim.accum_prim.copy(),
        sim.accum_time,
    )
    monitors = sim._monitors
    sim._monitors = []
    t0 = time.time()
    try:
        sim.advance()
    finally:
        elapsed = time.time() - t0
        (sim.q, sim.t, sim.step, sim.dt, sim.prev_max_courant,
         sim.prev_courant_edge) = state
        (sim.bflux_accum, sim.accum_sol, sim.accum_prim,
         sim.accum_time) = accum
        sim._monitors = monitors
    return elapsed


class StepTimer:
    """Attach as a monitor: records wall time of every coupling interval."""

    def __init__(self, sim):
        self.sim = sim
        self.times: List[float] = []
        self.steps: List[int] = []
        self._t0 = time.time()
        self._last_step = sim.step

    def __call__(self, sim):
        now = time.time()
        self.times.append(now - self._t0)
        self.steps.append(sim.step - self._last_step)
        self._t0 = now
        self._last_step = sim.step

    def summary(self) -> dict:
        if not self.times:
            return {}
        # the first interval includes the warm-up
        steady_t = self.times[1:] or self.times
        steady_s = self.steps[1:] or self.steps
        total_steps = sum(steady_s)
        total_time = sum(steady_t)
        ups = (
            total_steps * self.sim.num_cells / total_time if total_time else 0.0
        )
        return {
            "compile_interval_s": self.times[0],
            "steady_intervals": len(steady_t),
            "steady_seconds": total_time,
            "steady_steps": total_steps,
            "cell_updates_per_s": ups,
        }


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Device trace through torch.profiler: CPU activities, and CUDA's
    where a card is present; on exit the Chrome trace (chrome://tracing,
    Perfetto) is written to `<logdir>/trace.json`. `logdir` defaults to
    rdycore_tpu_torch_trace under the temporary directory."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "rdycore_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
