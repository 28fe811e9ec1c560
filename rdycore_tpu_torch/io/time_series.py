"""Time series: boundary-flux mass accounting + observation sites
(src/time_series.c).

- boundary_fluxes.dat: per output interval, for each boundary, the
  accumulated (sum over steps of dt * flux * edge_length) water/momentum
  fluxes through that boundary (time_series.c:298-393,464-506).
- observations.dat: solution sampled at chosen cells by natural id
  (time_series.c:119-251,395-448).

Across a mesh rebuild (AMR) the accumulators start again from zero on the
new mesh, as in the JAX package; `before_rebuild` writes the boundary
fluxes since the last line first, so that the lines still add up to the
whole run's fluxes (the JAX package's monitor keeps the old mesh's
accumulator and fails at its next line, ROADMAP fault 26).
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from ..simulation import Simulation


class TimeSeriesMonitor:
    def __init__(self, sim: "Simulation"):
        cfg = sim.config
        self.dir = os.path.join(cfg.config_dir, cfg.output.directory)
        os.makedirs(self.dir, exist_ok=True)
        self.bflux_interval = cfg.output.time_series.boundary_fluxes
        obs = cfg.output.time_series.observations
        self.obs_interval = obs.interval
        self.obs_cells = np.asarray(obs.sites.cells, dtype=np.int64)
        self.instantaneous = obs.time_sampling.instantaneous
        self.bflux_path = os.path.join(self.dir, "boundary_fluxes.dat")
        self.obs_path = os.path.join(self.dir, "observations.dat")
        self._bflux_written_header = False
        self._obs_written_header = False
        self._last_bflux_accum = np.zeros_like(sim.bflux_accum)
        self._last_bflux_step = sim.step

    def __call__(self, sim: "Simulation"):
        if self.bflux_interval and sim.step % self.bflux_interval == 0:
            self._write_boundary_fluxes(sim)
        if (
            self.obs_interval
            and len(self.obs_cells)
            and sim.step % self.obs_interval == 0
        ):
            self._write_observations(sim)

    def before_rebuild(self, sim: "Simulation"):
        """The mesh is about to be rebuilt: write the boundary fluxes of the
        steps since the last line; the next line counts from zero."""
        if self.bflux_interval and sim.step != self._last_bflux_step:
            self._write_boundary_fluxes(sim)
        self._last_bflux_accum = None

    def _write_boundary_fluxes(self, sim: "Simulation"):
        lens = sim.operator.arrays.bnd_len.cpu().numpy()
        last = self._last_bflux_accum
        delta = sim.bflux_accum - (0.0 if last is None else last)
        self._last_bflux_accum = sim.bflux_accum.copy()
        self._last_bflux_step = sim.step
        if not sim.is_writer:
            return
        with open(self.bflux_path, "a") as f:
            if not self._bflux_written_header:
                f.write("# time boundary water_flux x_momentum_flux y_momentum_flux\n")
                self._bflux_written_header = True
            for seg in sim.operator.segments:
                sl = slice(seg.start, seg.start + seg.count)
                w = float((delta[0, sl] * lens[sl]).sum())
                mx = float((delta[1, sl] * lens[sl]).sum())
                my = float((delta[2, sl] * lens[sl]).sum())
                f.write(f"{sim.t:.8e} {seg.name} {w:.8e} {mx:.8e} {my:.8e}\n")

    def _write_observations(self, sim: "Simulation"):
        nat = sim.get_natural_ids()
        order = np.argsort(nat)
        cells = order[self.obs_cells]  # natural id -> local index
        if self.instantaneous or sim.accum_time <= 0:
            sol = sim.get_solution()[:, cells]
        else:
            sol = sim.accum_sol[:, cells] / sim.accum_time
        if not sim.is_writer:
            return
        with open(self.obs_path, "a") as f:
            if not self._obs_written_header:
                f.write("# time cell h hu hv\n")
                self._obs_written_header = True
            for i, c in enumerate(self.obs_cells):
                f.write(
                    f"{sim.t:.8e} {int(c)} {sol[0, i]:.8e} {sol[1, i]:.8e} {sol[2, i]:.8e}\n"
                )
