"""Ensembles: one program, several simulations.

The counterpart of rdycore_tpu/ensemble.py. The reference splits
MPI_COMM_WORLD into equal member communicators and overrides
grid/materials/conditions per member (src/ensemble.c; per-member output
subdirectories rdyadvance.c:15-28). Here:

- each member is its own `Simulation` with its own advancer, on its own
  device: member i on cuda:i when there are as many cards as members,
  else every member on the entry point's device, or where `devices=`
  puts them (the JAX package's `_member_mesh`, ensemble.py:84-89)
- members sharing one grid file advance together: every member's
  interval is launched before any is read back, then each is read back
  once, so members on different cards overlap. They step with member 0's
  dt, step count and end time, each member's dt adapted from its own
  Courant number first (ROADMAP fault 25, as the JAX package does); the
  advancer is built as the JAX package builds it (the deck's temporal
  scheme, the accumulators and the source stream on), so a raster deck's
  members run the unstructured operator, as there
- members with distinct grids run as independent Simulations

Per-member outputs land in '<output>/<member_name or member_N>/'.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
from typing import List, Optional, Sequence

import torch

from .config.schema import Config, ConfigError
from .device import DeviceLike, resolve_device
from .simulation import Simulation, load_mesh_file
from .timestepping import adapt_timestep, make_interval_advancer


def member_config(config: Config, index: int) -> Config:
    """Apply ensemble member overrides (ConfigureEnsembleMember,
    ensemble.c:19-83)."""
    member = config.ensemble.members[index]
    cfg = copy.deepcopy(config)
    cfg.ensemble = dataclasses.replace(cfg.ensemble, size=0, members=[])
    if member.grid is not None and member.grid.file:
        cfg.grid = member.grid
    for override_list, target in (
        (member.materials, cfg.materials),
        (member.flow_conditions, cfg.flow_conditions),
        (member.sediment_conditions, cfg.sediment_conditions),
        (member.salinity_conditions, cfg.salinity_conditions),
        (member.temperature_conditions, cfg.temperature_conditions),
    ):
        for ov in override_list:
            replaced = False
            for i, item in enumerate(target):
                if item.name == ov.name:
                    target[i] = ov
                    replaced = True
            if not replaced:
                target.append(ov)
    name = member.name or f"member_{index}"
    cfg.output.directory = os.path.join(config.output.directory, name)
    return cfg


def member_devices(size: int, device: DeviceLike = None,
                   devices: Optional[Sequence[DeviceLike]] = None
                   ) -> List[torch.device]:
    """Where the members go: `devices` (one per member) when given; else
    member i on cuda:i when the entry point runs on CUDA and there are at
    least `size` cards; else every member on the entry point's device."""
    if devices is not None:
        if len(devices) != size:
            raise ValueError(f"devices names {len(devices)} devices for an "
                             f"ensemble of {size} members")
        return [resolve_device(d) for d in devices]
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= size:
        return [torch.device("cuda", i) for i in range(size)]
    return [dev] * size


class EnsembleSimulation:
    """Runs all ensemble members. Members sharing the grid file advance
    together (`shared_grid`, the JAX package's `vmapped`); others run as
    independent Simulations."""

    def __init__(self, config: Config, device: DeviceLike = None,
                 devices: Optional[Sequence[DeviceLike]] = None):
        if not config.ensemble.size:
            raise ConfigError("config has no ensemble section")
        self.size = config.ensemble.size
        self.devices = member_devices(self.size, device, devices)
        configs = [member_config(config, i) for i in range(self.size)]
        self.shared_grid = len({c.grid.file for c in configs}) == 1
        # a grid section that all members share is read once; each member
        # gets its own Mesh object over its arrays (setup replaces the
        # elevations' arrays, it writes none in place)
        mesh = None
        if all(c.grid == configs[0].grid for c in configs):
            mesh = load_mesh_file(config.resolve_path(config.grid.file))
        self.members: List[Simulation] = [
            Simulation(c, device=d, mesh=None if mesh is None
                       else dataclasses.replace(mesh))
            for c, d in zip(configs, self.devices)
        ]
        self._advancers = None

    @property
    def finished(self) -> bool:
        return all(m.finished for m in self.members)

    def advance(self):
        if not self.shared_grid:
            for m in self.members:
                if not m.finished:
                    m.advance()
            return
        self._advance_shared()

    def _advance_shared(self):
        """One coupling interval of every member on member 0's schedule
        (the JAX package's `_advance_vmapped`): launch all, then read each
        back once."""
        ms = self.members
        m0 = ms[0]
        cfg = m0.config

        ta = cfg.time.adaptive
        if ta.enable:
            for m in ms:
                if m.prev_max_courant is not None:
                    m.dt = adapt_timestep(
                        m.dt, m.prev_max_courant, ta.target_courant_number,
                        ta.max_increase_factor, m.coupling_interval,
                    )
        # members share dt/schedule (same config time section)
        dt = m0.dt
        t_end = min(m0.t + m0.coupling_interval, m0.t_final)
        n_steps = max(1, int(math.ceil((t_end - m0.t) / dt - 1e-12)))
        if m0.max_steps is not None:
            n_steps = min(n_steps, m0.max_steps - m0.step)
            t_end = min(t_end, m0.t + n_steps * dt)

        if self._advancers is None:
            self._advancers = [
                make_interval_advancer(m.operator, cfg.numerics.temporal)
                for m in ms]
        results = [
            adv(m.q, m0.t, dt, n_steps, t_end, m.boundary_values, m.ext_src)
            for adv, m in zip(self._advancers, ms)]
        # one read-back per member: the scalars and the accumulators
        packed = [torch.cat([torch.stack([r.t, r.max_courant, r.accum_time]),
                             r.bflux_accum.flatten(), r.accum_sol.flatten(),
                             r.accum_prim.flatten()])
                  for r in results]
        for m, r, flat in zip(ms, results, packed):
            host = flat.cpu().numpy()
            n_b, n_c = r.bflux_accum.numel(), r.accum_sol.numel()
            m.q = r.q
            m.t = float(host[0])
            m.step += int(n_steps)
            m.prev_max_courant = float(host[1])
            m.accum_time += float(host[2])
            # summed in float64 on the host, as Simulation.advance sums them
            m.bflux_accum += host[3:3 + n_b].reshape(m.bflux_accum.shape)
            m.accum_sol += host[3 + n_b:3 + n_b + n_c].reshape(
                m.accum_sol.shape)
            m.accum_prim += host[3 + n_b + n_c:].reshape(m.accum_prim.shape)
            for mon in m._monitors:
                mon(m)

    def run(self):
        while not self.finished:
            self.advance()
