"""The Simulation object: the RDy lifecycle on one device.

The counterpart of rdycore_tpu/simulation.py for the first-order,
flow-only, single-device paths: unstructured, and the uniform raster
(`edge_flux_backend: structured` or `fused_structured`) (the reference's
RDy object, src/rdycore.c, src/rdysetup.c, src/rdyadvance.c):

    sim = Simulation(load_config("case.yaml"))  # RDyCreate + RDySetup
    while not sim.finished:                     # while (!RDyFinished(rdy))
        sim.advance()                           #   RDyAdvance(rdy)

plus the E3SM-style coupling surface (src/rdydata.c): get/set arrays in
natural cell order between coupling intervals.

It runs on the CUDA device unless built with device="cpu". Every feature
outside these paths raises NotImplementedError naming the ROADMAP item
that will port it, or the JAX package's own ConfigError where that package
refuses it too; nothing degrades silently.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .config.expressions import compile_expression
from .config.schema import Config, ConfigError, time_from_seconds, time_to_seconds
from .constants import N_FLOW_DOF
from .device import DeviceLike, device_name, resolve_device
from .io.petsc_binary import read_petsc_vec
from .logging_ import Logger
from .mesh.core import Mesh, load_mesh_npz
from .operator import SWEOperator, build_operator
from .ops.kernels.raster_step import StructuredPlan
from .ops.structured import (
    FUSED_SCHEMES,
    STRUCTURED_SCHEMES,
    FusedStructuredOperator,
    boundary_edge_arrays,
    build_structured_operator,
    detect_uniform_raster,
    make_fused_structured_stepper,
    make_structured_stepper,
)
from .ops.swe import boundary as bc_mod
from .ops.swe.sources import SOURCE_IMPLICIT_XQ2018, SOURCE_SEMI_IMPLICIT
from .timestepping import adapt_timestep, make_interval_advancer

# raster wall -> its outward normal (cn, sn)
_WALL_NORMALS = {"left": (-1, 0), "right": (1, 0), "bottom": (0, -1),
                 "top": (0, 1)}

_BC_CODES = {
    "dirichlet": bc_mod.BC_DIRICHLET,
    "reflecting": bc_mod.BC_REFLECTING,
    "critical-outflow": bc_mod.BC_CRITICAL_OUTFLOW,
}

_SOURCE_CODES = {
    "semi_implicit": SOURCE_SEMI_IMPLICIT,
    "implicit_xq2018": SOURCE_IMPLICIT_XQ2018,
}


def _not_ported(feature: str, item: str):
    raise NotImplementedError(
        f"{feature} is not ported to rdycore_tpu_torch yet (ROADMAP {item})"
    )


def check_slice(config: Config) -> None:
    """Raise NotImplementedError for any configured feature outside the
    ported first-order, flow-only, single-device paths: unstructured, and
    the uniform raster (edge_flux_backend structured or fused_structured).
    The raster features are refused in `Simulation._init_structured_backend`:
    what the JAX package's raster paths refuse as ConfigErrors, and what its
    fused raster kernel runs and the port's does not yet."""
    p, n = config.physics, config.numerics
    raster = n.edge_flux_backend in ("structured", "fused_structured")
    if n.second_order and not raster:
        _not_ported("numerics.second_order (MUSCL)",
                    "queue 1 item 10 and queue 2 K3")
    if p.flow.well_balancing != "none" and not raster:
        _not_ported(f"well_balancing: {p.flow.well_balancing}",
                    "queue 1 item 11 and queue 2 K4/K5")
    if (p.sediment.num_classes or p.salinity or p.heat) and not raster:
        _not_ported("tracers (sediment, salinity, heat)",
                    "queue 1 item 12 and queue 2 K4")
    if (n.temporal in ("ark_imex", "beuler") and not raster) or (
        p.flow.source.method == "ark_imex"
    ):
        _not_ported(f"temporal: {n.temporal} / source.method: "
                    f"{p.flow.source.method}", "queue 1 item 13")
    if p.flow.mode != "swe":
        # the JAX package accepts the diffusion mode but runs the SWE for it
        raise NotImplementedError(
            f"physics.flow.mode: {p.flow.mode} is implemented in neither "
            "package; use swe"
        )
    if n.cell_ordering != "file":
        _not_ported(f"cell_ordering: {n.cell_ordering}",
                    "queue 1 item 5c (mesh readers and RCM ordering)")
    if config.ensemble.size:
        _not_ported("ensembles", "queue 1 item 14")
    if config.parallel.n_devices > 1 and not raster:
        _not_ported("parallel.n_devices > 1", "queue 1 item 16")
    if config.restart.file or config.checkpoint.interval:
        _not_ported("checkpoints and restart",
                    "queue 1 item 5b (checkpoints, restart, HDF5 output)")


def load_mesh_file(path: str) -> Mesh:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        return load_mesh_npz(path)
    if ext in (".msh", ".exo", ".e", ".exo2"):
        _not_ported(f"{ext} mesh files",
                    "queue 1 item 5c (mesh readers and RCM ordering)")
    raise ConfigError(f"unsupported mesh format '{ext}' ({path})")


class Simulation:
    """A configured simulation on one device."""

    def __init__(
        self, config: Config, mesh: Optional[Mesh] = None,
        device: DeviceLike = None,
    ):
        check_slice(config)
        self.device = resolve_device(device)
        self.config = config
        self.log = Logger(config.logging.level, config.logging.file)
        self.dtype = config.dtype

        # ---- mesh (rdysetup.c CreateDM + RDyMeshCreateFromDM) ----
        if mesh is None:
            mesh_path = config.resolve_path(config.grid.file)
            self.log.detail(f"Loading mesh from {mesh_path}")
            mesh = load_mesh_file(mesh_path)
        if config.grid.cell_elevation.file:
            cell_elev = read_petsc_vec(
                config.resolve_path(config.grid.cell_elevation.file)
            )
            mesh.set_cell_elevations(cell_elev[mesh.natural_ids])
        self.mesh = mesh

        # ---- regions / boundaries (InitRegions / InitBoundaries) ----
        self.region_cells: Dict[str, np.ndarray] = {}
        for r in config.regions:
            cells = mesh.regions.get(f"__id_{r.grid_region_id}")
            if cells is None:
                cells = mesh.regions.get(r.name)
            if cells is None:
                raise ConfigError(
                    f"region '{r.name}' (grid_region_id={r.grid_region_id}) "
                    f"not found in mesh (has {sorted(k for k in mesh.regions if not k.startswith('__'))})"
                )
            self.region_cells[r.name] = cells
        if not config.regions:
            self.region_cells["domain"] = np.arange(mesh.num_cells, dtype=np.int32)

        boundary_edges: Dict[str, np.ndarray] = {}
        for b in config.boundaries:
            edges = mesh.boundaries.get(f"__id_{b.grid_boundary_id}")
            if edges is None:
                edges = mesh.boundaries.get(b.name)
            if edges is None:
                raise ConfigError(
                    f"boundary '{b.name}' (grid_boundary_id={b.grid_boundary_id}) "
                    "not found in mesh"
                )
            boundary_edges[b.name] = np.asarray(edges)
        # any boundary edge not covered by a named boundary gets the implicit
        # reflecting wall (rdysetup.c:706-777)
        covered = (
            np.concatenate(list(boundary_edges.values()))
            if boundary_edges
            else np.zeros(0, dtype=np.int64)
        )
        all_bnd = np.arange(
            mesh.num_internal_edges, mesh.num_edges, dtype=np.int64
        )
        leftover = np.setdiff1d(all_bnd, covered)
        if len(leftover):
            boundary_edges["__auto_reflecting__"] = leftover
        self._mesh_for_op = dataclasses.replace(mesh, boundaries=dict(boundary_edges))

        # ---- conditions lookup ----
        self.flow_conditions = {c.name: c for c in config.flow_conditions}

        # ---- BC types per boundary (InitBoundaryConditions) ----
        bc_types: Dict[str, int] = {}
        self._dirichlet_conditions: Dict[str, object] = {}
        for bc in config.boundary_conditions:
            fc = self.flow_conditions[bc.flow]
            code = _BC_CODES.get(fc.type)
            if code is None:
                raise ConfigError(
                    f"flow condition '{fc.name}' has type '{fc.type}' which is "
                    "not a supported boundary condition"
                )
            for bname in bc.boundaries:
                bc_types[bname] = code
                if code == bc_mod.BC_DIRICHLET:
                    self._dirichlet_conditions[bname] = fc

        # ---- materials (InitMaterialProperties) ----
        mannings = np.zeros(mesh.num_cells)
        materials = {m.name: m for m in config.materials}
        for sc in config.surface_composition:
            mat = materials[sc.material]
            cells = self.region_cells[sc.region]
            prop = mat.properties.manning
            if prop.file:
                vals = read_petsc_vec(config.resolve_path(prop.file))
                if len(vals) == mesh.num_cells:
                    mannings[cells] = vals[mesh.natural_ids[cells]]
                else:
                    mannings[cells] = vals[: len(cells)]
            elif prop.value is not None:
                mannings[cells] = self._eval_cells(prop.value, cells)
            else:
                raise ConfigError(
                    f"material '{mat.name}' has no manning value or file"
                )
        self.mannings_n = mannings
        self.ndof = N_FLOW_DOF

        # ---- operator ----
        self.operator: SWEOperator = build_operator(
            self._mesh_for_op,
            bc_types=bc_types,
            mannings_n=mannings,
            tiny_h=config.physics.flow.tiny_h,
            h_anuga=config.physics.flow.h_anuga_reg_parameter,
            source_method=_SOURCE_CODES[config.physics.flow.source.method],
            xq2018_threshold=config.physics.flow.source.xq2018_threshold,
            dtype=self.dtype,
            device=self.device,
        )

        # ---- uniform-raster paths ----
        self._structured = None
        if config.numerics.edge_flux_backend in (
            "structured", "fused_structured"
        ):
            self._init_structured_backend()

        # ---- boundary geometry (edge centers, for BC expressions) ----
        self._bnd_centers = self._boundary_edge_centers()

        # ---- initial solution (InitSolution) ----
        self.q = self._tensor(self._initial_solution())

        # ---- Dirichlet boundary values (InitDirichletBoundaryConditions) ----
        self.boundary_values = self._tensor(self._dirichlet_values(t=0.0))

        # ---- external sources (InitSources) ----
        src0 = self._initial_sources()
        self.ext_src = self._tensor(src0)
        # when no source is active, the step loop skips the source stream;
        # a setter that activates one rebuilds the advancer
        self._ext_active = bool(np.any(src0))
        # which rows hold sources, known on the host (the raster path takes
        # water sources only)
        self._src_rows = np.any(src0, axis=1)

        # ---- time state ----
        tc = config.time
        self.time_unit = tc.unit
        self.t = 0.0  # seconds
        self.step = 0
        self.dt = time_to_seconds(tc.time_step, tc.unit)
        self.t_final = time_to_seconds(tc.stop, tc.unit)
        self.max_steps = tc.stop_n if tc.stop_n else None
        self.coupling_interval = time_to_seconds(tc.coupling_interval, tc.unit)
        self.prev_max_courant: Optional[float] = None
        self.prev_courant_edge: Optional[int] = None

        # ---- stepper ----
        self._advance_fn = None
        self._advance_scheme = config.numerics.temporal
        self._monitors: List[Callable] = []

        # monitors fire at step cadence in the reference (TSMonitors); each
        # coupling interval splits into chunks of the gcd of all configured
        # step intervals so each monitor sees its exact steps
        intervals = [
            i
            for i in (
                config.output.output_interval
                if config.output.format != "none"
                else 0,
                config.output.time_series.boundary_fluxes,
                config.output.time_series.observations.interval,
            )
            if i
        ]
        self.monitor_stride = math.gcd(*intervals) if intervals else 0

        # accumulated diagnostics for time series / outputs (host, f64)
        self.bflux_accum = np.zeros((self.ndof, max(self.operator.num_boundary_edges, 1)))
        self.accum_sol = np.zeros((self.ndof, mesh.num_cells))
        self.accum_prim = np.zeros((self.ndof, mesh.num_cells))
        self.accum_time = 0.0

        self.log_domain_statistics()

    # ------------------------------------------------------------- setup bits
    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    def _eval_cells(self, value, cells, t: float = 0.0) -> np.ndarray:
        """Evaluate a number-or-expression at cell centroids."""
        if isinstance(value, (int, float)):
            return np.full(len(cells), float(value))
        fn = compile_expression(str(value))
        x = self.mesh.cell_centroid[cells, 0]
        y = self.mesh.cell_centroid[cells, 1]
        return np.asarray(fn(x, y, t), dtype=np.float64)

    def _boundary_edge_centers(self) -> np.ndarray:
        """[Eb, 2] midpoints of boundary edges in operator segment order."""
        pts = self.mesh.points
        centers = []
        for seg in self.operator.segments:
            ev = self.mesh.edge_vertices[seg.edge_ids]
            centers.append((pts[ev[:, 0], :2] + pts[ev[:, 1], :2]) / 2.0)
        if centers:
            return np.concatenate(centers, axis=0)
        return np.zeros((0, 2))

    def _initial_solution(self) -> np.ndarray:
        q = np.zeros((self.ndof, self.mesh.num_cells))
        for ic in self.config.initial_conditions:
            fc = self.flow_conditions[ic.flow]
            cells = self.region_cells[ic.region]
            if fc.file:
                vals = read_petsc_vec(self.config.resolve_path(fc.file))
                if len(vals) != N_FLOW_DOF * self.mesh.num_cells:
                    raise ConfigError(
                        f"IC file for '{fc.name}' has {len(vals)} values; "
                        f"expected {N_FLOW_DOF * self.mesh.num_cells}"
                    )
                # blocked Vec in natural order (rdysetup.c:804-835)
                blocked = vals.reshape(self.mesh.num_cells, N_FLOW_DOF)
                nat = self.mesh.natural_ids
                q[:N_FLOW_DOF, cells] = blocked[nat[cells]].T
            else:
                for row, value in enumerate(
                    (fc.height, fc.x_momentum, fc.y_momentum)
                ):
                    q[row, cells] = self._eval_cells(
                        value if value is not None else 0.0, cells
                    )
        return q

    def _dirichlet_values(self, t: float) -> np.ndarray:
        bvals = np.zeros((self.ndof, max(self.operator.num_boundary_edges, 1)))
        for seg in self.operator.segments:
            fc = self._dirichlet_conditions.get(seg.name)
            if fc is None:
                continue
            sl = slice(seg.start, seg.start + seg.count)
            x = self._bnd_centers[sl, 0]
            y = self._bnd_centers[sl, 1]
            for row, value in enumerate((fc.height, fc.x_momentum, fc.y_momentum)):
                if value is None:
                    continue
                if isinstance(value, (int, float)):
                    bvals[row, sl] = float(value)
                else:
                    fn = compile_expression(str(value))
                    bvals[row, sl] = np.asarray(fn(x, y, t))
        return bvals

    def _initial_sources(self) -> np.ndarray:
        src = np.zeros((self.ndof, self.mesh.num_cells))
        for s in self.config.sources:
            if not s.flow:
                continue
            fc = self.flow_conditions[s.flow]
            cells = self.region_cells[s.region]
            if fc.file:
                vals = read_petsc_vec(self.config.resolve_path(fc.file))
                if len(vals) == self.mesh.num_cells:
                    src[0, cells] = vals[self.mesh.natural_ids[cells]]
                else:
                    src[0, cells] = vals[: len(cells)]
            else:
                for row, value in enumerate((fc.height, fc.x_momentum, fc.y_momentum)):
                    if value is not None:
                        src[row, cells] = self._eval_cells(value, cells)
        return src

    # ------------------------------------------------------------- lifecycle
    @property
    def finished(self) -> bool:
        """RDyFinished (rdyadvance.c:388-400)."""
        if self.t >= self.t_final - 1e-12:
            return True
        if self.max_steps is not None and self.step >= self.max_steps:
            return True
        return False

    def add_monitor(self, fn: Callable[["Simulation"], None]):
        """Register a per-coupling-interval callback (the TSMonitor analogue:
        output writers and time series)."""
        self._monitors.append(fn)

    def _needs_accumulators(self) -> bool:
        """Accumulate time-averaged/boundary-flux diagnostics only when some
        output consumes them."""
        cfg = self.config
        ts = cfg.output.time_series
        return bool(
            ts.boundary_fluxes
            or (
                ts.observations.interval
                and not ts.observations.time_sampling.instantaneous
            )
            or any(f.endswith("_Mean") for f in (cfg.output.fields or []))
        )

    def advance(self):
        """Advance one coupling interval (RDyAdvance, rdyadvance.c:261-383).
        The device state is read back once per monitor chunk."""
        cfg = self.config

        # adaptive dt from the previous interval's Courant diagnostics
        ta = cfg.time.adaptive
        if ta.enable and self.prev_max_courant is not None:
            self.dt = adapt_timestep(
                self.dt,
                self.prev_max_courant,
                ta.target_courant_number,
                ta.max_increase_factor,
                self.coupling_interval,
            )

        t_end = min(self.t + self.coupling_interval, self.t_final)
        span = t_end - self.t
        n_steps = max(1, int(np.ceil(span / self.dt - 1e-12)))
        if self.max_steps is not None:
            n_steps = min(n_steps, self.max_steps - self.step)
            t_end = min(t_end, self.t + n_steps * self.dt)

        if self._advance_fn is None and self._structured is None:
            self._advance_fn = make_interval_advancer(
                self.operator, self._advance_scheme,
                accumulate=self._needs_accumulators(),
                ext_sources=self._ext_active,
            )

        max_courant = 0.0
        stride = self.monitor_stride if self._monitors and self.monitor_stride else n_steps
        done = 0
        while done < n_steps:
            chunk = min(stride, n_steps - done)
            if self._structured is not None:
                cmax = self._advance_structured(chunk, t_end)
            else:
                cmax, edge = self._advance_unstructured(chunk, t_end)
                if cmax >= max_courant:
                    self.prev_courant_edge = edge
            done += chunk
            max_courant = max(max_courant, cmax)
            if self._monitors and self.monitor_stride and done < n_steps:
                for mon in self._monitors:
                    mon(self)

        self.prev_max_courant = max_courant

        self.log.detail(
            f"step {self.step}: t = {self.t:.6g} s, dt = {self.dt:.6g} s, "
            f"max courant = {self.prev_max_courant:.4g}"
        )

        for mon in self._monitors:
            mon(self)

    def run(self):
        """create -> setup -> advance loop (the C driver main.c:34-88)."""
        while not self.finished:
            self.advance()

    def _advance_unstructured(self, n_steps: int, t_end: float):
        """n_steps steps of the unstructured path; returns the chunk's
        (max Courant number, edge id attaining it)."""
        res = self._advance_fn(
            self.q, self.t, self.dt, n_steps, t_end, self.boundary_values,
            self.ext_src,
        )
        self.q = res.q
        self.t = float(res.t)
        self.step += int(n_steps)
        self.bflux_accum += res.bflux_accum.cpu().numpy()
        self.accum_sol += res.accum_sol.cpu().numpy()
        self.accum_prim += res.accum_prim.cpu().numpy()
        self.accum_time += float(res.accum_time)
        return float(res.max_courant), int(res.courant_edge)

    # ------------------------------------------------------------- raster
    def _init_structured_backend(self):
        """Wire the uniform-raster paths into the config surface (the JAX
        package's simulation.py:585-915, single device).

        'structured' = the zero-gather operator in plain PyTorch
        (ops/structured.py); 'fused_structured' = the raster step kernel K2
        (ops/kernels/raster_step.py) through the fused stepper. Both require
        a row-major uniform quad raster and flow-only first-order physics;
        anything the JAX package's raster paths refuse is a ConfigError
        here too, and a fused_structured deck whose raster is not 128-wide
        aligned falls back to 'structured' as it does there.
        """
        cfg = self.config
        p = cfg.physics
        kind = cfg.numerics.edge_flux_backend
        tracers = p.sediment.num_classes or p.salinity or p.heat
        if kind == "fused_structured":
            # the JAX package's fused raster kernel runs these; K2 not yet
            if cfg.numerics.second_order:
                _not_ported("numerics.second_order on the raster",
                            "queue 2 K2 mode 4: MUSCL in the raster kernel")
            if tracers:
                _not_ported("tracers on the raster",
                            "queue 2 K2 mode 3: tracers in the raster kernel")
            if cfg.numerics.temporal == "beuler":
                _not_ported("temporal: beuler on the raster",
                            "queue 1 item 13")
            if cfg.parallel.n_devices > 1:
                _not_ported("parallel.n_devices > 1 on the raster",
                            "queue 1 item 16 and queue 2 K2 row 13: the "
                            "row-strip sharded raster kernel")
        raster = detect_uniform_raster(self._mesh_for_op)
        if raster is None:
            raise ConfigError(
                f"edge_flux_backend: {kind} requires a uniform row-major "
                "quad raster mesh (and numerics.cell_ordering: natural)"
            )
        nx, ny, dx, dy = raster
        # what the JAX package's raster paths refuse (the fused kind reaches
        # only well_balancing here)
        unsupported = []
        if tracers:
            unsupported.append("tracers/sediment")
        if cfg.numerics.second_order:
            unsupported.append("second_order")
        if p.flow.well_balancing not in (None, "", "none"):
            unsupported.append("well_balancing")
        if cfg.parallel.n_devices > 1:
            unsupported.append("parallel.n_devices > 1")
        ts = cfg.output.time_series
        wants_bflux = bool(ts.boundary_fluxes)
        wants_means = any(
            f.endswith("_Mean") for f in (cfg.output.fields or [])
        ) or bool(
            ts.observations.interval
            and not ts.observations.time_sampling.instantaneous
        )
        if kind != "fused_structured":
            if wants_bflux:
                unsupported.append("time_series.boundary_fluxes")
            if wants_means:
                unsupported.append("time-averaged output fields")
        if unsupported:
            raise ConfigError(
                f"edge_flux_backend: {kind} does not support: "
                + ", ".join(unsupported)
            )

        # wall BCs from the operator's boundary segments via outward normals
        a = self.operator.arrays
        bnd_cn = a.bnd_cn.cpu().numpy().round().astype(int)
        bnd_sn = a.bnd_sn.cpu().numpy().round().astype(int)
        bnd_left = a.bnd_left.cpu().numpy()
        walls = {}  # (cn, sn) -> bc code
        for seg in self.operator.segments:
            sl = slice(seg.start, seg.start + seg.count)
            for w in set(zip(bnd_cn[sl].tolist(), bnd_sn[sl].tolist())):
                if walls.setdefault(w, seg.bc_type) != seg.bc_type:
                    raise ConfigError(
                        f"edge_flux_backend: {kind}: wall with normal {w} "
                        "has mixed boundary conditions"
                    )
        if kind != "fused_structured" and bc_mod.BC_DIRICHLET in walls.values():
            raise ConfigError(
                f"edge_flux_backend: {kind} does not support Dirichlet "
                "walls (use the fused_structured/xla/pallas backends)"
            )
        bcs = {side: walls.get(w, bc_mod.BC_REFLECTING)
               for side, w in _WALL_NORMALS.items()}
        mesh = self._mesh_for_op
        dzx = np.asarray(mesh.cell_dz_dx).reshape(ny, nx)
        dzy = np.asarray(mesh.cell_dz_dy).reshape(ny, nx)
        mann = np.asarray(self.mannings_n).reshape(ny, nx)
        scheme = cfg.numerics.temporal

        if kind == "fused_structured":
            if scheme not in FUSED_SCHEMES:
                raise ConfigError(
                    "edge_flux_backend: fused_structured supports temporal: "
                    "euler|ssprk2|ssprk3|rk4|beuler"
                )
            if self.operator.source_method != SOURCE_SEMI_IMPLICIT:
                raise ConfigError(
                    "edge_flux_backend: fused_structured supports the "
                    "semi_implicit source method only"
                )
            # the TPU kernel's row tile; kept so that one deck takes the
            # same path in both packages (K2 itself needs no alignment)
            ty = 16 if ny % 16 == 0 else 8
            if nx % 128 or ny % ty:
                self.log.warning(
                    f"fused_structured needs nx % 128 == 0 and ny % {ty} == "
                    f"0 (got {nx}x{ny}); falling back to the structured "
                    "path"
                )
                kind = "structured"
        if kind == "fused_structured":
            plan = StructuredPlan(
                nx=nx, ny=ny, dx=dx, dy=dy,
                tiny_h=cfg.physics.flow.tiny_h,
                h_anuga=cfg.physics.flow.h_anuga_reg_parameter,
                **{f"bc_{side}": bc for side, bc in bcs.items()},
            )
            # Dirichlet walls: position along the wall -> boundary_values
            # column, so the ghosts take the live Dirichlet values
            side_cols = {}
            for side, w in _WALL_NORMALS.items():
                if bcs[side] != bc_mod.BC_DIRICHLET:
                    continue
                n_side = ny if side in ("left", "right") else nx
                cols = np.full(n_side, -1, np.int64)
                for seg in self.operator.segments:
                    sl = np.arange(seg.start, seg.start + seg.count)
                    on = (bnd_cn[sl] == w[0]) & (bnd_sn[sl] == w[1])
                    cells = bnd_left[sl][on]
                    pos = cells // nx if side in ("left", "right") else cells % nx
                    cols[pos] = sl[on]
                if (cols < 0).any():
                    raise ConfigError(
                        f"edge_flux_backend: {kind}: Dirichlet wall "
                        f"'{side}' is not fully covered by boundary edges"
                    )
                side_cols[side] = torch.as_tensor(cols, device=self.device)
            accum = wants_bflux or wants_means
            bnd = None
            if wants_bflux and self.operator.num_boundary_edges:
                bnd = boundary_edge_arrays(a)

            def plane(x):
                return torch.as_tensor(x, dtype=torch.float32,
                                       device=self.device)

            op = FusedStructuredOperator(plan, plane(dzx), plane(dzy),
                                         plane(mann), bnd)
            # the rain plane goes to the kernel when the config declares
            # sources, or from the first interval a coupler sets one
            self._structured = dict(
                kind="fused", nx=nx, ny=ny, op=op, scheme=scheme,
                with_src=bool(cfg.sources), side_cols=side_cols,
                accumulate=accum,
                adv=make_fused_structured_stepper(op, scheme,
                                                  accumulate=accum),
            )
            self.log.info(
                f"structured raster {nx}x{ny}: raster step kernel K2 "
                f"({scheme}{', +src' if cfg.sources else ''}"
                f"{'; its plain version on the CPU' if self.device.type == 'cpu' else ''})"
            )
        else:
            if scheme not in STRUCTURED_SCHEMES:
                raise ConfigError(
                    "edge_flux_backend: structured supports temporal: "
                    "euler|ssprk2|rk4"
                )
            op = build_structured_operator(
                nx, ny, dx, dy, mannings_n=mann, dtype=self.dtype,
                dz_dx=dzx, dz_dy=dzy, device=self.device,
                **{f"bc_{side}": bc for side, bc in bcs.items()},
                tiny_h=cfg.physics.flow.tiny_h,
                h_anuga=cfg.physics.flow.h_anuga_reg_parameter,
                source_method=self.operator.source_method,
                xq2018_threshold=self.operator.xq2018_threshold,
            )
            self._structured = dict(
                kind="xla", op=op, nx=nx, ny=ny,
                adv=make_structured_stepper(op, scheme),
            )
            self.log.info(
                f"structured raster {nx}x{ny}: zero-gather path ({scheme})"
            )

    def _advance_structured(self, n_steps: int, t_end: float) -> float:
        """n_steps steps of the raster path; returns the chunk's max
        Courant number (a raster has no Courant edge id)."""
        st = self._structured
        nx, ny = st["nx"], st["ny"]
        if st["kind"] == "xla":
            q_out, t_out, cmax = st["adv"](
                st["op"].arrays, self.q.reshape(N_FLOW_DOF, ny, nx), self.t,
                self.dt, int(n_steps), t_end,
                self.ext_src.reshape(N_FLOW_DOF, ny, nx),
            )
            self.q = q_out.reshape(N_FLOW_DOF, ny * nx)
        else:
            if self._src_rows[1:].any():
                raise ConfigError(
                    "edge_flux_backend: fused_structured supports water "
                    "(row 0) external sources only (use structured for "
                    "momentum sources)"
                )
            if not st["with_src"] and self._src_rows[0]:
                self.log.info(
                    "fused_structured: external water source appeared; "
                    "the raster step takes the source plane from now on"
                )
                st["with_src"] = True
            f32 = torch.float32
            src = (self.ext_src[0].reshape(ny, nx).to(f32)
                   if st["with_src"] else None)
            bv = self.boundary_values
            bc_vals = {side: bv[:, cols].to(f32)
                       for side, cols in st["side_cols"].items()}
            accum = st["accumulate"]
            res = st["adv"](
                self.q.to(f32), np.float32(self.t), np.float32(self.dt),
                int(n_steps), np.float32(t_end), src=src, bc_vals=bc_vals,
                bv_edges=bv.to(f32) if accum else None,
            )
            if accum:
                if res.bflux_accum is not None:
                    self.bflux_accum += res.bflux_accum.cpu().numpy()
                self.accum_sol += res.accum_sol.cpu().numpy()
                self.accum_prim += res.accum_prim.cpu().numpy()
                self.accum_time += float(res.accum_time)
            self.q = res.q.to(self.dtype)
            t_out, cmax = res.t, res.max_courant
        self.t = float(t_out)
        self.step += int(n_steps)
        self.prev_courant_edge = None
        return float(cmax)

    def mark_cells_for_amr(self, refine_cell: np.ndarray) -> None:
        """RDyMarkOwnedCellsForAMR: adaptive mesh refinement is not ported."""
        _not_ported("adaptive mesh refinement", "queue 1 item 14")

    def perform_amr(self) -> None:
        """RDyPerformAMR: adaptive mesh refinement is not ported."""
        _not_ported("adaptive mesh refinement", "queue 1 item 14")

    # ------------------------------------------------------------- coupling API
    # The E3SM-style get/set surface (src/rdydata.c), arrays in natural
    # cell order. On a single device natural order == local order.

    @property
    def num_cells(self) -> int:
        return self.mesh.num_cells

    def get_height(self) -> np.ndarray:
        return self.q[0].cpu().numpy()

    def get_x_momentum(self) -> np.ndarray:
        return self.q[1].cpu().numpy()

    def get_y_momentum(self) -> np.ndarray:
        return self.q[2].cpu().numpy()

    def get_solution(self) -> np.ndarray:
        return self.q.cpu().numpy()

    def set_solution(self, q: np.ndarray):
        q = np.asarray(q)
        if q.shape != (self.ndof, self.mesh.num_cells):
            raise ValueError(
                f"expected shape {(self.ndof, self.mesh.num_cells)}, got {q.shape}"
            )
        self.q = self._tensor(q)

    def _set_row(self, row: int, values):
        q = self.get_solution()
        q[row] = values
        self.set_solution(q)

    def set_height(self, h: np.ndarray):
        self._set_row(0, h)

    def set_x_momentum(self, hu: np.ndarray):
        self._set_row(1, hu)

    def set_y_momentum(self, hv: np.ndarray):
        self._set_row(2, hv)

    def set_initial_conditions(self, q: np.ndarray):
        """RDySetInitialConditions (rdydata.c:541)."""
        self.set_solution(q)

    def get_cell_centroids(self) -> np.ndarray:
        return self.mesh.cell_centroid.copy()

    def get_cell_areas(self) -> np.ndarray:
        return self.mesh.cell_area.copy()

    def get_natural_ids(self) -> np.ndarray:
        return self.mesh.natural_ids.copy()

    def get_manning_n(self) -> np.ndarray:
        return self.mannings_n.copy()

    def set_manning_n(self, n: np.ndarray):
        n = np.broadcast_to(np.asarray(n, dtype=np.float64), (self.mesh.num_cells,))
        self.mannings_n = n.copy()
        self.operator.arrays.mannings_n = self._tensor(self.mannings_n)
        # the raster paths hold their own Manning plane: rebuild them
        if self._structured is not None:
            self._init_structured_backend()

    def _update_ext_src(self, src: np.ndarray):
        """Install new external sources; if sources just became active on
        an advancer built without them, drop it so the next interval
        rebuilds it with the source stream."""
        self.ext_src = self._tensor(src)
        self._src_rows = np.any(src, axis=1)
        if not self._ext_active and np.any(src):
            self._ext_active = True
            self._advance_fn = None

    def set_domain_water_source(self, rate: np.ndarray | float):
        """RDySetDomainWaterSource: water source for every cell [m/s]."""
        src = self.ext_src.cpu().numpy().copy()
        src[0, :] = rate
        self._update_ext_src(src)

    def set_regional_water_source(self, region: str, rate: np.ndarray | float):
        """RDySetRegionalWaterSource."""
        src = self.ext_src.cpu().numpy().copy()
        src[0, self.region_cells[region]] = rate
        self._update_ext_src(src)

    def set_flow_dirichlet_boundary_values(
        self, boundary: str, values: np.ndarray
    ):
        """RDySetFlowDirichletBoundaryValues: [3, n_edges] or [n_edges * 3]."""
        seg = self._segment(boundary)
        vals = np.asarray(values, dtype=np.float64)
        if vals.ndim == 1:
            vals = vals.reshape(seg.count, N_FLOW_DOF).T
        bv = self.boundary_values.cpu().numpy().copy()
        bv[:, seg.start : seg.start + seg.count] = vals
        self.boundary_values = self._tensor(bv)

    # ---- time accessors (RDyGetTime/GetTimeStep/Get-SetCouplingInterval) ----
    def get_time(self, unit: Optional[str] = None) -> float:
        return time_from_seconds(self.t, unit or self.time_unit)

    def set_time(self, value: float, unit: Optional[str] = None):
        self.t = time_to_seconds(value, unit or self.time_unit)

    def get_time_step(self, unit: Optional[str] = None) -> float:
        return time_from_seconds(self.dt, unit or self.time_unit)

    def set_time_step(self, value: float, unit: Optional[str] = None):
        self.dt = time_to_seconds(value, unit or self.time_unit)

    def get_step(self) -> int:
        return self.step

    def set_step(self, step: int):
        self.step = int(step)

    def get_coupling_interval(self, unit: Optional[str] = None) -> float:
        return time_from_seconds(self.coupling_interval, unit or self.time_unit)

    def set_coupling_interval(self, value: float, unit: Optional[str] = None):
        self.coupling_interval = time_to_seconds(value, unit or self.time_unit)

    # ---- boundary metadata (RDyGetNumBoundaryEdges) ----
    def _segment(self, boundary: str):
        return {s.name: s for s in self.operator.segments}[boundary]

    def get_num_boundary_edges(self, boundary: str) -> int:
        return self._segment(boundary).count

    # ---- diagnostics ----
    def log_domain_statistics(self):
        m = self.mesh
        self.log.detail(
            f"domain: {m.num_cells} cells, {m.num_edges} edges "
            f"({m.num_internal_edges} internal), {m.num_vertices} vertices; "
            f"area [{m.cell_area.min():.4g}, {m.cell_area.max():.4g}], "
            f"min edge length {m.min_edge_length():.4g}; "
            f"device {device_name(self.device)}"
        )

    def get_courant_number_diagnostics(self):
        """(max Courant number, global edge id, natural cell id) of the last
        coupling interval (CourantNumberDiagnostics, rdyoperatorimpl.h:21-26);
        (0.0, -1, -1) before the first interval."""
        if self.prev_max_courant is None:
            return (0.0, -1, -1)
        e = self.prev_courant_edge
        if e is None or e < 0:
            return (float(self.prev_max_courant), -1, -1)
        a = self.operator.arrays
        Ei = self.operator.num_internal_edges
        if e < Ei:
            cell = int(a.int_left[e])
        else:
            cell = int(a.bnd_left[e - Ei])
        cell = int(self._mesh_for_op.natural_ids[cell])
        return (float(self.prev_max_courant), int(e), cell)
