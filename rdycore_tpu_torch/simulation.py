"""The Simulation object: the RDy lifecycle.

The counterpart of rdycore_tpu/simulation.py for the single-device paths,
first order, flow only or with tracers (sediment with Hairsine-Rose
sources, salinity, heat), or second order (MUSCL with the positivity
limiter, flow only): unstructured, with or without well-balancing
(hydrostatic reconstruction, or BS2002 flow only), and the uniform raster
(`edge_flux_backend: structured`, first order and flow only, or
`fused_structured`, also cut into `parallel.n_devices` row strips, each on
its own device or several on one card)
(the reference's RDy object, src/rdycore.c, src/rdysetup.c,
src/rdyadvance.c):

    sim = Simulation(load_config("case.yaml"))  # RDyCreate + RDySetup
    while not sim.finished:                     # while (!RDyFinished(rdy))
        sim.advance()                           #   RDyAdvance(rdy)

plus the E3SM-style coupling surface (src/rdydata.c): get/set arrays in
natural cell order between coupling intervals.

It runs on the CUDA device unless built with device="cpu". Every feature
outside these paths, and every public member of the JAX package's
Simulation that this one lacks, raises NotImplementedError naming the
ROADMAP item that will port it, or the JAX package's own ConfigError where
that package refuses it too; nothing degrades silently.
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
    fused_strip_operators,
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


def _stub(name: str, item: str, kind=None):
    """A public member of the JAX package's Simulation that the port lacks:
    calling it (reading it, for a property) raises NotImplementedError
    naming its ROADMAP item (fault 20). kind: property, classmethod or
    staticmethod."""
    def stub(*args, **kwargs):
        _not_ported(f"Simulation.{name}", item)

    stub.__name__ = stub.__qualname__ = name
    stub.__doc__ = f"Not ported to rdycore_tpu_torch yet (ROADMAP {item})."
    return kind(stub) if kind else stub


_COUPLING = "queue 1 item 18 (the rest of the coupling surface)"
_CHECKPOINTS = "queue 1 item 5b (checkpoints, restart, HDF5 output)"
_AMR = "queue 1 item 14"


def num_tracers(config: Config) -> int:
    """Tracer rows of the state: the sediment classes, then salinity and
    heat."""
    p = config.physics
    return p.sediment.num_classes + int(bool(p.salinity)) + int(bool(p.heat))


def path_of(config: Config) -> str:
    """The path a deck asks for: "unstructured" (edge_flux_backend xla,
    auto or pallas), "fused_structured" or "structured"."""
    kind = config.numerics.edge_flux_backend
    return kind if kind in ("structured", "fused_structured") else "unstructured"


def check_slice(config: Config) -> None:
    """Raise for any configured feature outside the ported paths: single
    device, unstructured or on the uniform raster (edge_flux_backend
    structured or fused_structured). What depends on the path is refused
    by `refuse_on_path`."""
    p, n = config.physics, config.numerics
    if p.flow.source.method == "ark_imex":
        _not_ported(f"source.method: {p.flow.source.method}",
                    "queue 1 item 13")
    if p.flow.mode != "swe":
        # the JAX package accepts the diffusion mode but runs the SWE for it
        raise NotImplementedError(
            f"physics.flow.mode: {p.flow.mode} is implemented in neither "
            "package; use swe"
        )
    if num_tracers(config) and p.flow.source.method == "implicit_xq2018":
        # the JAX package runs semi-implicit friction in its place
        # (ROADMAP fault 2)
        raise ConfigError(
            "source.method: implicit_xq2018 has no form for the coupled "
            "flow + tracer system (sediment, salinity, heat); use "
            "semi_implicit"
        )
    if num_tracers(config) and p.flow.well_balancing == "bs2002":
        # the schema refuses sediment with BS2002; the JAX package runs
        # salinity and heat decks without the correction (ROADMAP fault 18)
        raise ConfigError(
            "well_balancing: bs2002 has no form for the coupled flow + "
            "tracer system (salinity, heat): the JAX package drops its "
            "correction there (ROADMAP fault 18); use "
            "hydrostatic_reconstruction"
        )
    if n.cell_ordering != "file":
        _not_ported(f"cell_ordering: {n.cell_ordering}",
                    "queue 1 item 5c (mesh readers and RCM ordering)")
    if config.ensemble.size:
        _not_ported("ensembles", "queue 1 item 14")
    if config.restart.file or config.checkpoint.interval:
        _not_ported("checkpoints and restart",
                    "queue 1 item 5b (checkpoints, restart, HDF5 output)")
    refuse_on_path(config, path_of(config))


# The features that depend on the path, and how each path refuses them:
# (feature, ROADMAP item) = not ported yet, NotImplementedError;
# _CONFIG_ERROR = refused by the JAX package too, one ConfigError listing
# them all, as it lists them. A path that runs a feature has no entry.
_CONFIG_ERROR = None
_PATH_REFUSALS = (
    ("tracers/sediment", lambda c: num_tracers(c) > 0,
     {"structured": _CONFIG_ERROR}),
    ("second_order", lambda c: c.numerics.second_order,
     {"structured": _CONFIG_ERROR}),
    ("well_balancing",
     lambda c: c.physics.flow.well_balancing not in (None, "", "none"), {
         "fused_structured": _CONFIG_ERROR, "structured": _CONFIG_ERROR}),
    ("parallel.n_devices > 1", lambda c: c.parallel.n_devices > 1, {
        "unstructured": ("parallel.n_devices > 1 on the unstructured path",
                         "queue 1 item 16"),
        "structured": _CONFIG_ERROR}),
    ("temporal: beuler", lambda c: c.numerics.temporal == "beuler", {
        "unstructured": ("temporal: beuler", "queue 1 item 13")}),
    # row strips refuse beuler with the JAX package's ConfigError
    # (Simulation._init_structured_backend)
    ("temporal: beuler",
     lambda c: c.numerics.temporal == "beuler" and c.parallel.n_devices <= 1,
     {"fused_structured": ("temporal: beuler on the raster",
                           "queue 1 item 13")}),
    ("temporal: ark_imex", lambda c: c.numerics.temporal == "ark_imex", {
        "unstructured": ("temporal: ark_imex", "queue 1 item 13")}),
    ("time_series.boundary_fluxes",
     lambda c: bool(c.output.time_series.boundary_fluxes),
     {"structured": _CONFIG_ERROR}),
    ("time-averaged output fields", lambda c: wants_means(c),
     {"structured": _CONFIG_ERROR}),
)


def wants_means(config: Config) -> bool:
    """Whether an output reads the time-averaged solution."""
    obs = config.output.time_series.observations
    return any(f.endswith("_Mean") for f in (config.output.fields or [])) or (
        bool(obs.interval and not obs.time_sampling.instantaneous))


def refuse_on_path(config: Config, path: str) -> None:
    """Raise for each configured feature that `path` does not run (the
    table above). The raster paths' temporal schemes, source method and
    walls are checked where the raster kind is decided
    (`Simulation._init_structured_backend`)."""
    unsupported = []
    for feature, present, refusals in _PATH_REFUSALS:
        if path not in refusals or not present(config):
            continue
        if refusals[path] is _CONFIG_ERROR:
            unsupported.append(feature)
        else:
            _not_ported(*refusals[path])
    if unsupported:
        raise ConfigError(
            f"edge_flux_backend: {path} does not support: "
            + ", ".join(unsupported)
        )


def load_mesh_file(path: str) -> Mesh:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        return load_mesh_npz(path)
    if ext in (".msh", ".exo", ".e", ".exo2"):
        _not_ported(f"{ext} mesh files",
                    "queue 1 item 5c (mesh readers and RCM ordering)")
    raise ConfigError(f"unsupported mesh format '{ext}' ({path})")


class Simulation:
    """A configured simulation: on `device` (CUDA unless "cpu"), and a
    fused_structured deck with parallel.n_devices = P > 1 in P row strips
    on cuda:0..P-1 (all on the CPU with device="cpu"), or on the devices
    `strip_devices` names, one per strip, a card as often as wanted. The
    state, sources and wall values live whole on `device` between
    intervals (where the coupling API reads and writes them) and are cut
    into the strips at the start of each interval and gathered at its end,
    as the JAX package packs its shards each interval."""

    def __init__(
        self, config: Config, mesh: Optional[Mesh] = None,
        device: DeviceLike = None,
        strip_devices: Optional[List[DeviceLike]] = None,
    ):
        check_slice(config)
        self.device = resolve_device(device)
        self.strip_devices = strip_devices
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

        # ---- tracers (sediment classes, then salinity and heat) ----
        self.num_sediment = config.physics.sediment.num_classes
        self.num_tracers = num_tracers(config)
        self.ndof = N_FLOW_DOF + self.num_tracers
        self.sediment_conditions = {c.name: c for c in config.sediment_conditions}
        self.salinity_conditions = {c.name: c for c in config.salinity_conditions}
        self.temperature_conditions = {
            c.name: c for c in config.temperature_conditions
        }

        # ---- operator ----
        self.operator: SWEOperator = build_operator(
            self._mesh_for_op,
            bc_types=bc_types,
            mannings_n=mannings,
            num_tracers=self.num_tracers,
            num_sediment=self.num_sediment,
            riemann=config.numerics.riemann,
            second_order=config.numerics.second_order,
            limiter=config.numerics.limiter,
            well_balancing_hr=(config.physics.flow.well_balancing
                               == "hydrostatic_reconstruction"),
            well_balancing_bs2002=(config.physics.flow.well_balancing
                                   == "bs2002"),
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
        if strip_devices is not None and not (
                self._structured and self._structured.get("strips")):
            raise ValueError("strip_devices: only a fused_structured deck "
                             "with parallel.n_devices > 1 runs in strips")

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
            # tracer ICs: condition values go directly into the state rows
            # (InitTracerSolution, rdysetup.c:911-1067)
            if self.num_tracers:
                self._init_tracer_rows(q, ic, cells)
        return q

    def _cell_values(self, cond, value, cells) -> np.ndarray:
        """A tracer condition's values on `cells`: from its file (natural
        order, or the first len(cells) values), else `value`."""
        if cond.file:
            vals = read_petsc_vec(self.config.resolve_path(cond.file))
            if len(vals) >= self.mesh.num_cells:
                return vals[self.mesh.natural_ids[cells]]
            return vals[: len(cells)]
        return self._eval_cells(value, cells)

    def _init_tracer_rows(self, q, ic, cells):
        """The tracer rows of the initial condition `ic` on its cells (the
        JAX package's simulation.py:440-481)."""
        row = N_FLOW_DOF
        if self.num_sediment and ic.sediment:
            classes = self.sediment_conditions[ic.sediment].classes
            for k, cond in enumerate(classes[: self.num_sediment]):
                if cond.file or cond.value is not None:
                    q[row + k, cells] = self._cell_values(cond, cond.value,
                                                          cells)
        row += self.num_sediment
        if self.config.physics.salinity and ic.salinity:
            cond = self.salinity_conditions[ic.salinity]
            if cond.file or cond.concentration is not None:
                q[row, cells] = self._cell_values(cond, cond.concentration,
                                                  cells)
            row += 1
        if self.config.physics.heat and ic.temperature:
            cond = self.temperature_conditions[ic.temperature]
            if cond.file or cond.temperature is not None:
                q[row, cells] = self._cell_values(cond, cond.temperature,
                                                  cells)

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
        return bool(self.config.output.time_series.boundary_fluxes
                    or wants_means(self.config))

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
        (ops/structured.py), flow only; 'fused_structured' = the raster step
        kernel K2 (ops/kernels/raster_step.py) through the fused stepper,
        with tracers in K2's nt mode and second order in K2 MUSCL
        (ops/kernels/raster_muscl.py). Both require a row-major uniform
        quad raster; anything the JAX package's raster
        paths refuse is a ConfigError here too (`refuse_on_path`), and a
        fused_structured deck whose raster is not 128-wide aligned falls
        back to 'structured', with that path's refusals, as it does there.
        """
        cfg = self.config
        kind = cfg.numerics.edge_flux_backend
        raster = detect_uniform_raster(self._mesh_for_op)
        if raster is None:
            raise ConfigError(
                f"edge_flux_backend: {kind} requires a uniform row-major "
                "quad raster mesh (and numerics.cell_ordering: natural)"
            )
        nx, ny, dx, dy = raster

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

        n_dev = cfg.parallel.n_devices
        if kind == "fused_structured":
            if scheme not in FUSED_SCHEMES + ("beuler",):
                raise ConfigError(
                    "edge_flux_backend: fused_structured supports temporal: "
                    "euler|ssprk2|ssprk3|rk4|beuler"
                )
            if self.operator.source_method != SOURCE_SEMI_IMPLICIT:
                raise ConfigError(
                    "edge_flux_backend: fused_structured supports the "
                    "semi_implicit source method only"
                )
            if n_dev > 1 and scheme == "beuler":
                raise ConfigError(
                    "edge_flux_backend: fused_structured with "
                    "parallel.n_devices > 1 supports temporal: "
                    "euler|ssprk2|ssprk3|rk4"
                )
            # the TPU kernel's row tile; kept so that one deck takes the
            # same path in both packages (K2 itself needs no alignment)
            ty = 16 if ny % (16 * max(n_dev, 1)) == 0 else 8
            if nx % 128 or ny % ty:
                self.log.warning(
                    f"fused_structured needs nx % 128 == 0 and ny % {ty} == "
                    f"0 (got {nx}x{ny}); falling back to the structured "
                    "path"
                )
                kind = "structured"
                if n_dev > 1:
                    raise ConfigError(
                        "edge_flux_backend: structured does not support "
                        "parallel.n_devices > 1"
                    )
                refuse_on_path(cfg, kind)
            elif n_dev > 1 and ny % (n_dev * ty):
                raise ConfigError(
                    f"edge_flux_backend: fused_structured with "
                    f"parallel.n_devices = {n_dev} needs ny divisible by "
                    f"n_devices * {ty} (got ny = {ny})"
                )
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
            accum = self._needs_accumulators()
            bnd = None
            if (cfg.output.time_series.boundary_fluxes
                    and self.operator.num_boundary_edges):
                bnd = boundary_edge_arrays(a)

            options = dict(
                num_tracers=self.num_tracers, num_sediment=self.num_sediment,
                riemann=cfg.numerics.riemann,
                second_order=cfg.numerics.second_order,
                limiter=cfg.numerics.limiter)
            if n_dev > 1:
                # P row strips of ny / P rows (the JAX package's row-strip
                # sharded stepper), each strip's planes on its device
                devices = self._strip_device_list(n_dev)
                op = fused_strip_operators(
                    plan, *(torch.as_tensor(x, dtype=torch.float32)
                            for x in (dzx, dzy, mann)),
                    devices, bnd, **options)
            else:
                op = FusedStructuredOperator(
                    plan, *(torch.as_tensor(x, dtype=torch.float32,
                                            device=self.device)
                            for x in (dzx, dzy, mann)), bnd, **options)
            # the rain plane goes to the kernel when the config declares
            # sources, or from the first interval a coupler sets one
            self._structured = dict(
                kind="fused", nx=nx, ny=ny, op=op, scheme=scheme,
                with_src=bool(cfg.sources), side_cols=side_cols,
                accumulate=accum, strips=n_dev > 1,
                adv=make_fused_structured_stepper(op, scheme,
                                                  accumulate=accum),
            )
            where = ("; its plain version on the CPU"
                     if self.device.type == "cpu" else "")
            if n_dev > 1:
                where += (f"; {n_dev} row strips of {ny // n_dev} rows on "
                          + ", ".join(map(str, devices)))
            self.log.info(
                f"structured raster {nx}x{ny}: raster step kernel "
                f"{'K2 MUSCL' if cfg.numerics.second_order else 'K2'} "
                f"({scheme}{', +src' if cfg.sources else ''}"
                f"{f', {self.num_tracers} tracers' if self.num_tracers else ''}"
                f"{where})"
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

    def _strip_device_list(self, n_dev: int) -> List[torch.device]:
        """The devices of the n_dev row strips: `strip_devices` (all of
        the simulation's device type), else cuda:0..n_dev-1, or the CPU
        n_dev times on a CPU simulation."""
        if self.strip_devices is not None:
            if len(self.strip_devices) != n_dev:
                raise ValueError(
                    f"strip_devices names {len(self.strip_devices)} "
                    f"devices for parallel.n_devices = {n_dev}")
            devices = [torch.device(d) for d in self.strip_devices]
            if any(d.type != self.device.type for d in devices):
                raise ValueError(
                    f"strip_devices {[str(d) for d in devices]}: every strip "
                    f"must be on a {self.device.type} device, as the "
                    f"simulation is on {self.device}")
            return [resolve_device(d) for d in devices]
        if self.device.type == "cpu":
            return [self.device] * n_dev
        count = torch.cuda.device_count()
        if count < n_dev:
            raise ConfigError(
                f"parallel.n_devices = {n_dev} but only {count} devices are "
                "available"
            )
        return [torch.device("cuda", k) for k in range(n_dev)]

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

    # ---- the JAX Simulation's members not ported yet (ROADMAP fault 20) ----
    rebuild_on_mesh = _stub("rebuild_on_mesh", _AMR)
    write_checkpoint = _stub("write_checkpoint", _CHECKPOINTS)
    read_checkpoint = _stub("read_checkpoint", _CHECKPOINTS)
    restarted = _stub("restarted", _CHECKPOINTS, property)
    from_file = _stub("from_file", _COUPLING, classmethod)
    set_momentum_source = _stub("set_momentum_source", _COUPLING)
    set_regional_momentum_source = _stub("set_regional_momentum_source",
                                         _COUPLING)
    set_regional_manning_n = _stub("set_regional_manning_n", _COUPLING)
    boundary_names = _stub("boundary_names", _COUPLING, property)
    get_num_boundary_conditions = _stub("get_num_boundary_conditions",
                                        _COUPLING)
    get_boundary_id = _stub("get_boundary_id", _COUPLING)
    get_boundary_condition_flow_type = _stub(
        "get_boundary_condition_flow_type", _COUPLING)
    get_boundary_edge_centers = _stub("get_boundary_edge_centers", _COUPLING)
    get_boundary_edge_centroids = _stub("get_boundary_edge_centroids",
                                        _COUPLING)
    get_boundary_cells = _stub("get_boundary_cells", _COUPLING)
    get_boundary_cell_centroids = _stub("get_boundary_cell_centroids",
                                        _COUPLING)
    get_boundary_cell_natural_ids = _stub("get_boundary_cell_natural_ids",
                                          _COUPLING)
    get_num_global_cells = _stub("get_num_global_cells", _COUPLING)
    convert_time = _stub("convert_time", _COUPLING, staticmethod)
    get_time_unit = _stub("get_time_unit", _COUPLING)
    get_version = _stub("get_version", _COUPLING)
    set_log_file = _stub("set_log_file", _COUPLING)
    get_build_configuration = _stub("get_build_configuration", _COUPLING)
    create_prognostic_array = _stub("create_prognostic_array", _COUPLING)
    create_one_dof_array = _stub("create_one_dof_array", _COUPLING)
    read_one_dof_vec_from_binary = _stub("read_one_dof_vec_from_binary",
                                         _COUPLING)
    write_one_dof_vec_to_binary = _stub("write_one_dof_vec_to_binary",
                                        _COUPLING)

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
        """RDySetFlowDirichletBoundaryValues: [3, n_edges] or [n_edges * 3]
        into the flow rows (the JAX package's setter fails on a state with
        tracer rows: it assigns 3 rows to all of them)."""
        seg = self._segment(boundary)
        vals = np.asarray(values, dtype=np.float64)
        if vals.ndim == 1:
            vals = vals.reshape(seg.count, N_FLOW_DOF).T
        bv = self.boundary_values.cpu().numpy().copy()
        bv[:N_FLOW_DOF, seg.start : seg.start + seg.count] = vals
        self.boundary_values = self._tensor(bv)

    # ---- tracer Dirichlet values and sources (RDySet*DirichletBoundaryValues,
    # RDySetRegional*Source) ----
    def _set_tracer_dirichlet(self, boundary: str, row: int, values):
        seg = self._segment(boundary)
        bv = self.boundary_values.cpu().numpy().copy()
        bv[row, seg.start : seg.start + seg.count] = values
        self.boundary_values = self._tensor(bv)

    def set_sediment_dirichlet_boundary_values(
        self, boundary: str, class_values: np.ndarray
    ):
        """class_values: [num_classes, n_edges] of h*c_i."""
        vals = np.atleast_2d(np.asarray(class_values, dtype=np.float64))
        for k in range(vals.shape[0]):
            self._set_tracer_dirichlet(boundary, N_FLOW_DOF + k, vals[k])

    def set_salinity_dirichlet_boundary_values(self, boundary: str, values):
        self._set_tracer_dirichlet(
            boundary, N_FLOW_DOF + self.num_sediment, values)

    def set_temperature_dirichlet_boundary_values(self, boundary: str,
                                                  values):
        row = (N_FLOW_DOF + self.num_sediment
               + (1 if self.config.physics.salinity else 0))
        self._set_tracer_dirichlet(boundary, row, values)

    def set_regional_sediment_source(self, region: str, class_idx: int, rate):
        src = self.ext_src.cpu().numpy().copy()
        src[N_FLOW_DOF + class_idx, self.region_cells[region]] = rate
        self._update_ext_src(src)

    def set_regional_tracer_source(self, region: str, row: int, rate):
        """row: the tracer's index among the tracers (0 = the first)."""
        src = self.ext_src.cpu().numpy().copy()
        src[N_FLOW_DOF + row, self.region_cells[region]] = rate
        self._update_ext_src(src)

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
