"""The Simulation object: the RDy lifecycle.

The counterpart of rdycore_tpu/simulation.py for the single-device paths,
first order, flow only or with tracers (sediment with Hairsine-Rose
sources, salinity, heat), or second order (MUSCL with the positivity
limiter, flow only): unstructured, with or without well-balancing
(hydrostatic reconstruction, or BS2002 flow only), and the uniform raster
(`edge_flux_backend: structured`, first order and flow only, or
`fused_structured`, also cut into `parallel.n_devices` row strips, each on
its own device or several on one card); explicit, ARK-IMEX (`temporal:
ark_imex`, unstructured) or backward Euler (`temporal: beuler`,
unstructured, and on one raster strip flow only)
(the reference's RDy object, src/rdycore.c, src/rdysetup.c,
src/rdyadvance.c):

    sim = Simulation(load_config("case.yaml"))  # RDyCreate + RDySetup
    while not sim.finished:                     # while (!RDyFinished(rdy))
        sim.advance()                           #   RDyAdvance(rdy)

plus the E3SM-style coupling surface (src/rdydata.c): get/set arrays in
natural cell order between coupling intervals, checkpoints and
restart (io/checkpoint.py: `checkpoint.interval`, `restart.file`,
`write_checkpoint`/`read_checkpoint`), and adaptive mesh refinement
(`mark_cells_for_amr`, `perform_amr`, `rebuild_on_mesh`; amr.py). A deck
with an `ensemble` section runs its base configuration here, as in the JAX
package; ensemble.py runs its members.

Multi-process runs (parallel.n_devices > 1 under torch.distributed, ROADMAP
items 16 and 16b): one shard of the unstructured path (every scheme,
BS2002 and AMR included), or one raster row strip, per rank
(`Simulation`'s docstring).

It runs on the CUDA device unless built with device="cpu". A feature
that the JAX package refuses too raises that package's own ConfigError;
what needs h5py where it is absent is a ConfigError naming h5py
(io/hdf5.py); nothing degrades silently.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .config.expressions import compile_expression
from .config.schema import Config, ConfigError, time_from_seconds, time_to_seconds
from .config.yaml_input import load_config
from .constants import N_FLOW_DOF
from .device import DeviceLike, device_name, resolve_device
from .io.checkpoint import restore_from_checkpoint, write_checkpoint
from .io.hdf5 import check_hdf5
from .io.petsc_binary import read_petsc_vec, write_petsc_vec
from .logging_ import Logger
from .mesh.core import Mesh, load_mesh_npz, rcm_reorder
from .mesh.exodus import read_exodus
from .mesh.gmsh import read_gmsh
from .operator import SWEOperator, build_operator
from .parallel.comm import OwnedAccumulators, transport_for
from .parallel.partition import partition_stats
from .parallel.sharded import ShardedSWE
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
from .ops.strips import RankStrip, strip_wall_values
from .ops.swe import boundary as bc_mod
from .ops.swe.sources import (
    SOURCE_IMPLICIT_XQ2018,
    SOURCE_NONE,
    SOURCE_SEMI_IMPLICIT,
)
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
    # admitted under temporal: ark_imex only, whose DIRK stages own the
    # friction (the advancer runs the operator without it)
    "ark_imex": SOURCE_NONE,
}


# the public RDyConditionType of each BC code (include/rdycore.h:133-139:
# dirichlet 0, neumann 1, reflecting 2, critical-outflow 3, runoff 4)
_PUBLIC_BC_TYPES = {bc_mod.BC_DIRICHLET: 0, bc_mod.BC_REFLECTING: 2,
                    bc_mod.BC_CRITICAL_OUTFLOW: 3}


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
    """Raise for any configured feature that no path runs, as the JAX
    package refuses it or where it runs it wrongly (a ConfigError naming
    the ROADMAP fault). What depends on the path is refused by
    `refuse_on_path`."""
    p, n = config.physics, config.numerics
    if p.flow.source.method == "ark_imex" and n.temporal != "ark_imex":
        # the JAX package runs semi-implicit friction for it without a
        # word (ROADMAP fault 11); under temporal: ark_imex the DIRK stages
        # own the friction, whatever the source method
        raise ConfigError(
            "source.method: ark_imex is the friction of temporal: ark_imex "
            f"and has no form under temporal: {n.temporal} (the JAX package "
            "runs semi_implicit friction in its place, ROADMAP fault 11); "
            "use semi_implicit or implicit_xq2018, or temporal: ark_imex"
        )
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
    refuse_on_path(config, path_of(config))


# The features that depend on the path, and the paths that refuse them as
# the JAX package does: one ConfigError listing them all, as it lists them.
_PATH_REFUSALS = (
    ("tracers/sediment", lambda c: num_tracers(c) > 0, ("structured",)),
    ("second_order", lambda c: c.numerics.second_order, ("structured",)),
    ("well_balancing",
     lambda c: c.physics.flow.well_balancing not in (None, "", "none"),
     ("fused_structured", "structured")),
    ("parallel.n_devices > 1", lambda c: c.parallel.n_devices > 1,
     ("structured",)),
    ("time_series.boundary_fluxes",
     lambda c: bool(c.output.time_series.boundary_fluxes), ("structured",)),
    ("time-averaged output fields", lambda c: wants_means(c),
     ("structured",)),
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
    unsupported = [feature for feature, present, paths in _PATH_REFUSALS
                   if path in paths and present(config)]
    if unsupported:
        raise ConfigError(
            f"edge_flux_backend: {path} does not support: "
            + ", ".join(unsupported)
        )


def load_mesh_file(path: str) -> Mesh:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".msh":
        return read_gmsh(path)
    if ext in (".exo", ".e", ".exo2"):
        return read_exodus(path)
    if ext == ".npz":
        return load_mesh_npz(path)
    raise ConfigError(f"unsupported mesh format '{ext}' ({path})")


def _accumulator(k: int, doc: str) -> property:
    """The Simulation attribute of accumulator k of `_accumulators()`: the
    host array (gathered where shards or rank strips hold it); setting it
    replaces the array, and their totals with it."""

    def get(self):
        return self._accumulators()[k]

    def put(self, value):
        acc = self._accumulators()
        acc[k] = value
        if self._owned_accum is not None:
            self._owned_accum.set(*acc)

    return property(get, put, doc=doc)


class Simulation:
    """A configured simulation on `device` (CUDA unless "cpu").

    parallel.n_devices = P > 1, in one process: a fused_structured deck
    runs in P row strips and an unstructured deck in P shards
    (parallel/sharded.py), on cuda:0..P-1 (all on the CPU with
    device="cpu"), or on the devices `strip_devices` names, one per strip
    or shard, a card as often as wanted. The strips' state lives whole on
    `device` between intervals and is cut into the strips each interval,
    as the JAX package packs its shards; the shards keep theirs on their
    devices and `q` is gathered from them when read.

    Under a process group of P ranks (`torchrun`, or
    `parallel.comm.spawn`), each rank holds one shard, or one row strip
    whose buffer stays on its card, on `device`; the deck's n_devices
    must equal the world size, and a one-rank group runs one shard. Then
    every getter and setter of the state, the sources, the boundary
    values and the accumulators is collective (each rank calls it, in the
    same order, with the same values): a getter gathers the owned rows
    from every rank, a setter scatters to them. Rank 0 (`is_writer`)
    writes the outputs and checkpoints; every rank reads a restart file.

    In shards (in one process or over ranks) and rank strips the global
    state, sources and boundary values are host tensors, and the
    accumulators (`accum_sol`, `accum_prim`, `bflux_accum`) stay on the
    shards' devices until read. Assign whole arrays (`q`, `ext_src`,
    `boundary_values`, the accumulators, or the setters): there an
    in-place change of the gathered array reaches no shard."""

    accum_sol = _accumulator(0, "The time-integrated state [ndof, C] "
                                "(host, f64).")
    accum_prim = _accumulator(1, "The time-integrated primitives [ndof, C] "
                                 "(host, f64).")
    bflux_accum = _accumulator(2, "The time-integrated boundary fluxes "
                                  "[ndof, max(Eb, 1)] (host, f64).")

    def __init__(
        self, config: Config, mesh: Optional[Mesh] = None,
        device: DeviceLike = None,
        strip_devices: Optional[List[DeviceLike]] = None,
    ):
        check_slice(config)
        check_hdf5(config)
        self.device = resolve_device(device)
        self.strip_devices = strip_devices
        self.config = config
        # the run's parallel mode: with a process group, one shard (or row
        # strip) per rank; without, P shards (strips) in this process
        self._ranks = dist.is_available() and dist.is_initialized()
        # the one process that writes the run's files (outputs,
        # checkpoints, time series, the log file): rank 0 of a group
        self.is_writer = not self._ranks or dist.get_rank() == 0
        self.log = Logger(config.logging.level,
                          config.logging.file if self.is_writer else "")
        self.dtype = config.dtype
        n_dev = config.parallel.n_devices
        path = path_of(config)
        if self._ranks and dist.get_world_size() != max(n_dev, 1):
            raise ConfigError(
                f"parallel.n_devices = {n_dev} but the process group has "
                f"{dist.get_world_size()} ranks; run one rank per device")
        n_shards = (max(n_dev, 1) if path == "unstructured"
                    and (n_dev > 1 or self._ranks) else 0)
        rank_strips = self._ranks and path == "fused_structured" and n_dev > 1
        self._sharded: Optional[ShardedSWE] = None
        self._rank_strip = None
        self._q = self._ext_src = self._bv = self._strip_src = None
        # where the global state, sources and boundary values live: on the
        # host when shards or rank strips hold the state on their devices
        self._home = (torch.device("cpu") if n_shards or rank_strips
                      else self.device)
        # the accumulators the shards or rank strips hold on their devices
        self._owned_accum: Optional[OwnedAccumulators] = None

        # ---- mesh (rdysetup.c CreateDM + RDyMeshCreateFromDM) ----
        if mesh is None:
            mesh_path = config.resolve_path(config.grid.file)
            self.log.detail(f"Loading mesh from {mesh_path}")
            mesh = load_mesh_file(mesh_path)
        if config.numerics.cell_ordering == "rcm":
            mesh = rcm_reorder(mesh)
            self.log.detail("applied RCM cell ordering")
        elif (n_dev > 1 and path == "unstructured"
              and config.parallel.partitioning == "auto"):
            # the shards are equal contiguous blocks of the cell order:
            # RCM bands it, so each shard's ghosts lie on its neighbours
            # (the JAX package's simulation.py:87-103; ParMETIS's place in
            # the reference, rdydm.c:116-121). Couplers see the reordered
            # cells; natural ids map them.
            mesh = rcm_reorder(mesh)
            self.log.detail(
                "applied RCM partition ordering (parallel.partitioning: auto)")
        if config.grid.cell_elevation.file:
            cell_elev = read_petsc_vec(
                config.resolve_path(config.grid.cell_elevation.file)
            )
            # the file is in natural cell order; a reordering above must
            # scatter it (the reference's natural -> global VecScatter,
            # rdysetup.c:826-831)
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
            # in shards or rank strips no device holds the whole operator
            device="cpu" if n_shards or rank_strips else self.device,
        )
        if n_shards:
            self._init_sharded(n_shards)

        # ---- uniform-raster paths ----
        self._structured = None
        if config.numerics.edge_flux_backend in (
            "structured", "fused_structured"
        ):
            self._init_structured_backend()
        in_process = (self._structured and self._structured.get("strips")
                      or self._sharded is not None) and not self._ranks
        if strip_devices is not None and not in_process:
            raise ValueError(
                "strip_devices: only a deck with parallel.n_devices > 1 run "
                "in one process (fused_structured strips or unstructured "
                "shards) takes devices")

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
        if self._advance_scheme == "ark_imex":
            self.log.info(
                "ark_imex: ARS(2,2,2) — explicit fluxes + per-cell "
                "closed-form implicit Manning friction per stage"
                + ("; tracers advance explicitly" if self.ndof > 3 else "")
            )
        if self._advance_scheme == "beuler":
            self.log.info(
                "beuler: backward Euler via matrix-free Newton-GMRES "
                "(kernel residuals, linearization-twin JVPs)"
            )
        self._monitors: List[Callable] = []

        # monitors fire at step cadence in the reference (TSMonitors); each
        # coupling interval splits into chunks of the gcd of all configured
        # step intervals so each monitor sees its exact steps
        intervals = [
            i
            for i in (
                config.checkpoint.interval,
                config.output.output_interval
                if config.output.format != "none"
                else 0,
                config.output.time_series.boundary_fluxes,
                config.output.time_series.observations.interval,
            )
            if i
        ]
        self.monitor_stride = math.gcd(*intervals) if intervals else 0

        # accumulated diagnostics for time series / outputs (host, f64;
        # in shards or rank strips gathered from them when read)
        self._accum = [
            np.zeros((self.ndof, mesh.num_cells)),
            np.zeros((self.ndof, mesh.num_cells)),
            np.zeros((self.ndof, max(self.operator.num_boundary_edges, 1)))]
        self.accum_time = 0.0

        self.log_domain_statistics()

        # ---- restart (checkpoint.c:259-317) ----
        if config.restart.file:
            restore_from_checkpoint(
                self, config.resolve_path(config.restart.file),
                config.restart.reinitialize)
            self.log.info(
                f"restarted from {config.restart.file} at t = {self.t:.6g} "
                f"s, step {self.step}")

    @classmethod
    def from_file(cls, path: str, device: DeviceLike = None,
                  **overrides) -> "Simulation":
        """RDyCreate + RDySetup from a YAML deck (`overrides`: dotted config
        keys to replace)."""
        return cls(load_config(path, overrides or None), device=device)

    # ------------------------------------------------------------- shards
    def _init_sharded(self, n_shards: int):
        """The unstructured path in n_shards shards (parallel/sharded.py):
        one per rank of the process group, else all here on the devices of
        `_strip_device_list`; the operator stays on the host, each shard's
        part on its device."""
        devices = ([self.device] if self._ranks
                   else self._strip_device_list(n_shards))
        self._sharded = sh = ShardedSWE(
            self.operator, n_shards, transport_for(n_shards, devices))
        self._owned_accum = sh.accumulators
        ghosts, frontier = partition_stats(sh.plans)
        where = (f"{n_shards} ranks over {dist.get_backend()}" if self._ranks
                 else "one process on " + ", ".join(map(str, devices)))
        self.log.info(
            f"parallel: {n_shards} shards of {sh.B} cells ({where}); halo "
            f"{'neighbours only' if sh.neighbor_only else 'any shard'}")
        vring = ([pl.vertex_ghosts for pl in sh.plans]
                 if self.operator.well_balancing_bs2002 else None)
        self.log.detail(
            f"partition: ghosts per shard {ghosts}, frontier cells per "
            f"shard {frontier}"
            + (f", BS2002 vertex-ring ghosts per shard {vring}" if vring
               else ""))
        cards = {d for d in devices if d.type == "cuda"}
        if not self._ranks and len(cards) > 1:
            self.log.warning(
                f"{n_shards} shards on {len(cards)} cards in one process run "
                "one thread per card under one interpreter lock: on four "
                "H100s 12-17 times slower a step than one card (ROADMAP "
                "item 7n). One rank per card scales: torchrun --standalone "
                f"--nproc-per-node {n_shards} -m rdycore_tpu_torch deck.yaml")

    @property
    def q(self) -> torch.Tensor:
        """The state [ndof, C] on `device`; in shards or rank strips on the
        host, gathered from them when first read after an interval
        (collective over the ranks), and setting it scatters it to them."""
        if self._q is None:
            self._q = (self._sharded.gather_state(self._qs, self._home)
                       if self._sharded is not None
                       else self._rank_strip.gather_state(self._home).to(
                           self.dtype))
        return self._q

    @q.setter
    def q(self, value: torch.Tensor):
        self._q = value
        if self._sharded is not None:
            self._qs = self._sharded.scatter_state(value)
        elif self._rank_strip is not None:
            self._rank_strip.set_state(value.to(torch.float32))

    @property
    def ext_src(self) -> torch.Tensor:
        """The external sources [ndof, C] on `device` (in shards or rank
        strips on the host; set: scattered to the shards, and a rank
        strip takes its rows at its next interval)."""
        return self._ext_src

    @ext_src.setter
    def ext_src(self, value: torch.Tensor):
        self._ext_src = value
        self._strip_src = None
        if self._sharded is not None:
            self._ess = self._sharded.scatter_state(value)

    @property
    def boundary_values(self) -> torch.Tensor:
        """The Dirichlet values [ndof, max(Eb, 1)] on `device` (in shards or
        rank strips on the host; set: scattered to the shards)."""
        return self._bv

    @boundary_values.setter
    def boundary_values(self, value: torch.Tensor):
        self._bv = value
        if self._sharded is not None:
            self._bvs = self._sharded.scatter_boundary(value)

    def _advance_sharded(self, n_steps: int, t_end: float):
        """n_steps steps of the shards; returns the chunk's (max Courant
        number, edge id attaining it). The shards' states and accumulators
        stay on their devices (ROADMAP fault 27: the shards accumulate)."""
        res = self._advance_fn(self._qs, self.t, self.dt, n_steps, t_end,
                               self._bvs, self._ess)
        self._qs = res.qs
        self._q = None
        self.t = res.t
        self.step += int(n_steps)
        self.accum_time += res.accum_time
        return res.max_courant, res.courant_edge

    def _accumulators(self) -> list:
        """[accum_sol, accum_prim, bflux_accum], host f64 arrays: gathered
        from the shards or rank strips where they hold them (collective
        over the ranks)."""
        if self._owned_accum is not None:
            return self._owned_accum.gather()
        return self._accum

    # ------------------------------------------------------------- setup bits
    def _tensor(self, x) -> torch.Tensor:
        """x where the global arrays live (the device, or the host in shards
        or rank strips) in the simulation's dtype, C-contiguous (the kernels
        take nothing else)."""
        return torch.as_tensor(np.ascontiguousarray(x), dtype=self.dtype,
                               device=self._home)

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

        if self._advance_fn is None and self._sharded is not None:
            self._advance_fn = self._sharded.make_interval_fn(
                self._advance_scheme, accumulate=self._needs_accumulators(),
                ext_sources=self._ext_active)
        elif self._advance_fn is None and self._structured is None:
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
                cmax, edge = (self._advance_sharded(chunk, t_end)
                              if self._sharded is not None else
                              self._advance_unstructured(chunk, t_end))
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
                side_cols[side] = torch.as_tensor(cols, device=self._home)
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
            rank = None
            if n_dev > 1 and self._ranks:
                # one strip per rank: this rank's planes on its card
                rank = dist.get_rank()
                cpu = torch.device("cpu")
                devices = [self.device if k == rank else cpu
                           for k in range(n_dev)]
                strip_ops = fused_strip_operators(
                    plan, *(torch.as_tensor(x, dtype=torch.float32)
                            for x in (dzx, dzy, mann)),
                    devices, bnd, **options)
                op = strip_ops[rank]
                old = self._rank_strip
                self._rank_strip = RankStrip(
                    [o.strip for o in strip_ops], nx,
                    transport_for(n_dev, [self.device]), self.device)
                if old is not None:  # a rebuild keeps the state
                    self._rank_strip.buf = old.buf
                else:  # each strip's rows and boundary edges
                    self._owned_accum = OwnedAccumulators(
                        self._rank_strip.transport,
                        [(np.arange(o.strip.row0 * nx,
                                    (o.strip.row0 + o.strip.rows) * nx),
                          np.zeros(0, np.int64) if o.bnd is None
                          else o.bnd_idx.cpu().numpy())
                         for o in strip_ops],
                        self.ndof, ny * nx, self.operator.num_boundary_edges)
            elif n_dev > 1:
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
            lin_op = None
            if scheme == "beuler":
                # the Newton-GMRES JVP twin: the first-order raster operator
                # in float32 with zero Dirichlet ghosts, as the JAX
                # package's lin_op (its simulation.py:846-860)
                lin_op = build_structured_operator(
                    nx, ny, dx, dy, mannings_n=mann, dtype=torch.float32,
                    dz_dx=dzx, dz_dy=dzy, device=self.device,
                    **{f"bc_{side}": bc for side, bc in bcs.items()},
                    tiny_h=cfg.physics.flow.tiny_h,
                    h_anuga=cfg.physics.flow.h_anuga_reg_parameter,
                    source_method=self.operator.source_method,
                    xq2018_threshold=self.operator.xq2018_threshold,
                )
            self._structured = dict(
                kind="fused", nx=nx, ny=ny, op=op, scheme=scheme,
                with_src=bool(cfg.sources), side_cols=side_cols,
                accumulate=accum, strips=n_dev > 1, lin_op=lin_op,
                adv=make_fused_structured_stepper(
                    op, scheme, accumulate=accum, lin_op=lin_op,
                    exchange_halo=None if rank is None
                    else self._rank_strip.exchange),
            )
            where = ("; its plain version on the CPU"
                     if self.device.type == "cpu" else "")
            if rank is not None:
                where += (f"; {n_dev} row strips of {ny // n_dev} rows, "
                          f"strip {rank} on this rank's {self.device}")
            elif n_dev > 1:
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
            bv = self.boundary_values
            bc_vals = {side: bv[:, cols].to(f32)
                       for side, cols in st["side_cols"].items()}
            if self._rank_strip is not None:
                return self._advance_rank_strip(n_steps, t_end, bc_vals)
            src = (self.ext_src[0].reshape(ny, nx).to(f32)
                   if st["with_src"] else None)
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

    def _advance_rank_strip(self, n_steps: int, t_end: float,
                            bc_vals) -> float:
        """n_steps steps of this rank's row strip, its buffer, rain rows
        and accumulators kept on the card; returns the Courant maximum over
        the ranks."""
        st, rs = self._structured, self._rank_strip
        op, s, dev = st["op"], rs.strip, self.device
        f32, host = torch.float32, torch.device("cpu")
        nx, ny = st["nx"], st["ny"]
        if st["with_src"] and self._strip_src is None:
            self._strip_src = self.ext_src[0].reshape(ny, nx)[
                s.row0:s.row0 + s.rows].to(dev, f32)
        src_s = self._strip_src if st["with_src"] else None
        bv = self.boundary_values
        bves = [None]
        if st["accumulate"] and op.bnd is not None:
            bves = [bv[:, op.bnd_idx.to(bv.device)].to(f32).to(dev)]
        r = st["adv"].strips([rs.buf], np.float32(self.t),
                             np.float32(self.dt), int(n_steps),
                             np.float32(t_end), [src_s],
                             [strip_wall_values(bc_vals, s, ny, dev)], bves)
        rs.buf = r["q"][0]
        self._q = None
        cmax = rs.gather(r["cmax"][0].reshape(1, 1), host).max()
        if st["accumulate"]:
            self._owned_accum.add(rs.rank, rs.owned(r["asol"][0]),
                                  r["aprim"][0], r["bfa"][0])
            self.accum_time += float(r["atime"])
        self.t = float(r["t"])
        self.step += int(n_steps)
        self.prev_courant_edge = None
        return float(cmax)

    # ---- adaptive mesh refinement (src/rdyamr.c, amr.py) ----
    def rebuild_on_mesh(self, new_mesh: Mesh, mannings_n: np.ndarray) -> None:
        """Rebuild the operator and stepper on a new mesh, keeping the time
        state (t, dt, step, the last Courant number), the monitors, the
        logger, the devices and every attribute that setup does not make
        (used by AMR, rdyamr.c:482+: regions/boundaries/operator/TS are
        reconstructed on the refined mesh). The setup pipeline runs again on
        `new_mesh`, as the JAX package's `__init__` does, so its errors are
        that package's (a raster deck: the ConfigError of a mesh that is no
        raster), and the accumulators start again from zero; it is built
        whole before it replaces anything, so a failed rebuild leaves the
        simulation as it was. A monitor with a `before_rebuild(sim)` method
        is told before the swap (the boundary-flux series writes its
        partial interval, ROADMAP fault 26). The caller sets the state
        and sources afterwards (amr.perform_amr). On a CUDA device the
        log's info line gives the device memory before, after and at peak:
        the old operator's tensors are alive while the new one is built.

        In shards the new simulation partitions the new mesh again, over
        the same devices or process group (in ranks a collective: every
        rank calls it with the same mesh); in rank strips, as on one
        raster, the refined mesh is no raster (the ConfigError)."""
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
        new = Simulation(self.config, mesh=new_mesh, device=dev,
                         strip_devices=self.strip_devices)
        new.log.close()
        new.set_manning_n(mannings_n)
        for mon in self._monitors:
            if hasattr(mon, "before_rebuild"):
                mon.before_rebuild(self)
        keep = dict(t=self.t, dt=self.dt, step=self.step,
                    prev_max_courant=self.prev_max_courant,
                    _monitors=self._monitors, log=self.log)
        self.__dict__.update(new.__dict__)
        self.__dict__.update(keep)
        if dev.type == "cuda":
            gb = 1e-9
            self.log.info(
                f"rebuild_on_mesh: {new_mesh.num_cells} cells; device memory "
                f"{before * gb:.3f} GB before, "
                f"{torch.cuda.memory_allocated(dev) * gb:.3f} GB after, peak "
                f"{torch.cuda.max_memory_allocated(dev) * gb:.3f} GB")

    def mark_cells_for_amr(self, refine_cell: np.ndarray) -> None:
        """Save per-cell refinement flags for the next perform_amr()
        (RDyMarkOwnedCellsForAMR, src/rdyamr.c:46-60)."""
        flags = np.asarray(refine_cell, dtype=bool)
        if flags.shape != (self.mesh.num_cells,):
            raise ValueError(
                f"refine_cell must have shape ({self.mesh.num_cells},)"
            )
        self._amr_marked = flags.copy()

    def perform_amr(self) -> None:
        """Refine marked cells, transfer state, rebuild operators
        (RDyPerformAMR, src/rdyamr.c:482+). Cells must have been marked
        with mark_cells_for_amr() first."""
        from .amr import perform_amr

        marked = getattr(self, "_amr_marked", None)
        if marked is None:
            raise RuntimeError(
                "no cells marked: call mark_cells_for_amr() first"
            )
        self._amr_marked = None
        perform_amr(self, marked)

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
        a = self.operator.arrays
        a.mannings_n = torch.as_tensor(self.mannings_n, dtype=self.dtype,
                                       device=a.area.device)
        if self._sharded is not None:
            self._sharded.set_cell_field("mannings_n", self.mannings_n)
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

    def set_momentum_source(self, comp: int, rate: np.ndarray | float):
        """A momentum source on every cell into state row `comp` (1 = x
        momentum, 2 = y momentum), as the JAX package's setter indexes it."""
        if comp not in (1, 2):
            raise ValueError(f"comp {comp}: the momentum rows are 1 and 2")
        src = self.ext_src.cpu().numpy().copy()
        src[comp, :] = rate
        self._update_ext_src(src)

    def set_regional_momentum_source(self, region: str, comp: int, rate):
        """RDySetRegional{X,Y}MomentumSource: comp 0 = x momentum, 1 = y."""
        if comp not in (0, 1):
            raise ValueError(f"comp {comp}: 0 (x momentum) or 1 (y momentum)")
        src = self.ext_src.cpu().numpy().copy()
        src[1 + comp, self.region_cells[region]] = rate
        self._update_ext_src(src)

    def set_regional_manning_n(self, region: str, values):
        """RDySetRegionalManningsN: Manning's n on one region's cells."""
        n = self.mannings_n.copy()
        n[self.region_cells[region]] = values
        self.set_manning_n(n)

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

    @staticmethod
    def convert_time(value: float, unit_from: str, unit_to: str) -> float:
        """RDyConvertTime (rdyadvance.c:427-432)."""
        return time_from_seconds(time_to_seconds(value, unit_from), unit_to)

    def get_time_unit(self) -> str:
        """RDyGetTimeUnit: the deck's time unit."""
        return self.time_unit

    # ---- version, build and logging (src/rdycore.c, rdysetup.c:1282) ----
    def get_version(self) -> str:
        """RDyGetVersion."""
        from . import __version__

        return __version__

    def get_build_configuration(self) -> str:
        """RDyGetBuildConfiguration: the package's version, torch's, the
        device and the dtype."""
        from . import __version__

        return (f"rdycore_tpu_torch {__version__} (torch {torch.__version__}, "
                f"device {self.device} ({device_name(self.device)}), dtype "
                f"{str(self.dtype).removeprefix('torch.')})")

    def set_log_file(self, path: str):
        """RDySetLogFile: the leveled log goes to `path` from now on."""
        self.log.close()
        self.log = Logger(self.config.logging.level, path)

    # ---- checkpoints (RDyWrite/ReadHDF5CheckpointFile, src/checkpoint.c) ----
    def write_checkpoint(self, path: str):
        """The state in natural order and {t, dt, step}: `.bin` PETSc
        binary, else HDF5 (which needs h5py)."""
        write_checkpoint(self, path)

    def read_checkpoint(self, path: str, reinitialize: bool = False):
        """Restore the state, and unless `reinitialize` {t, dt, step}."""
        restore_from_checkpoint(self, path, reinitialize)

    @property
    def restarted(self) -> bool:
        """RDyRestarted: whether the deck restarts from a checkpoint."""
        return bool(self.config.restart.file)

    # ---- arrays shaped like the state, and one-DOF files (rdydata.c) ----
    def create_prognostic_array(self) -> np.ndarray:
        """RDyCreatePrognosticVec: zeros [ndof, num_cells]."""
        return np.zeros((self.ndof, self.mesh.num_cells))

    def create_one_dof_array(self) -> np.ndarray:
        """RDyCreateOneDOFGlobalVec: zeros [num_cells]."""
        return np.zeros(self.mesh.num_cells)

    def read_one_dof_vec_from_binary(self, path: str) -> np.ndarray:
        """RDyReadOneDOFGlobalVecFromBinaryFile (rdydata.c:583-633): a
        naturally ordered per-cell PETSc binary Vec, in the simulation's cell
        order."""
        data = read_petsc_vec(path)
        if data.size != self.mesh.num_cells:
            raise ValueError(f"{path}: expected {self.mesh.num_cells} "
                             f"values, got {data.size}")
        return data[self.mesh.natural_ids]

    def write_one_dof_vec_to_binary(self, path: str, values: np.ndarray):
        """RDyWriteOneDOFGlobalVecToBinaryFile (rdydata.c:559-580): per-cell
        values (simulation cell order) as a naturally ordered PETSc binary
        Vec."""
        values = np.asarray(values, dtype=np.float64)
        if values.shape != (self.mesh.num_cells,):
            raise ValueError(f"expected shape ({self.mesh.num_cells},), got "
                             f"{values.shape}")
        natural = np.empty_like(values)
        natural[self.mesh.natural_ids] = values
        write_petsc_vec(path, natural)

    # ---- boundary metadata (RDyGetNumBoundaryEdges) ----
    def _segment(self, boundary: str):
        return {s.name: s for s in self.operator.segments}[boundary]

    def get_num_boundary_edges(self, boundary: str) -> int:
        return self._segment(boundary).count

    @property
    def boundary_names(self) -> List[str]:
        """The boundaries in operator order, the implicit reflecting wall
        (`__auto_reflecting__`) included."""
        return [s.name for s in self.operator.segments]

    def get_num_global_cells(self) -> int:
        """RDyGetNumGlobalCells."""
        return self.mesh.num_cells

    def get_num_boundary_conditions(self) -> int:
        """RDyGetNumBoundaryConditions (rdydata.c:18)."""
        return len(self.operator.segments)

    def get_boundary_id(self, boundary: str) -> int:
        """RDyGetBoundaryID (rdydata.c:434): the mesh's id of a named
        boundary; -1 for the implicit reflecting wall."""
        for b in self.config.boundaries:
            if b.name == boundary:
                return b.grid_boundary_id
        self._segment(boundary)  # KeyError for a name that is no boundary
        return -1

    def get_boundary_condition_flow_type(self, boundary: str) -> int:
        """RDyGetBoundaryConditionFlowType: the public RDyConditionType."""
        return _PUBLIC_BC_TYPES[self._segment(boundary).bc_type]

    def get_boundary_edge_centers(self, boundary: str) -> np.ndarray:
        """[n, 2] midpoints of the boundary's edges."""
        seg = self._segment(boundary)
        return self._bnd_centers[seg.start : seg.start + seg.count]

    def get_boundary_edge_centroids(self, boundary: str) -> np.ndarray:
        """[n, 3] midpoints of the boundary's edges, bed elevation included
        (RDyGetBoundaryEdge{X,Y,Z}Centroids)."""
        ev = self.mesh.edge_vertices[self._segment(boundary).edge_ids]
        return (self.mesh.points[ev[:, 0]] + self.mesh.points[ev[:, 1]]) / 2.0

    def get_boundary_cells(self, boundary: str) -> np.ndarray:
        """The cell inside each of the boundary's edges."""
        return self.mesh.edge_cells[self._segment(boundary).edge_ids, 0]

    def get_boundary_cell_centroids(self, boundary: str) -> np.ndarray:
        return self.mesh.cell_centroid[self.get_boundary_cells(boundary)]

    def get_boundary_cell_natural_ids(self, boundary: str) -> np.ndarray:
        return self.mesh.natural_ids[self.get_boundary_cells(boundary)]

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
