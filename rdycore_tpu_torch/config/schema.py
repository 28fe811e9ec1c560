"""Typed configuration schema: the libcyaml/RDyConfig replacement.

Mirrors the YAML schema of the reference (src/yaml_input.c +
include/private/rdyconfigimpl.h) section by section: physics, numerics,
time (+adaptive), logging, checkpoint, restart, output (+time series +
observations), grid, materials, surface_composition, regions, boundaries,
initial_conditions, sources, boundary_conditions, flow/sediment/salinity/
temperature conditions, ensemble, and mms. Defaults and validation match
SetMissingValues / ValidateConfig (yaml_input.c:851-1060).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..constants import (
    DEFAULT_H_ANUGA,
    DEFAULT_TINY_H,
    DEFAULT_XQ2018_THRESHOLD,
)

# ------------------------------- enums (string-typed for ergonomics)

FLOW_MODES = ("swe", "diffusion")
SOURCE_METHODS = ("semi_implicit", "implicit_xq2018", "ark_imex")
WELL_BALANCING = ("none", "bs2002", "hydrostatic_reconstruction")
LIMITERS = ("minmod", "none", "van_leer")
SPATIAL = ("fv", "fe")
TEMPORAL = ("euler", "rk4", "ssprk2", "ssprk3", "ark_imex", "beuler")
RIEMANN = ("roe", "upwind_roe", "hllc")
TIME_UNITS = ("seconds", "minutes", "hours", "days", "months", "years")
OUTPUT_FORMATS = ("none", "binary", "xdmf", "cgns")
CHECKPOINT_FORMATS = ("binary", "hdf5")
CONDITION_TYPES = ("dirichlet", "neumann", "reflecting", "critical-outflow", "runoff")
LOG_LEVELS = ("none", "warning", "info", "detail", "debug")

_SECONDS = {
    "seconds": 1.0,
    "minutes": 60.0,
    "hours": 3600.0,
    "days": 86400.0,
    "months": 30.0 * 86400.0,
    "years": 365.0 * 86400.0,
}


def time_to_seconds(value: float, unit: str) -> float:
    return value * _SECONDS[unit]


def time_from_seconds(value: float, unit: str) -> float:
    return value / _SECONDS[unit]


class ConfigError(ValueError):
    pass


def _check(cond, msg):
    if not cond:
        raise ConfigError(msg)


# ------------------------------- physics


@dataclass
class FlowSource:
    method: str = "semi_implicit"
    xq2018_threshold: float = DEFAULT_XQ2018_THRESHOLD


@dataclass
class PhysicsFlow:
    mode: str = "swe"
    tiny_h: float = DEFAULT_TINY_H
    h_anuga_reg_parameter: float = DEFAULT_H_ANUGA
    source: FlowSource = field(default_factory=FlowSource)
    well_balancing: str = "none"
    bed_slope: Optional[bool] = None  # None = auto from well_balancing


@dataclass
class PhysicsSediment:
    num_classes: int = 0


@dataclass
class Physics:
    flow: PhysicsFlow = field(default_factory=PhysicsFlow)
    sediment: PhysicsSediment = field(default_factory=PhysicsSediment)
    salinity: bool = False
    heat: bool = False


# ------------------------------- numerics


@dataclass
class Numerics:
    spatial: str = "fv"
    temporal: str = "euler"
    riemann: str = "roe"
    second_order: bool = False
    limiter: str = "minmod"
    # computation precision (the reference is f64-only; f32 is the fast
    # path on accelerators)
    precision: str = "double"  # "single" | "double"
    # interior edge-flux backend of the JAX package ("xla" gather twin or
    # "pallas" kernels; both select the unstructured path of this package,
    # "structured"/"fused_structured" are not ported yet) and cell ordering
    # ("file" keeps the mesh file order, "rcm" applies reverse
    # Cuthill-McKee for gather locality)
    edge_flux_backend: str = "xla"
    cell_ordering: str = "file"  # "file" | "rcm"


# ------------------------------- time


@dataclass
class TimeAdaptive:
    enable: bool = False
    target_courant_number: float = 0.0
    max_increase_factor: float = 0.0
    initial_time_step: float = 0.0


@dataclass
class Time:
    date: str = ""
    stop: Optional[float] = None  # final time [unit]
    unit: str = "seconds"
    stop_n: Optional[int] = None  # max number of steps
    time_step: Optional[float] = None  # [unit]
    coupling_interval: Optional[float] = None  # [unit]
    adaptive: TimeAdaptive = field(default_factory=TimeAdaptive)


# ------------------------------- logging / checkpoint / restart


@dataclass
class Logging:
    file: str = ""
    level: str = "info"


@dataclass
class Checkpoint:
    format: str = "hdf5"
    interval: int = 0  # steps; 0 = disabled
    prefix: str = ""


@dataclass
class Restart:
    file: str = ""
    reinitialize: bool = False


# ------------------------------- output


@dataclass
class ObservationSites:
    cells: List[int] = field(default_factory=list)


@dataclass
class ObservationTimeSampling:
    instantaneous: bool = True


@dataclass
class Observations:
    interval: int = 0
    sites: ObservationSites = field(default_factory=ObservationSites)
    time_sampling: ObservationTimeSampling = field(
        default_factory=ObservationTimeSampling
    )


@dataclass
class TimeSeries:
    boundary_fluxes: int = 0  # steps between outputs; 0 = disabled
    observations: Observations = field(default_factory=Observations)


@dataclass
class Output:
    directory: str = "output"
    fields: List[str] = field(default_factory=list)
    format: str = "none"
    output_interval: int = 0
    time_interval: int = 0
    time_unit: str = "seconds"
    batch_size: int = 1
    time_series: TimeSeries = field(default_factory=TimeSeries)
    # prefix defaults to the config file stem, like the reference
    prefix: str = ""


# ------------------------------- grid


@dataclass
class CellElevation:
    file: str = ""
    format: str = "binary"


@dataclass
class Grid:
    file: str = ""
    cell_elevation: CellElevation = field(default_factory=CellElevation)


# ------------------------------- materials / regions / boundaries


@dataclass
class MaterialProperty:
    value: Optional[object] = None  # number or expression string
    file: str = ""
    format: str = "binary"


@dataclass
class MaterialProperties:
    manning: MaterialProperty = field(default_factory=MaterialProperty)


@dataclass
class Material:
    name: str = ""
    properties: MaterialProperties = field(default_factory=MaterialProperties)


@dataclass
class SurfaceComposition:
    region: str = ""
    material: str = ""


@dataclass
class Region:
    name: str = ""
    grid_region_id: int = -1


@dataclass
class Boundary:
    name: str = ""
    grid_boundary_id: int = -1


# ------------------------------- conditions


@dataclass
class RegionCondition:
    region: str = ""
    flow: str = ""
    sediment: str = ""
    salinity: str = ""
    temperature: str = ""


@dataclass
class BoundaryCondition:
    boundaries: List[str] = field(default_factory=list)
    flow: str = ""
    sediment: str = ""
    salinity: str = ""
    temperature: str = ""


@dataclass
class FlowCondition:
    name: str = ""
    type: str = "dirichlet"
    height: Optional[object] = None  # number or expression string
    x_momentum: Optional[object] = None
    y_momentum: Optional[object] = None
    value: Optional[object] = None  # generic value (diffusion mode / runoff)
    file: str = ""
    format: str = "binary"


@dataclass
class ComponentCondition:
    value: Optional[object] = None
    file: str = ""
    format: str = "binary"


@dataclass
class SedimentCondition:
    name: str = ""
    type: str = "dirichlet"
    # per-class concentrations, keyed c0..c4 in YAML (MAX_NUM_SEDIMENT_CLASSES)
    c0: Optional[ComponentCondition] = None
    c1: Optional[ComponentCondition] = None
    c2: Optional[ComponentCondition] = None
    c3: Optional[ComponentCondition] = None
    c4: Optional[ComponentCondition] = None
    # single-concentration shorthand
    concentration: Optional[object] = None
    file: str = ""
    format: str = "binary"

    @property
    def classes(self) -> List[ComponentCondition]:
        out = []
        for c in (self.c0, self.c1, self.c2, self.c3, self.c4):
            if c is not None:
                out.append(c)
        return out


@dataclass
class SalinityCondition:
    name: str = ""
    type: str = "dirichlet"
    concentration: Optional[object] = None
    file: str = ""
    format: str = "binary"


@dataclass
class TemperatureCondition:
    name: str = ""
    type: str = "dirichlet"
    temperature: Optional[object] = None
    file: str = ""
    format: str = "binary"


# ------------------------------- ensemble


@dataclass
class EnsembleMember:
    name: str = ""
    grid: Optional[Grid] = None
    materials: List[Material] = field(default_factory=list)
    flow_conditions: List[FlowCondition] = field(default_factory=list)
    sediment_conditions: List[SedimentCondition] = field(default_factory=list)
    salinity_conditions: List[SalinityCondition] = field(default_factory=list)
    temperature_conditions: List[TemperatureCondition] = field(
        default_factory=list
    )


@dataclass
class Ensemble:
    size: int = 0
    members: List[EnsembleMember] = field(default_factory=list)


# ------------------------------- mms


@dataclass
class MMSConvergenceRates:
    L1: float = 0.0
    L2: float = 0.0
    Linf: float = 0.0


@dataclass
class MMSConvergence:
    num_refinements: int = 0
    base_refinement: int = 0
    expected_rates: Dict[str, MMSConvergenceRates] = field(default_factory=dict)


@dataclass
class MMS:
    constants: Dict[str, float] = field(default_factory=dict)
    swe: Dict[str, str] = field(default_factory=dict)  # h, dhdx, ..., z, n
    sediment: Dict[str, str] = field(default_factory=dict)
    convergence: Optional[MMSConvergence] = None


# ------------------------------- parallel


@dataclass
class Parallel:
    """Multi-device execution (the MPI domain-decomposition replacement).
    n_devices = 0 -> single device. n_devices = P > 1: the unstructured
    path in P shards (parallel/sharded.py) and a fused_structured raster
    in P row strips; one per rank under a process group of P ranks
    (`torchrun --nproc-per-node P -m rdycore_tpu_torch deck.yaml`),
    else all P in one process, on cuda:0..P-1 or on the CPU.

    partitioning: "auto" applies a graph-aware (RCM-banded) cell ordering
    before the equal-contiguous-block shard split, the analogue of the
    reference's ParMETIS DMPlexDistribute (rdydm.c:116-121): irregular
    meshes get O(bandwidth) frontiers and every ghost stays on shard p+-1
    (a halo with the neighbouring shards only). "none" shards the file
    order as-is. axis_name is read and unused (the JAX package's device
    mesh axis)."""

    n_devices: int = 0
    axis_name: str = "mesh"
    partitioning: str = "auto"  # auto | none


# ------------------------------- root


@dataclass
class Config:
    physics: Physics = field(default_factory=Physics)
    numerics: Numerics = field(default_factory=Numerics)
    time: Time = field(default_factory=Time)
    logging: Logging = field(default_factory=Logging)
    checkpoint: Checkpoint = field(default_factory=Checkpoint)
    restart: Restart = field(default_factory=Restart)
    output: Output = field(default_factory=Output)
    grid: Grid = field(default_factory=Grid)
    materials: List[Material] = field(default_factory=list)
    regions: List[Region] = field(default_factory=list)
    surface_composition: List[SurfaceComposition] = field(default_factory=list)
    initial_conditions: List[RegionCondition] = field(default_factory=list)
    sources: List[RegionCondition] = field(default_factory=list)
    boundaries: List[Boundary] = field(default_factory=list)
    boundary_conditions: List[BoundaryCondition] = field(default_factory=list)
    flow_conditions: List[FlowCondition] = field(default_factory=list)
    sediment_conditions: List[SedimentCondition] = field(default_factory=list)
    salinity_conditions: List[SalinityCondition] = field(default_factory=list)
    temperature_conditions: List[TemperatureCondition] = field(
        default_factory=list
    )
    ensemble: Ensemble = field(default_factory=Ensemble)
    mms: MMS = field(default_factory=MMS)
    parallel: Parallel = field(default_factory=Parallel)
    # directory of the config file (for resolving relative paths)
    config_dir: str = "."

    # ------------------------------------------------ validation
    def validate(self) -> "Config":
        p, n, t = self.physics, self.numerics, self.time
        _check(p.flow.mode in FLOW_MODES, f"physics.flow.mode must be one of {FLOW_MODES}")
        _check(
            p.flow.source.method in SOURCE_METHODS,
            f"physics.flow.source.method must be one of {SOURCE_METHODS}",
        )
        _check(
            p.flow.well_balancing in WELL_BALANCING,
            f"physics.flow.well_balancing must be one of {WELL_BALANCING}",
        )
        _check(n.spatial in SPATIAL, f"numerics.spatial must be one of {SPATIAL}")
        _check(n.temporal in TEMPORAL, f"numerics.temporal must be one of {TEMPORAL}")
        _check(n.riemann in RIEMANN, f"numerics.riemann must be one of {RIEMANN}")
        _check(n.limiter in LIMITERS, f"numerics.limiter must be one of {LIMITERS}")
        _check(n.precision in ("single", "double"), "numerics.precision must be single|double")
        _check(
            n.edge_flux_backend
            in ("xla", "pallas", "structured", "fused_structured"),
            "numerics.edge_flux_backend must be "
            "xla|pallas|structured|fused_structured",
        )
        _check(
            n.cell_ordering in ("file", "rcm"),
            "numerics.cell_ordering must be file|rcm",
        )
        _check(
            self.parallel.partitioning in ("auto", "none"),
            "parallel.partitioning must be auto|none",
        )
        _check(t.unit in TIME_UNITS, f"time.unit must be one of {TIME_UNITS}")
        _check(
            self.output.format in OUTPUT_FORMATS,
            f"output.format must be one of {OUTPUT_FORMATS}",
        )
        _check(
            self.logging.level in LOG_LEVELS,
            f"logging.level must be one of {LOG_LEVELS}",
        )

        from ..constants import MAX_NUM_SEDIMENT_CLASSES

        _check(
            0 <= p.sediment.num_classes <= MAX_NUM_SEDIMENT_CLASSES,
            f"physics.sediment.num_classes must be in [0, {MAX_NUM_SEDIMENT_CLASSES}]",
        )
        if p.flow.well_balancing == "bs2002":
            # the reference restricts BS2002 to sediment-free runs
            # (yaml_input.c:917-919)
            _check(
                p.sediment.num_classes == 0,
                "BS2002 well balancing requires sediment.num_classes = 0",
            )
        if n.second_order:
            # both restrictions mirror the reference's operator checks:
            # MUSCL is pure-SWE only (operator.c:361-363) and incompatible
            # with HR well balancing (operator.c:388-390; the h-based
            # reconstruction measurably breaks HR's lake-at-rest exactness)
            _check(
                p.sediment.num_classes == 0
                and not p.salinity
                and not p.heat,
                "numerics.second_order is only supported for pure SWE "
                "(no sediment, salinity, or heat tracers)",
            )
            _check(
                p.flow.well_balancing != "hydrostatic_reconstruction",
                "numerics.second_order cannot be used with "
                "well_balancing = hydrostatic_reconstruction",
            )
        if (
            p.flow.source.xq2018_threshold != DEFAULT_XQ2018_THRESHOLD
            and p.flow.source.method != "implicit_xq2018"
        ):
            raise ConfigError(
                "xq2018_threshold set but source method is not implicit_xq2018"
            )

        if t.adaptive.enable:
            _check(
                0.0 < t.adaptive.target_courant_number < 1.0,
                "time.adaptive.target_courant_number must be in (0, 1)",
            )
            _check(
                t.adaptive.max_increase_factor > 1.0,
                "time.adaptive.max_increase_factor must be > 1",
            )
            _check(
                t.adaptive.initial_time_step > 0.0,
                "time.adaptive.initial_time_step must be > 0",
            )
            _check(
                t.time_step is None or t.time_step == t.adaptive.initial_time_step,
                "time_step cannot be specified with adaptive time stepping",
            )
            t.time_step = t.adaptive.initial_time_step

        # exactly two of {stop, stop_n, time_step} must be given
        # (yaml_input.c:970-1005); with all three, stop must be consistent
        given = [t.stop is not None, t.stop_n is not None, t.time_step is not None]
        _check(
            sum(given) >= 2,
            "at least two of time.{stop, stop_n, time_step} must be specified",
        )
        if t.stop is None:
            t.stop = t.stop_n * t.time_step
        elif t.time_step is None:
            t.time_step = t.stop / t.stop_n
        elif t.stop_n is None:
            import math

            t.stop_n = int(math.ceil(t.stop / t.time_step - 1e-12))

        if t.coupling_interval is None:
            t.coupling_interval = t.stop
        _check(t.coupling_interval > 0.0, "time.coupling_interval must be > 0")

        # named references resolve
        region_names = {r.name for r in self.regions}
        boundary_names = {b.name for b in self.boundaries}
        material_names = {m.name for m in self.materials}
        flow_names = {c.name for c in self.flow_conditions}
        sed_names = {c.name for c in self.sediment_conditions}
        sal_names = {c.name for c in self.salinity_conditions}
        temp_names = {c.name for c in self.temperature_conditions}

        for sc in self.surface_composition:
            _check(
                sc.region in region_names,
                f"surface_composition references unknown region '{sc.region}'",
            )
            _check(
                sc.material in material_names,
                f"surface_composition references unknown material '{sc.material}'",
            )
        for ic in self.initial_conditions + self.sources:
            _check(
                ic.region in region_names,
                f"condition references unknown region '{ic.region}'",
            )
            if ic.flow:
                _check(
                    ic.flow in flow_names,
                    f"unknown flow condition '{ic.flow}'",
                )
            if ic.sediment:
                _check(ic.sediment in sed_names, f"unknown sediment condition '{ic.sediment}'")
            if ic.salinity:
                _check(ic.salinity in sal_names, f"unknown salinity condition '{ic.salinity}'")
            if ic.temperature:
                _check(
                    ic.temperature in temp_names,
                    f"unknown temperature condition '{ic.temperature}'",
                )
        for bc in self.boundary_conditions:
            for b in bc.boundaries:
                _check(
                    b in boundary_names,
                    f"boundary condition references unknown boundary '{b}'",
                )
            if bc.flow:
                _check(bc.flow in flow_names, f"unknown flow condition '{bc.flow}'")

        if self.ensemble.size:
            _check(
                len(self.ensemble.members) == self.ensemble.size,
                "ensemble.size must equal the number of ensemble.members",
            )
        return self

    # ------------------------------------------------ helpers
    def resolve_path(self, path: str) -> str:
        """Relative paths resolve against the config file's directory."""
        path = path.replace("${PETSC_ID_TYPE}", "int32")
        if os.path.isabs(path):
            return path
        return os.path.join(self.config_dir, path)

    @property
    def dtype(self):
        import torch

        return torch.float32 if self.numerics.precision == "single" else torch.float64
