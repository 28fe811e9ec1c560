"""The SWE spatial operator F(q, t) -> dq/dt.

The counterpart of rdycore_tpu/operator.py, at first order or (flow only)
second order, for the flow equations (3 unknowns) and for the coupled
flow + tracer system (3 + num_tracers unknowns: sediment classes with
Hairsine-Rose sources, then salinity and heat; the JAX package's
`_apply_tracer`/`_finish_tracer`), with or without well-balancing. The
JAX package's XLA gather form carries over:

1. gather left/right cell states onto edges
2. ghost states for boundary edges from their BC
3. one Roe solve over ALL edges (interior + boundary)
4. each cell *gathers* its <= 4 incident edge fluxes with precomputed
   +-len/area coefficients (fixed summation order; no scatter, no atomics)
5. cell-wise sources consuming the flux divergence

Steps 1-3 are the edge kernel K1a (`ops/kernels/edge_flux.py`), 4-5 the
cell kernel K1b (`ops/kernels/cell_stage.py`), and the Courant maximum with
its location the reduction kernel K1c (`ops/kernels/courant.py`). On CPU
tensors each runs its plain PyTorch version instead.

With `second_order` (MUSCL, the JAX package's `second_order=True`), K3a
(`ops/kernels/muscl.py`) first forms each cell's least-squares gradients,
K1a solves Roe on the limited face states of the interior edges, and,
with `positivity_limit` (on by default, as `Simulation` builds it), K3b
scales every edge's flux by its donor cell's factor min(1, h / (dt *
drain)) before the cell gather (the JAX package's `_finish_apply`
positivity step, operator.py:482-497 and :1084-1115). The scaled boundary
fluxes are those the accumulators read. A step with dt <= 0 takes 1 for
dt in that factor, as the raster kernel does: the JAX package's XLA path
divides by zero there and hides the NaN behind its loop's guard.

Well-balancing (the JAX package's `well_balancing_hr` and
`well_balancing_bs2002`):
- hydrostatic reconstruction (first order, with or without tracers): K1a
  reconstructs the interior edges' depths on `cell_z`, and K1b drops the
  bed-slope source and adds the hydrostatic pressure correction
  (operator.py:417-460, :1117-1151);
- BS2002 (flow only, first order or MUSCL): K5 (`ops/kernels/
  eta_vertex.py`) forms the vertex eta of the stage's raw depths, and K1a
  adds the momentum correction of every edge from it (operator.py:436-447,
  :1060-1070); at second order K3b then scales the corrected fluxes.
BS2002 with tracers is refused (ValueError): the JAX package's coupled
operator drops its correction without a word (ROADMAP fault 18). HR with
second order is refused as the JAX package refuses it.

Boundary edges carry a BC code each (`bnd_code`), so one launch covers all
edges whatever the segments; the JAX XLA path loops over segments instead.

`LinearizationTwin` (`linearization_twin(op)`) is the same operator with
every kernel taken by its plain version, on whatever device: the
backward-Euler integrator differentiates it by forward-mode AD for its
Jacobian-vector products, as the JAX package differentiates its XLA twin.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .constants import DEFAULT_H_ANUGA, DEFAULT_TINY_H, DEFAULT_XQ2018_THRESHOLD
from .device import DeviceLike, resolve_device
from .mesh.core import Mesh, named_boundary_sets
from .ops.kernels.cell_stage import (
    CellStageOut,
    swe_cell_stage,
    swe_cell_stage_plain,
)
from .ops.kernels.courant import courant_argmax, courant_argmax_plain
from .ops.kernels.edge_flux import (
    boundary_flux_plain,
    swe_edge_flux,
    swe_edge_flux_plain,
)
from .ops.kernels.eta_vertex import swe_eta_vertex
from .ops.kernels.muscl import (
    positivity_drain_plain,
    positivity_scale_plain,
    swe_muscl_grad,
    swe_positivity_drain,
    swe_positivity_scale,
)
from .ops.swe import boundary as bc_mod
from .ops.swe.bs2002 import (
    BS2002Arrays,
    bs2002_arrays_from_numpy,
    build_bs2002_host,
    eta_vertices,
)
from .ops.swe.muscl import LIMITERS, ls_gradients, precompute_ls_coefficients
from .ops.swe.sources import SOURCE_IMPLICIT_XQ2018, SOURCE_SEMI_IMPLICIT


class BoundarySegment(NamedTuple):
    """Static metadata for one named boundary (a contiguous edge slice)."""

    name: str
    bc_type: int  # bc_mod.BC_* code
    start: int  # offset into the boundary-edge block
    count: int
    edge_ids: np.ndarray  # mesh edge ids (for time series metadata)


@dataclasses.dataclass
class OperatorArrays:
    """Geometry and index tensors of the operator, all on one device."""

    # cells [C]
    area: torch.Tensor
    dz_dx: torch.Tensor
    dz_dy: torch.Tensor
    cell_z: torch.Tensor  # vertex-averaged bed elevation
    mannings_n: torch.Tensor
    # interior edges [Ei]
    int_left: torch.Tensor  # int32
    int_right: torch.Tensor  # int32
    int_cn: torch.Tensor
    int_sn: torch.Tensor
    # boundary edges [Eb] (ordered by segment)
    bnd_left: torch.Tensor  # int32
    bnd_cn: torch.Tensor
    bnd_sn: torch.Tensor
    bnd_code: torch.Tensor  # int8 BC code of each boundary edge
    # cell -> edge gather maps [C, MAX_CE]
    cell_edges: torch.Tensor  # int32 into [0, E]; E = dummy zero-flux edge
    cell_edge_coef: torch.Tensor  # sign * edge_len / cell_area (0 on padding)
    # per-edge Courant coefficient edge_len / min(adjacent areas) [E]
    edge_courant_coef: torch.Tensor
    # boundary edge lengths [Eb]
    bnd_len: torch.Tensor
    # MUSCL (second order only): LS gradient coefficients per cell_edges
    # slot [C, MAX_CE], centroid -> midpoint offsets per interior edge [Ei]
    cell_ls_cx: Optional[torch.Tensor] = None
    cell_ls_cy: Optional[torch.Tensor] = None
    int_dxl: Optional[torch.Tensor] = None
    int_dyl: Optional[torch.Tensor] = None
    int_dxr: Optional[torch.Tensor] = None
    int_dyr: Optional[torch.Tensor] = None
    # BS2002 well-balancing (None unless enabled): sorted cell beds, the
    # vertex -> cells lists and the edges' endpoint vertices and beds
    bs2002: Optional[BS2002Arrays] = None

    def numpy(self) -> Dict[str, np.ndarray]:
        """Every tensor field that is set as a host numpy array."""
        return {k: getattr(self, k).cpu().numpy() for k in ARRAY_FIELDS
                if getattr(self, k) is not None}


# the tensor fields (bs2002 is a namedtuple of tensors)
ARRAY_FIELDS = tuple(f.name for f in dataclasses.fields(OperatorArrays)
                     if f.name != "bs2002")
MUSCL_FIELDS = ("cell_ls_cx", "cell_ls_cy", "int_dxl", "int_dyl", "int_dxr",
                "int_dyr")
INDEX_FIELDS = {
    "int_left": torch.int32, "int_right": torch.int32,
    "bnd_left": torch.int32, "cell_edges": torch.int32,
    "bnd_code": torch.int8,
}


def arrays_from_numpy(
    d: Dict[str, np.ndarray], device: torch.device, dtype: torch.dtype
) -> OperatorArrays:
    """OperatorArrays from host arrays: index fields as int32 (bnd_code
    int8), the rest as `dtype`, all on `device`. The MUSCL fields are
    optional, all six or none; so is "bs2002", a dict of the BS2002Arrays
    fields."""
    missing = [k for k in ARRAY_FIELDS if k not in d and k not in MUSCL_FIELDS]
    muscl = [k for k in MUSCL_FIELDS if d.get(k) is not None]
    if missing or muscl and len(muscl) != len(MUSCL_FIELDS):
        raise KeyError(f"operator arrays lack {missing or muscl}")
    bs = d.get("bs2002")
    return OperatorArrays(
        **{
            k: torch.as_tensor(
                np.array(d[k]), dtype=INDEX_FIELDS.get(k, dtype),
                device=device,
            )
            for k in ARRAY_FIELDS if d.get(k) is not None
        },
        bs2002=None if bs is None else bs2002_arrays_from_numpy(
            bs, device, dtype),
    )


class RHSResult(NamedTuple):
    rhs: torch.Tensor  # [ndof, C] dq/dt
    flux_div: torch.Tensor  # [ndof, C] flux-divergence part ("riemannf")
    prim: torch.Tensor  # [ndof, C] (h, u, v[, concentrations])
    # [ndof, Eb] fluxes on boundary edges (positivity-scaled when limited)
    boundary_fluxes: torch.Tensor
    max_courant_per_dt: torch.Tensor  # 0-dim: max over edges of amax*len/area
    courant_edge: torch.Tensor  # 0-dim int32: index of that edge


@dataclasses.dataclass(eq=False)
class SWEOperator:
    """Static operator configuration + device tensors (the reference's
    Operator object, rdyoperatorimpl.h:107-206)."""

    arrays: OperatorArrays
    segments: Tuple[BoundarySegment, ...]
    num_cells: int
    num_internal_edges: int
    num_boundary_edges: int
    tiny_h: float = DEFAULT_TINY_H
    h_anuga: float = DEFAULT_H_ANUGA
    source_method: int = SOURCE_SEMI_IMPLICIT
    xq2018_threshold: float = DEFAULT_XQ2018_THRESHOLD
    # tracer rows beyond (h, hu, hv); the first num_sediment are sediment
    # classes. riemann: "roe" or "upwind_roe" (the tracer flux)
    num_tracers: int = 0
    num_sediment: int = 0
    riemann: str = "roe"
    # MUSCL reconstruction (flow only) with minmod | van_leer | none, and
    # the Audusse positivity limiter on its fluxes
    second_order: bool = False
    limiter: str = "minmod"
    positivity_limit: bool = True
    # well-balancing: hydrostatic reconstruction, or Bradford & Sanders
    # (2002) on the vertex eta
    well_balancing_hr: bool = False
    well_balancing_bs2002: bool = False

    def __post_init__(self):
        if self.riemann not in ("roe", "upwind_roe"):
            raise ValueError(f"riemann: {self.riemann!r}")
        if self.limiter not in LIMITERS:
            raise ValueError(f"limiter: {self.limiter!r}")
        if self.second_order and self.num_tracers:
            raise ValueError("second-order MUSCL reconstruction is only "
                             "supported for pure SWE (no tracers)")
        if self.second_order and self.arrays.cell_ls_cx is None:
            raise ValueError("a second-order operator needs the MUSCL arrays")
        if not 0 <= self.num_sediment <= self.num_tracers:
            raise ValueError(f"{self.num_sediment} sediment classes of "
                             f"{self.num_tracers} tracers")
        if self.num_tracers and self.source_method == SOURCE_IMPLICIT_XQ2018:
            # the JAX package runs semi-implicit friction in its place
            raise ValueError(
                "the implicit_xq2018 source method has no tracer form"
            )
        if self.well_balancing_hr and self.well_balancing_bs2002:
            raise ValueError("well_balancing: hydrostatic reconstruction "
                             "and BS2002 exclude each other")
        if self.well_balancing_hr and self.second_order:
            # the reference errors likewise (operator.c:388-390)
            raise ValueError(
                "second_order cannot be used with well_balancing = "
                "hydrostatic_reconstruction"
            )
        if self.well_balancing_bs2002 and self.num_tracers:
            # the JAX package's coupled operator drops the correction
            # (ROADMAP fault 18)
            raise ValueError(
                "BS2002 well balancing has no form for the coupled flow + "
                "tracer system (sediment, salinity, heat)"
            )
        if self.well_balancing_bs2002 and self.arrays.bs2002 is None:
            raise ValueError("a BS2002 operator needs the BS2002 arrays")

    @property
    def num_edges(self) -> int:
        return self.num_internal_edges + self.num_boundary_edges

    @property
    def ndof(self) -> int:
        return 3 + self.num_tracers

    def zero_boundary_values(self) -> torch.Tensor:
        """Zero Dirichlet values [ndof, max(Eb, 1)] on the operator's
        device."""
        a = self.arrays
        return torch.zeros((self.ndof, max(self.num_boundary_edges, 1)),
                           dtype=a.area.dtype, device=a.area.device)

    # ------------------------------------------------------------ kernels
    def muscl_grad(self, q: torch.Tensor) -> torch.Tensor:
        """K3a: the LS gradients [6, C] of the flow rows of q."""
        return swe_muscl_grad(self.arrays, q)

    def eta_vertices(self, h: torch.Tensor) -> torch.Tensor:
        """K5: the BS2002 vertex eta [NV] of the depths h [C]."""
        return swe_eta_vertex(self.arrays.bs2002, h, self.tiny_h)

    def edge_flux(
        self, q: torch.Tensor, boundary_values: torch.Tensor,
        grad: Optional[torch.Tensor] = None,
        eta_v: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K1a: (flux [ndof, E + 1] with column E zero, courant [E]); with
        grad, MUSCL faces on the interior edges; with eta_v, the BS2002
        correction; on an HR operator, hydrostatic reconstruction."""
        return swe_edge_flux(
            self.arrays, q, boundary_values, self.tiny_h, self.h_anuga,
            upwind=self.riemann == "upwind_roe", grad=grad,
            limiter=self.limiter, hr=self.well_balancing_hr,
            bs=self.arrays.bs2002, eta_v=eta_v,
        )

    def limit_positivity(self, flux: torch.Tensor, h: torch.Tensor,
                         dt: torch.Tensor) -> torch.Tensor:
        """K3b: the donor factors of the depths h over dt (drain), then
        flux scaled in place by them (scale). Returns flux."""
        s = swe_positivity_drain(self.arrays, flux, h, dt)
        return swe_positivity_scale(self.arrays, flux, s)

    def fluxes(
        self, q: torch.Tensor, boundary_values: torch.Tensor,
        dt: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The edge phase: K1a at first order; at second order K3a, K1a in
        MUSCL mode and, with positivity_limit, K3b over dt; under BS2002,
        K5 on the raw depths of q first. Returns (flux [ndof, E + 1],
        courant [E]); courant is taken before the positivity scaling."""
        eta_v = (self.eta_vertices(q[0]) if self.well_balancing_bs2002
                 else None)
        if not self.second_order:
            return self.edge_flux(q, boundary_values, eta_v=eta_v)
        flux, courant = self.edge_flux(q, boundary_values,
                                       self.muscl_grad(q), eta_v)
        if self.positivity_limit and self.num_edges:
            self.limit_positivity(flux, q[0], dt)
        return flux, courant

    def courant_max(
        self, courant: torch.Tensor, dt: Optional[torch.Tensor] = None,
        run_max: Optional[torch.Tensor] = None,
        run_idx: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K1c: (max, first edge attaining it) of courant [E]; with dt,
        run_max and run_idx, also folds max * dt into them in place."""
        return courant_argmax(courant, dt, run_max, run_idx)

    def cell_stage(
        self, flux: torch.Tensor, q: torch.Tensor, dt: torch.Tensor,
        ext_src: Optional[torch.Tensor], **mode,
    ) -> CellStageOut:
        """K1b in stage mode (stage=(alpha, beta, gamma), qA=...) or rhs
        mode (no stage); emit_prim=True adds the primitives of q. An HR
        operator runs it in its HR mode."""
        return swe_cell_stage(
            self.arrays, flux, q, dt, ext_src, tiny_h=self.tiny_h,
            h_anuga=self.h_anuga, xq2018_threshold=self.xq2018_threshold,
            source_method=self.source_method,
            num_sediment=self.num_sediment, hr=self.well_balancing_hr,
            **mode,
        )

    # ------------------------------------------------------------ apply
    def apply(
        self,
        q: torch.Tensor,  # [ndof, C]
        dt,  # 0-dim tensor or float
        boundary_values: torch.Tensor,  # [ndof, >= Eb] Dirichlet values
        ext_src: Optional[torch.Tensor],  # [ndof, C] external sources or None
    ) -> RHSResult:
        """Evaluate dq/dt: the edge phase (`fluxes`), one Courant reduction
        and one cell launch in rhs mode."""
        dt = torch.as_tensor(dt, dtype=q.dtype, device=q.device)
        flux, courant = self.fluxes(q, boundary_values, dt)
        cmax, cedge = self.courant_max(courant)
        out = self.cell_stage(flux, q, dt, ext_src, emit_prim=True)
        Ei = self.num_internal_edges
        return RHSResult(
            rhs=out.rhs,
            flux_div=out.flux_div,
            prim=out.prim,
            boundary_fluxes=flux[:, Ei:self.num_edges],
            max_courant_per_dt=cmax,
            courant_edge=cedge,
        )

    def rhs(
        self, q: torch.Tensor, dt, boundary_values: torch.Tensor,
        ext_src: Optional[torch.Tensor],
    ) -> torch.Tensor:
        """dq/dt alone: `apply` without its Courant reduction and
        primitives (the edge phase and one cell launch in rhs mode), for
        the implicit integrators' residuals and JVPs."""
        dt = torch.as_tensor(dt, dtype=q.dtype, device=q.device)
        flux, _ = self.fluxes(q, boundary_values, dt)
        return self.cell_stage(flux, q, dt, ext_src).rhs

    def boundary_fluxes(
        self, q: torch.Tensor, boundary_values: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Roe fluxes + masked max wave speeds on the boundary edges
        (fb [ndof, Eb], amax_b [Eb]) in plain PyTorch (the JAX package's
        `boundary_fluxes`, and `boundary_fluxes_nd` with tracers), with the
        BS2002 correction from the vertex eta of q's depths on a BS2002
        operator. The step loop takes fb from the edge kernel's output
        instead."""
        a = self.arrays
        eta_v = (self.eta_vertices(q[0]) if self.well_balancing_bs2002
                 else None)
        return boundary_flux_plain(
            a, q, boundary_values, self.tiny_h, self.h_anuga,
            upwind=self.riemann == "upwind_roe", bs=a.bs2002, eta_v=eta_v,
        )


class LinearizationTwin(SWEOperator):
    """The operator with every kernel replaced by its plain PyTorch
    version, whatever the device of its tensors: the linearization of the
    implicit integrator, as the JAX package builds its own from the kernel
    operator (`dataclasses.replace(op, edge_flux_backend="xla")`,
    rdycore_tpu/timestepping.py:270-278). `torch.func.jvp` differentiates
    its `apply` in every mode of the unstructured path; the residuals stay
    on the kernels (`SWEOperator`). Build it with `linearization_twin`."""

    def muscl_grad(self, q):
        return ls_gradients(self.arrays, q)

    def eta_vertices(self, h):
        return eta_vertices(self.arrays.bs2002, h, self.tiny_h)

    def edge_flux(self, q, boundary_values, grad=None, eta_v=None):
        return swe_edge_flux_plain(
            self.arrays, q, boundary_values, self.tiny_h, self.h_anuga,
            self.riemann == "upwind_roe", grad, self.limiter,
            self.well_balancing_hr, self.arrays.bs2002, eta_v)

    def limit_positivity(self, flux, h, dt):
        s = positivity_drain_plain(self.arrays, flux, h, dt)
        return positivity_scale_plain(self.arrays, flux, s)

    def courant_max(self, courant, dt=None, run_max=None, run_idx=None):
        return courant_argmax_plain(courant, dt, run_max, run_idx)

    def cell_stage(self, flux, q, dt, ext_src, **mode):
        return swe_cell_stage_plain(
            self.arrays, flux, q, dt, ext_src, tiny_h=self.tiny_h,
            h_anuga=self.h_anuga, xq2018_threshold=self.xq2018_threshold,
            source_method=self.source_method,
            num_sediment=self.num_sediment, hr=self.well_balancing_hr,
            **mode)


def linearization_twin(op: SWEOperator) -> LinearizationTwin:
    """`op`'s linearization twin: the same configuration and arrays, every
    kernel taken by its plain version."""
    return LinearizationTwin(**{f.name: getattr(op, f.name)
                                for f in dataclasses.fields(op)})


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------

def bnd_codes(segments) -> np.ndarray:
    """Per-boundary-edge BC codes [Eb] (int8) of segments in order."""
    codes = [np.full(s.count, s.bc_type, np.int8) for s in segments]
    return np.concatenate(codes) if codes else np.zeros(0, np.int8)


def build_operator(
    mesh: Mesh,
    bc_types: Optional[Dict[str, int]] = None,
    mannings_n: Optional[np.ndarray] = None,
    tiny_h: float = DEFAULT_TINY_H,
    h_anuga: float = DEFAULT_H_ANUGA,
    source_method: int = SOURCE_SEMI_IMPLICIT,
    xq2018_threshold: float = DEFAULT_XQ2018_THRESHOLD,
    num_tracers: int = 0,
    num_sediment: int = 0,
    riemann: str = "roe",
    second_order: bool = False,
    limiter: str = "minmod",
    positivity_limit: bool = True,
    well_balancing_hr: bool = False,
    well_balancing_bs2002: bool = False,
    dtype: torch.dtype = torch.float64,
    device: DeviceLike = None,
) -> SWEOperator:
    """Build an SWEOperator from a Mesh on `device` (CUDA unless "cpu").

    bc_types maps boundary name -> BC_* code; unlisted boundaries get the
    reflecting wall BC, like the reference's auto-assignment
    (rdysetup.c:706-777). second_order adds the MUSCL arrays, built on the
    host in float64 (`precompute_ls_coefficients`). well_balancing_hr runs
    hydrostatic reconstruction on the mesh's `cell_z` (which
    `Mesh.set_cell_elevations` replaces); well_balancing_bs2002 adds the
    BS2002 arrays, from the vertex beds `points[:, 2]`.
    """
    device = resolve_device(device)
    bc_types = dict(bc_types or {})
    unknown = set(bc_types) - set(mesh.boundaries)
    if unknown:
        raise ValueError(
            f"boundary condition(s) reference unknown boundaries: {sorted(unknown)}; "
            f"mesh defines {sorted(n for n in mesh.boundaries if not n.startswith('__id_'))}"
        )
    Ei = mesh.num_internal_edges
    E = mesh.num_edges
    C = mesh.num_cells

    # boundary segments: order boundary edges by (segment, edge id)
    segments: List[BoundarySegment] = []
    order: List[np.ndarray] = []
    start = 0
    for name, eids in named_boundary_sets(mesh).items():
        bc = bc_types.get(name, bc_mod.BC_REFLECTING)
        segments.append(
            BoundarySegment(
                name=name, bc_type=bc, start=start, count=len(eids), edge_ids=eids
            )
        )
        order.append(np.asarray(eids, dtype=np.int64))
        start += len(eids)
    bnd_order = (
        np.concatenate(order) if order else np.zeros(0, dtype=np.int64)
    )
    if start != E - Ei:
        raise ValueError(
            f"boundary segments cover {start} edges but mesh has {E - Ei}"
        )

    # remap edge index: new order = [internal (unchanged) | bnd_order]
    edge_perm = np.concatenate([np.arange(Ei, dtype=np.int64), bnd_order])
    inv_perm = np.empty(E + 1, dtype=np.int64)
    inv_perm[edge_perm] = np.arange(E)
    inv_perm[E] = E  # dummy stays dummy

    cell_edges = inv_perm[mesh.cell_edges].astype(np.int32)

    area = mesh.cell_area
    lengths = mesh.edge_length[edge_perm]
    left = mesh.edge_cells[edge_perm, 0]
    right = mesh.edge_cells[edge_perm, 1]

    # cell-edge coefficient: sign * len / area
    elen_pad = np.concatenate([lengths, [0.0]])
    coef = mesh.cell_edge_sign * elen_pad[cell_edges] / area[:, None]

    # Courant coefficient len / min(adjacent areas)
    area_l = area[left]
    area_r = np.where(right >= 0, area[np.where(right >= 0, right, 0)], np.inf)
    ccoef = lengths / np.minimum(area_l, area_r)

    if mannings_n is None:
        mannings_n = np.zeros(C)
    muscl = {}
    if second_order:
        muscl = dict(zip(MUSCL_FIELDS,
                         precompute_ls_coefficients(mesh, edge_perm, Ei)))

    bs2002 = (build_bs2002_host(mesh, edge_perm, Ei)
              if well_balancing_bs2002 else None)

    arrays = arrays_from_numpy(
        dict(
            area=area,
            dz_dx=mesh.cell_dz_dx,
            dz_dy=mesh.cell_dz_dy,
            cell_z=mesh.cell_z,
            mannings_n=np.asarray(mannings_n),
            int_left=left[:Ei],
            int_right=right[:Ei],
            int_cn=mesh.edge_cn[edge_perm][:Ei],
            int_sn=mesh.edge_sn[edge_perm][:Ei],
            bnd_left=left[Ei:],
            bnd_cn=mesh.edge_cn[edge_perm][Ei:],
            bnd_sn=mesh.edge_sn[edge_perm][Ei:],
            bnd_code=bnd_codes(segments),
            cell_edges=cell_edges,
            cell_edge_coef=coef,
            edge_courant_coef=ccoef,
            bnd_len=lengths[Ei:],
            bs2002=bs2002,
            **muscl,
        ),
        device, dtype,
    )
    return SWEOperator(
        arrays=arrays,
        segments=tuple(segments),
        num_cells=C,
        num_internal_edges=Ei,
        num_boundary_edges=E - Ei,
        tiny_h=tiny_h,
        h_anuga=h_anuga,
        source_method=source_method,
        xq2018_threshold=xq2018_threshold,
        num_tracers=num_tracers,
        num_sediment=num_sediment,
        riemann=riemann,
        second_order=second_order,
        limiter=limiter,
        positivity_limit=positivity_limit,
        well_balancing_hr=well_balancing_hr,
        well_balancing_bs2002=well_balancing_bs2002,
    )
