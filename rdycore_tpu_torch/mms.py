"""Method of Manufactured Solutions verification driver (src/rdymms.c): the
counterpart of rdycore_tpu/mms.py.

Given analytic h(x,y,t), u, v, z(x,y), n(x,y) and their derivatives from
the YAML `mms` section (and c_i with its derivatives for each sediment
class), this module:
  1. snaps the mesh's vertex elevations to z(x,y) (SnapVerticesToBathymetry,
     rdymms.c:108-135) and makes the geometry that reads them anew
  2. sets the analytic IC, analytic Dirichlet BCs on every boundary
     (rdymms.c:49-68) and analytic source terms (RDyMMSComputeSourceTerms,
     rdymms.c:489-600), both evaluated at t + dt/2 each step (MMSPreStep,
     rdymms.c:139-151): the expressions are compiled over torch and
     evaluated on the device inside the step loop
     (`make_interval_advancer`'s bc_fn and src_fn), with nothing read back
     to the host; the fields that do not read t are evaluated once per level
  3. computes area-weighted L1/L2/Linf error norms against the analytic
     solution, on the host in float64 (RDyMMSComputeErrorNorms,
     rdymms.c:850-903)
  4. runs convergence studies over uniform refinements with linear-regression
     rate fits and PASS/FAIL thresholds (rdymms.c:920-1066)

Everything runs on `device` (CUDA unless "cpu") in the deck's precision,
through the same operator and kernels as `Simulation`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .config.expressions import compile_expression
from .config.schema import Config, ConfigError, time_to_seconds
from .constants import GRAVITY
from .device import DeviceLike, resolve_device
from .mesh.core import Mesh, named_boundary_sets
from .mesh.generate import refine_uniform
from .operator import SWEOperator, build_operator
from .ops.swe.boundary import BC_DIRICHLET
from .ops.tracer.sources import SedimentParams
from .simulation import load_mesh_file
from .timestepping import IntervalResult, make_interval_advancer

_SWE_FIELDS = (
    "h", "dhdx", "dhdy", "dhdt",
    "u", "dudx", "dudy", "dudt",
    "v", "dvdx", "dvdy", "dvdt",
    "z", "dzdx", "dzdy", "n",
)
_SED_FIELDS = ("c", "dcdx", "dcdy", "dcdt")


def _evaluate(fn, x: torch.Tensor, y: torch.Tensor, t) -> torch.Tensor:
    """fn(x, y, t) as a tensor of x's shape: a constant expression (a
    Python number) or one of t alone (a 0-d tensor) is broadcast, as the
    JAX package's arithmetic broadcasts it."""
    v = fn(x, y, t)
    if not isinstance(v, torch.Tensor):
        return torch.full_like(x, float(v))
    return v if v.shape == x.shape else v.expand_as(x)


class MMSProblem:
    """Compiled analytic solution set (SWE + optional sediment classes)."""

    def __init__(self, config: Config):
        mms = config.mms
        if not mms.swe:
            raise ConfigError("config has no mms.swe section")
        consts = dict(mms.constants)
        self.fns = {}
        for f in _SWE_FIELDS:
            if f not in mms.swe:
                raise ConfigError(f"mms.swe is missing '{f}'")
            self.fns[f] = compile_expression(mms.swe[f], consts,
                                             backend="torch")
        self.num_sediment = config.physics.sediment.num_classes
        self.sed_fns = []
        for i in range(self.num_sediment):
            fns = {}
            for k in _SED_FIELDS:
                key = k.replace("c", f"c{i}", 1)
                if key not in mms.sediment:
                    raise ConfigError(f"mms.sediment is missing '{key}'")
                fns[k] = compile_expression(mms.sediment[key], consts,
                                            backend="torch")
            self.sed_fns.append(fns)
        self.config = config

    # ---- analytic fields -------------------------------------------------
    def host_field(self, name: str, x: np.ndarray, y: np.ndarray
                   ) -> np.ndarray:
        """A field of t = 0 (z or n) at host points, in float64."""
        xt, yt = torch.from_numpy(np.asarray(x, np.float64)), \
            torch.from_numpy(np.asarray(y, np.float64))
        return _evaluate(self.fns[name], xt, yt, 0.0).numpy()

    def solution(self, x: torch.Tensor, y: torch.Tensor, t) -> torch.Tensor:
        """(h, hu, hv, [h c_i...]) at points (x, y) and time t."""
        h = _evaluate(self.fns["h"], x, y, t)
        u = _evaluate(self.fns["u"], x, y, t)
        v = _evaluate(self.fns["v"], x, y, t)
        rows = [h, h * u, h * v]
        for fns in self.sed_fns:
            rows.append(h * _evaluate(fns["c"], x, y, t))
        return torch.stack(rows)

    def source_terms(self, x: torch.Tensor, y: torch.Tensor, t
                     ) -> torch.Tensor:
        """Analytic SWE (+sediment) source terms (rdymms.c:563-632)."""
        return self.forcing(x, y)(t)

    def forcing(self, x: torch.Tensor, y: torch.Tensor
                ) -> Callable[[object], torch.Tensor]:
        """src(t) -> `source_terms(x, y, t)`, the fields that do not read
        t evaluated once, here (the same values at every t)."""
        static = {}
        for key, fn in self._all_fields():
            if "t" not in fn.names:
                static[key] = _evaluate(fn, x, y, 0.0)

        def src(t):
            f = dict(static)
            for key, fn in self._all_fields():
                if key not in f:
                    f[key] = _evaluate(fn, x, y, t)
            return self._sources(f)

        return src

    def _all_fields(self):
        """(key, compiled expression) of every field: the SWE ones by name,
        class i's as (i, name)."""
        out = list(self.fns.items())
        for i, fns in enumerate(self.sed_fns):
            out += [((i, k), fn) for k, fn in fns.items()]
        return out

    def _sources(self, f) -> torch.Tensor:
        g = GRAVITY
        h, u, v = f["h"], f["u"], f["v"]
        cd = g * f["n"] ** 2 * torch.pow(h, -1.0 / 3.0)
        speed = torch.sqrt(u * u + v * v)

        s_h = (f["dhdt"] + u * f["dhdx"] + h * f["dudx"] + v * f["dhdy"]
               + h * f["dvdy"])

        s_hu = u * f["dhdt"] + h * f["dudt"]
        s_hu += 2.0 * u * h * f["dudx"] + u * u * f["dhdx"] + g * h * f["dhdx"]
        s_hu += u * h * f["dvdy"] + v * h * f["dudy"] + u * v * f["dhdy"]
        s_hu += f["dzdx"] * g * h
        s_hu += cd * u * speed

        s_hv = v * f["dhdt"] + h * f["dvdt"]
        s_hv += u * h * f["dvdx"] + v * h * f["dudx"] + u * v * f["dhdx"]
        s_hv += v * v * f["dhdy"] + 2.0 * v * h * f["dvdy"] + g * h * f["dhdy"]
        s_hv += f["dzdy"] * g * h
        s_hv += cd * v * speed

        rows = [s_h, s_hu, s_hv]
        if self.sed_fns:
            p = SedimentParams()
            tau_b = 0.5 * p.rhow * cd * (u * u + v * v)
            for i in range(len(self.sed_fns)):
                ci = f[(i, "c")]
                s_c = ci * f["dhdt"] + h * f[(i, "dcdt")]
                s_c += (u * ci * f["dhdx"] + h * ci * f["dudx"]
                        + u * h * f[(i, "dcdx")])
                s_c += (v * ci * f["dhdy"] + h * ci * f["dvdy"]
                        + v * h * f[(i, "dcdy")])
                ei = (p.kp_constant * (tau_b - p.tau_critical_erosion)
                      / p.tau_critical_erosion)
                di = p.settling_velocity * ci * (
                    1.0 - tau_b / p.tau_critical_deposition)
                s_c += -(ei - di)
                rows.append(s_c)
        return torch.stack(rows)

    def boundary_values(self, x: torch.Tensor, y: torch.Tensor, t
                        ) -> torch.Tensor:
        """Analytic Dirichlet (h, hu, hv[, h c_i]) at boundary-edge
        midpoints (RDyMMSEnforceBoundaryConditions, rdymms.c:708-760)."""
        return self.solution(x, y, t)


@dataclasses.dataclass
class MMSRunResult:
    L1: np.ndarray  # [ndof]
    L2: np.ndarray  # [ndof]
    Linf: np.ndarray  # [ndof]
    num_cells: int
    area: float
    n_steps: int = 0
    setup_seconds: float = 0.0  # mesh snap, operator, forcing and IC
    run_seconds: float = 0.0  # the interval and the error's copy back


@dataclasses.dataclass
class MMSLevel:
    """One mesh of an MMS study, set up: the snapped mesh, its operator
    with a Dirichlet BC on every boundary, the per-step forcing and the
    analytic IC."""

    problem: MMSProblem
    mesh: Mesh
    op: SWEOperator
    bc_fn: Callable  # t -> [ndof, Eb] in the operator's segment order
    src_fn: Callable  # t -> [ndof, C]
    centroids: tuple  # (cx, cy) on the device
    q0: torch.Tensor
    dt: float
    t_final: float
    n_steps: int
    setup_seconds: float = 0.0

    def advance(self, n_steps: Optional[int] = None,
                op: Optional[SWEOperator] = None) -> IntervalResult:
        """The level's run from the analytic IC (n_steps of it, and on `op`
        in place of the level's operator, where given), as one interval
        without accumulators (MMS reads none)."""
        op = self.op if op is None else op
        adv = make_interval_advancer(
            op, self.problem.config.numerics.temporal, bc_fn=self.bc_fn,
            src_fn=self.src_fn, accumulate=False)
        # the times as device scalars (fills: no copy from the host)
        t0, dt, t_end = (self.q0.new_full((), v)
                         for v in (0.0, self.dt, self.t_final))
        return adv(self.q0, t0, dt,
                   self.n_steps if n_steps is None else n_steps,
                   t_end, op.zero_boundary_values(),
                   torch.zeros_like(self.q0))

    def result(self, res: IntervalResult) -> MMSRunResult:
        """The error norms of a run's end state against the analytic
        solution at its end time."""
        q_exact = self.problem.solution(*self.centroids, float(res.t))
        err = (res.q - q_exact).cpu().numpy()
        area = self.mesh.cell_area
        return MMSRunResult(
            L1=(np.abs(err) * area).sum(axis=1),
            L2=np.sqrt(((err ** 2) * area).sum(axis=1)),
            Linf=np.abs(err).max(axis=1),
            num_cells=self.mesh.num_cells, area=float(area.sum()),
            n_steps=self.n_steps, setup_seconds=self.setup_seconds)

    def run(self) -> MMSRunResult:
        """The whole run and its error norms, timed."""
        t0 = time.perf_counter()
        res = self.result(self.advance())
        res.run_seconds = time.perf_counter() - t0
        return res


def setup_mms_level(problem: MMSProblem, mesh: Mesh,
                    dtype: torch.dtype = torch.float64,
                    device: DeviceLike = None) -> MMSLevel:
    """Set the MMS problem up on one mesh (rdycore_tpu/mms.py:151-251):
    the vertices snapped to z(x, y), a Dirichlet BC on every named
    boundary, the forcing at the boundary-edge midpoints (in the port's
    segment order) and the cell centroids, the IC, and n_steps =
    ceil(t_final / dt - 1e-12)."""
    t0 = time.perf_counter()
    device = resolve_device(device)
    cfg = problem.config

    # snap the bathymetry to the analytic z(x, y); the labels resolved as
    # the JAX package's rebuild resolves them
    pts = mesh.points
    mesh = mesh.with_vertex_elevations(
        problem.host_field("z", pts[:, 0], pts[:, 1]))
    mesh = dataclasses.replace(mesh, boundaries=named_boundary_sets(mesh))
    cx = mesh.cell_centroid[:, 0]
    cy = mesh.cell_centroid[:, 1]

    nt = problem.num_sediment
    op = build_operator(
        mesh,
        bc_types={name: BC_DIRICHLET for name in mesh.boundaries},
        mannings_n=problem.host_field("n", cx, cy),
        tiny_h=cfg.physics.flow.tiny_h,
        h_anuga=cfg.physics.flow.h_anuga_reg_parameter,
        second_order=cfg.numerics.second_order,
        limiter=cfg.numerics.limiter,
        num_tracers=nt,
        num_sediment=nt,
        riemann=cfg.numerics.riemann,
        dtype=dtype,
        device=device,
    )

    # boundary edge midpoints in the operator's segment order
    ev = np.concatenate([mesh.edge_vertices[seg.edge_ids]
                         for seg in op.segments]
                        or [np.zeros((0, 2), np.int64)])
    mid = (mesh.points[ev[:, 0], :2] + mesh.points[ev[:, 1], :2]) / 2.0

    def on_device(a):
        return torch.as_tensor(a, dtype=dtype).to(device)

    bx, by = on_device(mid[:, 0]), on_device(mid[:, 1])
    cxd, cyd = on_device(cx), on_device(cy)

    def bc_fn(t):
        return problem.boundary_values(bx, by, t)

    dt = time_to_seconds(cfg.time.time_step, cfg.time.unit)
    t_final = time_to_seconds(cfg.time.stop, cfg.time.unit)
    return MMSLevel(
        problem=problem, mesh=mesh, op=op, bc_fn=bc_fn,
        src_fn=problem.forcing(cxd, cyd), centroids=(cxd, cyd),
        q0=problem.solution(cxd, cyd, 0.0), dt=dt, t_final=t_final,
        n_steps=int(np.ceil(t_final / dt - 1e-12)),
        setup_seconds=time.perf_counter() - t0)


def run_mms_level(problem: MMSProblem, mesh: Mesh,
                  dtype: torch.dtype = torch.float64,
                  device: DeviceLike = None) -> MMSRunResult:
    """Run the MMS problem on one mesh and return its final error norms."""
    return setup_mms_level(problem, mesh, dtype, device).run()


def fit_rates(results) -> Dict[str, np.ndarray]:
    """Rates of each norm and component over a ladder of results: the
    slope of log10(err) against log10(N), times -dim (rdymms.c:980-1008)."""
    x = np.log10([r.num_cells for r in results])
    rates = {}
    dim = 2
    for norm in ("L1", "L2", "Linf"):
        errs = np.stack([getattr(r, norm) for r in results])  # [levels, ndof]
        rates[norm] = np.asarray([-np.polyfit(x, np.log10(errs[:, c]), 1)[0]
                                  * dim for c in range(errs.shape[1])])
    return rates


def estimate_convergence_rates(
    problem: MMSProblem, base_mesh: Mesh,
    dtype: torch.dtype = torch.float64, device: DeviceLike = None,
    log=print, on_level: Optional[Callable] = None,
) -> Dict[str, np.ndarray]:
    """Convergence study (RDyMMSEstimateConvergenceRates, rdymms.c:920-1008):
    run at refinements base..base+num, fit log10(err) vs log10(N), rate =
    -slope * dim. on_level(level, result) sees each level after its run."""
    conv = problem.config.mms.convergence
    base = conv.base_refinement
    num = conv.num_refinements

    results = []
    mesh = refine_uniform(base_mesh, base) if base else base_mesh
    for r in range(num + 1):
        level = setup_mms_level(problem, mesh, dtype, device)
        res = level.run()
        results.append(res)
        log(
            f"refinement {base + r}: N={res.num_cells}  "
            f"L1={res.L1}  L2={res.L2}  Linf={res.Linf}"
        )
        if on_level is not None:
            on_level(level, res)
        del level
        if r < num:
            mesh = refine_uniform(mesh, 1)
    return fit_rates(results)


class MMSDriver:
    """The rdycore_mms executable equivalent (driver/mms.c), on `device`
    (CUDA unless "cpu"). After `run`, `results` holds each level's
    MMSRunResult, `last_level` the finest level's MMSLevel and, after a
    convergence study, `rates` its rates."""

    def __init__(self, config: Config, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.problem = MMSProblem(config)
        self.base_mesh = load_mesh_file(config.resolve_path(config.grid.file))
        self.dtype = config.dtype
        self.COMPONENTS = tuple(
            ["h", "hu", "hv"]
            + [f"c{i}" for i in range(self.problem.num_sediment)]
        )
        self.results = []
        self.last_level: Optional[MMSLevel] = None
        self.rates: Optional[Dict[str, np.ndarray]] = None

    def _keep(self, level: MMSLevel, res: MMSRunResult) -> None:
        self.results.append(res)
        self.last_level = level

    def run(self, log=print) -> bool:
        self.results, self.last_level = [], None
        conv = self.config.mms.convergence
        if conv and conv.num_refinements:
            rates = self.rates = estimate_convergence_rates(
                self.problem, self.base_mesh, dtype=self.dtype,
                device=self.device, log=log, on_level=self._keep,
            )
            log("Convergence rates:")
            for i, comp in enumerate(self.COMPONENTS):
                log(
                    f"  {comp}: L1 = {rates['L1'][i]:.3g}, "
                    f"L2 = {rates['L2'][i]:.3g}, Linf = {rates['Linf'][i]:.3g}"
                )
            ok = True
            for i, comp in enumerate(self.COMPONENTS):
                expected = conv.expected_rates.get(comp)
                if expected is None:
                    continue
                for norm in ("L1", "L2", "Linf"):
                    got = rates[norm][i]
                    want = getattr(expected, norm)
                    if np.isnan(got) or got <= want:
                        log(
                            f"FAIL: {norm} convergence rate for {comp} is "
                            f"{got:.3g} (expected {want})"
                        )
                        ok = False
            if ok:
                log("PASS: all convergence rates satisfy thresholds.")
            return ok
        base = conv.base_refinement if conv else 0
        mesh = refine_uniform(self.base_mesh, base) if base else self.base_mesh
        level = setup_mms_level(self.problem, mesh, self.dtype, self.device)
        res = level.run()
        self._keep(level, res)
        log(f"Error norms at t = {self.config.time.stop}:")
        for i, comp in enumerate(self.COMPONENTS):
            log(
                f"  {comp}: L1 = {res.L1[i]:.6g}, L2 = {res.L2[i]:.6g}, "
                f"Linf = {res.Linf[i]:.6g}"
            )
        log(f"  Avg-cell-area    : {res.area / res.num_cells:.16f}")
        log(f"  Avg-length-scale : {np.sqrt(res.area / res.num_cells):.16f}")
        self.last_result = res
        return True
