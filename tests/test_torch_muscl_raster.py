"""The second-order raster step (K2 MUSCL, plain versions) of
rdycore_tpu_torch against the JAX package's, and against the port's own
unstructured MUSCL path, on the CPU, in float32.

- The fused stepper with `second_order` against the JAX package's
  `make_fused_structured_stepper(second_order=True)` run in interpret mode:
  euler with minmod and a rain plane, three steps on a 128x16 raster with a
  random wet/dry state (the last step cut short), a Dirichlet left wall,
  critical outflow on the right and top and a reflecting bottom. The state
  agrees to 2e-6 absolute (O(1) states; the kernel's rsqrt, FMA
  contraction by XLA), the float32 time bitwise and the Courant number to
  1e-6, and the positivity limiter acted (some donor factor below 1). The
  cells within two of the reflecting wall are deep: the sign of that
  wall's h-flux, zero up to rounding, decides whether its pressure flux is
  scaled, and XLA's fused code rounds it otherwise (ROADMAP fault 17).
  h_anuga = 1e-3 regularizes the velocities: a MUSCL face beside a dry
  cell may be thin with a momentum that is not, and with h_anuga = 0 its
  u = hu/h is so ill-conditioned that the two packages' roundings part
  within three steps. rk4 with van Leer is in
  tests/test_torch_muscl_raster_rk4.py (one JAX compile per file).
- A `Simulation` on `fused_structured` with `second_order` agrees with the
  port's unstructured second-order path on the same raster to 5e-5, as the
  JAX package holds its own two paths (tests/test_structured_backend.py
  :385-416), for minmod/euler, van Leer/ssprk2 and none/rk4.
- On `fused_structured` the boundary-flux accumulator stays first order
  and unscaled at second order, as the JAX package's raster stepper takes
  it from the unstructured `boundary_fluxes` (ROADMAP fault 16): after
  one step it is dt times the first-order boundary fluxes of the initial
  state.
- The drying twin of `test_fused_structured_second_order_drying_positivity`
  (tests/test_structured_backend.py:419-443) on both paths, port only: a
  steep front into a nearly dry floodplain with a large dt stays
  non-negative (h >= -1e-7), finite, and keeps its volume in a closed box
  to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdycore_tpu.ops.pallas.structured_step import GC
from rdycore_tpu.ops.pallas.structured_step import (
    StructuredPlan as JaxPlan,
)
from rdycore_tpu.ops.pallas.structured_step import (
    make_fused_structured_stepper as jax_fused_stepper,
)
from rdycore_tpu.ops.pallas.structured_step import pad_plane
from rdycore_tpu_torch import Simulation
from rdycore_tpu_torch.config.schema import Config
from rdycore_tpu_torch.mesh import structured_quad
from rdycore_tpu_torch.ops.kernels.raster_muscl import (
    donor_factors,
    raster_muscl_faces_plain,
)
from rdycore_tpu_torch.ops.kernels.raster_step import StructuredPlan
from rdycore_tpu_torch.ops.structured import (
    FusedStructuredOperator,
    make_fused_structured_stepper,
)

D, R, CO = 0, 1, 2  # Dirichlet, reflecting, critical outflow
NX, NY, DX = 128, 16, 1.0 / 64.0
H_ANUGA = 1e-3


def muscl_raster(rng, walls):
    """A wet/dry state with flow in all directions, bed slopes, Manning's n
    and Dirichlet wall values as float32 planes; the cells within two of a
    reflecting wall are deep."""
    h = rng.uniform(0.05, 0.6, (NY, NX))
    h = np.where(rng.uniform(size=h.shape) < 0.2, 0.0, h)
    left, right, bottom, top = walls
    for bc, rows in ((left, np.s_[:, :2]), (right, np.s_[:, -2:]),
                     (bottom, np.s_[:2]), (top, np.s_[-2:])):
        if bc == R:
            h[rows] = rng.uniform(0.4, 0.6, h[rows].shape)
    q = np.stack([h, h * rng.normal(0, 0.3, h.shape),
                  h * rng.normal(0, 0.3, h.shape)]).astype(np.float32)
    geo = [rng.normal(0, 0.02, (NY, NX)), rng.normal(0, 0.02, (NY, NX)),
           rng.uniform(0.01, 0.04, (NY, NX))]
    bcv = {s: np.stack([rng.uniform(0.1, 0.4, n), rng.normal(0, 0.05, n),
                        rng.normal(0, 0.05, n)]).astype(np.float32)
           for s, n in (("left", NY), ("right", NY), ("bottom", NX),
                        ("top", NX))}
    return q, [g.astype(np.float32) for g in geo], bcv


def run_both(scheme, limiter, walls, rain, seed):
    """Three steps (the last cut short) of the JAX package's fused MUSCL
    stepper (interpret mode) and of the port's (plain K2 MUSCL)."""
    rng = np.random.default_rng(seed)
    q, geo, bcv = muscl_raster(rng, walls)
    src = rng.uniform(0.0, 2e-2, (NY, NX)).astype(np.float32)
    dt, n_steps, t0 = 5e-4, 3, 0.25
    t_end = t0 + 2.5 * dt

    jplan = JaxPlan(NX, NY, DX, DX, 1e-7, H_ANUGA, *walls, gr=16)
    adv = jax_fused_stepper(jplan, *geo, scheme=scheme, with_src=rain,
                            second_order=True, limiter=limiter)
    pad = [jnp.asarray(pad_plane(x, 16)) for x in q]
    jh, jhu, jhv, jt, jc = jax.jit(
        lambda a, b, c: adv(
            a, b, c, t0, dt, n_steps, t_end,
            src=jnp.asarray(pad_plane(src, 16)) if rain else None,
            bc_vals=bcv, interpret=True,
        )
    )(*pad)
    jq = np.stack([np.asarray(x)[16:16 + NY, GC:GC + NX]
                   for x in (jh, jhu, jhv)])

    plan = StructuredPlan(NX, NY, DX, DX, 1e-7, H_ANUGA, *walls)
    op = FusedStructuredOperator(plan, *map(torch.as_tensor, geo),
                                 second_order=True, limiter=limiter)
    bct = {k: torch.as_tensor(v) for k, v in bcv.items()}
    res = make_fused_structured_stepper(op, scheme)(
        torch.as_tensor(q.reshape(3, -1)), t0, dt, n_steps, t_end,
        src=torch.as_tensor(src) if rain else None, bc_vals=bct)
    return dict(jax=(jq, float(jt), float(jc)), port=res, q0=q, plan=plan,
                op=op, bc_vals=bct, dt=dt)


def check_against_jax(r):
    jq, jt, jc = r["jax"]
    res = r["port"]
    got = res.q.numpy().reshape(3, NY, NX)
    assert np.abs(got - jq).max() <= 2e-6
    assert float(res.t) == jt  # float32 time, bitwise
    assert float(res.max_courant) == pytest.approx(jc, rel=1e-6)
    assert jc > 0.0
    assert np.abs(got - r["q0"]).max() > 1e-3  # the state moved


def check_limiter_acted(r):
    """Some donor factor of the initial state is below 1."""
    q = torch.as_tensor(r["q0"].reshape(3, -1))
    fx, fy, _ = raster_muscl_faces_plain(r["plan"], q, r["bc_vals"],
                                         r["op"].limiter)
    s = donor_factors(r["plan"], q, fx, fy, torch.tensor(r["dt"]))
    assert int((s < 1.0).sum()) > 0


@pytest.fixture(scope="module")
def euler_runs():
    return run_both("euler", "minmod", (D, CO, R, CO), True, 5)


def test_fused_muscl_euler_matches_jax(euler_runs):
    check_against_jax(euler_runs)


def test_positivity_limiter_acts_on_the_raster(euler_runs):
    check_limiter_acted(euler_runs)


def _cfg(backend, stop=0.04, dt=2e-3, temporal="euler", limiter="minmod",
         precision="single"):
    cfg = Config()
    cfg.time.stop = stop
    cfg.time.time_step = dt
    cfg.time.coupling_interval = stop / 2
    cfg.numerics.temporal = temporal
    cfg.numerics.edge_flux_backend = backend
    cfg.numerics.second_order = True
    cfg.numerics.limiter = limiter
    cfg.numerics.precision = precision
    cfg.logging.level = "none"
    return cfg.validate()


def _run(cfg, mesh, q0, manning=None):
    sim = Simulation(cfg, mesh=mesh, device="cpu")
    if manning is not None:
        sim.set_manning_n(np.full(mesh.num_cells, manning))
    sim.set_solution(q0)
    sim.run()
    return sim


@pytest.mark.parametrize("limiter, temporal", [
    ("minmod", "euler"), ("van_leer", "ssprk2"), ("none", "rk4"),
])
def test_raster_muscl_matches_unstructured_muscl(limiter, temporal):
    mesh = structured_quad(128, 16, 0, 32, 0, 4,
                           z_fn=lambda x, y: 0.05 * np.sin(x) * np.cos(y))
    C = mesh.num_cells
    rng = np.random.default_rng(17)
    q0 = np.stack([1.0 + rng.random(C), 0.3 * rng.standard_normal(C),
                   0.3 * rng.standard_normal(C)])
    sims = [_run(_cfg(b, temporal=temporal, limiter=limiter), mesh, q0)
            for b in ("xla", "fused_structured")]
    assert sims[1]._structured["kind"] == "fused"
    assert sims[1]._structured["op"].second_order
    q_ref, q_fused = (s.get_solution() for s in sims)
    assert (np.abs(q_fused - q_ref) / (1.0 + np.abs(q_ref))).max() < 5e-5


@pytest.mark.parametrize("backend", ["xla", "fused_structured"])
def test_muscl_drying_front_stays_positive(backend):
    mesh = structured_quad(128, 16, 0, 32, 0, 4)
    x = np.asarray(mesh.cell_centroid[:, 0])
    q0 = np.zeros((3, mesh.num_cells))
    q0[0] = np.where(x < 16.0, 2.0, 1e-4)
    q0[1] = np.where(x < 16.0, 2.0, 0.0)
    sim = _run(_cfg(backend, stop=1.0, dt=0.05, temporal="ssprk2"), mesh,
               q0, manning=0.02)
    q = sim.get_solution()
    assert sim.step == 20 and sim.q.dtype == torch.float32
    assert np.isfinite(q).all()
    assert (q[0] >= -1e-7).all(), "MUSCL overdrained"
    assert q[0].sum() == pytest.approx(q0[0].sum(), rel=1e-5)


def test_raster_muscl_boundary_flux_accumulator_is_first_order():
    mesh = structured_quad(128, 16, 0, 32, 0, 4)
    x = np.asarray(mesh.cell_centroid[:, 0])
    q0 = np.zeros((3, mesh.num_cells))
    q0[0] = np.where(x < 16.0, 2.0, 0.0)
    cfg = _cfg("fused_structured", stop=0.05, dt=0.05)
    cfg.output.time_series.boundary_fluxes = 1
    cfg.time.coupling_interval = 0.05
    sim = _run(cfg, mesh, q0)
    assert sim.step == 1 and sim._structured["op"].second_order
    q = torch.as_tensor(q0, dtype=torch.float32)
    fb, _ = sim.operator.boundary_fluxes(q, sim.boundary_values)
    acc = sim.bflux_accum
    assert np.abs(acc).max() > 0.0
    np.testing.assert_allclose(acc, 0.05 * fb.numpy(), rtol=1e-6,
                               atol=1e-7 * np.abs(acc).max())
