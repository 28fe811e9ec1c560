"""The raster step K2 (plain version) and the raster operator of
rdycore_tpu_torch against the JAX package's, on the CPU.

- The fused stepper on the plain K2 against the JAX package's
  `make_fused_structured_stepper` run in interpret mode, two steps on a
  128x16 raster with a random wet/dry state: euler with a rain plane
  (stage mode) and rk4 without one (rhs mode), each wall code on an x wall
  and on a y wall between the two cases. float32; absolute tolerance 2e-6
  on O(1) states (the kernel's rsqrt, FMA contraction by XLA).
- The stage, rhs and primitive outputs of one K2 call agree with each
  other, and the wrapper takes the plain version for CPU tensors.
- `StructuredSWEOperator` against the JAX `ops/structured.py` in float64:
  the RHS and Courant number to 1e-12 relative on a 24x16 raster (whole
  runs of its stepper: tests/test_torch_raster_structured.py).
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
from rdycore_tpu.ops.structured import (
    build_structured_operator as jax_build_structured,
)
from rdycore_tpu_torch.convert import structured_arrays_from_numpy
from rdycore_tpu_torch.ops import kernels
from rdycore_tpu_torch.ops.kernels.raster_step import (
    StructuredPlan,
    swe_raster_step,
    swe_raster_step_plain,
)
from rdycore_tpu_torch.ops.structured import (
    FUSED_STAGES,
    FusedStructuredOperator,
    build_structured_operator,
    make_fused_structured_stepper,
)

D, R, CO = 0, 1, 2  # Dirichlet, reflecting, critical outflow
NX, NY, DX = 128, 16, 1.0 / 64.0


def random_raster(rng, nx, ny):
    """A wet/dry state with flow in all directions, dry cells on the
    walls, bed slopes and Manning's n, as [ny, nx] float64 planes."""
    h = rng.uniform(0.05, 0.6, (ny, nx))
    h = np.where(rng.uniform(size=(ny, nx)) < 0.15, 0.0, h)
    h[0, :8] = h[:4, -1] = 0.0
    q = np.stack([h, h * rng.normal(0, 0.3, h.shape),
                  h * rng.normal(0, 0.3, h.shape)])
    geo = (rng.normal(0, 0.02, (ny, nx)), rng.normal(0, 0.02, (ny, nx)),
           rng.uniform(0.01, 0.04, (ny, nx)))
    return q, geo


def dirichlet_values(rng, nx, ny):
    return {s: np.stack([rng.uniform(0.1, 0.4, n), rng.normal(0, 0.05, n),
                         rng.normal(0, 0.05, n)])
            for s, n in (("left", ny), ("right", ny), ("bottom", nx),
                         ("top", nx))}


@pytest.mark.parametrize("scheme, walls, rain, h_anuga", [
    ("euler", (D, CO, R, CO), True, 0.0),
    ("rk4", (R, D, D, CO), False, 1e-3),
])
def test_fused_stepper_matches_jax(scheme, walls, rain, h_anuga):
    rng = np.random.default_rng(5)
    q, geo = random_raster(rng, NX, NY)
    q32 = q.astype(np.float32)
    geo32 = [g.astype(np.float32) for g in geo]
    bcv = {k: v.astype(np.float32)
           for k, v in dirichlet_values(rng, NX, NY).items()}
    src = rng.uniform(0.0, 2e-2, (NY, NX)).astype(np.float32)
    dt, n_steps, t0 = 1e-3, 2, 0.25
    t_end = t0 + 1.5 * dt  # the second step is cut in half

    jplan = JaxPlan(NX, NY, DX, DX, 1e-7, h_anuga, *walls, gr=16)
    adv = jax_fused_stepper(jplan, *geo32, scheme=scheme, with_src=rain)
    pad = [jnp.asarray(pad_plane(x, 16)) for x in q32]
    jh, jhu, jhv, jt, jc = jax.jit(
        lambda a, b, c: adv(
            a, b, c, t0, dt, n_steps, t_end,
            src=jnp.asarray(pad_plane(src, 16)) if rain else None,
            bc_vals=bcv, interpret=True,
        )
    )(*pad)
    jq = np.stack([np.asarray(x)[16:16 + NY, GC:GC + NX] for x in (jh, jhu,
                                                                    jhv)])

    plan = StructuredPlan(NX, NY, DX, DX, 1e-7, h_anuga, *walls)
    op = FusedStructuredOperator(plan, *map(torch.as_tensor, geo32))
    res = make_fused_structured_stepper(op, scheme)(
        torch.as_tensor(q32.reshape(3, -1)), t0, dt, n_steps, t_end,
        src=torch.as_tensor(src) if rain else None,
        bc_vals={k: torch.as_tensor(v) for k, v in bcv.items()},
    )
    got = res.q.numpy().reshape(3, NY, NX)
    assert np.abs(got - jq).max() <= 2e-6
    assert float(res.t) == float(jt)  # float32 time, bitwise
    assert float(res.max_courant) == pytest.approx(float(jc), rel=1e-6)
    assert float(jc) > 0.0


def test_raster_step_modes_agree():
    rng = np.random.default_rng(6)
    q, geo = random_raster(rng, 40, 24)
    plan = StructuredPlan(40, 24, 0.02, 0.01, 1e-7, 0.0, D, CO, R, D)
    t = torch.as_tensor
    dt = torch.tensor(0.002, dtype=torch.float64)
    args = (plan, t(q.reshape(3, -1)), *map(t, geo), dt)
    kw = dict(src=t(rng.uniform(0, 1e-2, (24, 40))),
              bc_vals={k: t(v) for k, v in dirichlet_values(rng, 40, 24)
                       .items()})
    qA = t(rng.uniform(0.0, 0.5, (3, 960)))
    kernels.reset_launch_counts()
    rhs = swe_raster_step(*args, emit_prim=True, **kw)
    for stage in FUSED_STAGES["ssprk3"]:
        alpha, beta, _ = stage
        got = swe_raster_step(*args, stage=stage, qA=qA, **kw)
        want = alpha * qA + beta * (args[1] + dt * rhs.out)
        assert torch.allclose(got.out, want, rtol=0.0, atol=1e-15)
        assert torch.equal(got.cmax, rhs.cmax)
    plain = swe_raster_step_plain(*args, emit_prim=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(rhs, plain))
    assert not any(k.launches for k in kernels.KERNELS)
    h = args[1][0]
    assert torch.equal(rhs.prim[0], h)
    assert torch.all(rhs.prim[1][h < 1e-7] == 0.0)
    # a Courant maximum per 32x16 tile (flow only); the largest is that of
    # the faces
    assert rhs.cmax.shape == (2 * 2,) and float(rhs.cmax.max()) > 0.0
    with pytest.raises(ValueError, match="Dirichlet"):
        swe_raster_step(*args)


@pytest.mark.parametrize("walls, method", [
    ((R, CO, D, CO), 0),
    ((CO, R, CO, R), 1),
])
def test_structured_operator_matches_jax(walls, method):
    rng = np.random.default_rng(7)
    nx, ny = 24, 16
    q, (dzx, dzy, mann) = random_raster(rng, nx, ny)
    kw = dict(bc_left=walls[0], bc_right=walls[1], bc_bottom=walls[2],
              bc_top=walls[3], source_method=method)
    jop = jax_build_structured(nx, ny, 0.0625, 0.05, mannings_n=mann,
                               dtype=jnp.float64, dz_dx=dzx, dz_dy=dzy, **kw)
    arrays = structured_arrays_from_numpy(
        {k: np.asarray(v) for k, v in jop.arrays._asdict().items()}, "cpu",
        torch.float64)
    top = build_structured_operator(nx, ny, 0.0625, 0.05, mannings_n=mann,
                                    dtype=torch.float64, dz_dx=dzx,
                                    dz_dy=dzy, device="cpu", **kw)
    assert all(torch.equal(a, b) for a, b in zip(top.arrays, arrays))
    ext = np.zeros((3, ny, nx))
    ext[0] = rng.uniform(0.0, 1e-3, (ny, nx))
    jr, jc = jax.jit(jop.apply)(jnp.asarray(q), 0.003, jnp.asarray(ext))
    tr, tc = top.apply(torch.as_tensor(q),
                       torch.tensor(0.003, dtype=torch.float64),
                       torch.as_tensor(ext))
    jr = np.asarray(jr)
    assert np.abs(tr.numpy() - jr).max() <= 1e-12 * np.abs(jr).max()
    assert float(tc) == pytest.approx(float(jc), rel=1e-12)
