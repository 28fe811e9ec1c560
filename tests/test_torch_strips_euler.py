"""The row-strip raster stepper of rdycore_tpu_torch (K2 in strip mode, as
its plain version, over P strips with the halo exchange) against the JAX
package's row-strip sharded stepper (`make_sharded_fused_structured_stepper`
in interpret mode, over P of the 8 host devices of tests/conftest.py), and
against the port's own single strip, on the CPU, in float32.

A 128x32 raster (1/64 m cells) with a random wet/dry state, bed slopes and
Manning's n, a Dirichlet left wall, critical outflow on the right, a
reflecting bottom and a Dirichlet top, and the rain plane: three euler
steps (the last cut short) in P = 2 and 4 strips. Both packages are fed
the same strips: the JAX package's padded strip planes
(`pad_plane_sharded`) become the port's strip buffers through
`convert.strips_from_sharded`, and the port's result goes back through
`convert.sharded_from_strips`. The state agrees with the JAX package's to
2e-6 absolute (O(1) states; the tolerance of the single-device raster
tests, tests/test_torch_raster_kernel.py: the kernel's rsqrt and XLA's FMA
contraction), the float32 time bit for bit and the Courant number to
1e-6. Against the port's single strip everything is bit for bit: q, t, the
Courant number and every accumulator (the boundary fluxes scattered back
into the raster's edge order). The other schemes, tracers and MUSCL are in
tests/test_torch_strips_{schemes,tracers,muscl}.py, `Simulation` in
tests/test_torch_strips_simulation.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec

from rdycore_tpu.ops.pallas.structured_step import (
    StructuredPlan as JaxPlan,
)
from rdycore_tpu.ops.pallas.structured_step import (
    make_sharded_fused_structured_stepper,
    pad_plane_sharded,
)
from rdycore_tpu_torch.convert import sharded_from_strips, strips_from_sharded
from rdycore_tpu_torch.mesh import structured_quad
from rdycore_tpu_torch.operator import build_operator
from rdycore_tpu_torch.ops.kernels.raster_step import StructuredPlan
from rdycore_tpu_torch.ops.strips import gather_rows, split_rows
from rdycore_tpu_torch.ops.structured import (
    FusedStructuredOperator,
    boundary_edge_arrays,
    fused_strip_operators,
    make_fused_structured_stepper,
)

D, R, CO = 0, 1, 2  # Dirichlet, reflecting, critical outflow
NX, NY, DX, GR = 128, 32, 1.0 / 64.0, 8
WALLS = (D, CO, R, D)  # left, right, bottom, top


def strip_raster(seed, nt=0, deep_walls=False):
    """A wet/dry state [3 + nt, NY, NX] with flow in all directions,
    tracer masses, bed slopes, Manning's n, the walls' Dirichlet values
    and a rain plane, float32 numpy. deep_walls: the cells within two of
    the reflecting bottom are deep (ROADMAP fault 17, second order)."""
    rng = np.random.default_rng(seed)
    h = rng.uniform(0.05, 0.6, (NY, NX))
    h = np.where(rng.uniform(size=h.shape) < 0.2, 0.0, h)
    if deep_walls:
        h[:2] = rng.uniform(0.4, 0.6, (2, NX))
    q = np.concatenate([
        [h, h * rng.normal(0, 0.3, h.shape), h * rng.normal(0, 0.3, h.shape)],
        h * rng.uniform(0.0, 0.01, (nt,) + h.shape)]).astype(np.float32)
    geo = [rng.normal(0, 0.02, (NY, NX)), rng.normal(0, 0.02, (NY, NX)),
           rng.uniform(0.01, 0.04, (NY, NX))]
    bcv = {s: np.concatenate([[rng.uniform(0.1, 0.4, n),
                               rng.normal(0, 0.05, n),
                               rng.normal(0, 0.05, n)],
                              rng.uniform(0.0, 1e-3, (nt, n))]
                             ).astype(np.float32)
           for s, n in (("left", NY), ("right", NY), ("bottom", NX),
                        ("top", NX))}
    src = rng.uniform(0.0, 2e-2, (NY, NX)).astype(np.float32)
    return q, [g.astype(np.float32) for g in geo], bcv, src


def run_jax(q, geo, bcv, src, P, scheme, h_anuga=0.0, n_steps=3,
            dt=5e-4, **kw):
    """n_steps of the JAX package's sharded stepper over P host devices
    (the last step cut in half): the output strips [ndof, P, nyl + 2 GR,
    nx + 128], t and the Courant number."""
    nt = q.shape[0] - 3
    t0 = 0.25
    plan = JaxPlan(NX, NY, DX, DX, 1e-7, h_anuga, *WALLS, gr=GR)
    dm = DeviceMesh(np.array(jax.devices()[:P]), ("y",))
    adv = make_sharded_fused_structured_stepper(
        plan, dm, scheme=scheme, with_src=True, interpret=True,
        num_tracers=nt, num_sediment=min(nt, 2), **kw)
    sh = NamedSharding(dm, PartitionSpec("y", None, None))

    def pack(x):
        return jax.device_put(jnp.asarray(pad_plane_sharded(x, P, GR)), sh)

    hc = None
    if nt:
        hc = jax.device_put(
            jnp.asarray(np.stack([pad_plane_sharded(x, P, GR)
                                  for x in q[3:]], axis=1)),
            NamedSharding(dm, PartitionSpec("y", None, None, None)))
    out = adv(pack(q[0]), pack(q[1]), pack(q[2]), t0, dt, n_steps,
              t0 + (n_steps - 0.5) * dt, pack(geo[0]), pack(geo[1]),
              pack(geo[2]), src=pack(src), bc_vals=bcv, hc=hc)
    planes = [np.asarray(x) for x in out[:3]]
    if nt:
        planes += list(np.moveaxis(np.asarray(out[3]), 1, 0))
    return np.stack(planes), float(out[3 + bool(nt)]), \
        float(out[4 + bool(nt)])


def run_port(q, geo, bcv, src, P, scheme, h_anuga=0.0, n_steps=3,
             dt=5e-4, bflux=True, **kw):
    """The port's stepper on the same steps over P strips (P = 1: the
    whole raster), fed through the JAX package's padded strip planes;
    with the boundary-flux accumulator of the raster's boundary edges."""
    nt = q.shape[0] - 3
    plan = StructuredPlan(NX, NY, DX, DX, 1e-7, h_anuga, *WALLS)
    geo_t = [torch.as_tensor(g) for g in geo]
    opts = dict(num_tracers=nt, num_sediment=min(nt, 2), **kw)
    bnd = None
    if bflux:
        mesh = structured_quad(NX, NY, 0.0, NX * DX, 0.0, NY * DX)
        bnd = boundary_edge_arrays(build_operator(
            mesh, bc_types={"left": D, "right": CO, "top": D},
            dtype=torch.float32, device="cpu").arrays)
    if P == 1:
        op = FusedStructuredOperator(plan, *geo_t, bnd, **opts)
        ops = [op]
    else:
        op = ops = fused_strip_operators(plan, *geo_t, ["cpu"] * P, bnd,
                                         **opts)
    # the JAX package's padded strips in, as the port's strip buffers
    stacks = np.stack([pad_plane_sharded(x, P, GR) for x in q])
    strips = [o.strip for o in ops]
    q_in = gather_rows(strips_from_sharded(stacks, GR, strips[0].halo_hi, "cpu"),
                       strips, NX, torch.device("cpu"))
    assert torch.equal(q_in, torch.as_tensor(q.reshape(q.shape[0], -1)))
    t0 = 0.25
    bv = torch.as_tensor(np.random.default_rng(9).uniform(
        0.1, 0.3, (3 + nt, 0 if bnd is None else bnd.bnd_left.shape[0])),
        dtype=torch.float32)
    res = make_fused_structured_stepper(op, scheme, accumulate=bflux)(
        q_in, t0, dt, n_steps, t0 + (n_steps - 0.5) * dt,
        src=torch.as_tensor(src),
        bc_vals={k: torch.as_tensor(v) for k, v in bcv.items()},
        bv_edges=bv if bflux else None)
    # and out as the JAX package's padded strips
    out = sharded_from_strips(split_rows(res.q, strips, ["cpu"] * P, NX),
                              strips, NX, GR)
    return res, out


def assert_matches_jax(jax_run, port_out, res, atol=2e-6):
    jq, jt, jc = jax_run
    interior = (slice(None), slice(None), slice(GR, -GR), slice(64, -64))
    assert np.abs(port_out[interior] - jq[interior]).max() <= atol
    assert float(res.t) == jt  # float32 time, bit for bit
    assert float(res.max_courant) == pytest.approx(jc, rel=1e-6)
    assert jc > 0.0


def assert_bitwise(a, b):
    """Two IntervalResults of the same run, bit for bit."""
    for name in ("q", "t", "max_courant", "bflux_accum", "accum_sol",
                 "accum_prim", "accum_time"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        assert x is None or torch.equal(x, y), name


@pytest.mark.parametrize("P", [2, 4])
def test_euler_strips_match_jax_and_the_single_strip(P):
    q, geo, bcv, src = strip_raster(11)
    res, out = run_port(q, geo, bcv, src, P, "euler")
    assert_matches_jax(run_jax(q, geo, bcv, src, P, "euler"), out, res)
    one, _ = run_port(q, geo, bcv, src, 1, "euler")
    assert_bitwise(one, res)
    assert float(res.bflux_accum.abs().max()) > 0.0
