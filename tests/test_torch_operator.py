"""`SWEOperator.apply` of rdycore_tpu_torch against the JAX package's XLA
gather twin, on the CPU (where the port's kernel wrappers take their plain
PyTorch versions).

Both packages get identical geometry and Manning's n (the JAX operator's
arrays carried across with `operator_arrays_from_numpy`) and the same
random wet/dry state, Dirichlet values and sources, made with numpy from a
seed. The walls are Dirichlet (left), critical outflow (right) and
reflecting (top, bottom). Tolerance, relative to each field's largest
magnitude: 1e-12 in f64 and 2e-5 in f32 (XLA contracts multiply-adds into
FMAs on the CPU and PyTorch does not). The Courant edge id must be equal.
The JAX results of each mesh and dtype come from one jitted call.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdycore_tpu.mesh import structured_quad, structured_tri
from rdycore_tpu.operator import build_operator as jax_build_operator
from rdycore_tpu.ops.swe import boundary as jbc
from rdycore_tpu_torch.convert import operator_arrays_from_numpy
from rdycore_tpu_torch.operator import BoundarySegment, SWEOperator, bnd_codes

BC_TYPES = {
    "left": jbc.BC_DIRICHLET,
    "right": jbc.BC_CRITICAL_OUTFLOW,
    "top": jbc.BC_REFLECTING,
}
MESHES = {
    "quad": lambda: structured_quad(24, 16, 0.0, 2.0, 0.0, 1.0),
    "tri": lambda: structured_tri(12, 10, 0.0, 2.0, 0.0, 1.0),
}
DTYPES = {"f64": (jnp.float64, torch.float64, 1e-12),
          "f32": (jnp.float32, torch.float32, 2e-5)}


def port_operator(jop, dtype) -> SWEOperator:
    """The port's operator on the JAX operator's own arrays (CPU)."""
    d = {k: np.asarray(v) for k, v in jop.arrays._asdict().items()
         if v is not None}
    d["bnd_code"] = bnd_codes(jop.segments)
    return SWEOperator(
        arrays=operator_arrays_from_numpy(d, "cpu", dtype),
        segments=tuple(BoundarySegment(*s) for s in jop.segments),
        num_cells=jop.num_cells,
        num_internal_edges=jop.num_internal_edges,
        num_boundary_edges=jop.num_boundary_edges,
        tiny_h=jop.tiny_h, h_anuga=jop.h_anuga,
        source_method=jop.source_method,
        xq2018_threshold=jop.xq2018_threshold,
        num_tracers=jop.num_tracers,
        num_sediment=jop.num_sediment,
        riemann=jop.riemann,
    )


def random_inputs(jop, seed):
    """State (a quarter of the cells dry, a tenth exactly zero), Dirichlet
    values and external sources."""
    rng = np.random.default_rng(seed)
    C, Eb = jop.num_cells, jop.num_boundary_edges
    h = rng.uniform(0.05, 1.0, C)
    h = np.where(rng.uniform(size=C) < 0.25, rng.uniform(0, 5e-8, C), h)
    h = np.where(rng.uniform(size=C) < 0.1, 0.0, h)
    q = np.stack([h, h * rng.normal(0, 0.4, C), h * rng.normal(0, 0.4, C)])
    bv = np.stack([rng.uniform(0.1, 0.6, Eb), rng.normal(0, 0.1, Eb),
                   rng.normal(0, 0.1, Eb)])
    ext = rng.normal(0.0, 1e-3, (3, C))
    return q, bv, ext


def assert_rel_close(a, b, tol, what):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, what
    if not a.size:
        return
    scale = max(float(np.max(np.abs(a))), 1e-30)
    err = float(np.max(np.abs(a - b)))
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


@functools.lru_cache(maxsize=None)
def jax_reference(mesh, dtype):
    """The JAX operators of the three source methods on one mesh and dtype,
    their inputs, and their `apply` results (with, on the f64 quad mesh,
    the boundary fluxes of seed 5) from ONE jitted call: one XLA compile
    serves four tests."""
    jdt = DTYPES[dtype][0]
    m = MESHES[mesh]()
    n = np.random.default_rng(3).uniform(0.01, 0.05, m.num_cells)
    jops = [jax_build_operator(m, bc_types=BC_TYPES, mannings_n=n,
                               source_method=method, dtype=jdt)
            for method in (0, 1, 2)]
    inputs = [random_inputs(jop, seed=method)
              for method, jop in enumerate(jops)]
    bnd_inputs = random_inputs(jops[0], seed=5)[:2]
    dt = 0.002

    def run(args, bnd_args):
        out = [jop.apply(q, jnp.asarray(dt, jdt), bv, ext)
               for jop, (q, bv, ext) in zip(jops, args)]
        return out, jops[0].boundary_fluxes(*bnd_args)

    def j(xs):
        return tuple(jnp.asarray(x, jdt) for x in xs)

    results, bnd = jax.jit(run)(tuple(j(x) for x in inputs), j(bnd_inputs))
    return jops, inputs, dt, results, (bnd_inputs, bnd)


@pytest.mark.parametrize("source_method", [0, 1, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_apply_matches_jax(mesh, dtype, source_method):
    _, tdt, tol = DTYPES[dtype]
    jops, inputs, dt, results, _ = jax_reference(mesh, dtype)
    top = port_operator(jops[source_method], tdt)
    q, bv, ext = inputs[source_method]
    rj = results[source_method]
    rt = top.apply(torch.as_tensor(q, dtype=tdt), dt,
                   torch.as_tensor(bv, dtype=tdt),
                   torch.as_tensor(ext, dtype=tdt))
    for field in ("rhs", "flux_div", "prim", "boundary_fluxes",
                  "max_courant_per_dt"):
        got = getattr(rt, field)
        assert got.dtype == tdt, field
        assert_rel_close(getattr(rj, field), got.numpy(), tol, field)
    assert int(rt.courant_edge) == int(rj.courant_edge)
    assert float(rt.max_courant_per_dt) > 0.0


def test_boundary_fluxes_match_jax():
    jops, _, _, _, ((q, bv), (fj, aj)) = jax_reference("quad", "f64")
    top = port_operator(jops[0], torch.float64)
    ft, at = top.boundary_fluxes(torch.as_tensor(q), torch.as_tensor(bv))
    assert_rel_close(fj, ft.numpy(), 1e-12, "fb")
    assert_rel_close(aj, at.numpy(), 1e-12, "amax_b")
