"""`SWEOperator.apply` of rdycore_tpu_torch with tracers against the JAX
package's XLA gather twin, on the CPU, in f64.

Three tracers, the first two sediment classes (Hairsine-Rose), ride on
the random wet/dry state of tests/test_torch_operator.py, on a quad and a
triangle mesh with Dirichlet (non-zero tracer masses), critical-outflow and
reflecting walls: the quad mesh with Roe tracer fluxes under the
semi-implicit source method, the triangles with upwind-Roe under the
method none. Both packages get the JAX operator's own arrays. rhs,
flux_div, prim, the boundary fluxes and the Courant maximum agree to 1e-12
relative to each field's largest magnitude; the Courant edge id is equal.
One jitted JAX `apply` per case (about 2 s of XLA compile) keeps the file
cheap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdycore_tpu.operator import build_operator as jax_build_operator
from rdycore_tpu_torch.operator import build_operator
from rdycore_tpu_torch.mesh import structured_quad

from test_torch_operator import (
    BC_TYPES,
    MESHES,
    assert_rel_close,
    port_operator,
    random_inputs,
)

NT, NS = 3, 2


@pytest.mark.parametrize("mesh, riemann, source_method", [
    ("quad", "roe", 0), ("tri", "upwind_roe", 2),
])
def test_apply_with_tracers_matches_jax(mesh, riemann, source_method):
    m = MESHES[mesh]()
    n = np.random.default_rng(3).uniform(0.01, 0.05, m.num_cells)
    jop = jax_build_operator(m, bc_types=BC_TYPES, mannings_n=n,
                             num_tracers=NT, num_sediment=NS,
                             riemann=riemann, source_method=source_method,
                             dtype=jnp.float64)
    top = port_operator(jop, torch.float64)
    assert (top.ndof, top.num_sediment, top.riemann) == (3 + NT, NS, riemann)
    assert top.zero_boundary_values().shape == (
        jop.zero_boundary_values().shape)
    q, bv, ext = random_inputs(jop, seed=7)
    rng = np.random.default_rng(8)
    C, Eb = jop.num_cells, jop.num_boundary_edges
    q = np.concatenate([q, q[0] * rng.uniform(0.0, 0.5, (NT, C))])
    bv = np.concatenate([bv, bv[0] * rng.uniform(0.0, 0.5, (NT, Eb))])
    ext = np.concatenate([ext, rng.normal(0.0, 1e-4, (NT, C))])
    dt = 0.002
    rj = jax.jit(jop.apply)(jnp.asarray(q), jnp.asarray(dt), jnp.asarray(bv),
                            jnp.asarray(ext))
    rt = top.apply(torch.as_tensor(q), dt, torch.as_tensor(bv),
                   torch.as_tensor(ext))
    for field in ("rhs", "flux_div", "prim", "boundary_fluxes",
                  "max_courant_per_dt"):
        got = getattr(rt, field)
        assert got.dtype == torch.float64 and got.shape[:1] == (
            np.shape(getattr(rj, field))[:1]), field
        assert_rel_close(getattr(rj, field), got.numpy(), 1e-12, field)
    assert int(rt.courant_edge) == int(rj.courant_edge)
    # the tracer rows carry flux; `boundary_fluxes` (the JAX package's
    # `boundary_fluxes_nd`, which computes what `apply` returns) agrees
    assert np.all(np.abs(rt.boundary_fluxes[3:].numpy()).max(axis=1) > 0)
    ft, _ = top.boundary_fluxes(torch.as_tensor(q), torch.as_tensor(bv))
    assert torch.equal(ft, rt.boundary_fluxes)


def test_tracer_operator_refuses_xq2018():
    with pytest.raises(ValueError, match="xq2018"):
        build_operator(structured_quad(4, 3, 0.0, 1.0, 0.0, 1.0),
                       num_tracers=1, source_method=1, device="cpu")
