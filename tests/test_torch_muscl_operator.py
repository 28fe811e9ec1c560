"""The second-order (MUSCL) `SWEOperator.apply` of rdycore_tpu_torch against
the JAX package's XLA gather twin, on the CPU, in float64.

Both packages get the JAX operator's arrays (the MUSCL ones included,
carried across by `operator_arrays_from_numpy`) and the same random state
with a wet/dry front, Dirichlet values (non-zero) and sources, made with
numpy from a seed, on a 24x16 quad mesh and a triangle mesh, with
Dirichlet, critical-outflow and reflecting walls. For each limiter
(minmod, van Leer, none) with the positivity limiter on, and for minmod
with it off (`positivity_limit=False`, set explicitly: ROADMAP fault 4),
rhs, flux_div, prim, the (scaled) boundary fluxes and the Courant maximum
agree to 1e-12 relative to each field's largest magnitude, and the Courant
edge is the same. The gradients of K3a's plain version and the limited face
states agree with the JAX package's to 1e-12. The positivity limiter acts
on these states: some donor factor is below 1, and some dry cell (h = 0)
drains (s = 0). The JAX results of each mesh come from one jitted call.

The port's own host builder of the MUSCL arrays (`build_operator` with
`second_order=True`, on a mesh from the port's own generator) gives the
JAX builder's cell_ls_cx/cy and int_dxl/dyl/dxr/dyr to 1e-12 on the quad
mesh, the triangle mesh (whose two corner triangles have one neighbour,
so their normal matrix is degenerate and their gradient zero) and a strip
one cell high (every cell degenerate).

A step with dt = 0 (a step past the interval's end) on a drying front:
the JAX package's positivity factor divides by dt * drain and gives NaN
for a dry donor, which its interval loop hides from the state (ROADMAP
fault 15); the port takes 1 for dt there, as the raster kernel does, so
its apply stays finite, and its state and accumulators after the step are
finite and equal to the JAX package's wherever those are finite.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdycore_tpu import mesh as jax_mesh
from rdycore_tpu.operator import build_operator as jax_build_operator
from rdycore_tpu.ops.swe import boundary as jbc
from rdycore_tpu.ops.swe.muscl import (
    reconstruct_interior_states as jax_reconstruct,
)
from rdycore_tpu.timestepping import (
    make_interval_advancer as jax_interval_advancer,
)
from rdycore_tpu_torch import mesh as port_mesh
from rdycore_tpu_torch.operator import build_operator as port_build_operator
from rdycore_tpu_torch.ops.kernels.muscl import (
    positivity_drain_plain,
    swe_muscl_grad,
)
from rdycore_tpu_torch.ops.swe.muscl import reconstruct_interior_states
from rdycore_tpu_torch.timestepping import make_interval_advancer

from test_torch_operator import (
    BC_TYPES,
    MESHES,
    assert_rel_close,
    port_operator,
)

LIMITERS = ("minmod", "van_leer", "none")
DT = 0.002
# the operators of each mesh: one per limiter, then minmod unlimited
CASES = [(lim, True) for lim in LIMITERS] + [("minmod", False)]
# (t0, dt, n_steps, t_end) of an interval whose one step has dt_i = 0
DT_ZERO_STEP = (1.0, 0.01, 1, 1.0)
# (generator, its arguments, cells with a degenerate normal matrix) of the
# builder comparison
BUILDER_MESHES = {
    "quad": ("structured_quad", (24, 16, 0.0, 2.0, 0.0, 1.0), 0),
    "tri": ("structured_tri", (12, 10, 0.0, 2.0, 0.0, 1.0), 2),
    "strip": ("structured_quad", (8, 1, 0.0, 2.0, 0.0, 0.25), 8),
}
MUSCL_FIELDS = ("cell_ls_cx", "cell_ls_cy", "int_dxl", "int_dyl", "int_dxr",
                "int_dyr")


def front_state(jop, seed):
    """A wet/dry state (30% of the cells dry, h = 0) with flow in every
    direction, Dirichlet values and external sources. The cells on a
    reflecting wall and their neighbours are deep (h >= 0.5), so that no
    donor factor on the wall is below 1: a reflecting wall's h-flux is
    zero only up to rounding, and its sign, which decides whether the
    wall's pressure flux is scaled, differs between XLA's fused
    (FMA-contracted) code and its op-by-op code (ROADMAP fault 17)."""
    rng = np.random.default_rng(seed)
    C, Eb = jop.num_cells, jop.num_boundary_edges
    h = rng.uniform(0.05, 1.0, C)
    h = np.where(rng.uniform(size=C) < 0.3, 0.0, h)
    a = jop.arrays
    bnd_left = np.asarray(a.bnd_left)
    wall = np.zeros(C, bool)
    for seg in jop.segments:
        if seg.bc_type == jbc.BC_REFLECTING:
            wall[bnd_left[seg.start:seg.start + seg.count]] = True
    il, ir = np.asarray(a.int_left), np.asarray(a.int_right)
    near = wall.copy()
    near[il[wall[ir]]] = near[ir[wall[il]]] = True
    h[near] = rng.uniform(0.5, 1.0, int(near.sum()))
    q = np.stack([h, h * rng.normal(0, 0.4, C), h * rng.normal(0, 0.4, C)])
    bv = np.stack([rng.uniform(0.1, 0.6, Eb), rng.normal(0, 0.1, Eb),
                   rng.normal(0, 0.1, Eb)])
    return q, bv, rng.normal(0.0, 1e-3, (3, C))


def jax_gradients(jop, q):
    """The JAX package's LS gradient gather (ops/swe/muscl.py
    reconstruct_interior_states :136-143) as [6, C]."""
    a = jop.arrays
    dq = q[:, a.int_right] - q[:, a.int_left]
    dq_pad = jnp.zeros((3, jop.num_edges + 1), q.dtype)
    gathered = dq_pad.at[:, :jop.num_internal_edges].set(dq)[:, a.cell_edges]
    return jnp.concatenate([(gathered * a.cell_ls_cx).sum(axis=-1),
                            (gathered * a.cell_ls_cy).sum(axis=-1)])


@functools.lru_cache(maxsize=None)
def jax_reference(mesh):
    """The JAX operators of CASES on one mesh, the inputs, and their apply
    results, gradients and face states from ONE jitted call."""
    m = MESHES[mesh]()
    n = np.random.default_rng(3).uniform(0.01, 0.05, m.num_cells)
    jops = [jax_build_operator(m, bc_types=BC_TYPES, mannings_n=n,
                               second_order=True, limiter=lim,
                               positivity_limit=pos, dtype=jnp.float64)
            for lim, pos in CASES]
    q, bv, ext = front_state(jops[0], 7)
    advance = jax_interval_advancer(jops[0], "euler")

    def run(q, bv, ext):
        # on the quad mesh also a step with dt = 0: apply, and one step
        # past the interval's end
        dt0 = ((jops[0].apply(q, jnp.asarray(0.0), bv, ext),
                advance(jops[0].arrays, q, *DT_ZERO_STEP, bv, ext))
               if mesh == "quad" else None)
        return ([jop.apply(q, jnp.asarray(DT), bv, ext) for jop in jops],
                jax_gradients(jops[0], q),
                [jax_reconstruct(jop, q) for jop in jops[:3]], dt0)

    results = jax.jit(run)(*map(jnp.asarray, (q, bv, ext)))
    return jops, (q, bv, ext), results


def port(jop, positivity):
    return dataclasses.replace(
        port_operator(jop, torch.float64), second_order=True,
        limiter=jop.limiter, positivity_limit=positivity)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{lim}-{'limited' if pos else 'unlimited'}"
                              for lim, pos in CASES])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_muscl_apply_matches_jax(mesh, case):
    jops, inputs, (results, *_) = jax_reference(mesh)
    top = port(jops[case], CASES[case][1])
    rj = results[case]
    rt = top.apply(*(torch.as_tensor(x) for x in inputs[:1]), DT,
                   *(torch.as_tensor(x) for x in inputs[1:]))
    for field in ("rhs", "flux_div", "prim", "boundary_fluxes",
                  "max_courant_per_dt"):
        assert_rel_close(getattr(rj, field), getattr(rt, field).numpy(),
                         1e-12, field)
    assert int(rt.courant_edge) == int(rj.courant_edge)
    assert float(rt.max_courant_per_dt) > 0.0


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gradients_and_faces_match_jax(mesh):
    jops, (q, _, _), (_, grad_j, faces_j, _) = jax_reference(mesh)
    top = port(jops[0], True)
    qt = torch.as_tensor(q)
    grad = swe_muscl_grad(top.arrays, qt)
    assert_rel_close(grad_j, grad.numpy(), 1e-12, "grad")
    assert float(grad.abs().max()) > 0.0
    for jop, fj in zip(jops, faces_j):
        ft = reconstruct_interior_states(top.arrays, qt, grad, jop.limiter)
        for side_j, side_t in zip(fj, ft):
            for k in range(3):
                assert_rel_close(side_j[k], side_t[k].numpy(), 1e-12,
                                 f"{jop.limiter} face state {k}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_positivity_limiter_acts(mesh):
    """On the front state the limiter scales some fluxes (s < 1), and some
    dry donor (h = 0) with an outgoing flux gets s = 0; unlimited, the
    same operator would drain that cell below zero."""
    jops, (q, bv, ext), (results, *_) = jax_reference(mesh)
    top = port(jops[0], True)
    qt, bvt = torch.as_tensor(q), torch.as_tensor(bv)
    flux, _ = top.edge_flux(qt, bvt, top.muscl_grad(qt))
    s = positivity_drain_plain(top.arrays, flux, qt[0],
                               torch.tensor(DT, dtype=torch.float64))
    assert int((s < 1.0).sum()) > 0
    dry_drained = (qt[0] == 0.0) & (s == 0.0)
    assert int(dry_drained.sum()) > 0
    # the unlimited JAX operator's flux divergence pulls such a cell below
    # zero in one step, the limited one does not
    idx = np.flatnonzero(dry_drained.numpy())
    unlimited = np.asarray(results[-1].flux_div[0])[idx]
    limited = np.asarray(results[0].flux_div[0])[idx]
    assert (q[0, idx] + DT * unlimited).min() < 0.0
    assert (q[0, idx] + DT * limited).min() >= -1e-12


def test_dt_zero_step_stays_finite():
    jops, (q, bv, ext), (*_, (rj, res_j)) = jax_reference("quad")
    # the JAX package's apply at dt = 0 divides 0 by 0 for a dry donor
    assert not np.isfinite(np.asarray(rj.rhs)).all()
    top = port(jops[0], True)
    t = torch.as_tensor
    rt = top.apply(t(q), 0.0, t(bv), t(ext))
    assert all(bool(torch.isfinite(x).all()) for x in rt[:4])
    res_t = make_interval_advancer(top, "euler")(t(q), *DT_ZERO_STEP, t(bv),
                                                 t(ext))
    for name in ("q", "bflux_accum", "accum_sol", "accum_prim",
                 "max_courant"):
        a, b = np.asarray(getattr(res_j, name)), getattr(res_t, name).numpy()
        assert np.isfinite(b).all(), name
        ok = np.isfinite(a)
        np.testing.assert_array_equal(a[ok], b[ok], err_msg=name)
    np.testing.assert_array_equal(res_t.q.numpy(), q)


@pytest.mark.parametrize("mesh", sorted(BUILDER_MESHES))
def test_muscl_arrays_match_jax_builder(mesh):
    gen, args, n_degenerate = BUILDER_MESHES[mesh]
    jop = jax_build_operator(getattr(jax_mesh, gen)(*args), second_order=True,
                             dtype=jnp.float64)
    top = port_build_operator(getattr(port_mesh, gen)(*args),
                              second_order=True, dtype=torch.float64,
                              device="cpu")
    for field in MUSCL_FIELDS:
        assert_rel_close(getattr(jop.arrays, field),
                         getattr(top.arrays, field).numpy(), 1e-12, field)
    # a cell with interior slots but all-zero coefficients took the
    # degenerate branch (|det| < 1e-15)
    cx, cy = top.arrays.cell_ls_cx.numpy(), top.arrays.cell_ls_cy.numpy()
    interior = top.arrays.cell_edges.numpy() < top.num_internal_edges
    zero = (np.abs(cx) + np.abs(cy)).sum(axis=1) == 0.0
    assert int((zero & interior.any(axis=1)).sum()) == n_degenerate
