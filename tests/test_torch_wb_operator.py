"""Well-balanced `SWEOperator.apply` of rdycore_tpu_torch against the JAX
package's XLA gather twin, on the CPU, in float64.

On a 12x10 triangle mesh over a bumpy bed (vertex z from `bumpy`), both
packages get the JAX operator's arrays (the BS2002 ones carried across by
`operator_arrays_from_numpy`) and the same random partly dry state,
Dirichlet values and sources, made with numpy from a seed; the walls are
Dirichlet, critical outflow and reflecting. Cases: hydrostatic
reconstruction (HR) flow only with each source method; HR with two
sediment classes and salinity, Roe and upwind-Roe; BS2002 at first order;
BS2002 with MUSCL (minmod) and the positivity limiter, at dt and at 40
times dt, where some donor factor is below 1. rhs, flux_div, prim, the
boundary fluxes and the Courant maximum agree to 1e-12 relative to each
field's largest magnitude, and the Courant edge is the same. All JAX
results come from one jitted call.

Lake at rest on the port alone, as tests/test_well_balancing.py holds the
JAX package: HR keeps still water still to 1e-12 over the bed fully wet
and partly dry; BS2002's vertex eta of a submerged lake is its level to
1e-12. BS2002 does not keep the lake still in either package (its
momentum rhs is that of no well-balancing to a fraction of a percent,
ROADMAP fault 19), which the last test pins.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdycore_tpu.mesh import structured_tri
from rdycore_tpu.operator import build_operator as jax_build_operator
from rdycore_tpu_torch import mesh as port_mesh
from rdycore_tpu_torch.convert import operator_arrays_from_numpy
from rdycore_tpu_torch.operator import (
    BoundarySegment,
    SWEOperator,
    bnd_codes,
)
from rdycore_tpu_torch.operator import build_operator as port_build_operator
from rdycore_tpu_torch.ops.kernels.muscl import positivity_drain_plain
from rdycore_tpu_torch.ops.swe.bs2002 import eta_vertices

from test_torch_muscl_operator import front_state
from test_torch_operator import BC_TYPES, assert_rel_close, random_inputs

DT = 0.002
NT, NS = 3, 2
# (name, build_operator keywords, inputs) of each case
CASES = (
    [(f"hr-src{m}", dict(well_balancing_hr=True, source_method=m), "flow")
     for m in (0, 1, 2)]
    + [(f"hr-tracers-{r}", dict(well_balancing_hr=True, num_tracers=NT,
                                num_sediment=NS, riemann=r), "tracers")
       for r in ("roe", "upwind_roe")]
    + [("bs2002", dict(well_balancing_bs2002=True), "flow"),
       ("bs2002-muscl", dict(well_balancing_bs2002=True, second_order=True,
                             limiter="minmod", positivity_limit=True),
        "front")]
)
FIELDS = ("rhs", "flux_div", "prim", "boundary_fluxes", "max_courant_per_dt")


def bumpy(x, y):
    return 0.15 * np.sin(3.0 * x) * np.cos(4.0 * y) + 0.05 * x


def port_wb_operator(jop) -> SWEOperator:
    """The port's operator on the JAX operator's own arrays (CPU, f64),
    its BS2002 arrays included."""
    a = jop.arrays
    d = {k: np.asarray(v) for k, v in a._asdict().items()
         if v is not None and k != "bs2002"}
    if a.bs2002 is not None:
        d["bs2002"] = {k: np.asarray(v) for k, v in a.bs2002._asdict().items()}
    d["bnd_code"] = bnd_codes(jop.segments)
    return SWEOperator(
        arrays=operator_arrays_from_numpy(d, "cpu", torch.float64),
        segments=tuple(BoundarySegment(*s) for s in jop.segments),
        num_cells=jop.num_cells,
        num_internal_edges=jop.num_internal_edges,
        num_boundary_edges=jop.num_boundary_edges,
        tiny_h=jop.tiny_h, h_anuga=jop.h_anuga,
        source_method=jop.source_method,
        xq2018_threshold=jop.xq2018_threshold,
        num_tracers=jop.num_tracers, num_sediment=jop.num_sediment,
        riemann=jop.riemann, second_order=jop.second_order,
        limiter=jop.limiter, positivity_limit=jop.positivity_limit,
        well_balancing_hr=jop.well_balancing_hr,
        well_balancing_bs2002=jop.well_balancing_bs2002,
    )


def case_inputs(jop, kind, seed):
    if kind == "front":
        return front_state(jop, seed)
    q, bv, ext = random_inputs(jop, seed)
    if kind == "tracers":
        rng = np.random.default_rng(seed + 100)
        C, Eb = jop.num_cells, jop.num_boundary_edges
        q = np.concatenate([q, q[0] * rng.uniform(0.0, 0.5, (NT, C))])
        bv = np.concatenate([bv, bv[0] * rng.uniform(0.0, 0.5, (NT, Eb))])
        ext = np.concatenate([ext, rng.normal(0.0, 1e-4, (NT, C))])
    return q, bv, ext


@functools.lru_cache(maxsize=None)
def jax_reference():
    """The JAX operators of CASES, their inputs and their apply results
    (the BS2002 MUSCL case also at 40 dt) from ONE jitted call."""
    m = structured_tri(12, 10, 0.0, 2.0, 0.0, 1.0, z_fn=bumpy)
    n = np.random.default_rng(3).uniform(0.01, 0.05, m.num_cells)
    jops = [jax_build_operator(m, bc_types=BC_TYPES, mannings_n=n,
                               dtype=jnp.float64, **kw)
            for _, kw, _ in CASES]
    inputs = [case_inputs(jop, kind, seed)
              for seed, (jop, (_, _, kind)) in enumerate(zip(jops, CASES))]

    def run(args):
        out = [jop.apply(q, jnp.asarray(DT), bv, ext)
               for jop, (q, bv, ext) in zip(jops, args)]
        q, bv, ext = args[-1]
        return out, jops[-1].apply(q, jnp.asarray(40 * DT), bv, ext)

    args = tuple(tuple(jnp.asarray(x) for x in inp) for inp in inputs)
    results, long = jax.jit(run)(args)
    return jops, inputs, results, long


def check_result(rj, rt):
    for field in FIELDS:
        got = getattr(rt, field)
        assert got.dtype == torch.float64, field
        assert_rel_close(getattr(rj, field), got.numpy(), 1e-12, field)
    assert int(rt.courant_edge) == int(rj.courant_edge)
    assert float(rt.max_courant_per_dt) > 0.0


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_wb_apply_matches_jax(case):
    jops, inputs, results, _ = jax_reference()
    top = port_wb_operator(jops[case])
    t = [torch.as_tensor(x) for x in inputs[case]]
    check_result(results[case], top.apply(t[0], DT, *t[1:]))


def test_bs2002_muscl_limited_at_40_dt():
    """The BS2002 MUSCL operator at 40 times dt, where the positivity
    limiter scales the corrected fluxes of some cells."""
    jops, inputs, _, long = jax_reference()
    top = port_wb_operator(jops[-1])
    q, bv, ext = (torch.as_tensor(x) for x in inputs[-1])
    dt = torch.tensor(40 * DT, dtype=torch.float64)
    flux, _ = top.edge_flux(q, bv, top.muscl_grad(q),
                            top.eta_vertices(q[0]))
    assert int((positivity_drain_plain(top.arrays, flux, q[0], dt)
                < 1.0).sum()) > 0
    check_result(long, top.apply(q, dt, bv, ext))


def test_bs2002_boundary_fluxes_match_jax():
    jops, inputs, results, _ = jax_reference()
    case = [c[0] for c in CASES].index("bs2002")
    top = port_wb_operator(jops[case])
    q, bv, _ = (torch.as_tensor(x) for x in inputs[case])
    fb, _ = top.boundary_fluxes(q, bv)
    assert_rel_close(results[case].boundary_fluxes, fb.numpy(), 1e-12,
                     "boundary_fluxes")


def lake_operator(nx, ny, lx, ly, **kw):
    mesh = port_mesh.structured_tri(nx, ny, 0, lx, 0, ly, z_fn=lambda x, y:
                                    0.3 * np.sin(x) * np.cos(y) + 0.02 * x)
    op = port_build_operator(mesh, mannings_n=np.zeros(mesh.num_cells),
                             dtype=torch.float64, device="cpu", **kw)
    return mesh, op


def lake_rhs(op, h0):
    q = torch.zeros((3, op.num_cells), dtype=torch.float64)
    q[0] = torch.as_tensor(h0)
    return op.apply(q, 0.01, op.zero_boundary_values(), torch.zeros_like(q))


@pytest.mark.parametrize("eta0, grid", [(2.0, (12, 10)), (0.15, (16, 12))],
                         ids=["wet", "partly-dry"])
def test_hr_lake_at_rest(eta0, grid):
    mesh, op = lake_operator(*grid, *grid, well_balancing_hr=True)
    h0 = np.maximum(eta0 - mesh.cell_z, 0.0)
    assert (h0 > 0).any() and ((h0 == 0).any() == (eta0 < 1.0))
    assert float(lake_rhs(op, h0).rhs.abs().max()) < 1e-12


def test_bs2002_submerged_lake():
    """The vertex eta of a submerged lake is its level to 1e-12, as in the
    JAX package's own test; the rhs is not still (fault 19): BS2002's
    momentum rhs is within 1% of that without well-balancing."""
    mesh, op = lake_operator(10, 8, 10, 8, well_balancing_bs2002=True)
    _, op0 = lake_operator(10, 8, 10, 8)
    h0 = 3.0 - mesh.cell_z
    eta_v = eta_vertices(op.arrays.bs2002, torch.as_tensor(h0), op.tiny_h)
    np.testing.assert_allclose(eta_v.numpy(), 3.0, rtol=0, atol=1e-12)
    r_bs, r_0 = lake_rhs(op, h0).rhs[1:], lake_rhs(op0, h0).rhs[1:]
    m_bs, m_0 = float(r_bs.abs().max()), float(r_0.abs().max())
    assert m_bs > 1.0 and abs(m_bs - m_0) < 0.01 * m_0
    assert not torch.equal(r_bs, r_0)
