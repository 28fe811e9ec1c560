"""K1a's flux records on the CPU: the layout the port's edge flux hands to
the cell and positivity kernels.

`swe_edge_flux` returns flux [ndof, E + 1] as the transpose of a
contiguous [E + 1, ndof] buffer, each edge's ndof fluxes side by side and
record E the zero dummy; its plain version returns the same layout. These
tests hold, in plain PyTorch (no JAX run), that:

- the plain K1a output is in record form for ndof 3, 4 and 6, in f32 and
  f64, its dummy record is zero, and its [ndof, E + 1] view equals bit for
  bit the row-major flux built from the same interior and boundary fluxes
  (the layout before records);
- K1b's and K3b's plain versions, `apply`'s boundary fluxes and the
  interval's boundary-flux accumulator give the same bits on the record
  view as on a contiguous copy;
- `flux_records` keeps a record flux as it is, copies any other layout,
  and refuses a flux of the wrong shape; `check_records`, the test the
  kernels' wrappers make on the card, refuses a row-major flux;
- K5's plain version on a mesh whose vertices are shuffled against its
  cells gives the shuffled vertex eta.
"""

import copy

import numpy as np
import pytest
import torch

from rdycore_tpu_torch.mesh import structured_quad, structured_tri
from rdycore_tpu_torch.operator import build_operator
from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
from rdycore_tpu_torch.ops.kernels.edge_flux import (
    boundary_flux_plain,
    check_records,
    flux_records,
    is_records,
    swe_edge_flux_plain,
)
from rdycore_tpu_torch.ops.kernels.muscl import (
    positivity_drain_plain,
    positivity_scale_plain,
)
from rdycore_tpu_torch.ops.swe.bs2002 import eta_vertices
from rdycore_tpu_torch.ops.swe.muscl import ls_gradients
from rdycore_tpu_torch.ops.swe.riemann import regularized_velocity, roe_flux
from rdycore_tpu_torch.ops.tracer.flux import safe_div, tracer_roe_flux
from rdycore_tpu_torch.timestepping import make_interval_advancer

CPU = torch.device("cpu")
DTYPES = [torch.float32, torch.float64]
MESHES = {
    "quad": lambda **kw: structured_quad(24, 16, 0.0, 2.0, 0.0, 1.0, **kw),
    "tri": lambda **kw: structured_tri(12, 10, 0.0, 2.0, 0.0, 1.0, **kw),
}


def bed(x, y):
    return 0.2 * (1.0 + np.sin(4 * np.pi * x) * np.sin(4 * np.pi * y))


def setup(mesh, dtype, nt=0, seed=0, **kw):
    """An operator over every BC code and a random wet/dry state, Dirichlet
    values and sources with nt tracer rows, made with numpy from seed."""
    rng = np.random.default_rng(seed)
    m = MESHES[mesh](z_fn=bed)
    op = build_operator(m, bc_types={"left": 0, "right": 2, "top": 1},
                        mannings_n=rng.uniform(0.01, 0.05, m.num_cells),
                        num_tracers=nt, num_sediment=min(nt, 2), dtype=dtype,
                        device=CPU, **kw)
    C, Eb = op.num_cells, op.num_boundary_edges
    h = rng.uniform(0.05, 1.0, C)
    h = np.where(rng.uniform(size=C) < 0.3, 0.0, h)
    q = np.concatenate([[h, h * rng.normal(0, 0.4, C),
                         h * rng.normal(0, 0.4, C)],
                        h * rng.uniform(0.0, 0.5, (nt, C))])
    bv = np.concatenate([[np.full(Eb, 0.3), np.full(Eb, 0.05),
                          np.zeros(Eb)], rng.uniform(0.0, 0.1, (nt, Eb))])
    ext = rng.normal(0, 1e-3, (3 + nt, C))

    def t(x):
        return torch.as_tensor(x, dtype=dtype)

    return op, t(q), t(bv), t(ext)


def row_major_flux(op, q, bv):
    """The first-order flux [ndof, E + 1] as a row-major tensor, from the
    interior Roe fluxes and `boundary_flux_plain`, with a zero column E."""
    a = op.arrays
    il, ir = a.int_left, a.int_right
    hl, hr = q[0, il], q[0, ir]
    ul, vl = regularized_velocity(hl, q[1, il], q[2, il], op.tiny_h,
                                  op.h_anuga)
    ur, vr = regularized_velocity(hr, q[1, ir], q[2, ir], op.tiny_h,
                                  op.h_anuga)
    if q.shape[0] == 3:
        fi = torch.stack(roe_flux(hl, ul, vl, hr, ur, vr, a.int_sn,
                                  a.int_cn)[:3])
        fi = fi * (~((hl < op.tiny_h) & (hr < op.tiny_h))).to(q.dtype)
    else:
        cil = safe_div(q[3:, il], hl, hl, op.tiny_h)
        cir = safe_div(q[3:, ir], hr, hr, op.tiny_h)
        f_flow, f_tr, _ = tracer_roe_flux(hl, ul, vl, cil, hr, ur, vr, cir,
                                          a.int_sn, a.int_cn, False)
        wet = ((hl > op.tiny_h) | (hr > op.tiny_h)).to(q.dtype)
        fi = torch.cat([f_flow, f_tr]) * wet
    fb, _ = boundary_flux_plain(a, q, bv, op.tiny_h, op.h_anuga)
    flux = torch.cat([fi, fb, fb.new_zeros((q.shape[0], 1))], dim=1)
    assert flux.is_contiguous()
    return flux


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nt", [0, 1, 3])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_plain_edge_flux_is_records(mesh, nt, dtype):
    op, q, bv, _ = setup(mesh, dtype, nt)
    flux, courant = swe_edge_flux_plain(op.arrays, q, bv, op.tiny_h,
                                        op.h_anuga)
    ndof, E = 3 + nt, op.num_edges
    assert flux.shape == (ndof, E + 1) and courant.shape == (E,)
    assert is_records(flux) and flux.stride() == (1, ndof)
    assert flux.t().is_contiguous()
    assert torch.equal(flux[:, E], torch.zeros(ndof, dtype=dtype))
    old = row_major_flux(op, q, bv)
    assert torch.equal(flux, old)
    assert torch.equal(flux.contiguous(), old)
    assert bool((flux[:, :E] != 0).any())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nt, hr", [(0, False), (0, True), (3, False),
                                    (3, True)])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cell_stage_plain_same_bits_on_records(mesh, nt, hr, dtype):
    op, q, bv, ext = setup(mesh, dtype, nt, well_balancing_hr=hr)
    a = op.arrays
    flux, _ = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga, hr=hr)
    row_major = flux.contiguous()
    assert is_records(flux) and not is_records(row_major)
    dt = torch.tensor(0.002, dtype=dtype)
    kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
              xq2018_threshold=op.xq2018_threshold, source_method=0,
              num_sediment=min(nt, 2), hr=hr, emit_prim=True)
    for mode in (dict(), dict(stage=(0.75, 0.25, 0.25), qA=q.flip(1))):
        got = swe_cell_stage_plain(a, flux, q, dt, ext, **kw, **mode)
        want = swe_cell_stage_plain(a, row_major, q, dt, ext, **kw, **mode)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_positivity_plain_same_bits_on_records(mesh, dtype):
    op, q, bv, _ = setup(mesh, dtype, second_order=True, h_anuga=1e-3)
    a = op.arrays
    flux, _ = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga,
                                  grad=ls_gradients(a, q))
    assert is_records(flux)
    for dt_s in (0.002, 0.0):
        dt = torch.tensor(dt_s, dtype=dtype)
        s = positivity_drain_plain(a, flux, q[0], dt)
        assert torch.equal(s, positivity_drain_plain(a, flux.contiguous(),
                                                     q[0], dt))
        assert bool((s < 1.0).any()) or dt_s == 0.0
        scaled = positivity_scale_plain(a, flux.clone(), s)
        assert is_records(scaled)
        assert torch.equal(scaled, positivity_scale_plain(
            a, flux.contiguous(), s))


class RowMajorFluxes:
    """op's edge phase handing its flux on as a row-major copy (the layout
    before records), for the accumulators' comparison."""

    def __init__(self, op):
        self.inner = op.fluxes

    def __call__(self, q, boundary_values, dt):
        flux, courant = self.inner(q, boundary_values, dt)
        return flux.contiguous(), courant


@pytest.mark.parametrize("scheme, second_order", [("euler", False),
                                                  ("rk4", False),
                                                  ("ssprk2", True)])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_boundary_flux_accumulator_same_bits_on_records(mesh, scheme,
                                                        second_order):
    op, q, bv, ext = setup(mesh, torch.float64, second_order=second_order,
                           h_anuga=1e-3)
    res = op.apply(q, 0.002, bv, ext)
    Ei, E = op.num_internal_edges, op.num_edges
    flux, _ = op.fluxes(q, bv, torch.tensor(0.002, dtype=q.dtype))
    assert torch.equal(res.boundary_fluxes, flux[:, Ei:E])
    row = copy.copy(op)
    row.fluxes = RowMajorFluxes(op)
    out = []
    for o in (op, row):
        adv = make_interval_advancer(o, scheme)
        out.append(adv(q, 0.0, 0.002, 5, 0.01, bv, ext))
    assert bool(out[0].bflux_accum.abs().max() > 0)
    for field in ("q", "bflux_accum", "accum_sol", "accum_prim",
                  "max_courant"):
        assert torch.equal(getattr(out[0], field), getattr(out[1], field))


def test_flux_records_helper():
    op, q, bv, _ = setup("tri", torch.float32)
    E = op.num_edges
    flux, _ = swe_edge_flux_plain(op.arrays, q, bv, op.tiny_h, op.h_anuga)
    assert flux_records(flux, E) is flux
    row_major = flux.contiguous()
    rec = flux_records(row_major, E)
    assert is_records(rec) and torch.equal(rec, flux)
    assert rec.data_ptr() != row_major.data_ptr()
    for bad in (flux[:, :-1], flux[:2], torch.zeros(11, E + 1), flux[0],
                torch.zeros(3, E + 1, 1)):
        with pytest.raises(ValueError):
            flux_records(bad, E)
    with pytest.raises(ValueError):
        flux_records(flux, E - 1)


def test_check_records_refuses_other_layouts():
    op, q, bv, _ = setup("quad", torch.float64, nt=3)
    E = op.num_edges
    flux, _ = swe_edge_flux_plain(op.arrays, q, bv, op.tiny_h, op.h_anuga)
    check_records(flux, 6, E, torch.float64, CPU, "k")
    check_records(flux, None, E, torch.float64, CPU, "k")
    for bad in (flux.contiguous(), flux[:, :-1], flux.float()):
        with pytest.raises((ValueError, TypeError)):
            check_records(bad, 6, E, torch.float64, CPU, "k")
    with pytest.raises(ValueError, match="records"):
        check_records(flux.contiguous(), 6, E, torch.float64, CPU, "k")
    with pytest.raises(ValueError):
        check_records(flux, 3, E, torch.float64, CPU, "k")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_eta_vertices_on_shuffled_vertices(mesh, dtype):
    op, q, _, _ = setup(mesh, dtype, well_balancing_bs2002=True)
    bs = op.arrays.bs2002
    NV = bs.vertex_cells.shape[0]
    perm = torch.as_tensor(np.random.default_rng(3).permutation(NV))
    shuffled = bs._replace(vertex_cells=bs.vertex_cells[perm],
                           vertex_inv_count=bs.vertex_inv_count[perm])
    ev = eta_vertices(bs, q[0], op.tiny_h)
    assert torch.equal(eta_vertices(shuffled, q[0], op.tiny_h), ev[perm])
