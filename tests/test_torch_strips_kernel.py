"""The row-strip modes of the raster kernels (plain versions) and the
strip plumbing of rdycore_tpu_torch, on the CPU, in float32.

- K2 (`swe_raster_step`, flow only and with three tracers, in rhs mode
  and each ssprk3 stage, rain and Dirichlet walls) and K2 MUSCL (faces and
  update) launched strip by strip on 4 strips of a 128x32 raster give the
  whole raster's launch bit for bit on the owned rows: outputs,
  primitives, faces, and the largest Courant maximum.
- The strip checks: a strip needs halo rows off the raster's walls (1 at
  first order, 3 at second) and none on them; the layout refuses rows
  that do not split or strips thinner than their halo.
- The halo exchange refills every halo row from the neighbours; the
  boundary edges of the strips cover each of the raster's exactly once;
  `convert` carries the JAX package's padded strip planes to strip
  buffers and back unchanged; the float32 cube root does not depend on
  the tensor's length (it did through torch.pow's vector path, which
  made a strip's critical-outflow ghosts differ by an ulp).
"""

import numpy as np
import pytest
import torch

from rdycore_tpu.ops.pallas.structured_step import pad_plane_sharded
from rdycore_tpu_torch.convert import sharded_from_strips, strips_from_sharded
from rdycore_tpu_torch.mesh import structured_quad
from rdycore_tpu_torch.operator import build_operator
from rdycore_tpu_torch.ops.kernels.raster_muscl import (
    donor_factors,
    swe_raster_muscl_faces,
    swe_raster_muscl_update,
)
from rdycore_tpu_torch.ops.kernels.raster_step import (
    Strip,
    StructuredPlan,
    swe_raster_step,
)
from rdycore_tpu_torch.ops.math import safe_cbrt
from rdycore_tpu_torch.ops.strips import (
    exchange,
    split_rows,
    strip_boundary_edges,
    strip_layout,
    strip_wall_values,
)
from rdycore_tpu_torch.ops.structured import (
    FUSED_STAGES,
    boundary_edge_arrays,
)

from test_torch_strips_euler import DX, NX, NY, WALLS, strip_raster

CPU = torch.device("cpu")


def strip_case(nt, halo, second_order=False):
    q, geo, bcv, src = strip_raster(21, nt)
    plan = StructuredPlan(NX, NY, DX, DX, 1e-7,
                          1e-3 if second_order else 0.0, *WALLS)
    t = torch.as_tensor
    strips = strip_layout(NY, 4, halo)
    qt = t(q.reshape(q.shape[0], -1))
    return (plan, qt, [t(g) for g in geo], {k: t(v) for k, v in bcv.items()},
            t(src), strips, split_rows(qt, strips, [CPU] * 4, NX))


def rows(x, s):
    return x[s.row0:s.row0 + s.rows]


@pytest.mark.parametrize("nt", [0, 3])
def test_raster_step_strips_reproduce_the_whole_raster(nt):
    plan, q, geo, bcv, src, strips, bufs = strip_case(nt, 1)
    dt = torch.tensor(5e-4)
    qA = q.flip(1).contiguous()
    bufs_A = split_rows(qA, strips, [CPU] * 4, NX)
    modes = [dict(emit_prim=True)] + [
        dict(stage=s, emit_prim=True, qA=i > 0)
        for i, s in enumerate(FUSED_STAGES["ssprk3"])]
    kw = dict(num_sediment=min(nt, 2), upwind=bool(nt))
    for mode in modes:
        use_qA = mode.pop("qA", False)
        whole = swe_raster_step(plan, q, *geo, dt, src=src, bc_vals=bcv,
                                qA=qA if use_qA else None, **kw, **mode)
        wq = whole.out.reshape(3 + nt, NY, NX)
        cms = []
        for s, b, bA in zip(strips, bufs, bufs_A):
            got = swe_raster_step(
                plan, b, *(rows(g, s) for g in geo), dt, src=rows(src, s),
                bc_vals=strip_wall_values(bcv, s, NY, CPU), strip=s,
                qA=bA if use_qA else None, **kw, **mode)
            assert torch.equal(s.owned(got.out),
                               wq[:, s.row0:s.row0 + s.rows])
            assert torch.equal(got.prim, whole.prim.reshape(3 + nt, NY, NX)[
                :, s.row0:s.row0 + s.rows].reshape(3 + nt, -1))
            cms.append(got.cmax.max())
        assert torch.equal(torch.stack(cms).max(), whole.cmax.max())


def test_raster_muscl_strips_reproduce_the_whole_raster():
    plan, q, geo, bcv, src, strips, bufs = strip_case(0, 3, True)
    dt = torch.tensor(5e-3)  # large enough for donor factors below 1
    fx, fy, cm = swe_raster_muscl_faces(plan, q, bcv, "minmod")
    assert int((donor_factors(plan, q, fx, fy, dt) < 1.0).sum()) > 0
    out, prim = swe_raster_muscl_update(plan, q, fx, fy, *geo, dt, src=src,
                                        emit_prim=True)
    cms = []
    for s, b in zip(strips, bufs):
        sfx, sfy, scm = swe_raster_muscl_faces(
            plan, b, strip_wall_values(bcv, s, NY, CPU), "minmod", s)
        f0 = s.row0 - int(s.halo_lo > 0)  # the first face row
        assert torch.equal(sfx, fx[:, f0:f0 + sfx.shape[1]])
        assert torch.equal(sfy, fy[:, f0:f0 + sfy.shape[1]])
        o, p = swe_raster_muscl_update(plan, b, sfx, sfy,
                                       *(rows(g, s) for g in geo), dt,
                                       src=rows(src, s), emit_prim=True,
                                       strip=s)
        assert torch.equal(s.owned(o),
                           out.reshape(3, NY, NX)[:, s.row0:s.row0 + s.rows])
        assert torch.equal(p.reshape(3, -1, NX), prim.reshape(3, NY, NX)[
            :, s.row0:s.row0 + s.rows])
        cms.append(scm.max())
    assert torch.equal(torch.stack(cms).max(), cm.max())


def test_strip_checks():
    plan, q, geo, bcv, src, strips, bufs = strip_case(0, 1)
    dt = torch.tensor(5e-4)
    s = strips[1]
    args = (plan, bufs[1], *(rows(g, s) for g in geo), dt)
    bc = strip_wall_values(bcv, s, NY, CPU)
    for bad in (s._replace(halo_lo=0), s._replace(halo_hi=0),
                Strip(0, 8, 1, 1), s._replace(row0=30)):
        with pytest.raises(ValueError, match="strip"):
            swe_raster_step(*args, bc_vals=bc, strip=bad)
    # second order needs 3 halo rows off the walls
    with pytest.raises(ValueError, match="halo rows >= 3"):
        swe_raster_muscl_faces(plan, bufs[1], bc, "minmod", s)
    # only the strips that hold a Dirichlet bottom or top wall read it
    assert set(bc) == {"left", "right"}
    assert set(strip_wall_values(bcv, strips[-1], NY, CPU)) == {
        "left", "right", "top"}
    for n, P, halo in ((32, 3, 1), (32, 16, 3)):
        with pytest.raises(ValueError):
            strip_layout(n, P, halo)


def test_exchange_refills_every_halo_row():
    plan, q, geo, bcv, src, strips, bufs = strip_case(3, 3)
    fresh = [b.clone() for b in bufs]
    for b, s in zip(bufs, strips):  # spoil the halo rows
        v = b.reshape(6, s.buffer_rows, NX)
        v[:, :s.halo_lo] = np.nan
        v[:, s.halo_lo + s.rows:] = np.nan
    exchange(bufs, strips, NX)
    assert all(torch.equal(a, b) for a, b in zip(bufs, fresh))


def test_strip_boundary_edges_cover_each_edge_once():
    mesh = structured_quad(NX, NY, 0.0, NX * DX, 0.0, NY * DX)
    bnd = boundary_edge_arrays(build_operator(
        mesh, dtype=torch.float32, device="cpu").arrays)
    seen = []
    for s in strip_layout(NY, 4, 1):
        sub, idx = strip_boundary_edges(bnd, NX, s, CPU)
        # the strip-buffer cell of each edge is its raster cell
        cell = sub.bnd_left.long() - (s.halo_lo - s.row0) * NX
        assert torch.equal(cell, bnd.bnd_left.long()[idx])
        assert torch.equal(sub.bnd_cn, bnd.bnd_cn[idx])
        seen.append(idx)
    seen = torch.cat(seen).sort().values
    assert torch.equal(seen, torch.arange(bnd.bnd_left.shape[0]))


def test_convert_carries_jax_strip_planes_both_ways():
    q, _, _, _ = strip_raster(22, nt=3)
    stacks = np.stack([pad_plane_sharded(x, 4, 8) for x in q])
    strips = strip_layout(NY, 4, 3)
    bufs = strips_from_sharded(stacks, 8, 3, "cpu")
    want = split_rows(torch.as_tensor(q.reshape(6, -1)), strips, [CPU] * 4,
                      NX)
    assert all(torch.equal(a, b) for a, b in zip(bufs, want))
    assert np.array_equal(sharded_from_strips(bufs, strips, NX, 8), stacks)


def test_float32_cube_root_does_not_depend_on_the_length():
    x = torch.as_tensor(np.random.default_rng(3).uniform(0, 1e-3, 64),
                        dtype=torch.float32)
    whole = safe_cbrt(x)
    parts = torch.cat([safe_cbrt(x[i:i + 17]) for i in range(0, 64, 17)])
    assert torch.equal(whole, parts)
    assert torch.equal(whole, torch.stack([safe_cbrt(v) for v in x]))
