"""The plain version of K2 MUSCL `swe_raster_muscl_step` (the raster's
second-order step in one launch per stage) on the CPU, in float32, pure
PyTorch.

- `raster_muscl_step_plain`, and the wrapper on CPU tensors, equal the
  composition of its parts (`raster_muscl_faces_plain`, then
  `raster_muscl_update_plain`) bit for bit, on rasters whose nx and ny are
  not multiples of the 32 x 16 tile (ny below one tile among them), one
  case of limiter, mode and rain each.
- The step keeps the raster's symmetries, for each limiter under every
  wall code (Dirichlet values non-zero), with rain and a step long enough
  for donor factors below 1: the transposed raster (x and y, dx and dy,
  hu and hv, the walls and their values swapped) gives the transposed
  result bit for bit, and the raster mirrored in x (hu and dz/dx negated,
  the left and right walls swapped) the mirrored result to 1e-6 of its
  largest value (the sum of a cell's faces, east less west, rounds
  otherwise), both with the same Courant number.
- In a closed box of reflecting walls, with no rain, an euler stage over a
  step whose donor factors fall below 1 keeps the volume to 1e-6 and h >=
  -1e-6 of its largest value (the Audusse scaling, one factor a face); a
  lake at rest (flat bed and surface, no flow, reflecting or Dirichlet
  walls holding the same depth) stays at rest exactly, with a zero rhs;
  and each stage equals alpha qA + beta (q + dt rhs) of the rhs mode's
  output to 1e-6.
- Its Courant maxima are those of the tiles of owned cells (row-major by
  tile, each the largest coefficient of exactly its cells), and fold to
  the same Courant number as the former per-block layout (32 x 8 blocks
  over the face rows), at an index whose tile holds the same cell.
- In P = 2 and 3 row strips (3 halo rows, the last strip ragged), each
  strip's launch equals the whole raster's on its owned rows bit for bit
  (out, prim), its faces are the whole raster's face rows, and the strips'
  largest Courant maximum is the whole raster's.
- dt <= 0 divides the donor factors by 1 (ROADMAP fault 15): finite.

The kernel itself is held to this plain version on the card
(tests/test_torch_cuda.py); the JAX parity of the second-order raster is in
tests/test_torch_muscl_raster*.py and tests/test_torch_strips_muscl.py.
"""

import numpy as np
import pytest
import torch

from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
from rdycore_tpu_torch.ops.kernels.raster_muscl import (
    TILE,
    donor_factors,
    raster_muscl_faces_plain,
    raster_muscl_step_plain,
    raster_muscl_update_plain,
    swe_raster_muscl_step,
)
from rdycore_tpu_torch.ops.kernels.raster_step import (
    Strip,
    StructuredPlan,
    block_max,
    num_blocks,
)
from rdycore_tpu_torch.ops.strips import split_rows, strip_wall_values

D, R, CO = 0, 1, 2  # Dirichlet, reflecting, critical outflow
CPU = torch.device("cpu")
# (nx, ny, walls left, right, bottom, top): ragged against the tile, ny
# below one tile, one tile exactly; every wall code on every side
RASTERS = [(70, 37, (D, CO, R, D)), (40, 5, (CO, D, D, R)),
           (32, 16, (R, R, CO, CO)), (33, 19, (D, D, D, D))]
MODES = {"euler": dict(stage=(0.0, 1.0, 1.0), emit_prim=True),
         "ssprk2 qA": dict(stage=(0.5, 0.5, 0.5), qA=True, emit_prim=True),
         "rhs": dict(emit_prim=True)}
LIMITERS = ("minmod", "van_leer", "none")


def raster(nx, ny, walls, seed, h_anuga=1e-3):
    """A wet/dry state with flow in all directions, bed slopes, Manning's
    n, the rain plane, qA and the Dirichlet walls' values."""
    rng = np.random.default_rng(seed)
    h = rng.uniform(0.05, 1.0, (ny, nx))
    h = np.where(rng.uniform(size=h.shape) < 0.3, 0.0, h)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32)

    q = t(np.stack([h, h * rng.normal(0, 0.4, h.shape),
                    h * rng.normal(0, 0.4, h.shape)]).reshape(3, -1))
    geo = [t(rng.normal(0, 0.01, (ny, nx))), t(rng.normal(0, 0.01, (ny, nx))),
           t(rng.uniform(0.01, 0.05, (ny, nx)))]
    plan = StructuredPlan(nx, ny, 0.01, 0.02, 1e-7, h_anuga, *walls)
    bc = {side: t([rng.uniform(0.1, 0.6, n), rng.normal(0, 0.1, n),
                   rng.normal(0, 0.1, n)])
          for side, w, n in zip(("left", "right", "bottom", "top"), walls,
                                (ny, ny, nx, nx)) if w == D}
    return plan, q, geo, bc, t(rng.uniform(0, 1e-2, (ny, nx))), q.flip(1)


def mode_kw(mode, rain, src, qA):
    kw = dict(MODES[mode])
    kw["qA"] = qA if kw.get("qA") else None
    return dict(kw, src=src if rain else None)


@pytest.mark.parametrize("nx, ny, walls, limiter, mode, rain", [
    r + c for r, c in zip(RASTERS, [("minmod", "euler", True),
                                    ("van_leer", "ssprk2 qA", False),
                                    ("none", "rhs", True),
                                    ("van_leer", "euler", False)])])
def test_step_plain_is_the_composed_pair(nx, ny, walls, limiter, mode,
                                         rain):
    plan, q, geo, bc, src, qA = raster(nx, ny, walls, nx * ny)
    dt = torch.tensor(0.02)  # long enough for donor factors below 1
    kw = mode_kw(mode, rain, src, qA)
    fx, fy, own = raster_muscl_faces_plain(plan, q, bc, limiter)
    assert int((donor_factors(plan, q, fx, fy, dt) < 1.0).sum()) > 0
    out, prim = raster_muscl_update_plain(plan, q, fx, fy, *geo, dt, **kw)
    for got in (raster_muscl_step_plain(plan, q, *geo, dt, bc, limiter,
                                        **kw),
                swe_raster_muscl_step(plan, q, *geo, dt, bc, limiter, **kw)):
        assert torch.equal(got.out, out)
        assert (got.prim is None) == (prim is None)
        if prim is not None:
            assert torch.equal(got.prim, prim)
        assert torch.equal(got.cmax, block_max(own, nx, ny, TILE))
        assert bool(torch.isfinite(got.out).all())


def transposed(plan, q, geo, bc, src):
    """The raster with x and y swapped: (plan, q, geo, bc, src)."""
    nx, ny = plan.nx, plan.ny
    tp = StructuredPlan(ny, nx, plan.dy, plan.dx, plan.tiny_h, plan.h_anuga,
                        plan.bc_bottom, plan.bc_top, plan.bc_left,
                        plan.bc_right)
    q = q.reshape(3, ny, nx)
    side = {"left": "bottom", "right": "top", "bottom": "left",
            "top": "right"}
    return (tp, torch.stack([q[0].T, q[2].T, q[1].T]).reshape(3, -1),
            [geo[1].T.contiguous(), geo[0].T.contiguous(),
             geo[2].T.contiguous()],
            {side[k]: v[[0, 2, 1]] for k, v in bc.items()},
            src.T.contiguous())


def mirrored(plan, q, geo, bc, src):
    """The raster mirrored in x: (plan, q, geo, bc, src)."""
    nx, ny = plan.nx, plan.ny
    mp = plan._replace(bc_left=plan.bc_right, bc_right=plan.bc_left)
    q = q.reshape(3, ny, nx).flip(2) * torch.tensor([1.0, -1.0, 1.0])[
        :, None, None]
    side = {"left": "right", "right": "left", "bottom": "bottom",
            "top": "top"}
    neg = torch.tensor([1.0, -1.0, 1.0])[:, None]
    return (mp, q.reshape(3, -1),
            [-geo[0].flip(1), geo[1].flip(1), geo[2].flip(1)],
            {side[k]: (v if k in ("left", "right") else v.flip(1)) * neg
             for k, v in bc.items()},
            src.flip(1))


@pytest.mark.parametrize("symmetry", ["transpose", "mirror x"])
@pytest.mark.parametrize("limiter", LIMITERS)
@pytest.mark.parametrize("nx, ny, walls", RASTERS)
def test_step_keeps_the_raster_symmetries(nx, ny, walls, limiter, symmetry):
    plan, q, geo, bc, src, _ = raster(nx, ny, walls, 7 * nx + ny)
    dt = torch.tensor(0.02)
    fx, fy, _ = raster_muscl_faces_plain(plan, q, bc, limiter)
    assert int((donor_factors(plan, q, fx, fy, dt) < 1.0).sum()) > 0
    kw = dict(stage=(0.0, 1.0, 1.0), emit_prim=True)
    want = raster_muscl_step_plain(plan, q, *geo, dt, bc, limiter, src=src,
                                   **kw)
    if symmetry == "transpose":
        tp, tq, tgeo, tbc, tsrc = transposed(plan, q, geo, bc, src)
        got = raster_muscl_step_plain(tp, tq, *tgeo, dt, tbc, limiter,
                                      src=tsrc, **kw)
        # back to the raster's layout: the transposed raster's transpose
        back = transposed(tp, got.out, tgeo, {}, tsrc)[1]
        back_prim = transposed(tp, got.prim, tgeo, {}, tsrc)[1]
        assert torch.equal(back, want.out)
        assert torch.equal(back_prim, want.prim)
    else:
        mp, mq, mgeo, mbc, msrc = mirrored(plan, q, geo, bc, src)
        got = raster_muscl_step_plain(mp, mq, *mgeo, dt, mbc, limiter,
                                      src=msrc, **kw)
        back = mirrored(mp, got.out, mgeo, {}, msrc)[1]
        back_prim = mirrored(mp, got.prim, mgeo, {}, msrc)[1]
        for g, w in ((back, want.out), (back_prim, want.prim)):
            assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())
    assert torch.equal(got.cmax.max(), want.cmax.max())


@pytest.mark.parametrize("limiter", LIMITERS)
@pytest.mark.parametrize("nx, ny", [(70, 37), (33, 19)])
def test_closed_box_keeps_its_volume_and_h_nonnegative(nx, ny, limiter):
    plan, q, geo, _, _, _ = raster(nx, ny, (R, R, R, R), nx + ny,
                                   h_anuga=0.0)
    dt = torch.tensor(0.05)
    fx, fy, _ = raster_muscl_faces_plain(plan, q, None, limiter)
    s = donor_factors(plan, q, fx, fy, dt)
    assert float(s.min()) < 0.5
    got = raster_muscl_step_plain(plan, q, *geo, dt, None, limiter,
                                  stage=(0.0, 1.0, 1.0))
    h0, h1 = q[0].double(), got.out[0].double()
    assert abs(float(h1.sum() - h0.sum())) <= 1e-6 * float(h0.sum())
    assert float(h1.min()) >= -1e-6 * float(h0.max())
    assert float((h1 - h0).abs().max()) > 1e-2  # the water moved


@pytest.mark.parametrize("limiter", LIMITERS)
@pytest.mark.parametrize("walls", [(R, R, R, R), (D, D, D, D)])
def test_lake_at_rest_stays_at_rest(walls, limiter):
    nx, ny = 40, 21
    plan = StructuredPlan(nx, ny, 0.01, 0.02, 1e-7, 1e-3, *walls)
    q = torch.zeros(3, ny * nx)
    q[0] = 0.3
    zero = torch.zeros(ny, nx)
    geo = [zero, zero, torch.full((ny, nx), 0.03)]
    bc = {side: torch.tensor([[0.3] * n, [0.0] * n, [0.0] * n])
          for side, n in (("left", ny), ("right", ny), ("bottom", nx),
                          ("top", nx))} if walls[0] == D else None
    dt = torch.tensor(0.01)
    stage = raster_muscl_step_plain(plan, q, *geo, dt, bc, limiter,
                                    stage=(0.0, 1.0, 1.0))
    rhs = raster_muscl_step_plain(plan, q, *geo, dt, bc, limiter)
    assert torch.equal(stage.out, q)
    assert torch.equal(rhs.out, torch.zeros_like(q))


@pytest.mark.parametrize("mode", ["euler", "ssprk2 qA"])
@pytest.mark.parametrize("limiter", LIMITERS)
def test_stage_is_the_rhs_stepped(limiter, mode):
    plan, q, geo, bc, src, qA = raster(70, 37, RASTERS[0][2], 29)
    dt = torch.tensor(0.02)
    kw = mode_kw(mode, True, src, qA)
    a, b, _ = kw["stage"]
    got = raster_muscl_step_plain(plan, q, *geo, dt, bc, limiter, **kw)
    rhs = raster_muscl_step_plain(plan, q, *geo, dt, bc, limiter, src=src)
    want = b * (q + dt * rhs.out)
    if kw["qA"] is not None:
        want = a * qA + want
    assert float((got.out - want).abs().max()) <= 1e-6 * float(
        want.abs().max())
    assert torch.equal(got.cmax, rhs.cmax)


def tile_maxima(own, tile):
    """The largest value of each tile of own [ny, nx], row-major by tile,
    by a loop over the tiles."""
    ny, nx = own.shape
    bx, by = tile
    return np.array([own[j:j + by, i:i + bx].max()
                     for j in range(0, ny, by) for i in range(0, nx, bx)])


@pytest.mark.parametrize("nx, ny, walls", RASTERS)
def test_tile_maxima_fold_like_the_block_layout(nx, ny, walls):
    """The tile maxima are those of the owned cells' own faces; their K1c
    fold gives the Courant number of the former 32 x 8 blocks over the
    face rows, at an index whose tile holds the same cell."""
    plan, q, geo, bc, src, _ = raster(nx, ny, walls, 5 + nx)
    dt = torch.tensor(0.002)
    tile = TILE
    got = raster_muscl_step_plain(plan, q, *geo, dt, bc, "minmod")
    own = raster_muscl_faces_plain(plan, q, bc, "minmod")[2]
    assert own.shape == (ny, nx) and bool((own > 0).any())
    assert got.cmax.shape == (num_blocks(nx, ny, tile),)
    np.testing.assert_array_equal(got.cmax.numpy(),
                                  tile_maxima(own.numpy(), tile))
    old = block_max(own, nx, ny, (32, 8))
    run = (torch.tensor(0.0), torch.tensor(-1, dtype=torch.int32))
    m_new, i_new = courant_argmax_plain(got.cmax, dt, *run)
    run_old = (torch.tensor(0.0), torch.tensor(-1, dtype=torch.int32))
    m_old, i_old = courant_argmax_plain(old, dt, *run_old)
    assert torch.equal(m_new, m_old) and torch.equal(run[0], run_old[0])
    cell = int(torch.argmax(own))  # the first cell of the largest value
    cj, ci = divmod(cell, nx)
    for idx, (bx, by) in ((int(i_new), tile), (int(i_old), (32, 8))):
        gx = -(-nx // bx)
        assert (idx // gx, idx % gx) == (cj // by, ci // bx)


def strips_of(ny, P):
    """P strips of the ny rows with 3 halo rows off the walls, each of
    ceil(ny / P) rows but the last, which is ragged."""
    rows = -(-ny // P)
    out = []
    for p in range(P):
        r0 = p * rows
        n = min(rows, ny - r0)
        out.append(Strip(r0, n, 3 if p else 0, 3 if p < P - 1 else 0))
    return out


@pytest.mark.parametrize("mode", ["ssprk2 qA", "rhs"])
@pytest.mark.parametrize("limiter", LIMITERS)
@pytest.mark.parametrize("P", [2, 3])
def test_strips_reproduce_the_whole_raster(P, limiter, mode):
    nx, ny = 70, 43
    plan, q, geo, bc, src, qA = raster(nx, ny, (D, CO, D, R), 11 + P)
    dt = torch.tensor(0.02)
    kw = mode_kw(mode, True, src, qA)
    whole = raster_muscl_step_plain(plan, q, *geo, dt, bc, limiter, **kw)
    fx, fy, _ = raster_muscl_faces_plain(plan, q, bc, limiter)
    strips = strips_of(ny, P)
    assert strips[-1].rows % TILE[1] and strips[-1].rows < strips[0].rows
    bufs = split_rows(q, strips, [CPU] * P, nx)
    bufs_A = split_rows(kw["qA"], strips, [CPU] * P, nx) if kw["qA"] \
        is not None else [None] * P
    cms = []
    for s, b, bA in zip(strips, bufs, bufs_A):
        rows = slice(s.row0, s.row0 + s.rows)
        bcs = strip_wall_values(bc, s, ny, CPU)
        got = swe_raster_muscl_step(
            plan, b, *(g[rows] for g in geo), dt, bcs, limiter, s,
            **dict(kw, src=src[rows], qA=bA))
        assert torch.equal(s.owned(got.out),
                           whole.out.reshape(3, ny, nx)[:, rows])
        if whole.prim is not None:
            assert torch.equal(got.prim.reshape(3, -1, nx),
                               whole.prim.reshape(3, ny, nx)[:, rows])
        assert got.cmax.shape == (num_blocks(nx, s.rows, TILE),)
        sfx, sfy, _ = raster_muscl_faces_plain(plan, b, bcs, limiter, s)
        f0 = s.row0 - int(s.halo_lo > 0)  # the first face row
        assert torch.equal(sfx, fx[:, f0:f0 + sfx.shape[1]])
        assert torch.equal(sfy, fy[:, f0:f0 + sfy.shape[1]])
        cms.append(got.cmax.max())
    assert torch.equal(torch.stack(cms).max(), whole.cmax.max())


@pytest.mark.parametrize("dt", [0.0, -1.0])
def test_nonpositive_dt_divides_by_one(dt):
    plan, q, geo, bc, src, _ = raster(70, 37, RASTERS[0][2], 3)
    t = torch.tensor(dt)
    got = raster_muscl_step_plain(plan, q, *geo, t, bc, "minmod", src=src)
    fx, fy, _ = raster_muscl_faces_plain(plan, q, bc, "minmod")
    s = donor_factors(plan, q, fx, fy, t)
    assert bool(torch.isfinite(got.out).all()) and bool((s <= 1.0).all())
    assert torch.equal(s, donor_factors(plan, q, fx, fy, torch.tensor(1.0)))


def test_wrapper_refuses_strips_without_their_halo():
    plan, q, geo, bc, src, _ = raster(70, 45, (D, CO, D, R), 2)
    s = strips_of(45, 3)[1]
    b = split_rows(q, [s], [CPU], 70)[0]
    rows = slice(s.row0, s.row0 + s.rows)
    for bad in (s._replace(halo_lo=1), s._replace(halo_hi=0)):
        with pytest.raises(ValueError, match="halo rows >= 3"):
            swe_raster_muscl_step(plan, b, *(g[rows] for g in geo),
                                  torch.tensor(0.01), None, "minmod", bad)
