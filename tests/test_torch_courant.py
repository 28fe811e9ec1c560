"""The contracts the CUDA kernels K1c and K2 keep, checked on the CPU.

- K1c `courant_argmax`: its plain version's (max, first index, run fold)
  against jnp.max / jnp.argmax and the JAX interval loop's fold
  (`bigger = step_courant > cmax`) on numpy inputs made from a seed: NaN,
  ties, +-inf, 0.0 against -0.0, one value, odd sizes, f32 and f64. The
  one-launch kernel is held to the plain version on the card
  (tests/test_torch_cuda.py).
- The Courant block layout the raster kernels write and K1c folds: each
  tile's maximum is that of exactly its own cells at ragged sizes, for K2's
  tiles and K2 MUSCL's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
from rdycore_tpu_torch.ops.kernels.raster_muscl import (
    TILE,
    raster_muscl_step_plain,
)
from rdycore_tpu_torch.ops.kernels.raster_step import (
    StructuredPlan,
    block_max,
    num_blocks,
    swe_raster_step_plain,
    tile_for,
)


def courant_values(case, rng):
    if case == "random n=1":
        return rng.uniform(0, 1, 1)
    if case == "random odd n":
        return rng.uniform(0, 1, 1001)
    x = rng.uniform(0, 1, 257)
    if case == "nan":
        x[[17, 200]] = np.nan
    elif case == "ties":
        x[[3, 90, 250]] = 1.5
    elif case == "+inf":
        x[[40, 41]] = np.inf
    elif case == "-inf":
        x[:] = -np.inf
    elif case == "signed zeros":
        x = np.array([-0.0, 0.0, -0.0, 0.0])
    elif case == "zero, then -0":
        x = np.array([0.0, -0.0, -1.0])
    return x


CASES = ["random n=1", "random odd n", "nan", "ties", "+inf", "-inf",
         "signed zeros", "zero, then -0"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", CASES)
def test_courant_argmax_plain_matches_jax(case, dtype):
    rng = np.random.default_rng(CASES.index(case))
    x = courant_values(case, rng).astype(dtype)
    dt, run0, idx0 = dtype(0.5), dtype(0.25), np.int32(-1)

    tdt = torch.as_tensor(x.dtype.type(dt))
    run = (torch.as_tensor(run0), torch.as_tensor(idx0))
    m, i = courant_argmax_plain(torch.as_tensor(x), tdt, *run)

    jm, ji = jnp.max(jnp.asarray(x)), jnp.argmax(jnp.asarray(x))
    step = jm * dt
    bigger = step > run0
    want_run = (np.asarray(jnp.where(bigger, step, run0)),
                np.asarray(jnp.where(bigger, ji.astype(jnp.int32), idx0)))

    assert m.dtype == (torch.float32 if dtype == np.float32 else torch.float64)
    assert i.dtype == torch.int32 and int(i) == int(ji)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(run[0].numpy(), want_run[0])
    assert int(run[1]) == int(want_run[1])


@pytest.mark.parametrize("tile", [tile_for(0), tile_for(3), TILE])
@pytest.mark.parametrize("nx, ny", [(1, 1), (70, 1), (1, 23), (33, 9),
                                    (100, 37), (2048, 1408)])
def test_block_layout_covers_every_cell_once(nx, ny, tile):
    """block_max of distinct values is, for each tile, the largest value
    of exactly the cells the tile owns (row-major by tile), so every cell
    lies in one tile and every tile holds a cell."""
    cell = torch.arange(1, nx * ny + 1, dtype=torch.float64).reshape(ny, nx)
    got = block_max(cell, nx, ny, tile)
    bx, by = tile
    gx = -(-nx // bx)
    assert got.shape == (num_blocks(nx, ny, tile),)
    rows, cols = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    owner = (rows // by) * gx + cols // bx
    want = np.zeros(num_blocks(nx, ny, tile))
    np.maximum.at(want, owner.ravel(), cell.numpy().ravel())
    assert np.all(want > 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.bincount(owner.ravel()).sum() == nx * ny


def test_k2_and_k2_muscl_keep_their_layouts():
    """The plain K2 writes one maximum per 32 x 16 tile flow only and per
    32 x 8 tile with tracers, and K2 MUSCL one per 32 x 16 tile, on a
    ragged raster."""
    nx, ny = 64, 37
    rng = np.random.default_rng(3)
    h = rng.uniform(0.05, 1.0, (ny, nx))
    flow = [h, 0.2 * h, -0.1 * h]
    plan = StructuredPlan(nx, ny, 0.01, 0.02, 1e-7, 1e-3, 1, 2, 1, 1)
    geo = [torch.zeros(ny, nx), torch.zeros(ny, nx), torch.full((ny, nx), 0.02)]
    dt = torch.tensor(0.001)
    assert TILE == (32, 16)
    assert tile_for(0) == (32, 16) and tile_for(3) == (32, 8)
    for rows, tile in ((flow, (32, 16)), (flow + [0.01 * h], (32, 8))):
        q = torch.as_tensor(np.stack(rows).reshape(len(rows), -1),
                            dtype=torch.float32)
        cmax = swe_raster_step_plain(plan, q, *geo, dt).cmax
        assert cmax.shape == (num_blocks(nx, ny, tile),)
        assert float(cmax.max()) > 0.0
    muscl = raster_muscl_step_plain(plan, q[:3], *geo, dt).cmax
    assert muscl.shape == (num_blocks(nx, ny, TILE),) == (2 * 3,)
    assert float(muscl.max()) > 0.0
