"""Carry the JAX package's operator arrays across to this package.

`operator_arrays_from_numpy` takes a JAX `OperatorArrays` given as numpy
arrays (`{k: np.asarray(v)}`) and returns this package's `OperatorArrays`;
`structured_arrays_from_numpy` does the same for the raster operator's
`StructuredArrays` (dz_dx, dz_dy, mannings_n). Both packages can so be fed
identical geometry, Manning's n and state. They take plain dicts of numpy
arrays, never JAX objects, and so import nothing of JAX.

The JAX arrays carry no per-edge BC code; give `bnd_code` in the dict
(`operator.bnd_codes(segments)` builds it from the segments), or it is
refused.

`strips_from_sharded` and `sharded_from_strips` carry the state of the JAX
package's row-strip sharded raster stepper across: its per-strip padded
planes (`pad_plane_sharded`, structured_step.py:1003-1016) to this
package's strip buffers (ops/strips.py) and back.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .operator import ARRAY_FIELDS, OperatorArrays, arrays_from_numpy
from .ops.kernels.raster_step import Strip
from .ops.strips import strip_layout
from .ops.structured import StructuredArrays

# ghost columns on each side of the JAX package's padded raster planes
# (structured_step.py GC): 128 columns in all, for the TPU's lane tiling
JAX_GHOST_COLS = 64


def operator_arrays_from_numpy(
    d: Dict[str, np.ndarray], device: DeviceLike, dtype: torch.dtype
) -> OperatorArrays:
    """This package's OperatorArrays from the fields of `d` on `device`
    ("cpu" or CUDA) in `dtype`: the first-order flow fields and, when `d`
    has them, the six MUSCL arrays (cell_ls_cx/cy, int_dxl/dyl/dxr/dyr) and
    `bs2002`, the JAX `BS2002Arrays` given as `{k: np.asarray(v)}` of its
    `_asdict()`. The fields this package does not use (the Pallas plan,
    the HR per-slot tables hr_nbr_cell/hr_cn/hr_sn, which K1b derives from
    the edge ids) and None values are ignored."""
    flow = {k: v for k, v in d.items()
            if k in ARRAY_FIELDS + ("bs2002",) and v is not None}
    return arrays_from_numpy(flow, resolve_device(device), dtype)


def structured_arrays_from_numpy(
    d: Dict[str, np.ndarray], device: DeviceLike, dtype: torch.dtype
) -> StructuredArrays:
    """This package's StructuredArrays from the [ny, nx] planes dz_dx,
    dz_dy and mannings_n of `d`, in `dtype` on `device`."""
    device = resolve_device(device)
    return StructuredArrays(**{
        k: torch.as_tensor(np.array(d[k]), dtype=dtype, device=device)
        for k in StructuredArrays._fields
    })


def strips_from_sharded(
    stacks: np.ndarray, gr: int, halo: int, device: DeviceLike,
) -> List[torch.Tensor]:
    """This package's float32 strip buffers [ndof, R * nx] on `device`, one
    per strip, from the JAX package's padded strip planes of each state row
    stacked as stacks [ndof, P, nyl + 2 gr, nx + 2 * 64] (`pad_plane_sharded`
    with gr ghost rows; tracer rows as the JAX stepper's hc stack, moved to
    the front). The owned rows are the planes' interiors; the `halo` rows
    beyond each inner strip boundary are copied from the neighbouring
    strip's interior, as the halo exchange fills them."""
    ndof, P, rows_p, nxp = stacks.shape
    nyl, gc = rows_p - 2 * gr, JAX_GHOST_COLS
    owned = np.asarray(stacks, np.float32)[:, :, gr:gr + nyl, gc:nxp - gc]
    whole = owned.reshape(ndof, P * nyl, -1)
    device = resolve_device(device)
    return [torch.as_tensor(np.ascontiguousarray(
                whole[:, s.row0 - s.halo_lo:s.row0 + s.rows + s.halo_hi]
            ).reshape(ndof, -1), device=device)
            for s in strip_layout(P * nyl, P, halo)]


def sharded_from_strips(
    buffers: Sequence[torch.Tensor], strips: Sequence[Strip], nx: int,
    gr: int,
) -> np.ndarray:
    """The JAX package's padded strip planes [ndof, P, rows + 2 gr, nx + 2 *
    64] of this package's strip buffers (their owned rows; the padding
    zero, as `pad_plane_sharded` leaves it)."""
    gc = JAX_GHOST_COLS
    out = []
    for b, s in zip(buffers, strips):
        x = b.detach().cpu().numpy().reshape(b.shape[0], s.buffer_rows, nx)
        owned = x[:, s.halo_lo:s.halo_lo + s.rows]
        out.append(np.pad(owned.astype(np.float32),
                          ((0, 0), (gr, gr), (gc, gc))))
    return np.stack(out, axis=1)
