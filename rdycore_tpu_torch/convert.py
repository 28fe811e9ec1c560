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
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .operator import ARRAY_FIELDS, OperatorArrays, arrays_from_numpy
from .ops.structured import StructuredArrays


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
