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
    """This package's OperatorArrays from the flow fields of `d` on
    `device` ("cpu" or CUDA) in `dtype`; fields of `d` that the first-order
    flow path does not use (the Pallas plan, MUSCL, BS2002 and HR arrays,
    None values) are ignored."""
    flow = {k: v for k, v in d.items() if k in ARRAY_FIELDS}
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
