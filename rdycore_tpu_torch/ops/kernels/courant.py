"""K1c `courant_argmax`: max of the per-edge Courant coefficients and the
lowest edge index attaining it, optionally folded into a running maximum.

`courant_argmax` launches csrc/courant_argmax.cu for CUDA tensors and takes
the plain PyTorch version `courant_argmax_plain` for CPU tensors. The
kernel replaces the o_cmax/o_cidx fold of the TPU kernel
`_fused_step_kernel` (rdycore_tpu/ops/pallas/slotted.py); see the source's
header for its bound and design.

With `dt`, `run_max` and `run_idx` given, the step Courant number max * dt
is folded into the running interval maximum in place, exactly as the XLA
interval loop does it (`bigger = step_courant > cmax`), so the step loop
never reads the maximum back to the host.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import build

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = [_P, _I64, _P, _INT, _P, _P, _P, _P, _P, _P]
_FUNCTIONS = {
    "rdy_courant_argmax_f32": _ARGTYPES,
    "rdy_courant_argmax_f64": _ARGTYPES,
    "rdy_courant_argmax_blocks_per_sm": [],
    "rdy_courant_argmax_work_bytes": [_INT],
}
# (device index, stream) -> (workspace, its capacity in blocks): the
# kernel's ticket and per-block pairs, allocated zero once and left at zero
# by every launch. A stream runs its launches in order, so they may share
# one; launches on two streams at once may not (csrc/courant_argmax.cu).
_WORKSPACES: Dict[Tuple[int, int], Tuple[torch.Tensor, int]] = {}


def _workspace(lib, dev: torch.device, stream: int):
    key = (dev.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        max_blocks = lib.rdy_courant_argmax_blocks_per_sm() * sms
        nbytes = lib.rdy_courant_argmax_work_bytes(max_blocks)
        ws = _WORKSPACES[key] = (
            torch.zeros((nbytes,), dtype=torch.uint8, device=dev), max_blocks)
    return ws


def courant_argmax_plain(
    courant: torch.Tensor,
    dt: Optional[torch.Tensor] = None,
    run_max: Optional[torch.Tensor] = None,
    run_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel (operator.py:605-608 and the interval
    loop's fold, timestepping.py:351-354). torch.argmax, like jnp.argmax,
    returns the first index of the maximum."""
    m = courant.max()
    i = torch.argmax(courant).to(torch.int32)
    if run_max is not None:
        step = m * dt
        bigger = step > run_max
        run_idx.copy_(torch.where(bigger, i, run_idx))
        run_max.copy_(torch.where(bigger, step, run_max))
    return m, i


def courant_argmax(
    courant: torch.Tensor,
    dt: Optional[torch.Tensor] = None,
    run_max: Optional[torch.Tensor] = None,
    run_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max, int32 index of its first occurrence) of courant [E], as 0-dim
    tensors on its device. Given dt, run_max (0-dim, courant's dtype) and
    run_idx (0-dim int32), also fold max * dt into them in place."""
    fold = (dt, run_max, run_idx)
    if any(x is None for x in fold) and any(x is not None for x in fold):
        raise ValueError("courant_argmax: give all of dt, run_max, run_idx")
    if courant.device.type == "cpu":
        return courant_argmax_plain(courant, dt, run_max, run_idx)
    dev, dtype = courant.device, courant.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"courant_argmax: unsupported dtype {dtype}")
    ck = build.check
    ck(courant, "courant", dtype, (None,), dev)
    n = courant.shape[0]
    if n == 0:
        raise ValueError("courant_argmax: no edges")
    if n >= 2**31:
        raise ValueError(f"courant_argmax: {n} values (int32 indices)")
    if run_max is not None:
        ck(dt, "dt", dtype, (), dev)
        ck(run_max, "run_max", dtype, (), dev)
        ck(run_idx, "run_idx", torch.int32, (), dev)

    lib = build.load("courant_argmax", _FUNCTIONS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    work, max_blocks = _workspace(lib, dev, stream)
    out_max = torch.empty((), dtype=dtype, device=dev)
    out_idx = torch.empty((), dtype=torch.int32, device=dev)
    fn = (lib.rdy_courant_argmax_f32 if dtype == torch.float32
          else lib.rdy_courant_argmax_f64)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        status = fn(
            courant.data_ptr(), n, work.data_ptr(), max_blocks,
            out_max.data_ptr(), out_idx.data_ptr(), ptr(dt), ptr(run_max),
            ptr(run_idx), stream,
        )
    build.check_status(status, "courant_argmax")
    courant_argmax.launches += 1
    return out_max, out_idx


courant_argmax.launches = 0
