"""K5 `swe_eta_vertex`: the BS2002 free-surface elevation at every vertex.

`swe_eta_vertex` launches csrc/swe_eta_vertex.cu for CUDA tensors and
takes the plain PyTorch version (`ops/swe/bs2002.py` `eta_vertices`) for
CPU tensors. The kernel replaces the TPU kernels `_route_kernel` and
`_accum_kernel` (rdycore_tpu/ops/pallas/routed.py) as the JAX package's
`eta_slotted` chains them; see the source's header for its bound and
design. One wrapper call is two device launches, the cell phase (each
cell's eta into a scratch array the wrapper allocates) and the vertex
phase; `launches` counts wrapper calls. K1a reads the result at each
edge's endpoints.
"""

from __future__ import annotations

import ctypes

import torch

from ..swe.bs2002 import BS2002Arrays, eta_vertices
from . import build

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _argtypes(real):
    return [_P, _INT, _P, _I64, _P, _P, _P, _P, _I64, real, _P, _P, _P]


_FUNCTIONS = {
    "rdy_swe_eta_vertex_f32": _argtypes(ctypes.c_float),
    "rdy_swe_eta_vertex_f64": _argtypes(ctypes.c_double),
}


def swe_eta_vertex(bs: BS2002Arrays, h: torch.Tensor,
                   tiny_h: float) -> torch.Tensor:
    """eta_v [NV] of the cell depths h [C] (a row of the state; any
    contiguous tensor) on the BS2002 arrays `bs`."""
    if h.device.type == "cpu":
        return eta_vertices(bs, h, tiny_h)
    dev, dt = h.device, h.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"swe_eta_vertex: unsupported dtype {dt}")
    (C,) = h.shape
    NV, K = bs.vertex_cells.shape
    ck = build.check
    ck(h, "h", dt, (C,), dev)
    ck(bs.vertex_cells, "vertex_cells", torch.int32, (NV, K), dev)
    ck(bs.vertex_inv_count, "vertex_inv_count", dt, (NV,), dev)
    for name in ("z1", "z2", "z3"):
        ck(getattr(bs, name), name, dt, (C,), dev)
    eta_c = torch.empty((C,), dtype=dt, device=dev)
    eta_v = torch.empty((NV,), dtype=dt, device=dev)
    lib = build.load("swe_eta_vertex", _FUNCTIONS)
    fn = (lib.rdy_swe_eta_vertex_f32 if dt == torch.float32
          else lib.rdy_swe_eta_vertex_f64)
    with torch.cuda.device(dev):
        status = fn(
            bs.vertex_cells.data_ptr(), K, bs.vertex_inv_count.data_ptr(), NV,
            bs.z1.data_ptr(), bs.z2.data_ptr(), bs.z3.data_ptr(),
            h.data_ptr(), C, tiny_h, eta_c.data_ptr(), eta_v.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check_status(status, "swe_eta_vertex")
    swe_eta_vertex.launches += 1
    return eta_v


swe_eta_vertex.launches = 0
