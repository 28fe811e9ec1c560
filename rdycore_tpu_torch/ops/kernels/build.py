"""Build and load the CUDA kernels of this package.

Each source `csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into a
shared library with a plain C interface, loaded with ctypes. Libraries go
to `build/rdycore_tpu_torch/` beside the package, named by a hash of their
sources and flags, so an edited source builds anew and an unchanged one is
reused. Nothing is built when this module is imported: a wrapper builds
its library at its first launch, and `build_all` builds every library in
parallel (one nvcc per source). A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Tuple

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "build", "rdycore_tpu_torch",
)
SOURCES = ("swe_edge_flux", "swe_cell_stage", "courant_argmax",
           "swe_raster_step", "swe_muscl_grad", "swe_positivity",
           "swe_raster_muscl", "swe_eta_vertex")
# the tracer rows a kernel takes beyond (h, hu, hv): kMaxTracers of
# csrc/swe_physics.cuh, MAX_NUM_SEDIMENT_CLASSES plus salinity and heat
MAX_TRACERS = 7
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the loaded libraries, one per source, for the life of the process
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The nvcc of the CUDA toolkit PyTorch was built against."""
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if not path:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for fn in sorted(os.listdir(_CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(_CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(_BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all(
    names: Iterable[str] = SOURCES, force: bool = False
) -> Dict[str, Tuple[float, str]]:
    """Compile the named libraries that are not built yet (all of them when
    `force`), all nvcc runs started together. Returns, per library built,
    the wall seconds its build took and nvcc's output (with the -Xptxas -v
    report of registers and spills)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    procs = {}
    built = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out) and not force:
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *FLAGS, "-o", tmp,
               os.path.join(_CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out, time.perf_counter())
    failed = []
    for name, (p, tmp, out, t0) in procs.items():
        log, _ = p.communicate()
        built[name] = (time.perf_counter() - t0, log)
        if p.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return built


def load(name: str, functions: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed, with
    `argtypes` set from `functions` (C name -> ctypes types) and every
    function returning the int status of cudaGetLastError()."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build_all([name])
        lib = ctypes.CDLL(path)
        for fn, argtypes in functions.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check_status(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def check(t, name: str, dtype, shape, device) -> None:
    """Raise unless tensor t has the dtype, shape (None = any extent),
    device and C-contiguous layout a kernel takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if len(t.shape) != len(shape) or any(
        s is not None and s != n for s, n in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
