"""Build the port's native mesh library at first use.

`library()` compiles mesh/csrc/mesh_builder.cpp with $CXX (else g++) and
the flags below into a shared library in `build/rdycore_tpu_torch/`
beside the package, named by a hash of the source, the compiler (its name
and version), the machine and the flags, and returns its path; a library
of that name is used as it is. Nothing is built when this module is imported. The build writes a
temporary file and renames it, so processes that build at once do not
see each other's partial output. `-ffp-contract=off` keeps a*b - c*d two
roundings, which makes `rdy_cell_geometry` the numpy geometry's bitwise
twin; there is no `-march=native`, so the library computes alike on every
x86-64 host, and no `-fopenmp` (the JAX package's build has it for entry
points this copy leaves out; a compiler without libgomp refuses it). A compiler that is missing or fails raises NativeBuildError
with its message: nothing falls back to another implementation.

    python -m rdycore_tpu_torch.mesh.build

prints the path of the library it built.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shlex
import subprocess
import sys

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "csrc", "mesh_builder.cpp")
ROOT = os.path.dirname(os.path.dirname(_DIR))  # holds the package
BUILD_DIR = os.path.join(ROOT, "build", "rdycore_tpu_torch")
FLAGS = ("-O3", "-ffp-contract=off", "-fPIC", "-std=c++17", "-shared")


class NativeBuildError(RuntimeError):
    """The native mesh library could not be built or loaded."""


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def compiler_version(cxx: str) -> str:
    """The first line of `cxx --version`, or "" where it gives none."""
    try:
        r = subprocess.run([cxx, "--version"], capture_output=True,
                           text=True, timeout=60)
    except OSError:
        return ""
    return (r.stdout.splitlines() or [""])[0]


def library() -> str:
    """The path of the native mesh library, built if it is not."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    cxx = compiler()
    h = hashlib.sha256(src)
    for part in (cxx, compiler_version(cxx), platform.machine(), *FLAGS):
        h.update(b"\0" + part.encode())
    out = os.path.join(BUILD_DIR, f"librdymesh_torch-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cxx, *FLAGS, "-o", tmp, SOURCE]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except OSError as e:
        raise NativeBuildError(
            f"native mesh library: cannot run the compiler: {shlex.join(cmd)}"
            f"\n{e}") from e
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise NativeBuildError(
            f"native mesh library: the build failed (exit {r.returncode}):\n"
            f"{shlex.join(cmd)}\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(library())
    sys.exit(0)
