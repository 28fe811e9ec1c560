"""Build the port's embedded C API and C host programs against it.

`build_shim` compiles capi.c with the host C compiler ($CC, else cc or
gcc) and the flags of `python3-config --embed` (the one beside the running
interpreter, else on PATH) into a shared library in
`build/rdycore_tpu_torch/` beside the package, named by a hash of its
source and flags; `build_host` compiles a C host program (such as the
JAX package's unchanged csrc/test_capi.c) and links it against that
library. Nothing is built when this module is imported. Each build writes
a temporary file and renames it, so processes that build at once do not
see each other's partial output. What embedding lacks here (no C compiler,
no python3-config, no Python.h) raises EmbedUnavailable; a compile that
fails raises RuntimeError.

    python -m rdycore_tpu_torch.capi.build csrc/test_capi.c

prints the path of the host program it built.
"""

from __future__ import annotations

import hashlib
import json
import os
import shlex
import shutil
import subprocess
import sys
from typing import List, Tuple

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "capi.c")
ROOT = os.path.dirname(os.path.dirname(_DIR))  # holds the package
BUILD_DIR = os.path.join(ROOT, "build", "rdycore_tpu_torch")


class EmbedUnavailable(RuntimeError):
    """This machine cannot build an embedded CPython: no C compiler, no
    python3-config or no Python.h."""


def compiler() -> str:
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if not cc:
        raise EmbedUnavailable("no C compiler (cc, gcc or $CC)")
    return cc


def python_config() -> str:
    """The python3-config of the running interpreter's installation."""
    beside = os.path.join(os.path.dirname(sys.executable), "python3-config")
    path = beside if os.path.exists(beside) else shutil.which("python3-config")
    if not path:
        raise EmbedUnavailable("no python3-config")
    return path


def embed_flags() -> Tuple[List[str], List[str]]:
    """(cflags, ldflags) of `python3-config --embed`, with an rpath to each
    library directory; EmbedUnavailable where Python.h is not found."""
    pc = python_config()
    flags = []
    for what in ("--cflags", "--ldflags"):
        r = subprocess.run([pc, "--embed", what], capture_output=True,
                           text=True, timeout=60)
        if r.returncode != 0:
            raise EmbedUnavailable(f"{pc} --embed {what} failed: {r.stderr}")
        flags.append(shlex.split(r.stdout))
    cflags, ldflags = flags
    includes = [f[2:] for f in cflags if f.startswith("-I")]
    if not any(os.path.exists(os.path.join(d, "Python.h")) for d in includes):
        raise EmbedUnavailable(f"no Python.h in {includes} ({pc})")
    ldflags += [f"-Wl,-rpath,{f[2:]}" for f in ldflags if f.startswith("-L")]
    return cflags, ldflags


def _hashed(stem: str, suffix: str, *parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else str(p).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}{suffix}")


def _compile(cmd: List[str], tmp: str, out: str) -> str:
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"C build failed (exit {r.returncode}):\n"
                           f"{shlex.join(cmd)}\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def build_shim() -> str:
    """The path of the shared library of capi.c, built if it is not."""
    cflags, ldflags = embed_flags()
    defines = [f"-DRDYTPU_PYTHON={json.dumps(sys.executable)}",
               f"-DRDYTPU_ROOT={json.dumps(ROOT)}"]
    with open(SOURCE, "rb") as f:
        src = f.read()
    cc = compiler()
    out = _hashed("librdycore_tpu_torch_capi", ".so", src, cc, *cflags,
                  *ldflags, *defines)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    return _compile([cc, "-x", "c", "-O2", "-fPIC", "-shared",
                     f"-Wl,-soname,{os.path.basename(out)}", *defines,
                     "-o", tmp, SOURCE, *cflags, *ldflags], tmp, out)


def build_host(source: str) -> str:
    """The path of the C host program `source` linked against the shim,
    built if it is not."""
    shim = build_shim()
    _, ldflags = embed_flags()
    with open(source, "rb") as f:
        src = f.read()
    stem = os.path.splitext(os.path.basename(source))[0]
    out = _hashed(stem, "", src, shim, *ldflags)
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    return _compile([compiler(), "-x", "c", "-O2", "-o", tmp, source,
                     "-x", "none", shim, f"-Wl,-rpath,{BUILD_DIR}", *ldflags,
                     "-lm"], tmp, out)


if __name__ == "__main__":
    print(build_host(sys.argv[1]))
