"""Small math helpers (the reference's rdymathimpl.h analogue).

The JAX package wraps sqrt and cbrt in custom JVPs for its implicit
integrator. This package differentiates nothing yet, so square roots are
plain torch.sqrt and the cube root of the critical-outflow ghost state is
the plain function below.
"""

from __future__ import annotations

import torch


def safe_cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of a non-negative tensor. torch has no cbrt, so this is
    pow(x, 1/3); the CUDA kernels call cbrt(). The two differ by an ulp at
    most, inside every tolerance the tests state. A float32 tensor takes
    the root in float64, rounded back: on the CPU, torch.pow's vector path
    and its scalar path (which takes the elements a vector does not fill)
    differ by an ulp in float32, so the root of an element would otherwise
    depend on the tensor's length, and a raster cut into row strips would
    not reproduce the whole raster bit for bit."""
    if x.dtype == torch.float32:
        return torch.pow(x.double(), 1.0 / 3.0).to(x.dtype)
    return torch.pow(x, 1.0 / 3.0)
