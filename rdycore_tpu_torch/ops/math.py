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
    most, inside every tolerance the tests state."""
    return torch.pow(x, 1.0 / 3.0)
