"""Small math helpers (the reference's rdymathimpl.h analogue).

The implicit integrator (`timestepping.newton_beuler_solve`) takes exact
Jacobian-vector products of the operator's plain PyTorch form by
forward-mode AD (`torch.func.jvp`). The SWE right-hand side takes square
and cube roots at 0 (dry cells, zero momentum), where the derivative is
infinite and a tangent would turn NaN. `safe_sqrt` and `safe_cbrt` are
`torch.autograd.Function`s whose forward-mode tangent is the one-sided
subgradient 0 at x == 0, as the JAX package's custom JVPs give
(rdycore_tpu/ops/math.py). Their primal is unchanged: `torch.sqrt`, and
`cbrt` below. They stand exactly where the JAX package calls its own;
elsewhere the port keeps `torch.sqrt` and `cbrt`.

`maximum0`, `minimum0` and `clip01` are max(x, 0), min(x, 0) and
clip(x, 0, 1) with the bits of `torch.clamp`, but with the JAX package's
tangent at a tie (half the tangent where x sits on the bound;
`torch.clamp` passes all of it), so that forward-mode AD through the
plain operator agrees with `jax.jvp` of the XLA operator at dry cells
(h == 0 exactly).
"""

from __future__ import annotations

import torch


def cbrt(x: torch.Tensor) -> torch.Tensor:
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


class _SafeSqrt(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return torch.sqrt(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0], output)

    @staticmethod
    def jvp(ctx, x_t):
        x, y = ctx.saved_tensors
        pos = x > 0
        return torch.where(pos, 0.5 / torch.where(pos, y, 1.0), 0.0) * x_t


class _SafeCbrt(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return cbrt(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(output)

    @staticmethod
    def jvp(ctx, x_t):
        (y,) = ctx.saved_tensors
        y2 = y * y
        pos = y2 > 0
        return torch.where(pos, (1.0 / 3.0) / torch.where(pos, y2, 1.0),
                           0.0) * x_t


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """torch.sqrt(x), whose forward-mode tangent is 0 where x == 0."""
    return _SafeSqrt.apply(x)


def safe_cbrt(x: torch.Tensor) -> torch.Tensor:
    """`cbrt(x)`, whose forward-mode tangent is 0 where x == 0."""
    return _SafeCbrt.apply(x)


def maximum0(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0), half the tangent where x == 0."""
    return torch.maximum(x, x.new_zeros(()))


def minimum0(x: torch.Tensor) -> torch.Tensor:
    """min(x, 0), half the tangent where x == 0."""
    return torch.minimum(x, x.new_zeros(()))


def clip01(x: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, 1), half the tangent where x == 0 or x == 1."""
    return torch.minimum(maximum0(x), x.new_ones(()))
