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

`power(x, e)` is torch.pow(x, e) whose bits do not depend on where an
element sits in the tensor: on the CPU, the elements that torch's loop
leaves past its last full vector take its scalar path, whose pow differs
from the vector path's by an ulp (in about 1% of float64 elements on
AVX512), so a shard's root of a cell (a tail of its shorter tensor) could
differ from the whole operator's. `power` pads the flat tensor to whole
vectors and takes it in pieces below torch's grain size (one thread, no
tail inside); on CUDA it is torch.pow.

`maximum0`, `minimum0` and `clip01` are max(x, 0), min(x, 0) and
clip(x, 0, 1) with the bits of `torch.clamp`, but with the JAX package's
tangent at a tie (half the tangent where x sits on the bound;
`torch.clamp` passes all of it), so that forward-mode AD through the
plain operator agrees with `jax.jvp` of the XLA operator at dry cells
(h == 0 exactly).
"""

from __future__ import annotations

import torch


# whole vectors of torch's CPU loop (2 vectors of 8 doubles or 16 floats
# under AVX512, unrolled) and its grain size (a loop below it takes one
# thread)
_WHOLE_VECTORS = 64
_GRAIN = 32768


def power(x: torch.Tensor, e: float) -> torch.Tensor:
    """x ** e, each element's bits independent of its place in x."""
    if x.device.type != "cpu":
        return torch.pow(x, e)
    flat = x.reshape(-1)
    n = flat.numel()
    pad = -n % _WHOLE_VECTORS
    if pad:
        flat = torch.cat([flat, flat.new_ones(pad)])
    pieces = [torch.pow(piece, e) for piece in flat.split(_GRAIN)]
    if not pad and len(pieces) == 1:
        return pieces[0].reshape(x.shape)
    # a tensor of its own, not a view (a custom Function returns it)
    return torch.cat(pieces)[:n].reshape(x.shape).clone()


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of a non-negative tensor. torch has no cbrt, so this is
    pow(x, 1/3) (`power`: an element's root does not depend on where it
    sits, so row strips and shards reproduce the whole bit for bit); the
    CUDA kernels call cbrt(). The two differ by an ulp at most, inside
    every tolerance the tests state."""
    return power(x, 1.0 / 3.0)


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
