"""Safe math-expression compiler: the muparser replacement.

The reference JIT-compiles YAML math expressions (ICs/BCs/materials/MMS
solutions, functions of x, y, t) with muparser (yaml_input.c:1237-1330).
Here we parse with Python's ast module against a whitelist and emit a
closure over one of two function tables, both behind the one parser and
validator:

- "numpy" (the default): evaluated on the host, at cell centroids and
  boundary-edge midpoints, before values go to the device (ICs, BCs,
  materials);
- "torch": evaluated on tensors where they lie, so the MMS driver
  (`mms.py`) evaluates its analytic forcing inside the step loop, on the
  card, at a time that is a 0-d device tensor (the JAX package traces its
  jnp closure into the jitted loop). `if ... else` is `torch.where`, `%`
  keeps Python's floor-mod (`torch.remainder`), cbrt is `ops/math.cbrt`
  with the sign of its argument. A call whose arguments are all numbers
  (a constant subexpression, or t given as a float) is taken by numpy's
  table; a number beside a tensor in a call becomes a 0-d tensor of that
  tensor's dtype on its device (a fill, not a host copy).

In both, an expression of constants alone (e.g. "0") comes back as a
Python number: the caller broadcasts it.

Grammar: numbers, + - * / ** unary-, parentheses, the function set below,
variables x/y/t, and user constants (single capital letters in MMS configs,
arbitrary names allowed here). '^' is accepted as power (muparser syntax).
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..ops.math import cbrt as _cbrt_nonneg

_FUNCS = {
    "sin": np.sin,
    "cos": np.cos,
    "tan": np.tan,
    "asin": np.arcsin,
    "acos": np.arccos,
    "atan": np.arctan,
    "atan2": np.arctan2,
    "sinh": np.sinh,
    "cosh": np.cosh,
    "tanh": np.tanh,
    "exp": np.exp,
    "log": np.log,
    "log2": np.log2,
    "log10": np.log10,
    "ln": np.log,
    "sqrt": np.sqrt,
    "cbrt": np.cbrt,
    "abs": np.abs,
    "sign": np.sign,
    "min": np.minimum,
    "max": np.maximum,
    "floor": np.floor,
    "ceil": np.ceil,
    "pow": np.power,
    "hypot": np.hypot,
}



def _torch_cbrt(x):
    return torch.sign(x) * _cbrt_nonneg(torch.abs(x))


_TORCH_FUNCS = {
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
    "atan2": torch.atan2,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "exp": torch.exp,
    "log": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "ln": torch.log,
    "sqrt": torch.sqrt,
    "cbrt": _torch_cbrt,
    "abs": torch.abs,
    "sign": torch.sign,
    "min": torch.minimum,
    "max": torch.maximum,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "pow": torch.pow,
    "hypot": torch.hypot,
}
BACKENDS = ("numpy", "torch")

_CONSTS = {"pi": np.pi, "e": np.e, "_pi": np.pi, "_e": np.e}

_ALLOWED_BINOPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow, ast.Mod)
_ALLOWED_UNARY = (ast.USub, ast.UAdd)
_ALLOWED_CMP = (ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Eq, ast.NotEq)


class ExpressionError(ValueError):
    pass


def compile_expression(
    expr: str,
    constants: Optional[Mapping[str, float]] = None,
    variables: tuple = ("x", "y", "t"),
    backend: str = "numpy",
) -> Callable:
    """Compile an expression string to fn(x, y, t) (keyword-callable too)
    over the `backend`'s function table ("numpy" or "torch").

    Missing trailing variables may be omitted at call time; they default
    to 0.0 (e.g. pure-spatial expressions evaluated without t).
    `fn.names` is the set of variables the expression reads: one without
    "t" gives the same values at every time.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown expression backend {backend!r} "
                         f"(one of {BACKENDS})")
    constants = dict(constants or {})
    src = expr.replace("^", "**")
    try:
        tree = ast.parse(src, mode="eval")
    except SyntaxError as e:
        raise ExpressionError(f"cannot parse expression '{expr}': {e}") from e

    _validate(tree.body, constants, variables, expr)

    def fn(*args, **kwargs):
        env: Dict[str, object] = dict(_CONSTS)
        env.update(constants)
        for i, name in enumerate(variables):
            if i < len(args):
                env[name] = args[i]
            elif name in kwargs:
                env[name] = kwargs[name]
            else:
                env[name] = 0.0
        ref = None
        if backend == "torch":
            ref = next((env[n] for n in variables
                        if isinstance(env[n], torch.Tensor)), None)
        return _eval(tree.body, env, ref)

    fn.expression = expr  # type: ignore[attr-defined]
    fn.names = frozenset(  # type: ignore[attr-defined]
        n.id for n in ast.walk(tree.body)
        if isinstance(n, ast.Name) and n.id in variables)
    return fn


def _validate(node, constants, variables, expr):
    if isinstance(node, ast.Constant):
        if not isinstance(node.value, (int, float)):
            raise ExpressionError(f"non-numeric literal in '{expr}'")
    elif isinstance(node, ast.BinOp):
        if not isinstance(node.op, _ALLOWED_BINOPS):
            raise ExpressionError(f"operator not allowed in '{expr}'")
        _validate(node.left, constants, variables, expr)
        _validate(node.right, constants, variables, expr)
    elif isinstance(node, ast.UnaryOp):
        if not isinstance(node.op, _ALLOWED_UNARY):
            raise ExpressionError(f"unary operator not allowed in '{expr}'")
        _validate(node.operand, constants, variables, expr)
    elif isinstance(node, ast.Compare):
        if len(node.ops) != 1 or not isinstance(node.ops[0], _ALLOWED_CMP):
            raise ExpressionError(f"comparison not allowed in '{expr}'")
        _validate(node.left, constants, variables, expr)
        _validate(node.comparators[0], constants, variables, expr)
    elif isinstance(node, ast.Call):
        if not isinstance(node.func, ast.Name) or node.func.id not in _FUNCS:
            raise ExpressionError(
                f"unknown function in '{expr}' "
                f"(allowed: {sorted(_FUNCS)})"
            )
        if node.keywords:
            raise ExpressionError(f"keyword args not allowed in '{expr}'")
        for a in node.args:
            _validate(a, constants, variables, expr)
    elif isinstance(node, ast.Name):
        if (
            node.id not in variables
            and node.id not in constants
            and node.id not in _CONSTS
        ):
            raise ExpressionError(
                f"unknown symbol '{node.id}' in '{expr}' "
                f"(variables: {variables}; constants: {sorted(constants)})"
            )
    elif isinstance(node, ast.IfExp):
        _validate(node.test, constants, variables, expr)
        _validate(node.body, constants, variables, expr)
        _validate(node.orelse, constants, variables, expr)
    else:
        raise ExpressionError(
            f"construct {type(node).__name__} not allowed in '{expr}'"
        )


def _as_tensor(v, ref):
    """v, a number made a 0-d tensor of ref's dtype on its device (a fill:
    no copy from the host)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), v, dtype=ref.dtype, device=ref.device)


def _eval(node, env, ref=None):
    """The value of node in env; ref is None over numpy, or a tensor among
    the variables over torch (where numbers beside tensors take its dtype
    and device)."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        return env[node.id]
    if isinstance(node, ast.BinOp):
        a = _eval(node.left, env, ref)
        b = _eval(node.right, env, ref)
        if isinstance(node.op, ast.Add):
            return a + b
        if isinstance(node.op, ast.Sub):
            return a - b
        if isinstance(node.op, ast.Mult):
            return a * b
        if isinstance(node.op, ast.Div):
            return a / b
        if isinstance(node.op, ast.Pow):
            return a**b
        if isinstance(node.op, ast.Mod):
            return a % b
    if isinstance(node, ast.UnaryOp):
        v = _eval(node.operand, env, ref)
        return -v if isinstance(node.op, ast.USub) else +v
    if isinstance(node, ast.Compare):
        a = _eval(node.left, env, ref)
        b = _eval(node.comparators[0], env, ref)
        op = node.ops[0]
        if isinstance(op, ast.Lt):
            return a < b
        if isinstance(op, ast.LtE):
            return a <= b
        if isinstance(op, ast.Gt):
            return a > b
        if isinstance(op, ast.GtE):
            return a >= b
        if isinstance(op, ast.Eq):
            return a == b
        return a != b
    if isinstance(node, ast.IfExp):
        test = _eval(node.test, env, ref)
        if ref is None:
            return np.where(test, _eval(node.body, env, ref),
                            _eval(node.orelse, env, ref))
        if not isinstance(test, torch.Tensor):
            return _eval(node.body if test else node.orelse, env, ref)
        return torch.where(test, _as_tensor(_eval(node.body, env, ref), ref),
                           _as_tensor(_eval(node.orelse, env, ref), ref))
    if isinstance(node, ast.Call):
        args = [_eval(a, env, ref) for a in node.args]
        if ref is None:
            return _FUNCS[node.func.id](*args)
        if not any(isinstance(a, torch.Tensor) for a in args):
            return float(_FUNCS[node.func.id](*args))
        return _TORCH_FUNCS[node.func.id](*[_as_tensor(a, ref) for a in args])
    raise ExpressionError(f"unexpected node {type(node).__name__}")
