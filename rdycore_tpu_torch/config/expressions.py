"""Safe math-expression compiler: the muparser replacement.

The reference JIT-compiles YAML math expressions (ICs/BCs/materials/MMS
solutions, functions of x, y, t) with muparser (yaml_input.c:1237-1330).
Here we parse with Python's ast module against a whitelist and emit a
closure over numpy: expressions are evaluated on the host, at cell
centroids and boundary-edge midpoints, before values go to the device.

Grammar: numbers, + - * / ** unary-, parentheses, the function set below,
variables x/y/t, and user constants (single capital letters in MMS configs,
arbitrary names allowed here). '^' is accepted as power (muparser syntax).
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, Mapping, Optional

import numpy as np

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
) -> Callable:
    """Compile an expression string to fn(x, y, t) (keyword-callable too).

    Missing trailing variables may be omitted at call time; they default
    to 0.0 (e.g. pure-spatial expressions evaluated without t).
    """
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
        return _eval(tree.body, env)

    fn.expression = expr  # type: ignore[attr-defined]
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


def _eval(node, env):
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        return env[node.id]
    if isinstance(node, ast.BinOp):
        a = _eval(node.left, env)
        b = _eval(node.right, env)
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
        v = _eval(node.operand, env)
        return -v if isinstance(node.op, ast.USub) else +v
    if isinstance(node, ast.Compare):
        a = _eval(node.left, env)
        b = _eval(node.comparators[0], env)
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
        return np.where(
            _eval(node.test, env), _eval(node.body, env), _eval(node.orelse, env)
        )
    if isinstance(node, ast.Call):
        f = _FUNCS[node.func.id]
        return f(*[_eval(a, env) for a in node.args])
    raise ExpressionError(f"unexpected node {type(node).__name__}")
