"""The MMS building blocks of rdycore_tpu_torch against the JAX package's,
on the CPU, in f64, on the same inputs made with numpy from a seed.

- every function and operator of the expression grammar: the port's torch
  backend against `rdycore_tpu.config.expressions` (jnp), to 1e-15
  relative to the largest value;
- `refine_uniform`: equal to the JAX package's array for array (points,
  cells, geometry, edges, regions and boundaries) on quad, triangle and
  mixed meshes with regions, 1 and 2 levels;
(tests/test_torch_mms_interval_jax.py holds the forced advancer,
tests/test_torch_mms_levels_jax.py an MMS level's norms and the rates of a
ladder against the JAX package's.)
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdycore_tpu.config.expressions import compile_expression as jax_compile
from rdycore_tpu.mesh import build_mesh as jax_build_mesh
from rdycore_tpu.mesh import generate as jax_generate
from rdycore_tpu_torch.config.expressions import compile_expression
from rdycore_tpu_torch.mesh import build_mesh
from rdycore_tpu_torch.mesh import generate

CONSTS = {"K": 1.7, "C0": -0.3}
# (expression, domain of x and y): every function of the grammar, every
# binary and unary operator, each comparison in an if ... else, '^',
# the named constants
EXPRESSIONS = [
    ("sin(K*x) + cos(y) * tan(0.3*x)", (-2, 2)),
    ("asin(x) + acos(y) + atan(x*y)", (-0.99, 0.99)),
    ("atan2(y, x) + hypot(x, y)", (-2, 2)),
    ("sinh(x) - cosh(y) + tanh(K*x)", (-2, 2)),
    ("exp(C0*x) * log(y) + log2(x) - log10(y) + ln(x*y)", (0.1, 3)),
    ("sqrt(x) + cbrt(y - 1.5)", (0.1, 3)),
    ("abs(x) + sign(y) + min(x, y) - max(x, 0.2)", (-2, 2)),
    ("floor(3*x) + ceil(2*y) + pow(x, 2.5) + pow(2, y)", (0.1, 3)),
    ("x % 0.7 + (-y) % 1.3 + 5 % (x + 3)", (-2, 2)),
    ("x^3 - y**2 / (1 + x*x) + -x + +y", (-2, 2)),
    ("x if x < y else y", (-2, 2)),
    ("1 if x <= 0 else 2*y", (-2, 2)),
    ("x*t if y > 0.5 else -t", (-2, 2)),
    ("sin(x) if y >= 0 else 0", (-2, 2)),
    ("1 if floor(x) == 0 else 0", (-2, 2)),
    ("x if floor(y) != 1 else 3", (-2, 2)),
    ("pi*x + e*y + _pi + _e*t", (-2, 2)),
    ("K*exp(-t/2) + C0", (-2, 2)),
    ("3.5", (-2, 2)),
]


@pytest.mark.parametrize("expr, dom", EXPRESSIONS,
                         ids=[e for e, _ in EXPRESSIONS])
def test_expression_grammar_matches_jax(expr, dom):
    rng = np.random.default_rng(5)
    x = rng.uniform(*dom, 300)
    y = rng.uniform(*dom, 300)
    t = 0.37
    want = np.broadcast_to(np.asarray(jax_compile(expr, CONSTS)(
        jnp.asarray(x), jnp.asarray(y), t), np.float64), x.shape)
    got = compile_expression(expr, CONSTS, backend="torch")(
        torch.as_tensor(x), torch.as_tensor(y),
        torch.tensor(t, dtype=torch.float64))
    got = np.broadcast_to(np.asarray(got, np.float64), x.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= 1e-15 * scale


def mixed_mesh(build, gen):
    """A quad mesh with every third quad split in two triangles, regions
    (one empty) and the quad mesh's named boundaries."""
    m = gen.structured_quad(5, 4, 0.0, 5.0, 0.0, 4.0,
                            z_fn=lambda x, y: 0.1 * x + 0.05 * y * y,
                            region_fn=lambda cx, cy: (cx > 2).astype(int))
    cells = []
    for c, v in enumerate(m.cell_vertices):
        if c % 3 == 0:
            cells += [[v[0], v[1], v[2], -1], [v[0], v[2], v[3], -1]]
        else:
            cells.append(list(v))
    cells = np.asarray(cells, np.int32)
    C = len(cells)
    return build(m.points, cells,
                 regions={"a": np.arange(0, C, 2, dtype=np.int32),
                          "empty": np.zeros(0, np.int32)},
                 boundary_edges={n: m.edge_vertices[e]
                                 for n, e in m.boundaries.items()})


MESHES = {
    "quad": lambda b, g: g.structured_quad(
        4, 3, 0.0, 4.0, 0.0, 3.0,
        region_fn=lambda cx, cy: (cy > 1).astype(int)),
    "tri": lambda b, g: g.structured_tri(4, 3, z_fn=lambda x, y: x * y),
    "mixed": mixed_mesh,
}


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("kind", list(MESHES))
def test_refine_uniform_matches_jax(kind, levels):
    want = jax_generate.refine_uniform(
        MESHES[kind](jax_build_mesh, jax_generate), levels)
    got = generate.refine_uniform(MESHES[kind](build_mesh, generate), levels)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, dict):
            assert a.keys() == b.keys(), f.name
            for k in a:
                assert np.array_equal(a[k], b[k]), (f.name, k)
                assert a[k].dtype == b[k].dtype, (f.name, k)
        else:
            assert np.array_equal(a, b), f.name
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
