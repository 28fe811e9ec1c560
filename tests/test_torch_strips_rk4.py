"""The row-strip raster stepper under rk4 (K2 in rhs mode, the halo
exchange before each of the four stages), on the CPU, in float32: 2
strips against the JAX package's sharded stepper in interpret mode (one
compile of its four rhs-mode call sites), and against the port's single
strip bit for bit. Deck, feeding and tolerances as in
tests/test_torch_strips_euler.py; rk4 with tracers in strips is in
tests/test_torch_strips_tracers.py.
"""

from test_torch_strips_euler import (
    assert_bitwise,
    assert_matches_jax,
    run_jax,
    run_port,
    strip_raster,
)


def test_rk4_strips_match_jax_and_the_single_strip():
    q, geo, bcv, src = strip_raster(14)
    res, out = run_port(q, geo, bcv, src, 2, "rk4")
    assert_matches_jax(run_jax(q, geo, bcv, src, 2, "rk4"), out, res)
    one, _ = run_port(q, geo, bcv, src, 1, "rk4")
    assert_bitwise(one, res)

