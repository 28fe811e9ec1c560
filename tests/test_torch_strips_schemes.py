"""The row-strip raster stepper under ssprk2 and ssprk3 (K2 in stage mode
with qA, over strips), on the CPU, in float32: ssprk2 in 4 strips against
the JAX package's sharded stepper in interpret mode, ssprk3 in 2 and 8 strips
against the port's single strip. The deck, the feeding of both
packages through `convert` and the tolerances are those of
tests/test_torch_strips_euler.py (2e-6 absolute on the state against the
JAX package, as the single-device raster tests; bit for bit against the
single strip). rk4 is in tests/test_torch_strips_rk4.py (one JAX compile
per file).
"""

import pytest

from test_torch_strips_euler import (
    assert_bitwise,
    assert_matches_jax,
    run_jax,
    run_port,
    strip_raster,
)


def test_ssprk2_strips_match_jax_and_the_single_strip():
    q, geo, bcv, src = strip_raster(12)
    res, out = run_port(q, geo, bcv, src, 4, "ssprk2")
    assert_matches_jax(run_jax(q, geo, bcv, src, 4, "ssprk2"), out, res)
    one, _ = run_port(q, geo, bcv, src, 1, "ssprk2")
    assert_bitwise(one, res)


@pytest.mark.parametrize("P", [2, 8])
def test_ssprk3_strips_match_the_single_strip(P):
    q, geo, bcv, src = strip_raster(13)
    res, _ = run_port(q, geo, bcv, src, P, "ssprk3")
    one, _ = run_port(q, geo, bcv, src, 1, "ssprk3")
    assert_bitwise(one, res)
