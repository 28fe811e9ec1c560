"""The row-strip raster stepper with tracers (K2's nt mode in strip mode:
two sediment classes with Hairsine-Rose sources and a third tracer, every
tracer row in the halo exchange), on the CPU, in float32: euler in 4
strips against the JAX package's sharded stepper in interpret mode (its
hc stack fed through the same padded strip planes), every row of the
state to 2e-6 absolute (tracer masses of order 1e-2), the float32 time
bit for bit and the Courant number to 1e-6; and against the port's single
strip bit for bit, also under upwind-Roe and rk4. Deck and feeding as in
tests/test_torch_strips_euler.py.
"""

import pytest

from test_torch_strips_euler import (
    assert_bitwise,
    assert_matches_jax,
    run_jax,
    run_port,
    strip_raster,
)


def test_tracer_strips_match_jax_and_the_single_strip():
    q, geo, bcv, src = strip_raster(16, nt=3)
    res, out = run_port(q, geo, bcv, src, 4, "euler")
    assert_matches_jax(run_jax(q, geo, bcv, src, 4, "euler"), out, res)
    assert float(res.q[3:].abs().max()) > 0.0
    one, _ = run_port(q, geo, bcv, src, 1, "euler")
    assert_bitwise(one, res)


@pytest.mark.parametrize("scheme, riemann, P", [
    ("ssprk2", "upwind_roe", 4), ("ssprk3", "upwind_roe", 4),
    ("rk4", "roe", 2)])
def test_tracer_strips_match_the_single_strip(scheme, riemann, P):
    q, geo, bcv, src = strip_raster(17, nt=3)
    res, _ = run_port(q, geo, bcv, src, P, scheme, riemann=riemann)
    one, _ = run_port(q, geo, bcv, src, 1, scheme, riemann=riemann)
    assert_bitwise(one, res)
