"""The second-order raster stepper under rk4 with van Leer (K2 MUSCL in
rhs mode, four launch pairs a step, the Courant number from k1) against
the JAX package's `make_fused_structured_stepper(second_order=True,
limiter="van_leer")` in interpret mode, on the CPU, in float32: the
random wet/dry raster of tests/test_torch_muscl_raster.py with a
reflecting left wall, a Dirichlet right and bottom wall and a critical-
outflow top, no rain. The same tolerances: the state to 2e-6 absolute,
the float32 time bitwise, the Courant number to 1e-6; and the positivity
limiter acted. One JAX compile (rk4 lowers four kernel call sites) for
the file.
"""

import pytest

from test_torch_muscl_raster import (
    CO,
    D,
    R,
    check_against_jax,
    check_limiter_acted,
    run_both,
)


@pytest.fixture(scope="module")
def rk4_runs():
    return run_both("rk4", "van_leer", (R, D, D, CO), False, 6)


def test_fused_muscl_rk4_matches_jax(rk4_runs):
    check_against_jax(rk4_runs)


def test_positivity_limiter_acts_under_rk4(rk4_runs):
    check_limiter_acted(rk4_runs)
