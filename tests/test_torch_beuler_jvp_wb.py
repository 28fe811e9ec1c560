"""The JVPs of backward Euler through the port's linearization twin
against `jax.jvp` of the JAX package's XLA operator (as
tests/test_torch_beuler_jvp.py, whose helpers and tangents these are), for
MUSCL (minmod, with the positivity limiter at the step's dt: K3a's
gradients, K3b's drain and scale), hydrostatic reconstruction and BS2002
(its vertex eta), on the CPU, in f64, to 1e-12. A file of its own: each
JAX operator's JVP costs seconds of compile."""

import pytest

from test_torch_beuler_jvp import check_jvp, jax_jvps

CASES = {
    "muscl": (dict(second_order=True, limiter="minmod",
                   positivity_limit=True), "front"),
    "hr": (dict(well_balancing_hr=True), "flow"),
    "bs2002": (dict(well_balancing_bs2002=True), "flow"),
}


@pytest.fixture(scope="module")
def reference():
    return jax_jvps(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_jvp_matches_jax(reference, case):
    check_jvp(*reference, case)
