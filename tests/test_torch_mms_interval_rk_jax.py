"""The MMS forcing through rdycore_tpu_torch's interval advancer against
the JAX package's, on the CPU, in f64: rk4 and ark_imex, as
tests/test_torch_mms_interval_jax.py holds euler, ssprk2 and ssprk3 (each
JAX scheme compiles for some 3 s).
"""

import pytest

import test_torch_mms_interval_jax as forced


@pytest.mark.parametrize("scheme", ["rk4", "ark_imex"])
def test_forced_interval_matches_jax(scheme):
    forced.forced_interval_matches_jax(scheme)
