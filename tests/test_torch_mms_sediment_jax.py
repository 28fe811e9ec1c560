"""An MMS level with two sediment classes (Hairsine-Rose erosion and
deposition in the manufactured sources) through rdycore_tpu_torch against
the JAX package's, on the CPU, in f64: the norms of every component to
1e-10 relative, under Roe and upwind-Roe tracer fluxes (the cases of
tests/test_torch_mms_levels_jax.py).
"""

import pytest

import test_torch_mms_levels_jax as levels


@pytest.mark.parametrize("case", ["sediment_roe", "sediment_upwind_roe"])
def test_sediment_level_norms_match_jax(case):
    levels.level_norms_match_jax(case)
