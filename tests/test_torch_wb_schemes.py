"""Hydrostatic reconstruction through the port's `Simulation` under
ssprk3 (stage mode, three K1a and K1b HR launches a step) and rk4 (`apply`
four times a step, on a 16-step deck) against the JAX package, on the CPU
in float64: the dam break over a bumpy bed of
tests/test_torch_wb_simulation.py, to 1e-10 in the final state, the
accumulators and the Courant number (`check_runs_agree`).
"""

import pytest

from test_torch_wb_simulation import check_runs_agree


@pytest.mark.parametrize("scheme, stop", [("ssprk3", 0.0625),
                                          ("rk4", 0.015625)])
def test_hr_schemes_match_jax(tmp_path, scheme, stop):
    check_runs_agree(tmp_path, wb="hydrostatic_reconstruction",
                     scheme=scheme, stop=stop)
