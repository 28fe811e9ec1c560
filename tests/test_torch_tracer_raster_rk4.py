"""The tracer raster deck of tests/test_torch_tracer_raster.py (two
sediment classes and salinity, upwind-Roe tracer fluxes) under rk4 in both
packages, on the CPU: the fused kind (K2's nt mode in rhs mode, four
raster steps a step, the Courant number from k1) to the same steps, dt
sequence and float32 time, the state to 2e-6 and the accumulators to
1e-5, and every tracer check of the euler deck. The pair of runs is made
once, in a module fixture, so the JAX package compiles its rk4 tracer
raster stepper once for all the tests here. The flow-only rk4 deck is in
tests/test_torch_raster_rk4.py.
"""

import numpy as np
import pytest

from test_torch_raster_simulation import assert_runs_agree
from test_torch_tracer_raster import (
    check_accumulators,
    check_courant,
    check_steps_and_state,
    tracer_runs,
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tracer_runs(tmp_path_factory.mktemp("rk4"), "rk4")


def test_tracer_run_matches_jax(runs):
    (js, ts), (jlog, tlog), _ = runs
    assert ts._structured["kind"] == "fused"
    assert_runs_agree(js, ts, jlog, tlog, 2e-6, 1e-5)
    assert np.abs(ts.bflux_accum).max() > 0.0


def test_tracer_steps_and_state_match(runs):
    check_steps_and_state(runs)


def test_tracer_accumulators_match(runs):
    check_accumulators(runs)


def test_tracer_courant_matches(runs):
    check_courant(runs)
