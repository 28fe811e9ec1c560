"""The second-order dam break of tests/test_torch_muscl_simulation.py under
ssprk3 (minmod) and rk4 (unlimited slopes) against the JAX package's
`Simulation`, to the same tolerances; then, port only, the deck in float32
(`precision: single`) through the CLI on the CPU, with binary output and
the boundary-flux time series.
"""

import os

import numpy as np
import pytest

from rdycore_tpu_torch.__main__ import main as cli_main

from test_torch_muscl_simulation import check_runs_agree, write_deck


@pytest.mark.parametrize("scheme, limiter", [
    ("ssprk3", "minmod"), ("rk4", "none"),
])
def test_muscl_run_matches_jax(tmp_path, scheme, limiter):
    check_runs_agree(tmp_path, scheme, limiter)


def test_cli_runs_a_single_precision_muscl_deck(tmp_path):
    path = write_deck(tmp_path, "ssprk2", "van_leer", "single", "binary")
    out = os.path.join(tmp_path, "out")
    assert cli_main([path, "--cpu", "--output-dir", out]) == 0
    assert any(f.endswith(".bin") for f in os.listdir(out))
    with open(os.path.join(out, "boundary_fluxes.dat")) as f:
        rows = [line.split() for line in f if not line.startswith("#")]
    assert {r[1] for r in rows} >= {"left", "right"}
    assert all(np.isfinite(float(x)) for r in rows for x in r[2:])
