"""The `structured` kind (the zero-gather raster operator in plain
PyTorch) of rdycore_tpu_torch's `Simulation` against the JAX package's, on
the CPU in float64: the raster deck of tests/test_torch_raster_simulation.py
on 24x16 cells of 1/16 m, reflecting on the left (the kind refuses
Dirichlet walls and the boundary-flux series), under euler, ssprk2 and rk4.
Both take the same steps and dt sequence, and the state and Courant number
agree to 1e-10 over the run.
"""

import numpy as np
import pytest


from test_torch_raster_simulation import run_both, write_deck


@pytest.mark.parametrize("scheme", ["euler", "ssprk2", "rk4"])
def test_structured_kind_matches_jax(tmp_path, scheme):
    path = write_deck(tmp_path, scheme, "structured", nx=24, dx=0.0625,
                      bflux=0, left="wall")
    (js, ts), (jlog, tlog) = run_both(path)
    assert ts._structured["kind"] == "xla"
    assert ts.step == js.step and tlog == jlog
    qj = np.asarray(js.q)
    assert np.abs(ts.get_solution() - qj).max() <= 1e-10 * np.abs(qj).max()
    assert ts.prev_max_courant == pytest.approx(js.prev_max_courant,
                                                rel=1e-10)
