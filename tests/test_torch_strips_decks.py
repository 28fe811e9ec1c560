"""`Simulation` of rdycore_tpu_torch on row-strip raster decks in 2 and 8
strips, on the CPU: the 128x64 dam break of
tests/test_torch_raster_simulation.py (a Dirichlet inflow on the left,
critical outflow on the right, the boundary-flux time series on) for ten
steps under ssprk3, rk4 with two sediment classes, and MUSCL (minmod, the
positivity limiter) under ssprk2, with `parallel.n_devices` 2 or 8,
against the same deck as one strip: steps, t, the Courant number, q and
every accumulator bit for bit. (Against the JAX package, the strip decks
are held in tests/test_torch_strips_simulation.py and the steppers in
tests/test_torch_strips_{euler,schemes,rk4,tracers,muscl}.py.)
"""

import numpy as np
import pytest

from rdycore_tpu_torch import Simulation, load_config

from test_torch_raster_simulation import write_deck


@pytest.mark.parametrize("P, deck", [
    (2, dict(scheme="ssprk3")),
    (8, dict(scheme="rk4", physics=", sediment: {num_classes: 2}")),
    (2, dict(scheme="ssprk2", numerics=", second_order: true")),
])
def test_strip_counts_and_schemes_match_the_single_strip(tmp_path, P, deck):
    """Ten steps of a deck in 2 or 8 strips (a 128x64 raster) against the
    single strip, bit for bit."""
    runs = []
    for extra in ("", f"parallel: {{n_devices: {P}}}\n"):
        cfg = load_config(write_deck(tmp_path, ny=64, extra=extra, **deck))
        cfg.time.stop_n = 10
        sim = Simulation(cfg, device="cpu")
        sim.run()
        runs.append(sim)
    one, many = runs
    assert len(many._structured["op"]) == P and many.step == 10
    assert one.t == many.t and one.prev_max_courant == many.prev_max_courant
    for name in ("bflux_accum", "accum_sol", "accum_prim"):
        assert np.array_equal(getattr(one, name), getattr(many, name)), name
    assert np.array_equal(one.get_solution(), many.get_solution())
