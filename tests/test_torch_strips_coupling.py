"""A row-strip raster deck (`edge_flux_backend: fused_structured`,
`parallel.n_devices: 4`) through the coupling API and the CLI of
rdycore_tpu_torch, on the CPU.

The 128x32 dam break of tests/test_torch_strips_simulation.py, with the
coupling setters driven after the second interval (`set_manning_n`
rebuilds the strips' Manning planes; `set_domain_water_source` switches
the strips' rain plane on; `set_flow_dirichlet_boundary_values` changes
the wall values each strip reads, halo rows included): the 4 strips equal
the single strip driven the same way bit for bit (steps, t, the Courant
number, q and every accumulator). The CLI runs the deck with `--cpu`
and writes its outputs and boundary-flux series.
"""

import os

import numpy as np
import torch

from rdycore_tpu_torch import Simulation, load_config
from rdycore_tpu_torch.__main__ import main as cli_main

from test_torch_raster_simulation import write_deck

STRIPS = "parallel: {n_devices: 4}\n"


def setters(sim):
    """The coupling setters, after the second interval."""
    rng = np.random.default_rng(3)
    sim.set_manning_n(rng.uniform(0.01, 0.03, 128 * 32))
    sim.set_domain_water_source(2e-3)
    sim.set_flow_dirichlet_boundary_values(
        "left", np.stack([np.full(32, 0.3), np.full(32, 0.02),
                          np.zeros(32)]))


def test_strip_deck_with_setters_matches_the_single_strip(tmp_path):
    runs = []
    for extra in ("", STRIPS):
        sim = Simulation(load_config(write_deck(tmp_path, ny=32,
                                                extra=extra)),
                         device="cpu")
        n = 0
        while not sim.finished:
            sim.advance()
            n += 1
            if n == 2:
                setters(sim)
        runs.append(sim)
    one, four = runs
    assert four._structured["with_src"]
    assert one.step == four.step and one.t == four.t
    assert one.prev_max_courant == four.prev_max_courant
    for name in ("q", "bflux_accum", "accum_sol", "accum_prim"):
        a, b = getattr(one, name), getattr(four, name)
        a, b = (x.numpy() if isinstance(x, torch.Tensor) else x
                for x in (a, b))
        assert np.array_equal(a, b), name


def test_cli_runs_a_strip_deck_on_cpu(tmp_path):
    path = write_deck(tmp_path, ny=32, fmt="binary", extra=STRIPS)
    out = os.path.join(tmp_path, "out")
    assert cli_main([path, "--cpu", "--output-dir", out]) == 0
    assert any(f.endswith(".bin") for f in os.listdir(out))
    with open(os.path.join(out, "boundary_fluxes.dat")) as f:
        rows = [line.split() for line in f if not line.startswith("#")]
    assert {r[1] for r in rows} >= {"left", "right"}
    assert all(np.isfinite(float(x)) for r in rows for x in r[2:])
