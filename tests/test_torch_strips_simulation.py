"""`Simulation` of rdycore_tpu_torch on a row-strip raster deck
(`edge_flux_backend: fused_structured`, `parallel.n_devices: 4`) against
the JAX package's `Simulation` with the same deck (its row-strip sharded
stepper in interpret mode over 4 of the 8 host devices of
tests/conftest.py), on the CPU, where the port puts all 4 strips.

The 128x32 dam break of tests/test_torch_raster_simulation.py (a
Dirichlet inflow on the left, critical outflow on the right, adaptive dt,
the boundary-flux time series on): both packages take the same steps and
dt sequence to the same float32 time, the state agrees to 2e-6 and the
accumulators to 1e-5 of their largest magnitude (the tolerances of the
single-device raster deck; the JAX package takes the strips' boundary
fluxes from its raster twin in float64). Every refusal of the JAX
package's row-strip routing is the port's too, with its message; the
unstructured path runs in shards instead (ROADMAP item 16). The
coupling setters and the CLI on a strip deck are in
tests/test_torch_strips_coupling.py, decks in 2 and 8 strips under the
other schemes in tests/test_torch_strips_decks.py.
"""

import types

import numpy as np
import pytest
import torch

from rdycore_tpu.config.schema import ConfigError as JaxConfigError
from rdycore_tpu.config.yaml_input import load_config as jax_load_config
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, load_config
from rdycore_tpu_torch.config.schema import ConfigError

from test_torch_raster_simulation import (
    assert_runs_agree,
    run_both,
    write_deck,
)

STRIPS = "parallel: {n_devices: 4}\n"


def test_strip_deck_matches_jax(tmp_path):
    path = write_deck(tmp_path, ny=32, extra=STRIPS)
    (js, ts), (jlog, tlog) = run_both(path)
    assert js._structured["kind"] == "fused_sharded"
    ops = ts._structured["op"]
    assert [(o.strip.row0, o.strip.rows) for o in ops] == [
        (0, 8), (8, 8), (16, 8), (24, 8)]
    assert_runs_agree(js, ts, jlog, tlog, 2e-6, 1e-5)
    assert np.abs(ts.bflux_accum).max() > 0.0


@pytest.mark.parametrize("deck, match", [
    # beuler is not run in strips (the JAX package's message)
    (dict(scheme="beuler", extra=STRIPS), "supports temporal"),
    # 16 rows do not split into 4 strips of 8-row tiles
    (dict(extra=STRIPS), "needs ny divisible by n_devices"),
    # a raster that is not 128 wide falls back to `structured`, which
    # has no strips
    (dict(nx=24, dx=0.0625, bflux=0, left="wall",
          extra="parallel: {n_devices: 2}\n"),
     "structured does not support parallel.n_devices > 1"),
    (dict(backend="structured", left="wall", bflux=0,
          extra="parallel: {n_devices: 2}\n"),
     "does not support: parallel.n_devices > 1"),
    # more strips than the host has devices
    (dict(ny=256, extra="parallel: {n_devices: 16}\n"), None),
])
def test_strip_refusals_of_both_packages(tmp_path, deck, match):
    path = write_deck(tmp_path, **deck)
    with pytest.raises(JaxConfigError, match=match or "only 8 devices"):
        JaxSimulation(jax_load_config(path))
    if match is None:
        # the port counts cards; on the CPU every strip runs there
        fake = types.SimpleNamespace(strip_devices=None,
                                     device=torch.device("cuda", 0))
        cuda = torch.cuda
        count = cuda.device_count
        cuda.device_count = lambda: 8
        try:
            with pytest.raises(ConfigError, match="only 8 devices"):
                Simulation._strip_device_list(fake, 16)
        finally:
            cuda.device_count = count
        return
    with pytest.raises(ConfigError, match=match):
        Simulation(load_config(path), device="cpu")


def test_strips_elsewhere_raise(tmp_path):
    # the unstructured path runs in shards (tests/test_torch_sharded*.py),
    # strip_devices naming one device per shard
    path = write_deck(tmp_path, backend="xla", extra=STRIPS)
    sim = Simulation(load_config(path), device="cpu",
                     strip_devices=["cpu"] * 4)
    assert sim._sharded is not None and sim._sharded.P == 4
    # strip_devices: one per strip, and only for a strip deck
    with pytest.raises(ValueError, match="names 2 devices"):
        Simulation(load_config(write_deck(tmp_path, ny=32, extra=STRIPS)),
                   device="cpu", strip_devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="in one process"):
        Simulation(load_config(write_deck(tmp_path)), device="cpu",
                   strip_devices=["cpu"])
    # strips of a CPU simulation stay on the CPU
    with pytest.raises(ValueError, match="must be on a cpu device"):
        Simulation(load_config(write_deck(tmp_path, ny=32, extra=STRIPS)),
                   device="cpu", strip_devices=["cpu", "cuda:0", "cpu",
                                                "cpu"])
