"""The port's profiling harness (rdycore_tpu_torch/profiling.py) on the CPU:
`preload` runs an interval and puts back exactly what it changed (q, t,
step, dt, the last Courant number and its edge, the accumulators, the
monitors), on a deck with adaptive dt and boundary fluxes; `StepTimer`
gives the JAX package's summary keys, its first interval split out;
`trace` writes a Chrome trace naming the operator's work.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from rdycore_tpu import profiling as jax_profiling
from rdycore_tpu_torch import Simulation, load_config
from rdycore_tpu_torch.profiling import StepTimer, preload, trace
from tests.test_torch_ensemble import write_deck


@pytest.fixture
def sim(tmp_path):
    return Simulation(load_config(write_deck(tmp_path)), device="cpu")


def snapshot(sim):
    return (sim.q.clone(), sim.t, sim.step, sim.dt, sim.prev_max_courant,
            sim.prev_courant_edge, sim.bflux_accum.copy(),
            sim.accum_sol.copy(), sim.accum_prim.copy(), sim.accum_time,
            list(sim._monitors))


def assert_same(a, b):
    assert torch.equal(a[0], b[0])
    assert a[1:6] == b[1:6]
    for x, y in zip(a[6:9], b[6:9]):
        np.testing.assert_array_equal(x, y)
    assert a[9:] == b[9:]


def test_preload_restores_the_state(sim):
    sim.advance()  # a Courant number, accumulators and an adapted dt
    seen = []
    sim.add_monitor(lambda s: seen.append(s.step))
    before = snapshot(sim)
    assert before[4] is not None and before[6].any()
    seconds = preload(sim)
    assert seconds > 0.0 and not seen
    assert_same(snapshot(sim), before)
    # the warmed simulation goes on as one never preloaded
    sim.advance()
    fresh = Simulation(sim.config, device="cpu")
    fresh.advance()
    fresh.advance()
    assert torch.equal(sim.q, fresh.q) and sim.step == fresh.step
    assert seen == [sim.step]


def test_step_timer_summary_keys(sim):
    timer = StepTimer(sim)
    assert timer.summary() == {}
    sim.add_monitor(timer)
    sim.run()
    got = timer.summary()
    dummy = types.SimpleNamespace(step=0, num_cells=sim.num_cells)
    jax_timer = jax_profiling.StepTimer(dummy)
    for n in (3, 7):
        dummy.step += n
        jax_timer(dummy)
    assert got.keys() == jax_timer.summary().keys()
    assert got["steady_intervals"] == len(timer.times) - 1 == 3
    assert got["steady_steps"] == sim.step - timer.steps[0]
    assert got["cell_updates_per_s"] > 0.0


def test_trace_writes_a_chrome_trace(sim, tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir) as where:
        sim.advance()
    assert where == logdir
    path = os.path.join(logdir, "trace.json")
    events = json.load(open(path))["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("swe_edge_flux" in n or "aten::" in n for n in names)
