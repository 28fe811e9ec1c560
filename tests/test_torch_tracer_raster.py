"""The raster kind (`edge_flux_backend: fused_structured`) with sediment and
salinity against the JAX package's `Simulation`, on the CPU, in f32.

The 128x16 raster deck of tests/test_torch_raster_simulation.py (reservoir
at x < 1 m, a Dirichlet inflow on the left, critical outflow on the right,
reflecting walls elsewhere, adaptive dt, boundary-flux time series on)
carries two sediment classes and salinity, set by `set_solution` (sediment
in the reservoir, salt everywhere), and the Dirichlet inflow carries
sediment and salt (`set_sediment_dirichlet_boundary_values`,
`set_salinity_dirichlet_boundary_values`). The JAX package's raster kernel
runs in interpret mode, K2's nt mode as its plain version. The euler
pair of runs is made once (a module fixture: the JAX package compiles its
kernel once, in stage mode) and checked by several tests: the same steps,
dt sequence and float32 time; every row of q to 2e-6 relative to that
row's largest magnitude; the accumulators to 1e-5 (the JAX package
computes the boundary fluxes of the float32 state in float64), with the
tracer rows of the boundary-flux accumulator zero in both packages
(ROADMAP fault 13); and the Courant number to 1e-5. The rk4 pair (K2's
rhs mode, upwind-Roe) is made and checked the same way in
tests/test_torch_tracer_raster_rk4.py, which compiles the JAX package's rk4
raster stepper once for all its tests.

The `structured` kind refuses tracers in both packages, also where a
fused_structured deck on a raster that is not 128 cells wide falls back
to it.
"""

import numpy as np
import pytest

from rdycore_tpu.config.schema import ConfigError as JaxConfigError
from rdycore_tpu.config.yaml_input import load_config as jax_load_config
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, load_config
from rdycore_tpu_torch.config.schema import ConfigError

from test_torch_raster_simulation import write_deck

NX, NY = 128, 16


def rows_rel_err(a, b):
    """Largest error of each row relative to that row's largest value."""
    scale = np.maximum(np.abs(a).max(axis=1), 1e-30)
    return np.abs(a - b).max(axis=1) / scale


def tracer_runs(tmp_path, scheme):
    """The tracer raster deck under `scheme` in both packages: (the two
    Simulations, their logs of (step, dt, t), the initial state)."""
    path = write_deck(
        tmp_path, scheme,
        physics=", sediment: {num_classes: 2}, salinity: true",
        numerics=", riemann: upwind_roe" if scheme == "rk4" else "")
    sims = (JaxSimulation(jax_load_config(path)),
            Simulation(load_config(path), device="cpu"))
    q = sims[1].get_solution()
    h = q[0]
    x = np.arange(NX * NY) % NX
    q[3] = h * np.where(x < NX // 2, 0.004, 0.0)
    q[4] = h * np.where(x < NX // 2, 0.002, 0.0)
    q[5] = h * np.where(x < NX // 2, 0.008, 0.003)
    logs = ([], [])
    for sim, log in zip(sims, logs):
        nb = sim.get_num_boundary_edges("left")
        sim.set_solution(q)
        sim.set_sediment_dirichlet_boundary_values(
            "left", np.stack([np.full(nb, 5e-4), np.full(nb, 2.5e-4)]))
        sim.set_salinity_dirichlet_boundary_values("left", np.full(nb, 1e-3))
        while not sim.finished:
            sim.advance()
            log.append((sim.step, sim.dt, sim.t))
    return sims, logs, q


def check_steps_and_state(runs):
    (js, ts), (jlog, tlog), q0 = runs
    assert ts._structured["kind"] == "fused" and ts.ndof == 6
    assert ts.step == js.step and tlog == jlog
    assert ts.t == js.t == ts.t_final
    qj, qt = np.asarray(js.q), ts.get_solution()
    assert rows_rel_err(qj, qt).max() <= 2e-6
    # the tracers moved: sediment eroded and salt carried downstream
    assert np.abs(qt[3:] - q0[3:]).max(axis=1).min() > 1e-7


def check_accumulators(runs):
    (js, ts), _, _ = runs
    for name in ("bflux_accum", "accum_sol", "accum_prim"):
        a, b = getattr(js, name), getattr(ts, name)
        assert a.shape == b.shape == (6, a.shape[1]), name
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), name
    assert ts.accum_time == pytest.approx(js.accum_time, rel=1e-6)
    # tracer rows of the raster boundary-flux accumulator stay zero in both
    assert not js.bflux_accum[3:].any() and not ts.bflux_accum[3:].any()
    assert np.abs(ts.accum_sol[3:]).min(axis=1).max() > 0.0


def check_courant(runs):
    (js, ts), _, _ = runs
    cj, ct = (js.get_courant_number_diagnostics(),
              ts.get_courant_number_diagnostics())
    assert ct[0] == pytest.approx(cj[0], rel=1e-5) and ct[0] > 0.0
    assert ct[1:] == cj[1:] == (-1, -1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tracer_runs(tmp_path_factory.mktemp("euler"), "euler")


def test_steps_and_state_match(runs):
    check_steps_and_state(runs)


def test_accumulators_match(runs):
    check_accumulators(runs)


def test_courant_matches(runs):
    check_courant(runs)


@pytest.mark.parametrize("deck", [
    dict(backend="structured", left="wall", bflux=0),
    dict(nx=24, dx=0.0625, left="wall", bflux=0),  # falls back to structured
])
def test_structured_kind_refuses_tracers_in_both_packages(tmp_path, deck):
    path = write_deck(tmp_path, physics=", salinity: true", **deck)
    with pytest.raises(JaxConfigError, match="tracers"):
        JaxSimulation(jax_load_config(path))
    with pytest.raises(ConfigError, match="tracers"):
        Simulation(load_config(path), device="cpu")
