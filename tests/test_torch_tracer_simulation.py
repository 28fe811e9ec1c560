"""`Simulation` of rdycore_tpu_torch with sediment and salinity against the
JAX package's, on the CPU, in f64.

The 40x20 dam break of tests/test_torch_simulation.py (reservoir and
floodplain, critical outflow on the right, a Dirichlet inflow on the left,
reflecting walls elsewhere, adaptive dt, boundary-flux time series on)
carries two sediment classes (Hairsine-Rose) and salinity: ndof = 6. The
reservoir holds sediment and both regions salt. Before the first interval
the coupling setters move both packages the same way (Manning's n, the
sediment and salinity Dirichlet values of the inflow, a regional sediment
and a regional salinity source). Three coupling intervals later both have
taken the same steps with the identical dt sequence, and every row of q
and of the accumulators agrees to 1e-10 relative to that row's largest
magnitude: euler with Roe tracer fluxes, ssprk3 with upwind-Roe.

An implicit_xq2018 deck with sediment raises ConfigError in the port (the
JAX package runs semi-implicit friction instead), and the CLI runs the
tracer deck on the CPU.
"""

import os

import numpy as np
import pytest

from rdycore_tpu.config.yaml_input import load_config as jax_load_config
from rdycore_tpu.mesh import structured_quad
from rdycore_tpu.mesh.core import save_mesh_npz
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, load_config
from rdycore_tpu_torch.__main__ import main as cli_main
from rdycore_tpu_torch.config.schema import ConfigError

DECK = """
physics:
  flow: {mode: swe, source: {method: %(method)s}}
  sediment: {num_classes: 2}
  salinity: true
numerics: {spatial: fv, temporal: %(scheme)s, riemann: %(riemann)s}
logging: {level: none}
time:
  stop: 0.06
  unit: seconds
  coupling_interval: 0.02
  adaptive: {enable: true, target_courant_number: 0.7,
             max_increase_factor: 1.3, initial_time_step: 0.0005}
output:
  format: %(format)s
  output_interval: 50
  time_series: {boundary_fluxes: 7}
grid: {file: dam_break.npz}
regions:
  - {name: reservoir, grid_region_id: 1}
  - {name: floodplain, grid_region_id: 2}
surface_composition:
  - {region: reservoir, material: smooth}
  - {region: floodplain, material: smooth}
materials: [{name: smooth, properties: {manning: {value: 0.018}}}]
initial_conditions:
  - {region: reservoir, flow: column, sediment: muddy, salinity: salty}
  - {region: floodplain, flow: wet_bed, salinity: brackish}
boundaries:
  - {name: left, grid_boundary_id: 1}
  - {name: right, grid_boundary_id: 2}
boundary_conditions:
  - {boundaries: [right], flow: outflow}
  - {boundaries: [left], flow: inflow}
flow_conditions:
  - {name: column, type: dirichlet, height: 0.25, x_momentum: 0, y_momentum: 0}
  - {name: wet_bed, type: dirichlet, height: 0.05, x_momentum: 0, y_momentum: 0}
  - {name: outflow, type: critical-outflow}
  - {name: inflow, type: dirichlet, height: 0.25, x_momentum: 0.01, y_momentum: 0}
sediment_conditions:
  - {name: muddy, type: dirichlet, c0: {value: 0.0025}, c1: {value: 0.001}}
salinity_conditions:
  - {name: salty, type: dirichlet, concentration: 0.0075}
  - {name: brackish, type: dirichlet, concentration: 0.0015}
"""


def write_deck(tmp_path, scheme="euler", riemann="roe",
               method="semi_implicit", fmt="none"):
    mesh = structured_quad(
        40, 20, 0.0, 2.0, 0.0, 1.0,
        region_fn=lambda cx, cy: np.where(cx < 1.0, 1, 2),
    )
    save_mesh_npz(mesh, os.path.join(tmp_path, "dam_break.npz"))
    path = os.path.join(tmp_path, f"sediment_{scheme}_{method}.yaml")
    with open(path, "w") as f:
        f.write(DECK % dict(scheme=scheme, riemann=riemann, method=method,
                            format=fmt))
    return path


def setters(sim, nb, n):
    sim.set_manning_n(n)
    sim.set_sediment_dirichlet_boundary_values(
        "left", np.stack([np.full(nb, 4e-4), np.full(nb, 2e-4)]))
    sim.set_salinity_dirichlet_boundary_values("left", np.full(nb, 1e-3))
    sim.set_regional_sediment_source("floodplain", 1, 1e-5)
    sim.set_regional_tracer_source("reservoir", 2, 2e-5)


def assert_rows_close(a, b, tol, what):
    assert a.shape == b.shape, what
    for k in range(a.shape[0]):
        scale = max(float(np.max(np.abs(a[k]))), 1e-30)
        err = float(np.max(np.abs(a[k] - b[k])))
        assert err <= tol * scale, f"{what} row {k}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("scheme, riemann", [("euler", "roe"),
                                             ("ssprk3", "upwind_roe")])
def test_tracer_run_matches_jax(tmp_path, scheme, riemann):
    path = write_deck(tmp_path, scheme, riemann)
    sims = (JaxSimulation(jax_load_config(path)),
            Simulation(load_config(path), device="cpu"))
    n = np.random.default_rng(5).uniform(0.01, 0.03, 800)
    logs = ([], [])
    q_init = sims[1].get_solution()
    for sim, log in zip(sims, logs):
        assert (sim.ndof, sim.num_sediment, sim.num_tracers) == (6, 2, 3)
        setters(sim, sim.get_num_boundary_edges("left"), n)
        while not sim.finished:
            sim.advance()
            log.append((sim.step, sim.dt))
    js, ts = sims
    assert len(logs[1]) == 3 and logs[1] == logs[0]
    assert ts.t == pytest.approx(js.t, abs=1e-12)
    q0 = np.asarray(js.q)
    assert_rows_close(q0, ts.get_solution(), 1e-10, "q")
    for name in ("bflux_accum", "accum_sol", "accum_prim"):
        assert_rows_close(getattr(js, name), getattr(ts, name), 1e-10, name)
    assert ts.accum_time == pytest.approx(js.accum_time, abs=1e-12)
    assert ts.prev_max_courant == pytest.approx(js.prev_max_courant,
                                                rel=1e-12)
    # the sediment sources acted and every tracer crossed the walls
    assert np.abs(ts.get_solution()[3:5] - q_init[3:5]).max() > 1e-6
    assert np.all(np.abs(ts.bflux_accum[3:]).max(axis=1) > 0.0)


def test_xq2018_with_sediment_is_refused(tmp_path):
    path = write_deck(tmp_path, method="implicit_xq2018")
    with pytest.raises(ConfigError, match="implicit_xq2018"):
        Simulation(load_config(path), device="cpu")


def test_cli_runs_a_tracer_deck_on_cpu(tmp_path):
    path = write_deck(tmp_path, fmt="binary")
    out = os.path.join(tmp_path, "out")
    assert cli_main([path, "--cpu", "--output-dir", out]) == 0
    files = sorted(os.listdir(out))
    assert "boundary_fluxes.dat" in files
    assert any(f.endswith(".bin") for f in files)
