"""`Simulation` of rdycore_tpu_torch against the JAX package's, on the CPU.

A 40x20 dam break (the physics of examples/dam_break.yaml: reservoir and
floodplain regions, critical outflow on the right, plus a Dirichlet inflow
on the left and reflecting walls elsewhere) is written to tmp_path and run by both packages with adaptive dt
on and the boundary-flux time series on. They take the same number of
steps with the identical dt sequence, and the state and accumulators agree
to 1e-10. The coupling setters move both packages the same way, and the
CLI runs the deck on the CPU with binary output.
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

DECK = """
physics: {flow: {mode: swe}}
numerics: {spatial: fv, temporal: euler, riemann: roe}
logging: {level: none}
time:
  stop: 0.3
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
  - {region: reservoir, flow: column}
  - {region: floodplain, flow: wet_bed}
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
"""


def write_deck(tmp_path, fmt="none"):
    mesh = structured_quad(
        40, 20, 0.0, 2.0, 0.0, 1.0,
        region_fn=lambda cx, cy: np.where(cx < 1.0, 1, 2),
    )
    save_mesh_npz(mesh, os.path.join(tmp_path, "dam_break.npz"))
    path = os.path.join(tmp_path, "dam_break.yaml")
    with open(path, "w") as f:
        f.write(DECK % {"format": fmt})
    return path


def run_both(path):
    js = JaxSimulation(jax_load_config(path))
    ts = Simulation(load_config(path), device="cpu")
    jlog, tlog = [], []
    while not js.finished:
        js.advance()
        jlog.append((js.step, js.dt))
    while not ts.finished:
        ts.advance()
        tlog.append((ts.step, ts.dt))
    return js, ts, jlog, tlog


def test_run_matches_jax(tmp_path):
    js, ts, jlog, tlog = run_both(write_deck(tmp_path))
    assert ts.step == js.step
    assert tlog == jlog  # the same step counts and the identical dt sequence
    assert ts.t == pytest.approx(js.t, abs=1e-12)
    scale = float(np.max(np.abs(np.asarray(js.q))))
    assert np.max(np.abs(np.asarray(js.q) - ts.get_solution())) <= 1e-10 * scale
    for name in ("bflux_accum", "accum_sol", "accum_prim"):
        a, b = getattr(js, name), getattr(ts, name)
        assert np.max(np.abs(a - b)) <= 1e-10 * max(np.max(np.abs(a)), 1e-30), name
    assert ts.accum_time == pytest.approx(js.accum_time, abs=1e-12)
    assert ts.prev_max_courant == pytest.approx(js.prev_max_courant, rel=1e-12)
    cj, ct = (js.get_courant_number_diagnostics(),
              ts.get_courant_number_diagnostics())
    assert ct[0] == pytest.approx(cj[0], rel=1e-12)
    assert 0 <= ct[1] < ts.mesh.num_edges and 0 <= ct[2] < ts.num_cells


def test_coupling_setters_match_jax(tmp_path):
    path = write_deck(tmp_path)
    js = JaxSimulation(jax_load_config(path))
    ts = Simulation(load_config(path), device="cpu")
    C = ts.num_cells
    rng = np.random.default_rng(4)
    n = rng.uniform(0.01, 0.03, C)
    nb = ts.get_num_boundary_edges("left")
    dirichlet = np.stack([np.full(nb, 0.3), np.full(nb, 0.02), np.zeros(nb)])
    for sim in (js, ts):
        sim.set_manning_n(n)
        sim.set_domain_water_source(1e-4)
        sim.set_regional_water_source("floodplain", 2e-4)
        sim.set_flow_dirichlet_boundary_values("left", dirichlet)
        sim.set_coupling_interval(0.01)
        sim.advance()
    assert ts.get_step() == js.get_step()
    assert ts.get_time() == pytest.approx(js.get_time(), abs=1e-12)
    assert ts.get_time_step() == js.get_time_step()
    assert np.array_equal(ts.get_manning_n(), js.get_manning_n())
    qj, qt = js.get_solution(), ts.get_solution()
    assert np.max(np.abs(qj - qt)) <= 1e-10 * np.max(np.abs(qj))
    for row, getter in enumerate(("get_height", "get_x_momentum",
                                  "get_y_momentum")):
        assert np.array_equal(getattr(ts, getter)(), qt[row]), getter

    # state setters round-trip
    q = ts.get_solution()
    q[0] += 0.01
    ts.set_height(q[0])
    assert np.array_equal(ts.get_height(), q[0])
    ts.set_solution(q)
    assert np.array_equal(ts.get_solution(), q)
    ts.set_time(1.5)
    ts.set_time_step(0.001)
    ts.set_step(7)
    assert (ts.get_time(), ts.get_time_step(), ts.get_step()) == (1.5, 0.001, 7)


def test_cli_runs_deck_on_cpu(tmp_path):
    path = write_deck(tmp_path, fmt="binary")
    out = os.path.join(tmp_path, "out")
    assert cli_main([path, "--cpu", "--output-dir", out]) == 0
    files = sorted(os.listdir(out))
    assert "boundary_fluxes.dat" in files
    assert any(f.endswith(".bin") for f in files)
    with open(os.path.join(out, "boundary_fluxes.dat")) as f:
        rows = [line.split() for line in f if not line.startswith("#")]
    assert {r[1] for r in rows} >= {"left", "right"}
    assert all(np.isfinite(float(x)) for r in rows for x in r[2:])
