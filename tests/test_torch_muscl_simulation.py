"""Second-order (MUSCL) `Simulation` of rdycore_tpu_torch against the JAX
package's (`edge_flux_backend: xla`), on the CPU, in float64.

A 24x16 dam break of 1/64 m cells (a 0.25 m reservoir at x < 0.1875 m, a
DRY floodplain, a Dirichlet inflow on the left, critical outflow on the
right, reflecting walls elsewhere; boundary-flux time series on) with
`second_order: true` runs 64 steps of 2^-10 s in both packages. They agree
to 1e-10 in the final state, the accumulators (boundary fluxes, scaled by
the positivity limiter, time-averaged state and primitives) and the
Courant number, with the same Courant edge. euler (minmod) and ssprk2
(minmod) run here, ssprk3 (minmod) and rk4 (none) in
tests/test_torch_muscl_schemes.py, so that each file stays under 15 s.
"""

import numpy as np
import pytest

from rdycore_tpu.config.yaml_input import load_config as jax_load_config
from rdycore_tpu.mesh import structured_quad
from rdycore_tpu.mesh.core import save_mesh_npz
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, load_config

NX, NY = 24, 16
DECK = """
physics: {flow: {mode: swe}}
numerics: {spatial: fv, temporal: %(scheme)s, riemann: roe,
           second_order: true, limiter: %(limiter)s,
           precision: %(precision)s}
logging: {level: none}
time: {stop: 0.0625, unit: seconds, coupling_interval: 0.015625,
       time_step: 0.0009765625}
output: {format: %(format)s, output_interval: 16,
         time_series: {boundary_fluxes: 10}}
grid: {file: muscl.npz}
regions:
  - {name: reservoir, grid_region_id: 1}
  - {name: floodplain, grid_region_id: 2}
surface_composition:
  - {region: reservoir, material: smooth}
  - {region: floodplain, material: smooth}
materials: [{name: smooth, properties: {manning: {value: 0.018}}}]
initial_conditions:
  - {region: reservoir, flow: column}
  - {region: floodplain, flow: dry}
boundaries:
  - {name: left, grid_boundary_id: 1}
  - {name: right, grid_boundary_id: 2}
boundary_conditions:
  - {boundaries: [right], flow: outflow}
  - {boundaries: [left], flow: inflow}
flow_conditions:
  - {name: column, type: dirichlet, height: 0.25, x_momentum: 0, y_momentum: 0}
  - {name: dry, type: dirichlet, height: 0.0, x_momentum: 0, y_momentum: 0}
  - {name: outflow, type: critical-outflow}
  - {name: inflow, type: dirichlet, height: 0.25, x_momentum: 0.01, y_momentum: 0}
"""


def write_deck(tmp_path, scheme, limiter="minmod", precision="double",
               fmt="none"):
    mesh = structured_quad(
        NX, NY, 0.0, NX / 64, 0.0, NY / 64,
        region_fn=lambda cx, cy: np.where(cx < NX / 128, 1, 2))
    save_mesh_npz(mesh, str(tmp_path / "muscl.npz"))
    path = tmp_path / "deck.yaml"
    path.write_text(DECK % dict(scheme=scheme, limiter=limiter,
                                precision=precision, format=fmt))
    return str(path)


def check_runs_agree(tmp_path, scheme, limiter):
    path = write_deck(tmp_path, scheme, limiter)
    js = JaxSimulation(jax_load_config(path))
    ts = Simulation(load_config(path), device="cpu")
    assert ts.operator.second_order and ts.operator.limiter == limiter
    js.run()
    ts.run()
    assert ts.step == js.step == 64 and ts.t == pytest.approx(js.t)
    qj, qt = np.asarray(js.q), ts.get_solution()
    assert np.abs(qt - qj).max() <= 1e-10 * np.abs(qj).max()
    for name in ("bflux_accum", "accum_sol", "accum_prim"):
        a, b = np.asarray(getattr(js, name)), getattr(ts, name)
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max(), name
    cj, ct = (js.get_courant_number_diagnostics(),
              ts.get_courant_number_diagnostics())
    assert ct[0] == pytest.approx(cj[0], rel=1e-10) and ct[0] > 0.0
    assert ct[1:] == cj[1:]
    # the front moved into the dry floodplain, which stays non-negative
    x = np.arange(NX * NY) % NX
    assert qt[0, x == NX // 2 + 2].min() > 0.0 and qt[0].min() >= 0.0


@pytest.mark.parametrize("scheme, limiter", [
    ("euler", "minmod"), ("ssprk2", "minmod"),
])
def test_muscl_run_matches_jax(tmp_path, scheme, limiter):
    check_runs_agree(tmp_path, scheme, limiter)

