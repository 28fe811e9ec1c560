"""Well-balanced `Simulation` of rdycore_tpu_torch against the JAX
package's (`edge_flux_backend: xla`), on the CPU, in float64.

A 24x16 dam break of 1/64 m quads over a bumpy bed (vertex z; a 0.25 m
reservoir at x < 0.1875 m, a Dirichlet inflow on the left, critical
outflow on the right, reflecting walls elsewhere; boundary-flux time
series on) runs 64 steps of 2^-10 s in both packages: hydrostatic
reconstruction (HR) under euler, flow only and with two sediment classes,
and BS2002 under euler. The sediment and the BS2002 decks read the cell
beds from `grid.cell_elevation.file`, which HR takes (cell_z) and BS2002
does not (vertex z), in both packages. They agree to 1e-10 in the final
state, the accumulators and the Courant number, with the same Courant
edge (`check_runs_agree`). HR under ssprk3 and rk4 runs in
tests/test_torch_wb_schemes.py, BS2002 with MUSCL in
tests/test_torch_wb_bs2002.py, so that each file stays under 15 s (the
JAX package's compile of each deck takes most of it).

Refusals: BS2002 with salinity or heat is a ConfigError in the port (the JAX
package drops the correction with a tracer, ROADMAP fault 18, shown in
tests/test_torch_wb_bs2002.py); HR with second order is a ConfigError in
both packages, and so is any well-balancing on `fused_structured`.
"""

import os

import numpy as np
import pytest

from rdycore_tpu.config.schema import ConfigError as JaxConfigError
from rdycore_tpu.config.yaml_input import load_config as jax_load_config
from rdycore_tpu.io.petsc_binary import write_petsc_vec
from rdycore_tpu.mesh import structured_quad
from rdycore_tpu.mesh.core import save_mesh_npz
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, load_config
from rdycore_tpu_torch.config.schema import ConfigError

from test_torch_operator import assert_rel_close

NX, NY = 24, 16
DECK = """
physics:
  flow: {mode: swe, well_balancing: %(wb)s}
%(tracers)s
numerics: {spatial: fv, temporal: %(scheme)s, riemann: roe,
           second_order: %(second_order)s, limiter: minmod,
           edge_flux_backend: %(backend)s}
logging: {level: none}
time: {stop: %(stop)s, unit: seconds, coupling_interval: 0.015625,
       time_step: 0.0009765625}
output: {format: none, time_series: {boundary_fluxes: 10}}
grid: {file: wb.npz%(elevation)s}
regions:
  - {name: reservoir, grid_region_id: 1}
  - {name: floodplain, grid_region_id: 2}
surface_composition:
  - {region: reservoir, material: smooth}
  - {region: floodplain, material: smooth}
materials: [{name: smooth, properties: {manning: {value: 0.018}}}]
initial_conditions:
  - {region: reservoir, flow: column%(ic)s}
  - {region: floodplain, flow: plain}
boundaries:
  - {name: left, grid_boundary_id: 1}
  - {name: right, grid_boundary_id: 2}
boundary_conditions:
  - {boundaries: [right], flow: outflow}
  - {boundaries: [left], flow: inflow}
flow_conditions:
  - {name: column, type: dirichlet, height: 0.25, x_momentum: 0, y_momentum: 0}
  - {name: plain, type: dirichlet, height: %(plain)s, x_momentum: 0,
     y_momentum: 0}
  - {name: outflow, type: critical-outflow}
  - {name: inflow, type: dirichlet, height: 0.25, x_momentum: 0.01, y_momentum: 0}
%(conditions)s
"""
SEDIMENT = ("  sediment: {num_classes: 2}",
            ", sediment: muddy",
            "sediment_conditions:\n  - {name: muddy, type: dirichlet, "
            "c0: {value: 0.0025}, c1: {value: 0.001}}")
SALINITY = ("  salinity: true", ", salinity: salty",
            "salinity_conditions:\n  - {name: salty, type: dirichlet, "
            "concentration: 0.0075}")


def bed(x, y):
    return 0.02 * (1.0 + np.sin(8 * np.pi * x) * np.sin(8 * np.pi * y))


def write_deck(tmp_path, wb, scheme="euler", second_order=False,
               tracers=None, elevation=False, stop=0.0625, plain=0.05,
               backend="xla", nx=NX, ny=NY):
    mesh = structured_quad(
        nx, ny, 0.0, nx / 64, 0.0, ny / 64, z_fn=bed,
        region_fn=lambda cx, cy: np.where(cx < NX / 128, 1, 2))
    save_mesh_npz(mesh, os.path.join(tmp_path, "wb.npz"))
    if elevation:
        # cell beds that differ from the vertex averages
        write_petsc_vec(os.path.join(tmp_path, "z.bin"),
                        mesh.cell_z + 0.01 * np.cos(mesh.cell_centroid[:, 1]
                                                    * 40.0))
    tr = tracers or ("", "", "")
    path = os.path.join(tmp_path, "deck.yaml")
    with open(path, "w") as f:
        f.write(DECK % dict(
            wb=wb, scheme=scheme, second_order=str(second_order).lower(),
            tracers=tr[0], ic=tr[1], conditions=tr[2], stop=stop,
            plain=plain, backend=backend,
            elevation=", cell_elevation: {file: z.bin}" if elevation
            else ""))
    return path


def check_runs_agree(tmp_path, **kw):
    """Run the deck of write_deck(**kw) in both packages and hold the port
    to the JAX package (1e-10)."""
    path = write_deck(str(tmp_path), **kw)
    js = JaxSimulation(jax_load_config(path))
    ts = Simulation(load_config(path), device="cpu")
    hr = kw["wb"] == "hydrostatic_reconstruction"
    assert (ts.operator.well_balancing_hr, ts.operator.well_balancing_bs2002,
            ts.operator.second_order) == (hr, not hr, kw.get("second_order",
                                                             False))
    if kw.get("elevation"):
        # the file's beds replace cell_z, which only HR reads
        assert not np.allclose(ts.mesh.cell_z, ts.mesh.points[
            ts.mesh.cell_vertices, 2].mean(axis=1))
    js.run()
    ts.run()
    steps = round(kw.get("stop", 0.0625) * 1024)
    assert ts.step == js.step == steps and ts.t == pytest.approx(js.t)
    qj, qt = np.asarray(js.q), ts.get_solution()
    for k in range(qj.shape[0]):
        assert_rel_close(qj[k], qt[k], 1e-10, f"q row {k}")
    for name in ("bflux_accum", "accum_sol", "accum_prim"):
        a, b = np.asarray(getattr(js, name)), getattr(ts, name)
        for k in range(a.shape[0]):
            assert_rel_close(a[k], b[k], 1e-10, f"{name} row {k}")
    cj, ct = (js.get_courant_number_diagnostics(),
              ts.get_courant_number_diagnostics())
    assert ct[0] == pytest.approx(cj[0], rel=1e-10) and ct[0] > 0.0
    assert ct[1:] == cj[1:]
    assert qt[0].min() >= 0.0


CASES = {
    "hr-euler": dict(wb="hydrostatic_reconstruction"),
    "hr-sediment": dict(wb="hydrostatic_reconstruction", tracers=SEDIMENT,
                        elevation=True),
    "bs2002-euler": dict(wb="bs2002", elevation=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wb_run_matches_jax(tmp_path, case):
    check_runs_agree(tmp_path, **CASES[case])


@pytest.mark.parametrize("tracer", ["salinity", "heat"])
def test_bs2002_with_a_tracer_is_refused(tmp_path, tracer):
    tracers = SALINITY if tracer == "salinity" else (
        "  heat: true", ", temperature: warm",
        "temperature_conditions:\n  - {name: warm, type: dirichlet, "
        "temperature: 0.3}")
    path = write_deck(str(tmp_path), "bs2002", tracers=tracers)
    with pytest.raises(ConfigError, match="fault 18"):
        Simulation(load_config(path), device="cpu")


def test_hr_with_second_order_is_refused_in_both(tmp_path):
    path = write_deck(str(tmp_path), "hydrostatic_reconstruction",
                      second_order=True)
    for load, error in ((jax_load_config, JaxConfigError),
                        (load_config, ConfigError)):
        with pytest.raises(error, match="second_order"):
            load(path)


@pytest.mark.parametrize("wb", ["hydrostatic_reconstruction", "bs2002"])
def test_wb_on_fused_structured_is_refused_in_both(tmp_path, wb):
    path = write_deck(str(tmp_path), wb, backend="fused_structured", nx=128,
                      ny=4)
    with pytest.raises(JaxConfigError, match="well_balancing"):
        JaxSimulation(jax_load_config(path))
    with pytest.raises(ConfigError, match="well_balancing"):
        Simulation(load_config(path), device="cpu")
