"""`Simulation` of rdycore_tpu_torch against the JAX package's on a raster
deck (`edge_flux_backend: fused_structured`), on the CPU.

A 128x16 dam break on 1/64 m cells (reservoir at x < 1 m, a Dirichlet
inflow on the left, critical outflow on the right, reflecting walls
elsewhere) runs with adaptive dt and the boundary-flux time series on in
both packages; the JAX package's raster kernel runs in interpret mode, the
port's raster step as its plain version. Spacings and times are exact in
binary, so the float32 time of the fused steppers lands on each interval's
end. Both take the same steps and dt sequence to the same float32 time,
the state agrees to 2e-6 (absolute, O(1) states, float32) and the
accumulators to 1e-5 of their largest magnitude (the JAX package computes
the boundary fluxes of the float32 state in float64). The euler case also
drives the coupling setters after setup (`set_manning_n` and
`set_domain_water_source` rebuild or re-arm the raster stepper); the other
schemes are in tests/test_torch_raster_{schemes,rk4}.py and the
`structured` kind in tests/test_torch_raster_structured.py.

A fused_structured deck on a raster that is not 128 cells wide falls back
to the `structured` kind in both packages, every ConfigError of the JAX
package's raster routing is raised by both packages, the decks that leave
the raster for the unstructured path in shards (BS2002, beuler) run there
as on one device, and the CLI runs a raster deck on the CPU.
"""

import os

import numpy as np
import pytest

from rdycore_tpu.config.schema import ConfigError as JaxConfigError
from rdycore_tpu.config.yaml_input import load_config as jax_load_config
from rdycore_tpu.mesh import structured_quad
from rdycore_tpu.mesh.core import save_mesh_npz
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, load_config, timestepping
from rdycore_tpu_torch.__main__ import main as cli_main
from rdycore_tpu_torch.config.schema import ConfigError

DECK = """
physics: {flow: {mode: swe%(flow)s}%(physics)s}
numerics: {spatial: fv, temporal: %(scheme)s, riemann: roe,
           edge_flux_backend: %(backend)s%(numerics)s}
logging: {level: none}
time:
  stop: 0.03125
  unit: seconds
  coupling_interval: 0.00390625
  adaptive: {enable: true, target_courant_number: 0.7,
             max_increase_factor: 1.3, initial_time_step: 0.00048828125}
output:
  format: %(format)s
  output_interval: 10
  time_series: {boundary_fluxes: %(bflux)s}
grid: {file: raster.npz}
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
  - {boundaries: [left], flow: %(left)s}
flow_conditions:
  - {name: column, type: dirichlet, height: 0.25, x_momentum: 0, y_momentum: 0}
  - {name: wet_bed, type: dirichlet, height: 0.05, x_momentum: 0, y_momentum: 0}
  - {name: outflow, type: critical-outflow}
  - {name: inflow, type: dirichlet, height: 0.25, x_momentum: 0.01, y_momentum: 0}
  - {name: wall, type: reflecting}
  - {name: push, type: dirichlet, height: 0, x_momentum: 0.001, y_momentum: 0}
%(extra)s"""


def write_deck(tmp_path, scheme="euler", backend="fused_structured",
               nx=128, ny=16, dx=1.0 / 64.0, fmt="none", bflux=7,
               left="inflow", flow="", physics="", numerics="", extra=""):
    mesh = structured_quad(
        nx, ny, 0.0, nx * dx, 0.0, ny * dx,
        region_fn=lambda cx, cy: np.where(cx < nx * dx / 2, 1, 2),
    )
    save_mesh_npz(mesh, os.path.join(tmp_path, "raster.npz"))
    path = os.path.join(tmp_path, f"raster_{scheme}_{backend}.yaml")
    with open(path, "w") as f:
        f.write(DECK % dict(scheme=scheme, backend=backend, format=fmt,
                            bflux=bflux, left=left, flow=flow, physics=physics,
                            numerics=numerics, extra=extra))
    return path


def run_both(path, setters=None):
    """Run the deck in both packages; `setters(sim)` is called on each
    after its second interval."""
    sims = (JaxSimulation(jax_load_config(path)),
            Simulation(load_config(path), device="cpu"))
    logs = ([], [])
    for sim, log in zip(sims, logs):
        while not sim.finished:
            sim.advance()
            log.append((sim.step, sim.dt, sim.t))
            if setters is not None and len(log) == 2:
                setters(sim)
    return sims, logs


def assert_runs_agree(js, ts, jlog, tlog, q_atol, accum_rtol):
    assert ts.step == js.step and tlog == jlog
    assert ts.t == js.t == ts.t_final
    qj = np.asarray(js.q)
    assert np.abs(ts.get_solution() - qj).max() <= q_atol
    for name in ("bflux_accum", "accum_sol", "accum_prim"):
        a, b = getattr(js, name), getattr(ts, name)
        assert np.abs(a - b).max() <= accum_rtol * np.abs(a).max(), name
    assert ts.accum_time == pytest.approx(js.accum_time, rel=1e-6)
    cj, ct = (js.get_courant_number_diagnostics(),
              ts.get_courant_number_diagnostics())
    assert ct[0] == pytest.approx(cj[0], rel=1e-5) and ct[0] > 0.0
    assert ct[1:] == cj[1:] == (-1, -1)


def fused_run_matches_jax(tmp_path, scheme, setters=None):
    """The fused raster deck in both packages (shared with the scheme
    tests)."""
    (js, ts), (jlog, tlog) = run_both(write_deck(tmp_path, scheme), setters)
    assert ts._structured["kind"] == "fused"
    assert_runs_agree(js, ts, jlog, tlog, 2e-6, 1e-5)
    assert np.abs(ts.bflux_accum).max() > 0.0
    return js, ts


def test_fused_euler_and_setters_match_jax(tmp_path):
    n = np.random.default_rng(3).uniform(0.01, 0.03, 128 * 16)
    nb = 16

    def setters(sim):
        sim.set_manning_n(n)
        sim.set_domain_water_source(2e-3)
        sim.set_flow_dirichlet_boundary_values(
            "left", np.stack([np.full(nb, 0.3), np.full(nb, 0.02),
                              np.zeros(nb)]))

    js, ts = fused_run_matches_jax(tmp_path, "euler", setters)
    assert np.array_equal(ts._structured["op"].mannings_n.numpy(),
                          n.reshape(16, 128).astype(np.float32))
    assert ts._structured["with_src"]


def test_unaligned_fused_deck_falls_back_to_structured(tmp_path):
    path = write_deck(tmp_path, nx=24, dx=0.0625, bflux=0, left="wall")
    for sim in (JaxSimulation(jax_load_config(path)),
                Simulation(load_config(path), device="cpu")):
        assert sim._structured["kind"] == "xla"


@pytest.mark.parametrize("deck", [
    dict(dx=0.002),  # centroid spacings not exact: not taken as a raster
    dict(backend="structured"),  # Dirichlet wall, boundary-flux series
    dict(backend="structured", left="wall", scheme="ssprk3", bflux=0),
    dict(flow=", source: {method: implicit_xq2018}"),
    dict(scheme="ark_imex"),
    dict(flow=", well_balancing: hydrostatic_reconstruction"),
    # MUSCL: not on the structured kind, nor with tracers
    dict(backend="structured", left="wall", bflux=0,
         numerics=", second_order: true"),
    dict(numerics=", second_order: true", physics=", salinity: true"),
    # RCM reorders the raster, which is then no row-major raster
    dict(scheme="beuler", numerics=", cell_ordering: rcm"),
])
def test_config_errors_of_both_packages(tmp_path, deck):
    path = write_deck(tmp_path, **deck)
    with pytest.raises(JaxConfigError):
        JaxSimulation(jax_load_config(path))
    with pytest.raises(ConfigError):
        Simulation(load_config(path), device="cpu")


def test_momentum_sources_are_refused_on_the_fused_raster(tmp_path):
    path = write_deck(tmp_path, bflux=0,
                      extra="sources: [{region: reservoir, flow: push}]\n")
    for sim, error in ((JaxSimulation(jax_load_config(path)), JaxConfigError),
                       (Simulation(load_config(path), device="cpu"),
                        ConfigError)):
        with pytest.raises(error, match="row 0"):
            sim.advance()


@pytest.mark.parametrize("deck", [
    # the unstructured path in shards runs BS2002 (first and second order)
    # and beuler since they were ported; beuler in row strips stays the
    # ConfigError of test_config_errors_of_both_packages
    dict(backend="xla", numerics=", second_order: true",
         flow=", well_balancing: bs2002",
         extra="parallel: {n_devices: 2}\n"),
    dict(scheme="beuler", backend="xla", extra="parallel: {n_devices: 2}\n"),
    dict(backend="xla", flow=", well_balancing: bs2002",
         extra="parallel: {n_devices: 2}\n"),
])
def test_unported_raster_features_raise(tmp_path, deck, monkeypatch):
    """These decks, refused in shards until BS2002 and beuler were
    ported, run in 2 shards (partitioning: auto, RCM) and give the single
    device on the same RCM order: 8 steps bit for bit, beuler's 2 steps
    (a Newton iteration of GMRES(2)) to 1e-12."""
    monkeypatch.setattr(timestepping, "NEWTON_ITERS", 1)
    monkeypatch.setattr(timestepping, "KRYLOV_M", 2)
    beuler = deck.get("scheme") == "beuler"
    steps = {"time.stop_n": 2 if beuler else 8}
    path = write_deck(tmp_path, bflux=0, **deck)
    sims = []
    for extra in (None, {"numerics.cell_ordering": "rcm",
                         "parallel.n_devices": 1}):
        sim = Simulation(load_config(path, dict(steps, **(extra or {}))),
                         device="cpu")
        sim.run()
        sims.append(sim)
    two, one = sims
    assert two._sharded is not None and one._sharded is None
    assert two.step == one.step == steps["time.stop_n"]
    np.testing.assert_array_equal(two.get_natural_ids(),
                                  one.get_natural_ids())
    if beuler:
        np.testing.assert_allclose(two.get_solution(), one.get_solution(),
                                   rtol=0, atol=1e-12)
    else:
        np.testing.assert_array_equal(two.get_solution(),
                                      one.get_solution())
        assert two.t == one.t


def test_cli_runs_a_raster_deck_on_cpu(tmp_path):
    path = write_deck(tmp_path, fmt="binary")
    out = os.path.join(tmp_path, "out")
    assert cli_main([path, "--cpu", "--output-dir", out]) == 0
    files = sorted(os.listdir(out))
    assert any(f.endswith(".bin") for f in files)
    with open(os.path.join(out, "boundary_fluxes.dat")) as f:
        rows = [line.split() for line in f if not line.startswith("#")]
    assert {r[1] for r in rows} >= {"left", "right"}
    assert all(np.isfinite(float(x)) for r in rows for x in r[2:])
