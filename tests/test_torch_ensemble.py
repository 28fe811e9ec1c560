"""The port's ensembles (rdycore_tpu_torch/ensemble.py) against the JAX
package's, f64 on the CPU.

`member_config` gives the JAX package's member decks field for field
(overrides matched by name and appended where absent, the grid replaced
only where a member names a file, the output under the member's name,
the member's own ensemble emptied). A two-member shared-grid ensemble of
a small dam break (member 1 with another Manning's n and a deeper
reservoir, adaptive dt on) runs against the JAX package's
EnsembleSimulation on its XLA backend: the members' states, times, steps,
dt and accumulators within 1e-12. Every member steps with member 0's dt
(ROADMAP fault 25): member 0 equals a solo Simulation of its deck, member
1 does not under adaptive dt, and with a fixed dt each member equals its
solo run. Monitors run once per interval per member. The distinct-grid
path runs each member's own Simulation. `devices=` places the members.
"""

import dataclasses
import os

import numpy as np
import pytest

from rdycore_tpu.config.yaml_input import load_config as jax_load_config
from rdycore_tpu.ensemble import EnsembleSimulation as JaxEnsemble
from rdycore_tpu.ensemble import member_config as jax_member_config
from rdycore_tpu_torch import Simulation, load_config
from rdycore_tpu_torch.config.schema import ConfigError
from rdycore_tpu_torch.ensemble import EnsembleSimulation, member_config
from rdycore_tpu_torch.mesh import save_mesh_npz, structured_quad

DECK = """
physics: {flow: {mode: swe}}
numerics: {spatial: fv, temporal: euler, riemann: roe, precision: double}
logging: {level: none}
time: {stop: 0.04, unit: seconds, time_step: %(dt)s, coupling_interval: 0.01,
       adaptive: {enable: %(adaptive)s, target_courant_number: 0.1,
                  max_increase_factor: 1.5, initial_time_step: %(dt)s}}
output: {format: none, directory: out,
         time_series: {boundary_fluxes: 3}}
grid: {file: dam.npz}
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
boundaries: [{name: right, grid_boundary_id: 2}]
boundary_conditions: [{boundaries: [right], flow: outflow}]
flow_conditions:
  - {name: column, type: dirichlet, height: 0.5, x_momentum: 0, y_momentum: 0}
  - {name: wet_bed, type: dirichlet, height: 0.1, x_momentum: 0, y_momentum: 0}
  - {name: outflow, type: critical-outflow}
ensemble:
  size: 2
  members:
    - {name: gentle}
    - materials: [{name: smooth, properties: {manning: {value: 0.03}}}]
      flow_conditions:
        - {name: column, type: dirichlet, height: 0.7, x_momentum: 0,
           y_momentum: 0}
        - {name: extra, type: dirichlet, height: 0.2}
%(grid)s"""


def write_deck(tmp_path, adaptive=True, distinct=False):
    """The dam break on 16 x 8 quads (dam.npz; dam2.npz, 12 x 6 quads, for
    member 1 when `distinct`), dt 0.001 s, or adaptive from 0.01 s to a
    Courant number of 0.1 (which both members exceed at first, each by its
    own amount); the deck's path."""
    for name, (nx, ny) in (("dam.npz", (16, 8)), ("dam2.npz", (12, 6))):
        mesh = structured_quad(nx, ny, 0.0, 4.0, 0.0, 2.0, region_fn=lambda
                               cx, cy: np.where(cx < 2.0, 1, 2))
        mesh.boundaries["__id_2"] = mesh.boundaries["right"]
        save_mesh_npz(mesh, str(tmp_path / name))
    grid = "      grid: {file: dam2.npz}\n" if distinct else ""
    path = str(tmp_path / f"ens_{adaptive}_{distinct}.yaml")
    with open(path, "w") as f:
        f.write(DECK % dict(adaptive=str(adaptive).lower(), grid=grid,
                            dt=0.01 if adaptive else 0.001))
    return path


def test_member_config_matches_jax(tmp_path):
    deck = write_deck(tmp_path, distinct=True)
    cfg, jcfg = load_config(deck), jax_load_config(deck)
    for i in range(2):
        got = dataclasses.asdict(member_config(cfg, i))
        want = dataclasses.asdict(jax_member_config(jcfg, i))
        assert got == want
    m0, m1 = member_config(cfg, 0), member_config(cfg, 1)
    assert m0.output.directory.endswith(os.path.join("out", "gentle"))
    assert m1.output.directory.endswith(os.path.join("out", "member_1"))
    assert m1.materials[0].properties.manning.value == 0.03
    assert [c.name for c in m1.flow_conditions] == [
        "column", "wet_bed", "outflow", "extra"]
    assert m1.grid.file == "dam2.npz" and m0.grid.file == "dam.npz"
    assert m0.ensemble.size == 0 and not m0.ensemble.members


def test_no_ensemble_section_raises(tmp_path):
    cfg = load_config(write_deck(tmp_path))
    cfg.ensemble.size = 0
    with pytest.raises(ConfigError, match="no ensemble section"):
        EnsembleSimulation(cfg, device="cpu")


@pytest.fixture(scope="module")
def adaptive_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ens")
    deck = write_deck(tmp)
    jens = JaxEnsemble(jax_load_config(deck))
    assert jens.vmapped
    jens.run()
    calls = [[], []]
    ens = EnsembleSimulation(load_config(deck), device="cpu")
    for m, log in zip(ens.members, calls):
        m.add_monitor(lambda sim, log=log: log.append(sim.step))
    ens.run()
    solos = []
    for i in range(2):
        solo = Simulation(member_config(load_config(deck), i), device="cpu")
        solo.run()
        solos.append(solo)
    return dict(jax=jens, port=ens, calls=calls, solos=solos, deck=deck)


def test_shared_grid_ensemble_matches_jax(adaptive_runs):
    ens, jens = adaptive_runs["port"], adaptive_runs["jax"]
    assert ens.shared_grid and ens.finished
    for m, jm in zip(ens.members, jens.members):
        np.testing.assert_allclose(m.get_solution(), jm.get_solution(),
                                   rtol=0, atol=1e-12)
        assert m.step == jm.step and m.t == pytest.approx(jm.t, abs=1e-15)
        assert m.dt == pytest.approx(jm.dt, rel=1e-12)
        assert m.prev_max_courant == pytest.approx(jm.prev_max_courant,
                                                   rel=1e-12)
        for name in ("bflux_accum", "accum_sol", "accum_prim"):
            np.testing.assert_allclose(getattr(m, name), getattr(jm, name),
                                       rtol=0, atol=1e-12)
        assert m.accum_time == pytest.approx(jm.accum_time, rel=1e-12)
        assert m.prev_courant_edge is None  # not updated, as in the JAX one
    h0, h1 = (m.get_height() for m in ens.members)
    assert not np.allclose(h0, h1)


def test_member_0_dt_for_all_fault_25(adaptive_runs):
    """Member 1 adapts its own dt but steps with member 0's: it does not
    equal its solo run (ROADMAP fault 25); member 0 does."""
    ens, solos = adaptive_runs["port"], adaptive_runs["solos"]
    m0, m1 = ens.members
    np.testing.assert_allclose(m0.get_solution(), solos[0].get_solution(),
                               rtol=0, atol=1e-12)
    assert m0.step == solos[0].step and m1.step == m0.step
    assert m1.dt != m0.dt and solos[1].dt != m0.dt
    assert not np.allclose(m1.get_solution(), solos[1].get_solution())


def test_monitors_once_per_interval(adaptive_runs):
    """The solo runs call monitors every boundary_fluxes chunk (3 steps);
    the ensemble once per interval per member."""
    ens, calls = adaptive_runs["port"], adaptive_runs["calls"]
    assert calls[0] == calls[1] and len(calls[0]) == 4
    assert calls[0][-1] == ens.members[0].step


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]])
def test_fixed_dt_members_equal_solo_runs(tmp_path, devices):
    deck = write_deck(tmp_path, adaptive=False)
    ens = EnsembleSimulation(load_config(deck), device="cpu", devices=devices)
    assert [str(d) for d in ens.devices] == ["cpu", "cpu"]
    ens.run()
    for i, m in enumerate(ens.members):
        solo = Simulation(member_config(load_config(deck), i), device="cpu")
        solo.run()
        assert m.step == solo.step == 40 and m.t == pytest.approx(solo.t)
        np.testing.assert_allclose(m.get_solution(), solo.get_solution(),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(m.bflux_accum, solo.bflux_accum, rtol=0,
                                   atol=1e-12)


def test_distinct_grids_run_each_member(tmp_path):
    deck = write_deck(tmp_path, distinct=True)
    ens = EnsembleSimulation(load_config(deck), device="cpu")
    assert not ens.shared_grid
    assert [m.num_cells for m in ens.members] == [128, 72]
    ens.run()
    assert ens.finished
    for i, m in enumerate(ens.members):
        solo = Simulation(member_config(load_config(deck), i), device="cpu")
        solo.run()
        assert m.step == solo.step
        np.testing.assert_array_equal(m.get_solution(), solo.get_solution())


def test_devices_must_name_every_member(tmp_path):
    with pytest.raises(ValueError, match="names 1 devices"):
        EnsembleSimulation(load_config(write_deck(tmp_path)), devices=["cpu"])


def test_simulation_runs_the_base_deck(tmp_path):
    """A Simulation given a deck with an ensemble section runs the base
    configuration, as the JAX package's does."""
    deck = write_deck(tmp_path, adaptive=False)
    sim = Simulation(load_config(deck), device="cpu")
    sim.run()
    base = Simulation(member_config(load_config(deck), 0), device="cpu")
    base.run()
    np.testing.assert_array_equal(sim.get_solution(), base.get_solution())
