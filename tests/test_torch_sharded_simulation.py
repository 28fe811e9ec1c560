"""`Simulation` with `parallel.n_devices: 4` on the unstructured path: the
port's shards in one process against the JAX package's sharded
`Simulation` (its shard_map over 4 of the 8 host devices of
tests/conftest.py) on a dam break this test writes, in float64 on the CPU.

Both packages reorder the cells by RCM (`parallel.partitioning: auto`),
so the states are compared in natural order, within 1e-12. The port's
shards are its single-device run on the same RCM order bit for bit: the
state, the accumulators, the Courant diagnostics and the boundary-flux
time series, while the JAX package's sharded run writes zeros there: its sharded
advance never updates the accumulators (ROADMAP fault 27). BS2002 in 2
shards is its single-device run bit for bit, and beuler agrees with it
to 1e-12.
"""

import os

import numpy as np
import pytest

from rdycore_tpu.config.yaml_input import load_config as jax_load_config
from rdycore_tpu.io.writers import (
    attach_output_monitors as jax_attach_output_monitors,
)
from rdycore_tpu.mesh import structured_tri
from rdycore_tpu.mesh.core import save_mesh_npz
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, load_config, timestepping
from rdycore_tpu_torch.io.writers import attach_output_monitors

DECK = """
physics: {flow: {mode: swe%(flow)s}}
numerics: {spatial: fv, temporal: %(scheme)s, riemann: roe,
           precision: double%(numerics)s}
logging: {level: none}
time: {stop_n: 24, unit: seconds, time_step: 0.002,
       coupling_interval: 0.008}
output:
  format: none
  directory: %(out)s
  time_series: {boundary_fluxes: 4}
grid: {file: valley.npz}
regions:
  - {name: reservoir, grid_region_id: 1}
  - {name: floodplain, grid_region_id: 2}
surface_composition:
  - {region: reservoir, material: smooth}
  - {region: floodplain, material: smooth}
materials: [{name: smooth, properties: {manning: {value: 0.02}}}]
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
  - {name: column, type: dirichlet, height: 0.5, x_momentum: 0, y_momentum: 0}
  - {name: wet_bed, type: dirichlet, height: 0.1, x_momentum: 0, y_momentum: 0}
  - {name: outflow, type: critical-outflow}
  - {name: inflow, type: dirichlet, height: 0.5, x_momentum: 0.05, y_momentum: 0}
%(extra)s"""


def write_deck(tmp_path, name, scheme="euler", flow="", extra="",
               numerics=""):
    mesh_path = os.path.join(tmp_path, "valley.npz")
    if not os.path.exists(mesh_path):
        mesh = structured_tri(
            20, 10, 0.0, 2.0, 0.0, 1.0,
            z_fn=lambda x, y: 0.01 * np.sin(3 * x) * np.cos(2 * y))
        cx = mesh.cell_centroid[:, 0]
        mesh.regions = {"__id_1": np.nonzero(cx < 0.8)[0].astype(np.int32),
                        "__id_2": np.nonzero(cx >= 0.8)[0].astype(np.int32)}
        save_mesh_npz(mesh, mesh_path)
    out = os.path.join(tmp_path, f"out_{name}")
    path = os.path.join(tmp_path, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(DECK % dict(scheme=scheme, flow=flow, extra=extra, out=out,
                            numerics=numerics))
    return path, out


def natural(sim):
    q = np.empty_like(sim.get_solution())
    q[:, np.asarray(sim.get_natural_ids())] = sim.get_solution()
    return q


def run(sim, attach):
    attach(sim)
    while not sim.finished:
        sim.advance()
    return sim


def series(out):
    with open(os.path.join(out, "boundary_fluxes.dat")) as f:
        return [line.split() for line in f if not line.startswith("#")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sharded_sim"))
    four = "parallel: {n_devices: 4}\n"
    p1, o1 = write_deck(tmp, "one", numerics=", cell_ordering: rcm")
    p4, o4 = write_deck(tmp, "four", extra=four)
    pj, oj = write_deck(tmp, "jax_four", extra=four)
    one = run(Simulation(load_config(p1), device="cpu"),
              attach_output_monitors)
    sharded = run(Simulation(load_config(p4), device="cpu"),
                  attach_output_monitors)
    jax = run(JaxSimulation(jax_load_config(pj)), jax_attach_output_monitors)
    return dict(one=one, sharded=sharded, jax=jax, o1=o1, o4=o4, oj=oj)


def test_shards_match_the_jax_simulation(runs):
    sh, jx = runs["sharded"], runs["jax"]
    assert sh._sharded is not None and sh._sharded.P == 4
    assert jx._sharded is not None
    assert sh.step == jx.step == 24
    assert sh.t == pytest.approx(jx.t, abs=1e-15)
    np.testing.assert_allclose(natural(sh), natural(jx), rtol=0, atol=1e-12)
    # both reorder by RCM for the shard split
    np.testing.assert_array_equal(sh.get_natural_ids(), jx.get_natural_ids())


def test_shards_are_the_single_device_run_on_its_rcm_order(runs):
    """The single-device deck under cell_ordering: rcm has the shards'
    cell and edge order: the state, the accumulators, the Courant
    diagnostics and the boundary-flux series file are its own, bit for
    bit."""
    one, sh = runs["one"], runs["sharded"]
    np.testing.assert_array_equal(sh.get_natural_ids(), one.get_natural_ids())
    np.testing.assert_array_equal(sh.get_solution(), one.get_solution())
    for name in ("bflux_accum", "accum_sol", "accum_prim"):
        np.testing.assert_array_equal(getattr(sh, name), getattr(one, name))
    assert (sh.get_courant_number_diagnostics()
            == one.get_courant_number_diagnostics())
    with open(os.path.join(runs["o1"], "boundary_fluxes.dat")) as a, \
            open(os.path.join(runs["o4"], "boundary_fluxes.dat")) as b:
        assert a.read() == b.read()


def test_boundary_flux_series_fault_27(runs):
    port, jax = series(runs["o4"]), series(runs["oj"])
    assert len(port) == len(jax) == 3 * 24 // 4  # 3 boundaries
    # the JAX package's sharded run accumulates nothing
    assert all(float(x) == 0.0 for r in jax for x in r[2:])
    assert not np.any(runs["jax"].bflux_accum)
    # the port's shards do: in the water rows, inflow and outflow
    water = {r[1]: [float(x[2]) for x in port if x[1] == r[1]]
             for r in port}
    assert min(water["left"]) < 0.0 < max(water["right"])


def test_boundary_flux_series_is_the_single_device_one(tmp_path):
    """Without RCM (partitioning: none) the boundary edges keep their
    order, and the series of 4 shards is the single-device file byte for
    byte; so are the accumulators."""
    p1, o1 = write_deck(str(tmp_path), "one")
    p4, o4 = write_deck(str(tmp_path), "four", extra=(
        "parallel: {n_devices: 4, partitioning: none}\n"))
    one = run(Simulation(load_config(p1), device="cpu"),
              attach_output_monitors)
    sh = run(Simulation(load_config(p4), device="cpu"),
             attach_output_monitors)
    for name in ("boundary_fluxes.dat",):
        with open(os.path.join(o1, name)) as a, \
                open(os.path.join(o4, name)) as b:
            assert a.read() == b.read()
    for name in ("bflux_accum", "accum_sol", "accum_prim"):
        np.testing.assert_array_equal(getattr(sh, name), getattr(one, name))
    np.testing.assert_array_equal(sh.get_solution(), one.get_solution())
    assert (sh.get_courant_number_diagnostics()
            == one.get_courant_number_diagnostics())


@pytest.mark.parametrize("deck", [
    dict(flow=", well_balancing: bs2002"),
    dict(scheme="beuler"),
])
def test_what_shards_do_not_run_raises(tmp_path, deck, monkeypatch):
    """BS2002 and beuler, refused in shards until they were ported, now
    run there: 2 shards (RCM, partitioning: auto) against the single
    device on the same RCM order, BS2002 over the deck's 24 steps bit for
    bit, beuler over 2 steps (a Newton iteration of GMRES(2)) to 1e-12
    (its inner products add per-shard partials)."""
    monkeypatch.setattr(timestepping, "NEWTON_ITERS", 1)
    monkeypatch.setattr(timestepping, "KRYLOV_M", 2)
    steps = {"time.stop_n": 2} if deck.get("scheme") == "beuler" else None
    p2, _ = write_deck(str(tmp_path), "two",
                       extra="parallel: {n_devices: 2}\n", **deck)
    p1, _ = write_deck(str(tmp_path), "one",
                       numerics=", cell_ordering: rcm", **deck)
    two = run(Simulation(load_config(p2, steps), device="cpu"),
              attach_output_monitors)
    one = run(Simulation(load_config(p1, steps), device="cpu"),
              attach_output_monitors)
    assert two._sharded is not None and two._sharded.P == 2
    assert two.step == one.step == (2 if steps else 24)
    np.testing.assert_array_equal(two.get_natural_ids(),
                                  one.get_natural_ids())
    q2, q1 = two.get_solution(), one.get_solution()
    assert np.abs(q1[0] - 0.1).max() > 1e-3  # the dam broke
    if steps:
        np.testing.assert_allclose(q2, q1, rtol=0, atol=1e-12)
    else:
        np.testing.assert_array_equal(q2, q1)
        np.testing.assert_array_equal(two.bflux_accum, one.bflux_accum)
        assert (two.get_courant_number_diagnostics()
                == one.get_courant_number_diagnostics())
