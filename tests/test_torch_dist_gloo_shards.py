"""BS2002 and AMR in 2 ranks over gloo on the CPU (`parallel.comm.spawn`,
a FileStore in the test's tmp_path), one shard of the unstructured path
per rank (parallel/comm.DistTransport), f64:

- BS2002 on a bumpy bed, first order (euler) and second order (MUSCL,
  ssprk2): bit for bit the one-process run of the same deck (its 2 shards
  in this process), state, time, step, Courant diagnostics and
  accumulators, on every rank;
- AMR mid-run (`partitioning: none`): the refined mesh partitioned again
  over the same process group, bit for bit the one-process run after the
  next interval;
- a rebuild of a raster deck in one row strip per rank on a refined mesh:
  the ConfigError of a mesh that is no raster, as on one device.

beuler on the deck's mesh is in tests/test_torch_dist_gloo_beuler.py.
Port only: the ranks import neither JAX nor the JAX package.
"""

import os

import numpy as np
import pytest
import torch

from rdycore_tpu_torch import Simulation, load_config
from rdycore_tpu_torch.amr import refine_marked
from rdycore_tpu_torch.config.schema import ConfigError
from rdycore_tpu_torch.mesh import save_mesh_npz, structured_tri
from rdycore_tpu_torch.parallel.comm import spawn

from test_torch_dist_gloo_strips import write_raster
from test_torch_sharded_amr import refine_mid_run

DECK = """
physics: {flow: {mode: swe%(flow)s}}
numerics: {spatial: fv, temporal: %(scheme)s, riemann: roe,
           precision: double%(numerics)s}
logging: {level: none}
time: {stop_n: %(steps)d, unit: seconds, time_step: 0.002,
       coupling_interval: 0.008}
output:
  format: none
  time_series: {boundary_fluxes: 4}
grid: {file: bumpy.npz}
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
  - {name: wet_bed, type: dirichlet, height: 0.2, x_momentum: 0, y_momentum: 0}
  - {name: outflow, type: critical-outflow}
  - {name: inflow, type: dirichlet, height: 0.5, x_momentum: 0.05, y_momentum: 0}
parallel: {n_devices: %(P)d, partitioning: none}
"""

DECKS = {  # name: (flow, scheme, numerics, steps)
    "bs2002": (", well_balancing: bs2002", "euler", "", 16),
    "bs2002_muscl": (", well_balancing: bs2002", "ssprk2",
                     ", second_order: true", 16),
    "beuler": ("", "beuler", "", 2),
}


def write_deck(d, name, P):
    """The deck `name` on structured_tri(20, 10) over 2 m x 1 m with a
    bumpy bed, in P shards."""
    mesh_path = os.path.join(d, "bumpy.npz")
    if not os.path.exists(mesh_path):
        mesh = structured_tri(
            20, 10, 0.0, 2.0, 0.0, 1.0,
            z_fn=lambda x, y: 0.05 * np.sin(6 * x) * np.cos(4 * y))
        cx = mesh.cell_centroid[:, 0]
        mesh.regions = {"__id_1": np.nonzero(cx < 0.8)[0].astype(np.int32),
                        "__id_2": np.nonzero(cx >= 0.8)[0].astype(np.int32)}
        save_mesh_npz(mesh, mesh_path)
    flow, scheme, numerics, steps = DECKS[name]
    path = os.path.join(d, f"{name}_{P}.yaml")
    with open(path, "w") as f:
        f.write(DECK % dict(flow=flow, scheme=scheme, numerics=numerics,
                            steps=steps, P=P))
    return path


def run_deck(path):
    sim = Simulation(load_config(path), device="cpu")
    sim.run()
    return dict(q=sim.get_solution(), t=sim.t, step=sim.step,
                courant=sim.get_courant_number_diagnostics(),
                bflux=sim.bflux_accum, accum_sol=sim.accum_sol,
                sharded=sim._sharded is not None)


def strip_rebuild_error(raster):
    """The error of a rank strip's rebuild on the refined raster mesh."""
    sim = Simulation(load_config(raster, {"parallel.n_devices": 2}),
                     device="cpu")
    assert sim._rank_strip is not None
    marked = np.zeros(sim.mesh.num_cells, bool)
    marked[:8] = True
    mesh, parent = refine_marked(sim.mesh, marked)
    try:
        sim.rebuild_on_mesh(mesh, sim.mannings_n[parent])
    except ConfigError as e:
        return str(e)
    return None


def ranks(rank, world, decks, raster):
    torch.set_num_threads(1)
    out = {name: run_deck(path) for name, path in decks.items()}
    sim, got = refine_mid_run("tri", world)
    out["amr"] = dict(got, sharded=sim._sharded is not None,
                      transport=type(sim._sharded.transport).__name__)
    out["strip"] = strip_rebuild_error(raster)
    return out


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("gloo_shards"))
    decks = {name: write_deck(d, name, 2) for name in ("bs2002",
                                                       "bs2002_muscl")}
    raster = write_raster(d)
    got = spawn(ranks, 2, "gloo", d, args=(decks, raster), timeout=120)
    return dict(got=got, decks=decks, d=d, raster=raster)


def assert_same_run(got, want):
    assert got["sharded"] and want["sharded"]
    for k in ("q", "bflux", "accum_sol"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["t"], got["step"], got["courant"]) == (
        want["t"], want["step"], want["courant"])


@pytest.mark.parametrize("name", ["bs2002", "bs2002_muscl"])
def test_two_ranks_are_the_one_process_shards(two, name):
    want = run_deck(two["decks"][name])
    for rank in two["got"]:
        assert_same_run(rank[name], want)


def test_amr_over_the_ranks_is_the_one_process_run(two):
    _, want = refine_mid_run("tri", 2)
    for rank in two["got"]:
        got = rank["amr"]
        assert got["sharded"] and got["transport"] == "DistTransport"
        np.testing.assert_array_equal(got["after"]["q"], want["after"]["q"])
        np.testing.assert_array_equal(got["end"], want["end"])
        assert (got["t"], got["step"]) == (want["t"], want["step"])


def test_a_rank_strip_rebuild_is_the_raster_config_error(two):
    sim = Simulation(load_config(two["raster"], {"parallel.n_devices": 1}),
                     device="cpu")
    marked = np.zeros(sim.mesh.num_cells, bool)
    marked[:8] = True
    mesh, parent = refine_marked(sim.mesh, marked)
    with pytest.raises(ConfigError) as one:
        sim.rebuild_on_mesh(mesh, sim.mannings_n[parent])
    assert [r["strip"] for r in two["got"]] == [str(one.value)] * 2
