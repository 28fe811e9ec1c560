"""Four ranks over gloo on the CPU (`parallel.comm.spawn`, a FileStore in
the test's tmp_path): a raster deck (`fused_structured`,
`parallel.n_devices: 4`) in one row strip per rank, each strip's buffer
kept by its rank across intervals and its halo rows moved between ranks
(ops/strips.RankStrip), and the unstructured dam break of
tests/test_torch_dist_gloo.py in one shard per rank.

Each is bit for bit the one-process run of the same deck (the row strips,
the in-process shards): the dt sequence of the adaptive raster deck, the
state, the time, the Courant diagnostics and the accumulators, the
boundary fluxes through the raster's end strips included, on every rank.
Port only.
"""

import os

import numpy as np
import pytest
import torch

from rdycore_tpu_torch import Simulation, load_config
from rdycore_tpu_torch.mesh import save_mesh_npz, structured_quad
from rdycore_tpu_torch.parallel.comm import spawn

from test_torch_dist_gloo import assert_same_run, run_deck, write_deck

RASTER = """
physics: {flow: {mode: swe}}
numerics: {spatial: fv, temporal: ssprk2, riemann: roe,
           edge_flux_backend: fused_structured}
logging: {level: none}
time:
  stop: 0.03125
  unit: seconds
  coupling_interval: 0.00390625
  adaptive: {enable: true, target_courant_number: 0.7,
             max_increase_factor: 1.3, initial_time_step: 0.00048828125}
output:
  format: none
  time_series: {boundary_fluxes: 7}
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
  - {boundaries: [left], flow: inflow}
flow_conditions:
  - {name: column, type: dirichlet, height: 0.25, x_momentum: 0, y_momentum: 0}
  - {name: wet_bed, type: dirichlet, height: 0.05, x_momentum: 0, y_momentum: 0}
  - {name: outflow, type: critical-outflow}
  - {name: inflow, type: dirichlet, height: 0.25, x_momentum: 0.01, y_momentum: 0}
parallel: {n_devices: 4}
"""


def write_raster(d):
    """The 128 x 32 dam break of 1/64 m cells of the port's strip tests."""
    dx = 1.0 / 64.0
    mesh = structured_quad(128, 32, 0.0, 128 * dx, 0.0, 32 * dx,
                           region_fn=lambda cx, cy: np.where(
                               cx < 64 * dx, 1, 2))
    save_mesh_npz(mesh, os.path.join(d, "raster.npz"))
    path = os.path.join(d, "raster.yaml")
    with open(path, "w") as f:
        f.write(RASTER)
    return path


def run_raster(path):
    sim = Simulation(load_config(path), device="cpu")
    log = []
    while not sim.finished:
        sim.advance()
        log.append((sim.step, sim.dt, sim.t, sim.prev_max_courant))
    return dict(q=sim.get_solution(), log=log, bflux=sim.bflux_accum,
                accum_sol=sim.accum_sol, accum_prim=sim.accum_prim,
                rank_strip=sim._rank_strip is not None)


def ranks_of_four(rank, world, raster, deck):
    torch.set_num_threads(1)
    return dict(raster=run_raster(raster), shards=run_deck(deck))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("gloo4"))
    raster, deck = write_raster(d), write_deck(d, "euler4", 4)
    got = spawn(ranks_of_four, 4, "gloo", d, args=(raster, deck),
                timeout=120)
    return dict(got=got, raster=raster, deck=deck)


def test_four_rank_strips_are_the_one_process_strips(four):
    want = run_raster(four["raster"])
    assert not want["rank_strip"]
    assert np.abs(want["bflux"]).max() > 0.0
    for r in four["got"]:
        got = r["raster"]
        assert got["rank_strip"]
        assert got["log"] == want["log"]
        for k in ("q", "bflux", "accum_sol", "accum_prim"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_four_rank_shards_are_the_one_process_shards(four):
    want = run_deck(four["deck"])
    for r in four["got"]:
        assert_same_run(r["shards"], want)
