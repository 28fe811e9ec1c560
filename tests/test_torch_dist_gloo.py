"""Multi-process runs of rdycore_tpu_torch on the CPU: 2 ranks over gloo,
each joined to a process group over a FileStore in the test's tmp_path
(`parallel.comm.spawn`, the spawn start method; no TCP port), one shard
of the unstructured path per rank (parallel/comm.DistTransport).

Against the one-process run of the same deck (its shards in this
process): bit for bit the state, the time and step, the Courant
diagnostics (maximum, edge, cell) and the accumulators, on every rank,
at first order (euler) and at second order (MUSCL, ssprk2, the 3-ring
halo), and at first order with the state and the accumulators read after
every interval (each read gathers from the ranks). The halo of each
rank's shard (3 rings, MUSCL) holds the owners' rows both ways,
gloo's point-to-point buffers and NCCL's one all-gather. A deck whose
parallel.n_devices is not the world size raises a ConfigError. The CLI
under a 2-rank group writes one output set, from
rank 0: the binary snapshots and the boundary-flux series of the
one-process CLI run, byte for byte, each line once. The 4-rank runs are
in tests/test_torch_dist_gloo_strips.py.

Port only: the ranks import neither JAX nor the JAX package.
"""

import os

import numpy as np
import pytest
import torch

from rdycore_tpu_torch import Simulation, load_config
from rdycore_tpu_torch.__main__ import main as cli_main
from rdycore_tpu_torch.config.schema import ConfigError
from rdycore_tpu_torch.mesh import save_mesh_npz, structured_tri
from rdycore_tpu_torch.parallel.comm import spawn

DECK = """
physics: {flow: {mode: swe}}
numerics: {spatial: fv, temporal: %(scheme)s, riemann: roe,
           precision: double%(numerics)s}
logging: {level: none}
time: {stop_n: 16, unit: seconds, time_step: 0.002,
       coupling_interval: 0.008}
output:
  format: %(fmt)s
  output_interval: 8
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
parallel: {n_devices: %(P)d}
"""


def write_deck(d, name, P, scheme="euler", numerics="", fmt="none"):
    """A dam break on structured_tri(20, 10) over 2 m x 1 m in directory
    d, with an inflow wall and critical outflow, in P shards."""
    os.makedirs(d, exist_ok=True)
    mesh_path = os.path.join(d, "valley.npz")
    if not os.path.exists(mesh_path):
        mesh = structured_tri(20, 10, 0.0, 2.0, 0.0, 1.0)
        cx = mesh.cell_centroid[:, 0]
        mesh.regions = {"__id_1": np.nonzero(cx < 0.8)[0].astype(np.int32),
                        "__id_2": np.nonzero(cx >= 0.8)[0].astype(np.int32)}
        save_mesh_npz(mesh, mesh_path)
    path = os.path.join(d, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(DECK % dict(scheme=scheme, numerics=numerics, fmt=fmt, P=P))
    return path


def run_deck(path, peek=False):
    """The deck's run: what the ranks and this process compare. With
    `peek`, the state and the accumulators are read after every
    interval."""
    sim = Simulation(load_config(path), device="cpu")
    while not sim.finished:
        sim.advance()
        if peek:
            sim.get_solution(), sim.bflux_accum, sim.accum_prim
    return dict(q=sim.get_solution(), t=sim.t, step=sim.step,
                courant=sim.get_courant_number_diagnostics(),
                natural=sim.get_natural_ids(), bflux=sim.bflux_accum,
                accum_sol=sim.accum_sol, sharded=sim._sharded is not None)


def assert_same_run(got, want):
    assert got["sharded"] and want["sharded"]
    for k in ("q", "natural", "bflux", "accum_sol"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["t"], got["step"], got["courant"]) == (
        want["t"], want["step"], want["courant"])


def halos_fill_the_ghosts(path):
    """Whether both ways of the halo fill this rank's ghost rows with the
    owners' rows of the global state (point-to-point, then the all-gather
    into rows set to -1)."""
    sim = Simulation(load_config(path), device="cpu")
    sh = sim._sharded
    u, tr = sh.units[0], sh.transport
    plan, q = sh.plans[u], sim._qs[u]
    rows = torch.arange(plan.nown, plan.nown + len(plan.ghosts))
    want = sim.q[:, torch.as_tensor(plan.ghosts)]
    q[:, rows] = -1.0
    tr.exchange(u, q)
    p2p = torch.equal(q[:, rows], want)
    q[:, rows] = -1.0
    tr.exchange_gather(q)
    return p2p, torch.equal(q[:, rows], want), len(plan.rings)


def ranks_of_two(rank, world, decks, bad_deck, cli_deck, out):
    """Each rank: the decks' runs (the first also read after every
    interval), the ConfigError of a deck of another size, then the CLI."""
    torch.set_num_threads(1)
    runs = [run_deck(p) for p in decks]
    runs.append(run_deck(decks[0], peek=True))
    halo = halos_fill_the_ghosts(decks[1])
    try:
        Simulation(load_config(bad_deck), device="cpu")
        err = None
    except ConfigError as e:
        err = str(e)
    rc = cli_main([cli_deck, "--cpu", "--output-dir", out])
    return dict(runs=runs, err=err, rc=rc, halo=halo)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("gloo2"))
    decks = [write_deck(d, "euler", 2),
             write_deck(d, "muscl", 2, "ssprk2", ", second_order: true")]
    bad = write_deck(d, "four", 4)
    cli = write_deck(os.path.join(d, "cli"), "cli", 2, fmt="binary")
    out = os.path.join(d, "out_ranks")
    got = spawn(ranks_of_two, 2, "gloo", d, args=(decks, bad, cli, out),
                timeout=120)
    return dict(got=got, decks=decks, d=d, cli=cli, out=out)


@pytest.mark.parametrize("k", [0, 1, 2],
                         ids=["euler", "muscl_ssprk2", "euler_read_each_interval"])
def test_two_ranks_are_the_one_process_run(two, k):
    want = run_deck(two["decks"][k % 2])
    for rank in two["got"]:
        assert_same_run(rank["runs"][k], want)
    assert np.abs(want["bflux"]).max() > 0.0


def test_both_halo_ways_fill_the_ghost_rows(two):
    assert [r["halo"] for r in two["got"]] == [(True, True, 3)] * 2


def test_a_world_of_another_size_is_refused(two):
    for rank in two["got"]:
        assert "parallel.n_devices = 4" in rank["err"]
        assert "2 ranks" in rank["err"]


def test_the_cli_writes_one_output_set_from_rank_0(two):
    assert [r["rc"] for r in two["got"]] == [0, 0]
    out_one = os.path.join(two["d"], "out_one")
    assert cli_main([two["cli"], "--cpu", "--output-dir", out_one]) == 0
    names = sorted(os.listdir(out_one))
    assert sorted(os.listdir(two["out"])) == names
    assert "boundary_fluxes.dat" in names
    assert sum(n.endswith(".bin") for n in names) == 3
    for n in names:
        with open(os.path.join(out_one, n), "rb") as a, \
                open(os.path.join(two["out"], n), "rb") as b:
            assert a.read() == b.read(), n
