"""An Exodus deck under `numerics.cell_ordering: rcm` through the port's
Simulation against the JAX package's, f64 on the CPU.

The mesh file (written here, cells and vertices shuffled) is read and
reordered by RCM in both packages; the deck's per-cell files are in
natural (file) order and must be scattered by natural id: the bed
(grid.cell_elevation), the floodplain's Manning values and initial
state, and a water source. After 20 steps the state, read in natural
order, agrees with the JAX package's within 1e-12, and so do the binary
output files (written in natural order) and the boundary-flux sums. The
natural ids are the JAX package's (and not the identity); a checkpoint
written by either package restarts the other on the RCM deck; per-cell
files read and written through the coupling surface are in natural order.
"""

import os

import numpy as np
import pytest

from rdycore_tpu.config.yaml_input import load_config as jax_load_config
from rdycore_tpu.io.checkpoint import write_checkpoint as jax_write_checkpoint
from rdycore_tpu.io.writers import (
    attach_output_monitors as jax_attach_output_monitors,
)
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, load_config
from rdycore_tpu_torch.io.petsc_binary import read_petsc_vec, write_petsc_vec
from rdycore_tpu_torch.io.writers import attach_output_monitors
from tools.torch_flood_files import MeshFile, SideSet, write_exodus

NX, NY, LX, LY = 12, 8, 4.0, 2.75
STEPS = 20
DECK = """
physics: {flow: {mode: swe}}
numerics: {spatial: fv, temporal: euler, riemann: roe, precision: double,
           cell_ordering: rcm}
logging: {level: none}
time: {stop_n: %(steps)d, unit: seconds, time_step: 0.001,
       coupling_interval: 0.005}
output: {format: binary, output_interval: 10, directory: %(out)s,
         time_series: {boundary_fluxes: 5}}
grid: {file: valley.exo, cell_elevation: {file: bed.bin}}
regions:
  - {name: reservoir, grid_region_id: 1}
  - {name: floodplain, grid_region_id: 2}
surface_composition:
  - {region: reservoir, material: smooth}
  - {region: floodplain, material: rough}
materials:
  - {name: smooth, properties: {manning: {value: 0.018}}}
  - {name: rough, properties: {manning: {file: manning.bin}}}
initial_conditions:
  - {region: reservoir, flow: column}
  - {region: floodplain, flow: from_file}
sources:
  - {region: floodplain, flow: rain}
boundaries:
  - {name: right, grid_boundary_id: 2}
boundary_conditions:
  - {boundaries: [right], flow: outflow}
flow_conditions:
  - {name: column, type: dirichlet, height: 0.4, x_momentum: 0, y_momentum: 0}
  - {name: from_file, type: dirichlet, file: ic.bin}
  - {name: rain, type: dirichlet, file: rain.bin}
  - {name: outflow, type: critical-outflow}
%(extra)s"""


def valley_file(seed=0):
    """structured_tri(NX, NY) over LX x LY, cells (within each block) and
    vertices shuffled; block 1 the reservoir (x < LX / 2), side sets 1 left
    and 2 right."""
    from rdycore_tpu_torch.mesh import structured_tri

    rng = np.random.default_rng(seed)
    mesh = structured_tri(NX, NY, 0.0, LX, 0.0, LY,
                          z_fn=lambda x, y: 0.02 * x + 0.01 * np.sin(3 * y))
    res = mesh.cell_centroid[:, 0] < LX / 2
    cperm = np.concatenate([rng.permutation(np.nonzero(res)[0]),
                            rng.permutation(np.nonzero(~res)[0])])
    vperm = rng.permutation(mesh.num_vertices)
    cinv, vinv = np.argsort(cperm), np.argsort(vperm)
    cells = mesh.cell_vertices[cperm]
    cells = np.where(cells >= 0, vinv[np.maximum(cells, 0)], -1)
    sets = []
    for sid, name in ((1, "left"), (2, "right")):
        eids = mesh.boundaries[name]
        left = mesh.edge_cells[eids, 0]
        side = np.argmax(mesh.cell_edges[left] == eids[:, None], axis=1)
        sets.append(SideSet(sid, name, cinv[left], side))
    return MeshFile(mesh.points[vperm], cells.astype(np.int32),
                    np.where(res[cperm], 1, 2), {1: "reservoir",
                                                 2: "floodplain"}, sets)


def write_case(tmp_path, name="deck", steps=STEPS, extra=""):
    d = str(tmp_path)
    if not os.path.exists(os.path.join(d, "valley.exo")):
        mf = valley_file()
        write_exodus(os.path.join(d, "valley.exo"), mf)
        rng = np.random.default_rng(1)
        C = len(mf.cells)
        write_petsc_vec(os.path.join(d, "bed.bin"), rng.uniform(0, 0.05, C))
        write_petsc_vec(os.path.join(d, "manning.bin"),
                        rng.uniform(0.01, 0.05, C))
        ic = np.stack([rng.uniform(0.05, 0.15, C), rng.uniform(-0.01, 0.01, C),
                       rng.uniform(-0.01, 0.01, C)], axis=1)
        write_petsc_vec(os.path.join(d, "ic.bin"), ic.ravel())
        write_petsc_vec(os.path.join(d, "rain.bin"),
                        rng.uniform(0.0, 1e-3, C))
    path = os.path.join(d, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(DECK % dict(steps=steps, out=f"out_{name}", extra=extra))
    return path


def natural(sim, values):
    """Per-cell values [..., C] of sim in natural order."""
    return np.asarray(values)[..., np.argsort(sim.get_natural_ids())]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rcm")
    deck = write_case(tmp)
    cfg, jax_cfg = load_config(deck), jax_load_config(deck)
    cfg.output.directory, jax_cfg.output.directory = "out_port", "out_jax"
    port = Simulation(cfg, device="cpu")
    attach_output_monitors(port)
    jax = JaxSimulation(jax_cfg)
    jax_attach_output_monitors(jax)
    port.q_start = natural(port, port.get_solution())
    port.run()
    jax.run()
    return tmp, port, jax


def test_rcm_deck_matches_the_jax_package_by_natural_id(runs):
    tmp, port, jax = runs
    assert port.step == jax.step == STEPS and port.t == pytest.approx(jax.t)
    want = natural(jax, jax.get_solution())
    got = natural(port, port.get_solution())
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert np.abs(port.bflux_accum - np.asarray(jax.bflux_accum)).max() \
        <= 1e-12 * np.abs(np.asarray(jax.bflux_accum)).max()
    # the state moved, and the reordering is not the identity
    assert np.abs(got[0] - port.q_start[0]).max() > 1e-4
    nat = port.get_natural_ids()
    assert np.array_equal(nat, jax.get_natural_ids())
    assert not np.array_equal(nat, np.arange(len(nat)))
    assert np.array_equal(np.sort(nat), np.arange(len(nat)))
    # bed, Manning values and sources scattered by natural id alike
    assert np.array_equal(port.mesh.cell_z, jax.mesh.cell_z)
    assert np.array_equal(port.get_manning_n(), np.asarray(jax.get_manning_n()))


def test_binary_output_in_natural_order_matches(runs):
    tmp, port, jax = runs
    names = sorted(n for n in os.listdir(tmp / "out_port")
                   if n.endswith(".bin"))
    assert len(names) == 3  # steps 0, 10 and 20
    assert names == sorted(n for n in os.listdir(tmp / "out_jax")
                           if n.endswith(".bin"))
    for n in names:
        got = read_petsc_vec(str(tmp / "out_port" / n))
        want = read_petsc_vec(str(tmp / "out_jax" / n))
        assert got.shape == (3 * port.mesh.num_cells,)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    last = read_petsc_vec(str(tmp / "out_port" / names[-1]))
    assert np.array_equal(last.reshape(-1, 3).T,
                          natural(port, port.get_solution()))


def test_one_dof_files_are_in_natural_order(runs, tmp_path):
    _, port, jax = runs
    vals = np.arange(port.mesh.num_cells, dtype=np.float64)
    path = str(tmp_path / "v.bin")
    write_petsc_vec(path, vals)
    got = port.read_one_dof_vec_from_binary(path)
    assert np.array_equal(got, np.asarray(jax.read_one_dof_vec_from_binary(
        path)))
    assert np.array_equal(got, port.get_natural_ids().astype(np.float64))
    port.write_one_dof_vec_to_binary(str(tmp_path / "w.bin"), got)
    assert np.array_equal(read_petsc_vec(str(tmp_path / "w.bin")), vals)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_the_packages_on_rcm(runs, writer):
    tmp, port, jax = runs
    ckpt = str(tmp / f"{writer}.bin")
    src = jax if writer == "jax" else port
    if writer == "jax":
        jax_write_checkpoint(jax, ckpt)
    else:
        port.write_checkpoint(ckpt)
    deck = write_case(tmp, name=f"restart_{writer}",
                      extra=f"restart: {{file: {writer}.bin}}\n")
    dst = (Simulation(load_config(deck), device="cpu") if writer == "jax"
           else JaxSimulation(jax_load_config(deck)))
    assert dst.step == src.step and dst.t == src.t
    assert np.array_equal(natural(dst, dst.get_solution()),
                          natural(src, src.get_solution()))
