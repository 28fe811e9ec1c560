"""The port's CLI AMR options against the JAX package's CLI on the CPU:
`--amr-dataset-dir` with `--amr-area-threshold` on a small f64 dam break
(16 x 8 quads of 0.25 m, critical outflow on the right), two PETSc
datasets on the base mesh: minute 0 marks the cells within 0.5 m of the
dam, minute 2 those within 0.25 m of x = 3 m (the deck has no time.date,
so the minutes count from 2011-01-01). Both packages' `main` run it to the
end; the refinement events give the same cell counts, and the final
binary outputs (natural order, on the twice-refined mesh) agree within
1e-10.
"""

import datetime
import os

import numpy as np

from rdycore_tpu.__main__ import main as jax_main
from rdycore_tpu_torch.__main__ import main
from rdycore_tpu_torch.forcing import dataset_filename
from rdycore_tpu_torch.io.petsc_binary import read_petsc_vec, write_petsc_vec
from rdycore_tpu_torch.mesh import save_mesh_npz, structured_quad

START = datetime.datetime(2011, 1, 1)
DECK = """
physics: {flow: {mode: swe}}
numerics: {spatial: fv, temporal: euler, riemann: roe, precision: double}
logging: {level: none}
time: {stop: 0.03, unit: seconds, time_step: 0.001, coupling_interval: 0.005}
output: {format: binary, output_interval: 30}
grid: {file: dam.npz}
regions:
  - {name: reservoir, grid_region_id: 1}
  - {name: floodplain, grid_region_id: 2}
surface_composition:
  - {region: reservoir, material: m}
  - {region: floodplain, material: m}
materials: [{name: m, properties: {manning: {value: 0.02}}}]
initial_conditions:
  - {region: reservoir, flow: column}
  - {region: floodplain, flow: wet_bed}
boundaries: [{name: right, grid_boundary_id: 2}]
boundary_conditions: [{boundaries: [right], flow: outflow}]
flow_conditions:
  - {name: column, type: dirichlet, height: 0.5, x_momentum: 0, y_momentum: 0}
  - {name: wet_bed, type: dirichlet, height: 0.1, x_momentum: 0, y_momentum: 0}
  - {name: outflow, type: critical-outflow}
"""


def write_case(tmp_path):
    """The mesh (.npz with regions 1 and 2 and the right side as boundary
    id 2), the deck and the two datasets; the path of the deck."""
    mesh = structured_quad(16, 8, 0.0, 4.0, 0.0, 2.0,
                           region_fn=lambda cx, cy: np.where(cx < 2.0, 1, 2))
    mesh.boundaries["__id_2"] = mesh.boundaries["right"]
    save_mesh_npz(mesh, str(tmp_path / "dam.npz"))
    x = mesh.cell_centroid[:, 0]
    amr_dir = tmp_path / "amr"
    os.makedirs(amr_dir)
    for minute, band in ((0, np.abs(x - 2.0) < 0.5),
                         (2, np.abs(x - 3.0) < 0.25)):
        write_petsc_vec(dataset_filename(
            str(amr_dir), START + datetime.timedelta(minutes=minute)),
            band.astype(np.float64))
    path = str(tmp_path / "dam.yaml")
    with open(path, "w") as f:
        f.write(DECK)
    return path


def test_amr_options_run_as_the_jax_cli(tmp_path):
    deck = write_case(tmp_path)
    outs = {}
    for name, run in (("port", main), ("jax", jax_main)):
        out = str(tmp_path / name)
        assert run([deck, "--cpu", "--output-dir", out, "--amr-dataset-dir",
                    str(tmp_path / "amr"), "--amr-area-threshold",
                    "0.03"]) == 0
        files = sorted(f for f in os.listdir(out) if f.endswith(".bin"))
        outs[name] = read_petsc_vec(os.path.join(out, files[-1]))
    # 128 quads; minute 0: 4 red columns of 8 (+96) and their 2 fanned
    # neighbour columns (+64); minute 2: 2 red columns (+48), on the left
    # the fans' triangles on x = 2.75 m bisected (+8), on the right a
    # fanned column (+32): 376 cells, 3 values each
    got, want = outs["port"], outs["jax"]
    assert got.shape == want.shape == (3 * 376,)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    assert np.isfinite(got).all() and got[0::3].min() >= 0.0
