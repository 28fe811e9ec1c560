"""XDMF and CGNS output of rdycore_tpu_torch against the JAX package's, on
the CPU, dataset by dataset (both write HDF5 through h5py).

A 40x20 dam break whose reservoir is quads and whose floodplain is
triangles (so the XDMF topology and the CGNS element section are mixed)
runs 30 steps in f64 in both packages with both writers attached: snapshots
every 10 steps in batches of 2, the fields Height, MomentumX, VelocityX,
VelocityY, WaterSource and the time averages Height_Mean and
MomentumX_Mean, a domain water source set after the first interval. The
two output directories hold the same files; each HDF5 file has the same
groups, datasets and attributes, integers and strings equal and floats to
1e-12 (the states agree to rounding, not bit for bit); the XMF text is
equal.
"""

import os

import numpy as np
import pytest

from rdycore_tpu.config.yaml_input import load_config as jax_load_config
from rdycore_tpu.io.cgns import CGNSWriter as JaxCGNSWriter
from rdycore_tpu.io.writers import attach_output_monitors as jax_attach
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, load_config
from rdycore_tpu_torch.io.cgns import CGNSWriter
from rdycore_tpu_torch.io.writers import attach_output_monitors
from rdycore_tpu_torch.mesh.core import build_mesh, save_mesh_npz

h5py = pytest.importorskip("h5py")

DECK = """
physics: {flow: {mode: swe}}
numerics: {spatial: fv, temporal: euler, riemann: roe, precision: double}
logging: {level: none}
time: {stop_n: 30, unit: seconds, time_step: 0.001, coupling_interval: 0.01}
output:
  format: xdmf
  output_interval: 10
  batch_size: 2
  prefix: dam
  fields: [Height, MomentumX, VelocityX, VelocityY, WaterSource,
           Height_Mean, MomentumX_Mean]
grid: {file: mixed.npz}
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
  - {name: right, grid_boundary_id: 2}
boundary_conditions:
  - {boundaries: [right], flow: outflow}
flow_conditions:
  - {name: column, type: dirichlet, height: 0.25, x_momentum: 0, y_momentum: 0}
  - {name: wet_bed, type: dirichlet, height: 0.05, x_momentum: 0, y_momentum: 0}
  - {name: outflow, type: critical-outflow}
"""


def mixed_mesh(nx=40, ny=20):
    """Quads for x < 1 (region 1), each quad cut in two triangles beyond
    (region 2), on [0, 2] x [0, 1]."""
    xs, ys = np.linspace(0.0, 2.0, nx + 1), np.linspace(0.0, 1.0, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    points = np.stack([X.ravel(), Y.ravel()], axis=1)
    vid = lambda i, j: j * (nx + 1) + i  # noqa: E731
    cells, region = [], []
    for j in range(ny):
        for i in range(nx):
            v = [vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)]
            if i < nx // 2:
                cells.append(v)
                region.append(1)
            else:
                cells += [[v[0], v[1], v[2], -1], [v[0], v[2], v[3], -1]]
                region += [2, 2]
    region = np.asarray(region)
    right = np.stack([vid(nx, np.arange(ny)), vid(nx, np.arange(1, ny + 1))],
                     axis=1)
    return build_mesh(
        points, np.asarray(cells),
        regions={f"__id_{r}": np.nonzero(region == r)[0] for r in (1, 2)},
        boundary_edges={"__id_2": right})


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """The output directories of the JAX package's run and the port's."""
    root = tmp_path_factory.mktemp("outputs")
    mesh = mixed_mesh()
    dirs = []
    for name, load, make, attach, cgns in (
            ("jax", jax_load_config, JaxSimulation, jax_attach,
             JaxCGNSWriter),
            ("port", load_config,
             lambda cfg: Simulation(cfg, device="cpu"), attach_output_monitors,
             CGNSWriter)):
        d = root / name
        d.mkdir()
        save_mesh_npz(mesh, str(d / "mixed.npz"))
        (d / "deck.yaml").write_text(DECK)
        sim = make(load(str(d / "deck.yaml")))
        attach(sim)
        sim.add_monitor(cgns(sim))
        sim.advance()
        sim.set_domain_water_source(1e-3)
        sim.run()
        assert sim.step == 30
        dirs.append(str(d / "output"))
    return dirs


def h5_items(path):
    """{name: (attrs, data or None)} of every group and dataset of a file,
    the file itself as ''."""
    items = {}
    with h5py.File(path, "r") as f:
        items[""] = (dict(f.attrs), None)
        f.visititems(lambda name, obj: items.__setitem__(name, (
            dict(obj.attrs),
            obj[()] if isinstance(obj, h5py.Dataset) else None)))
    return items


def same_value(a, b, where):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, where
    if a.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12, err_msg=where)
    else:
        assert np.array_equal(a, b), where


@pytest.mark.parametrize("kind", [".h5", ".xmf", ".cgns"])
def test_output_files_match_the_jax_package(outputs, kind):
    jax_dir, port_dir = outputs
    names = sorted(f for f in os.listdir(jax_dir) if f.endswith(kind))
    assert names and names == sorted(f for f in os.listdir(port_dir)
                                     if f.endswith(kind))
    for name in names:
        a, b = (os.path.join(d, name) for d in outputs)
        if kind == ".xmf":
            assert open(a).read() == open(b).read()
            continue
        ia, ib = h5_items(a), h5_items(b)
        assert list(ia) == list(ib), name  # same nodes, in the same order
        for node, ((attrs_a, data_a), (attrs_b, data_b)) in zip(
                ia, zip(ia.values(), ib.values())):
            where = f"{name}:{node}"
            assert attrs_a.keys() == attrs_b.keys(), where
            for k in attrs_a:
                same_value(attrs_a[k], attrs_b[k], f"{where}@{k}")
            assert (data_a is None) == (data_b is None), where
            if data_a is not None:
                same_value(data_a, data_b, where)


def test_snapshots_hold_the_run(outputs):
    """Four snapshots (steps 0, 10, 20, 30) in two batch files, the mixed
    topology, and the time averages of a run that moved."""
    port_dir = outputs[1]
    with h5py.File(os.path.join(port_dir, "dam.grid.h5")) as f:
        topo = f["grid/topology"][()]
    assert topo.size == 400 * 5 + 800 * 4 and set(topo[::5][:3]) == {5}
    steps = []
    for batch in ("dam.000.h5", "dam.001.h5"):
        with h5py.File(os.path.join(port_dir, batch)) as f:
            for g in f.values():
                steps.append(int(g.attrs["step"]))
                if g.attrs["step"] == 30:
                    h, mean = g["Height"][()], g["Height_Mean"][()]
                    assert np.abs(h - mean).max() > 1e-3
                    assert np.all(g["WaterSource"][()] == 1e-3)
    assert steps == [0, 10, 20, 30]
    with h5py.File(os.path.join(port_dir, "dam-20.cgns")) as f:
        el = f["Base/Zone/Elements"]
        assert el[" data"][0] == 20  # MIXED
        assert el["ElementStartOffset/ data"][-1] == 400 * 5 + 800 * 4
