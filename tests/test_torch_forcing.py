"""The port's forcing datasets (rdycore_tpu_torch/forcing.py) against the
JAX package's (rdycore_tpu/forcing.py) on the CPU, with datasets written
here in PETSc binary: `interp_time_series` (piecewise constant and
linear), `ConstantRain`, `HomogeneousDataset`, `dataset_filename` with
int32 and int64 ids, `RasterDataset` (the nearest-cell map, the hourly
switch, int64 files, a `map_file` written and read back),
`UnstructuredDataset` (nearest points by cKDTree, a stride of 2), and
`Forcing.apply` on the two packages' Simulations of one Exodus deck (the
sources and Dirichlet values it sets, to rounding). `attach_forcing`
keeps a closed box's volume budget under constant rain.
"""

import datetime
import os

import numpy as np
import pytest

from rdycore_tpu import forcing as jf
from rdycore_tpu.config.yaml_input import load_config as jax_load_config
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, load_config
from rdycore_tpu_torch import forcing as pf
from rdycore_tpu_torch.io.petsc_binary import write_petsc_vec
from tools.torch_flood_files import MeshFile, SideSet, write_exodus, write_raster

START = datetime.datetime(2017, 8, 26, 0)
DECK = """
physics: {flow: {mode: swe}}
numerics: {spatial: fv, temporal: euler, riemann: roe, precision: double}
logging: {level: none}
time: {stop: 0.02, unit: seconds, time_step: 0.001, coupling_interval: 0.01}
output: {format: none}
grid: {file: box.exo}
regions:
  - {name: west, grid_region_id: 1}
  - {name: east, grid_region_id: 2}
surface_composition:
  - {region: west, material: m}
  - {region: east, material: m}
materials: [{name: m, properties: {manning: {value: 0.02}}}]
initial_conditions:
  - {region: west, flow: still}
  - {region: east, flow: still}
boundaries:
  - {name: inlet, grid_boundary_id: 1}
  - {name: outlet, grid_boundary_id: 2}
boundary_conditions:
  - {boundaries: [inlet], flow: level}
  - {boundaries: [outlet], flow: level}
flow_conditions:
  - {name: still, type: dirichlet, height: 0.5, x_momentum: 0, y_momentum: 0}
  - {name: level, type: dirichlet, height: 0.5, x_momentum: 0, y_momentum: 0}
"""


def box(tmp_path):
    """A 4 m x 2 m box of 8 x 4 quads in two blocks (x < 2, x > 2), its
    left side set 1 (inlet), its right side set 2 (outlet); the deck."""
    xs, ys = np.linspace(0, 4, 9), np.linspace(0, 2, 5)
    X, Y = np.meshgrid(xs, ys)
    points = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], axis=1)
    cells, block = [], []
    for b in (1, 2):
        for j in range(4):
            for i in range(4 * (b - 1), 4 * b):
                v = j * 9 + i
                cells.append([v, v + 1, v + 10, v + 9])
                block.append(b)
    cells = np.array(cells, np.int32)
    left = np.array([c for c in range(32) if cells[c, 0] % 9 == 0])
    right = np.array([c for c in range(32) if cells[c, 1] % 9 == 8])
    mf = MeshFile(points, cells, np.array(block), {1: "w", 2: "e"},
                  [SideSet(1, "inlet", left, np.full(4, 3)),
                   SideSet(2, "outlet", right, np.full(4, 1))])
    write_exodus(str(tmp_path / "box.exo"), mf)
    path = str(tmp_path / "deck.yaml")
    with open(path, "w") as f:
        f.write(DECK)
    return path


def test_interp_time_series_matches():
    rng = np.random.default_rng(0)
    pairs = np.stack([np.sort(rng.uniform(0, 100, 7)),
                      rng.uniform(-1, 1, 7)], axis=1)
    ts = np.concatenate([rng.uniform(-10, 110, 50), pairs[:, 0]])
    for interpolate in (False, True):
        for t in ts:
            assert pf.interp_time_series(pairs, t, interpolate) == \
                jf.interp_time_series(pairs, t, interpolate)
    assert pf.ConstantRain(3e-6).rate_at(5.0) == \
        jf.ConstantRain(3e-6).rate_at(5.0) == 3e-6


@pytest.mark.parametrize("interpolate", [False, True])
def test_homogeneous_dataset_matches(tmp_path, interpolate):
    path = str(tmp_path / "rain.bin")
    write_petsc_vec(path, [0.0, 1e-5, 600.0, 3e-5, 1200.0, 0.0])
    p = pf.HomogeneousDataset(path, temporally_interpolate=interpolate)
    j = jf.HomogeneousDataset(path, temporally_interpolate=interpolate)
    assert np.array_equal(p.pairs, j.pairs)
    for t in (-1.0, 0.0, 300.0, 600.0, 900.0, 1200.0, 5000.0):
        assert p.value_at(t) == j.value_at(t)
    write_petsc_vec(path, [0.0, 1.0, 2.0])
    for cls in (pf.HomogeneousDataset, jf.HomogeneousDataset):
        with pytest.raises(ValueError, match=r"\(t, v\) pairs"):
            cls(path)


@pytest.mark.parametrize("idtype", ["int32", "int64"])
def test_dataset_filename_matches(idtype):
    for date in (START, datetime.datetime(2021, 1, 2, 13, 45)):
        name = pf.dataset_filename("d", date, idtype)
        assert name == jf.dataset_filename("d", date, idtype)
    assert pf.dataset_filename("d", START, idtype) == \
        f"d/2017-08-26:00-00.{idtype}.bin"


def write_rasters(directory, idtype, rng):
    os.makedirs(directory, exist_ok=True)
    for hour in range(3):
        write_raster(pf.dataset_filename(directory, START + datetime.
                                         timedelta(hours=hour), idtype),
                     rng.uniform(0, 1e-5, (5, 7)), 0.25, 0.5, 0.5,
                     int64=idtype == "int64")


@pytest.mark.parametrize("idtype", ["int32", "int64"])
def test_raster_dataset_matches(tmp_path, idtype):
    rng = np.random.default_rng(1)
    d = str(tmp_path / "rain")
    write_rasters(d, idtype, rng)
    xy = rng.uniform(-0.5, 4.5, (40, 2))  # some beyond the raster
    p = pf.RasterDataset(d, START, xy, idtype=idtype)
    j = jf.RasterDataset(d, START, xy, idtype=idtype)
    assert np.array_equal(p.data2mesh, j.data2mesh)
    for t in (0.0, 1800.0, 3599.0, 3600.0, 7300.0, 3600.0):
        assert np.array_equal(p.rates_at(t), j.rates_at(t))
        assert p.current_date == j.current_date
    assert p.current_date == START + datetime.timedelta(hours=1)
    assert not np.array_equal(p.rates_at(0.0), p.rates_at(3600.0))


def test_raster_map_file_is_written_and_read(tmp_path):
    rng = np.random.default_rng(2)
    d = str(tmp_path / "rain")
    write_rasters(d, "int32", rng)
    xy = rng.uniform(0, 4, (30, 2))
    maps = [str(tmp_path / f"{k}.map.bin") for k in ("port", "jax")]
    p = pf.RasterDataset(d, START, xy, map_file=maps[0])
    j = jf.RasterDataset(d, START, xy, map_file=maps[1])
    with open(maps[0], "rb") as a, open(maps[1], "rb") as b:
        assert a.read() == b.read()
    # read back: the map file wins over the (here different) coordinates
    p2 = pf.RasterDataset(d, START, xy[::-1], map_file=maps[0])
    assert np.array_equal(p2.data2mesh, p.data2mesh)
    assert np.array_equal(p2.rates_at(10.0), j.rates_at(10.0))


def test_unstructured_dataset_matches(tmp_path):
    rng = np.random.default_rng(3)
    d = str(tmp_path / "u")
    os.makedirs(d)
    data_xy = rng.uniform(0, 4, (9, 2))
    for hour in range(2):
        write_petsc_vec(pf.dataset_filename(d, START + datetime.timedelta(
            hours=hour)), rng.uniform(0, 1, 18))
    xy = rng.uniform(0, 4, (25, 2))
    p = pf.UnstructuredDataset(d, START, xy, data_xy, stride=2)
    j = jf.UnstructuredDataset(d, START, xy, data_xy, stride=2)
    assert np.array_equal(p.data2mesh, j.data2mesh)
    for t in (0.0, 3600.0, 10.0):
        assert np.array_equal(p.values_at(t), j.values_at(t))
        assert p.values_at(t).shape == (25, 2)


def both_forcings(tmp_path, sims):
    """The same Forcing in each package, every kind of dataset in it."""
    rng = np.random.default_rng(4)
    d = str(tmp_path / "rain")
    write_rasters(d, "int32", rng)
    hom = str(tmp_path / "h.bin")
    write_petsc_vec(hom, [0.0, 2e-6, 0.01, 4e-6])
    u = str(tmp_path / "u")
    os.makedirs(u)
    for hour in range(2):
        write_petsc_vec(pf.dataset_filename(u, START + datetime.timedelta(
            hours=hour)), rng.uniform(0.1, 0.9, 3 * 6))
    data_xy = rng.uniform(3.5, 4.5, (6, 2))
    out = []
    for m, sim in zip((pf, jf), sims):
        seg = {s.name: s for s in sim.operator.segments}["outlet"]
        bnd = np.asarray(sim.operator.arrays.bnd_left)[
            seg.start : seg.start + seg.count]
        f = m.Forcing(raster_rain=m.RasterDataset(
            d, START, sim.mesh.cell_centroid[:, :2]))
        f.regional_rain["east"] = m.HomogeneousDataset(hom)
        f.homogeneous_bc["inlet"] = m.HomogeneousDataset(hom)
        f.unstructured_bc["outlet"] = m.UnstructuredDataset(
            u, START, sim.mesh.cell_centroid[bnd, :2], data_xy, stride=3)
        out.append(f)
    return out


def test_forcing_apply_matches_the_jax_package(tmp_path):
    deck = box(tmp_path)
    sims = (Simulation(load_config(deck), device="cpu"),
            JaxSimulation(jax_load_config(deck)))
    forcings = both_forcings(tmp_path, sims)
    for t in (0.0, 0.005, 0.02, 3600.0):
        for f, sim in zip(forcings, sims):
            f.apply(sim, t)
        port, jax = sims
        assert np.allclose(port.ext_src.numpy(), np.asarray(jax.ext_src),
                           rtol=1e-15, atol=0)
        assert np.allclose(port.boundary_values.numpy(),
                           np.asarray(jax.boundary_values), rtol=1e-15,
                           atol=0)
    assert port.ext_src[0].max() > 0
    # the other domain sources, one at a time
    for make in (lambda m: m.Forcing(constant_rain=m.ConstantRain(1e-6)),
                 lambda m: m.Forcing(homogeneous_rain=m.HomogeneousDataset(
                     str(tmp_path / "h.bin"), temporally_interpolate=True))):
        for m, sim in zip((pf, jf), sims):
            make(m).apply(sim, 0.004)
        assert np.array_equal(sims[0].ext_src.numpy(),
                              np.asarray(sims[1].ext_src))


def test_attach_forcing_keeps_the_volume_budget(tmp_path):
    deck = box(tmp_path)
    cfg = load_config(deck)
    cfg.boundary_conditions = []  # every wall reflecting: a closed box
    sim = Simulation(cfg, device="cpu")
    rate = 1e-4
    pf.attach_forcing(sim, pf.Forcing(constant_rain=pf.ConstantRain(rate)))
    area = sim.mesh.cell_area
    v0 = float((sim.get_height() * area).sum())
    sim.run()
    v1 = float((sim.get_height() * area).sum())
    assert v1 - v0 == pytest.approx(rate * area.sum() * sim.t, rel=1e-10)
