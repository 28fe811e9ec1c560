"""The port's mesh file readers (rdycore_tpu_torch/mesh/gmsh.py and
mesh/exodus.py) against the JAX package's on the CPU, on files written
here by tools/torch_flood_files.py: quads and triangles in two element
blocks (one unnamed), cells and vertices in a shuffled order, some cells
clockwise, side sets in the planar and the shell side numbering, an
unnamed one and one that is not on the boundary (Exodus skips it), Gmsh
with contiguous and scattered node tags, Exodus in CDF-1 and CDF-2. Every
array of the Mesh is exactly the JAX reader's, and so are the regions and
boundaries, key order included. Both formats of one mesh give the same
Mesh, and `Simulation`'s loader reads each extension.
"""

import dataclasses

import numpy as np
import pytest

from rdycore_tpu.mesh.exodus import read_exodus as jax_read_exodus
from rdycore_tpu.mesh.gmsh import read_gmsh as jax_read_gmsh
from rdycore_tpu_torch.config.schema import ConfigError
from rdycore_tpu_torch.mesh import read_gmsh
from rdycore_tpu_torch.mesh.exodus import read_exodus
from rdycore_tpu_torch.simulation import load_mesh_file
from tools.torch_flood_files import MeshFile, SideSet, write_exodus, write_gmsh

NX, NY = 6, 4  # quads for x < 1.5, two triangles per square beyond


def small_mesh_file(named=True, internal=True, seed=0):
    """A 3 m x 2 m mesh of quads (block 10) and triangles (block 20) with
    side sets west (planar), south (shell numbering), north + east, and the
    quads' side on the block interface."""
    rng = np.random.default_rng(seed)
    xs, ys = np.linspace(0, 3, NX + 1), np.linspace(0, 2, NY + 1)
    X, Y = np.meshgrid(xs, ys)
    points = np.stack([X.ravel(), Y.ravel(),
                       rng.uniform(0, 0.1, X.size)], axis=1)

    def v(i, j):
        return j * (NX + 1) + i

    quads, tris = [], []
    for j in range(NY):
        for i in range(NX):
            a, b, c, d = v(i, j), v(i + 1, j), v(i + 1, j + 1), v(i, j + 1)
            if i < NX // 2:
                quads.append([a, b, c, d])
            else:
                tris += [[a, b, c, -1], [a, c, d, -1]]
    quads, tris = np.array(quads), np.array(tris)
    quads, tris = quads[rng.permutation(len(quads))], tris[
        rng.permutation(len(tris))]
    cells = np.concatenate([quads, tris])
    flip = rng.random(len(cells)) < 0.3  # clockwise cells
    for c in np.nonzero(flip)[0]:
        n = 4 if cells[c, 3] >= 0 else 3
        cells[c, :n] = cells[c, :n][::-1]
    block = np.repeat([10, 20], [len(quads), len(tris)])

    def sides_on(pred):
        out_c, out_k = [], []
        for c, cell in enumerate(cells):
            n = 4 if cell[3] >= 0 else 3
            for k in range(n):
                p, q = points[cell[k], :2], points[cell[(k + 1) % n], :2]
                if pred(p) and pred(q):
                    out_c.append(c)
                    out_k.append(k)
        return np.array(out_c), np.array(out_k)

    sets = [SideSet(1, "west", *sides_on(lambda p: p[0] == 0.0)),
            SideSet(2, "south", *sides_on(lambda p: p[1] == 0.0), shell=True),
            SideSet(3, "north_east" if named else "",
                    *sides_on(lambda p: p[1] == 2.0 or p[0] == 3.0))]
    if internal:
        c, k = sides_on(lambda p: p[0] == 1.5)
        quad = c < len(quads)
        sets.append(SideSet(4, "interface", c[quad], k[quad]))
    vperm = rng.permutation(len(points))
    vinv = np.argsort(vperm)
    cells = np.where(cells >= 0, vinv[np.maximum(cells, 0)], -1)
    return MeshFile(points[vperm], cells.astype(np.int32), block,
                    {10: "meadow", 20: "bank" if named else ""}, sets)


def assert_same_mesh(a, b, ordered=True):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            assert (list(x) == list(y)) if ordered else (x.keys() == y.keys())
            for k in x:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("named", [True, False])
def test_exodus_matches_the_jax_reader(tmp_path, named, version):
    path = str(tmp_path / "m.exo")
    write_exodus(path, small_mesh_file(named), version=version)
    mesh = read_exodus(path)
    assert_same_mesh(mesh, jax_read_exodus(path))
    # the shell-numbered side set is found, the interface is skipped
    assert {"__id_1", "__id_2", "__id_3", "west", "south"} <= set(
        mesh.boundaries)
    assert "__id_4" not in mesh.boundaries and (
        "north_east" in mesh.boundaries) == named
    assert ("bank" in mesh.regions) == named and "__id_20" in mesh.regions
    assert "__unassigned__" not in mesh.boundaries
    assert set(mesh.cell_num_vertices.tolist()) == {3, 4}


@pytest.mark.parametrize("scattered_tags", [False, True])
@pytest.mark.parametrize("named", [True, False])
def test_gmsh_matches_the_jax_reader(tmp_path, named, scattered_tags):
    mf = small_mesh_file(named, internal=False, seed=1)
    tags = None
    if scattered_tags:
        rng = np.random.default_rng(2)
        tags = rng.choice(np.arange(1, 5 * len(mf.points)), len(mf.points),
                          replace=False)
    path = str(tmp_path / "m.msh")
    write_gmsh(path, mf, node_tags=tags)
    mesh = read_gmsh(path)
    assert_same_mesh(mesh, jax_read_gmsh(path))
    assert ("boundary_3" in mesh.boundaries) == (not named)
    assert ("region_20" in mesh.regions) == (not named)


def test_both_formats_give_one_mesh(tmp_path):
    mf = small_mesh_file(internal=False, seed=3)
    write_exodus(str(tmp_path / "m.exo"), mf)
    write_gmsh(str(tmp_path / "m.msh"), mf)
    assert_same_mesh(read_exodus(str(tmp_path / "m.exo")),
                     read_gmsh(str(tmp_path / "m.msh")), ordered=False)


@pytest.mark.parametrize("ext", [".msh", ".exo", ".e", ".exo2"])
def test_simulation_loads_each_extension(tmp_path, ext):
    mf = small_mesh_file(internal=False, seed=4)
    path = str(tmp_path / f"m{ext}")
    (write_gmsh if ext == ".msh" else write_exodus)(path, mf)
    reader = jax_read_gmsh if ext == ".msh" else jax_read_exodus
    assert_same_mesh(load_mesh_file(path), reader(path))


def test_unsupported_files_are_refused(tmp_path):
    with pytest.raises(ConfigError, match="unsupported mesh format"):
        load_mesh_file(str(tmp_path / "m.vtk"))
    path = tmp_path / "old.msh"
    path.write_text("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
    for reader in (read_gmsh, jax_read_gmsh):
        with pytest.raises(ValueError, match="need 4.x"):
            reader(str(path))
