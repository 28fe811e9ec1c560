"""The port's native mesh builder (rdycore_tpu_torch/mesh/native.py over
mesh/csrc/mesh_builder.cpp, built at first use into build/) on the CPU:

- its cell geometry and edges equal the numpy plain versions of
  mesh/core.py array for array, bit for bit, on triangles, quads and a
  mixed mesh with a random bed and jittered vertices;
- `build_mesh` equals the JAX package's array for array;
- its RCM permutation equals the JAX package's native `rcm_order` (where
  that library loads) and a breadth-first oracle written here, on a mesh
  of several components, and `rcm_reorder` equals the JAX package's;
- `reorder_cells` refuses what is not a permutation;
- a compiler that fails (CXX=false) raises with the build's message.
"""

import dataclasses
from collections import deque

import numpy as np
import pytest

from rdycore_tpu.mesh import native as jax_native
from rdycore_tpu.mesh.core import build_mesh as jax_build_mesh
from rdycore_tpu.mesh.core import rcm_reorder as jax_rcm_reorder
from rdycore_tpu_torch.mesh import build as native_build
from rdycore_tpu_torch.mesh import build_mesh, native, structured_quad
from rdycore_tpu_torch.mesh import structured_tri
from rdycore_tpu_torch.mesh.core import (
    _cell_slopes,
    _extract_edges,
    _polygon_areas_centroids,
    _vertex_mean_z,
    rcm_reorder,
    reorder_cells,
)


def jittered(mesh, seed):
    """Points and cells of `mesh` with its interior vertices moved and a
    random bed."""
    rng = np.random.default_rng(seed)
    pts = mesh.points.copy()
    inner = ~np.isin(np.arange(len(pts)), mesh.edge_vertices[
        mesh.num_internal_edges:].ravel())
    pts[inner, :2] += rng.uniform(-0.2, 0.2, (inner.sum(), 2)) * (
        mesh.min_edge_length())
    pts[:, 2] = rng.uniform(-1.0, 1.0, len(pts))
    return pts, mesh.cell_vertices


def mixed():
    """Quads on the left half, triangles on the right."""
    quad = structured_quad(6, 4, 0.0, 3.0, 0.0, 2.0)
    cv = quad.cell_vertices.copy()
    right = quad.cell_centroid[:, 0] > 1.5
    a, b, c, d = cv[right].T
    tris = np.concatenate([np.stack([a, b, c, -np.ones_like(a)], 1),
                           np.stack([a, c, d, -np.ones_like(a)], 1)])
    return quad.points, np.concatenate([cv[~right], tris])


CASES = {
    "tri": lambda: jittered(structured_tri(12, 9, 0.0, 3.0, 0.0, 2.0), 0),
    "quad": lambda: jittered(structured_quad(11, 7, 0.0, 3.0, 0.0, 2.0), 1),
    "mixed": mixed,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_equals_the_numpy_plain_versions(case):
    points, cv = CASES[case]()
    mesh = build_mesh(points, cv)
    cv, nv = mesh.cell_vertices, mesh.cell_num_vertices
    area, cen, dzdx, dzdy, cz = native.cell_geometry(mesh.points, cv, nv)
    p_area, p_cen = _polygon_areas_centroids(mesh.points, cv, nv)
    p_dzdx, p_dzdy = _cell_slopes(mesh.points, cv, nv, p_cen)
    for got, want in ((area, p_area), (cen, p_cen), (dzdx, p_dzdx),
                      (dzdy, p_dzdy), (cz, _vertex_mean_z(mesh.points, cv,
                                                          nv))):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    got = native.extract_edges(mesh.num_vertices, cv, nv)
    want = _extract_edges(mesh.num_vertices, cv, nv)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_mesh_equals_the_jax_package(case):
    points, cv = CASES[case]()
    port, jax = build_mesh(points, cv), jax_build_mesh(points, cv)
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(jax, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name


def components():
    """Three disconnected patches (triangles, quads, triangles) in one
    mesh, their cells interleaved."""
    parts, off = [], 0
    for k, make in enumerate((lambda: structured_tri(5, 4),
                              lambda: structured_quad(6, 3),
                              lambda: structured_tri(3, 7))):
        m = make()
        pts = m.points + np.array([2.0 * k, 0.0, 0.0])
        parts.append((pts, np.where(m.cell_vertices >= 0,
                                    m.cell_vertices + off, -1)))
        off += len(pts)
    points = np.concatenate([p for p, _ in parts])
    cells = np.concatenate([c for _, c in parts])
    order = np.random.default_rng(5).permutation(len(cells))
    return build_mesh(points, cells[order])


def rcm_oracle(num_cells, left, right):
    """RCM as the builder defines it: each component breadth first from
    its lowest unvisited cell, a cell's neighbours by (degree, id), the
    whole order reversed."""
    nbrs = [[] for _ in range(num_cells)]
    for a, b in zip(left.tolist(), right.tolist()):
        if b >= 0:
            nbrs[a].append(b)
            nbrs[b].append(a)
    deg = [len(n) for n in nbrs]
    seen, order = [False] * num_cells, []
    for start in range(num_cells):
        if seen[start]:
            continue
        seen[start] = True
        order.append(start)
        queue = deque([start])
        while queue:
            new = [n for n in nbrs[queue.popleft()] if not seen[n]]
            for n in new:
                seen[n] = True
            for n in sorted(new, key=lambda c: (deg[c], c)):
                order.append(n)
                queue.append(n)
    return np.array(order[::-1], dtype=np.int32)


def test_rcm_equals_the_jax_package_on_several_components():
    mesh = components()
    left, right = mesh.edge_cells[:, 0], mesh.edge_cells[:, 1]
    perm = native.rcm_order(mesh.num_cells, left, right)
    assert np.array_equal(perm, rcm_oracle(mesh.num_cells, left, right))
    jax_perm = jax_native.rcm_order(mesh.num_cells, left, right)
    if jax_perm is not None:  # the JAX package's library loaded
        assert np.array_equal(perm, jax_perm)
    port, jax = rcm_reorder(mesh), jax_rcm_reorder(mesh)
    assert np.array_equal(port.natural_ids, perm)
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(jax, f.name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), f.name
        elif isinstance(a, dict):
            assert list(a) == list(b)
            assert all(np.array_equal(a[k], b[k]) for k in a)


def test_reorder_cells_refuses_what_is_not_a_permutation():
    mesh = structured_quad(3, 2)
    for perm in ([0, 1, 2, 3, 4, 4], [0, 1, 2], [5, 4, 3, 2, 1, 6]):
        with pytest.raises(ValueError, match="permutation"):
            reorder_cells(mesh, np.array(perm))
    back = reorder_cells(mesh, np.arange(6)[::-1])
    assert np.array_equal(back.natural_ids, np.arange(6)[::-1])


def test_a_failed_build_raises_with_the_compilers_message(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(native_build.NativeBuildError,
                       match=r"build failed \(exit 1\):\nfalse -O3"):
        structured_quad(3, 2)
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'mesh_builder.cpp: error: no' >&2\n"
                   "exit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(native_build.NativeBuildError,
                       match=r"exit 3(.|\n)*mesh_builder.cpp: error: no"):
        structured_quad(3, 2)
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(native_build.NativeBuildError,
                       match="cannot run the compiler"):
        structured_quad(3, 2)
    monkeypatch.setenv("CXX", "g++")
    path = native_build.library()
    assert path.startswith(native_build.BUILD_DIR)
    assert structured_quad(3, 2).num_cells == 6
