"""The port's red-green refinement (rdycore_tpu_torch/amr.py) against the
JAX package's, on the CPU without a JAX compile.

`refine_marked` is vectorized numpy in the port and a walk over the cells
in the JAX package; the two must agree array for array: the new points,
the cells in the JAX emission order, the geometry and edges the mesh
builder makes of them, `parent`, the regions and the boundary sets. On
triangles, on quads with random marks (red quads, green triangles, quad
fans), and on a mixed mesh (a quad mesh refined once, then marked again
across its fans and children). Also the identity on no marks, the marking
rule and the ValueError on a wrong shape, as tests/test_amr.py holds them
for the JAX package.
"""

import dataclasses

import numpy as np
import pytest

from rdycore_tpu.amr import refine_marked as jax_refine_marked
from rdycore_tpu.mesh import generate as jax_generate
from rdycore_tpu_torch.amr import mark_cells_from_raster, refine_marked
from rdycore_tpu_torch.mesh import generate


def assert_same_mesh(got, want):
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, dict):
            assert a.keys() == b.keys(), f.name
            for k in a:
                assert np.array_equal(a[k], b[k]), (f.name, k)
                assert a[k].dtype == b[k].dtype, (f.name, k)
        else:
            assert np.array_equal(a, b), f.name
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name


def quads(gen):
    return gen.structured_quad(
        8, 6, 0.0, 4.0, 0.0, 3.0, z_fn=lambda x, y: 0.1 * x + 0.05 * y,
        region_fn=lambda cx, cy: np.where(cx < 2.0, 1, 2))


def tri_first_five(gen, refine):
    mesh = gen.structured_tri(6, 4)
    marked = np.zeros(mesh.num_cells, bool)
    marked[:5] = True
    return mesh, marked


def quad_random(seed):
    def case(gen, refine):
        mesh = quads(gen)
        marked = np.random.default_rng(seed).random(mesh.num_cells) < 0.15
        return mesh, marked
    return case


def mixed(gen, refine):
    """A quad mesh refined once around its middle (red quads, quad fans),
    then marked again at random over the mixed mesh."""
    mesh = quads(gen)
    c = mesh.cell_centroid
    mid = (np.abs(c[:, 0] - 2.0) < 1.0) & (np.abs(c[:, 1] - 1.5) < 0.75)
    mesh, _ = refine(mesh, mid)
    marked = np.random.default_rng(7).random(mesh.num_cells) < 0.1
    return mesh, marked


CASES = {"tri_first_5": tri_first_five, "quad_seed0": quad_random(0),
         "quad_seed1": quad_random(1), "quad_seed2": quad_random(2),
         "mixed": mixed}


@pytest.mark.parametrize("case", list(CASES))
def test_refine_marked_matches_jax(case):
    jax_mesh, jax_marked = CASES[case](jax_generate, jax_refine_marked)
    mesh, marked = CASES[case](generate, refine_marked)
    assert np.array_equal(marked, jax_marked)
    want, want_parent = jax_refine_marked(jax_mesh, jax_marked)
    got, parent = refine_marked(mesh, marked)
    assert np.array_equal(parent, want_parent)
    assert parent.dtype == want_parent.dtype
    assert_same_mesh(got, want)
    # every transition kind is present on the quad and mixed meshes
    kids = np.bincount(parent, minlength=mesh.num_cells)
    if case != "tri_first_5":
        assert {1, 4, 5} <= set(kids.tolist())
    if case == "mixed":
        assert 2 in kids  # a green triangle
    assert np.isclose(got.cell_area.sum(), mesh.cell_area.sum())


def test_refine_nothing_is_identity():
    mesh = generate.structured_tri(4, 4)
    out, parent = refine_marked(mesh, np.zeros(mesh.num_cells, bool))
    assert out is mesh
    assert np.array_equal(parent, np.arange(mesh.num_cells))


def test_mark_rule():
    depths = np.array([0.0, 0.5, 2.0, 1.0])
    areas = np.array([1.0, 1.0, 0.05, 1.0])
    marked = mark_cells_from_raster(depths, areas, area_threshold=0.125)
    assert marked.tolist() == [False, True, False, True]


def test_wrong_shape_raises():
    mesh = generate.structured_tri(4, 4)
    for refine in (refine_marked, jax_refine_marked):
        with pytest.raises(ValueError, match=f"shape \\({mesh.num_cells},\\)"):
            refine(mesh, np.ones(3, bool))
