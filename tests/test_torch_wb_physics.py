"""The well-balancing pieces of rdycore_tpu_torch against the JAX package's,
on the CPU, in float64.

- `eta_cells` on every branch (dry, all, one and two vertices submerged,
  z2 = z3, a flat cell), `eta_vertices` (the plain version of K5, also
  through its wrapper `swe_eta_vertex` on CPU tensors) and
  `dhv_correction`, on inputs made with numpy from a seed: to 1e-12
  relative (the port's cube root is pow(x, 1/3), XLA's is cbrt).
- The port's vectorized BS2002 builder against the JAX package's loop
  (`build_bs2002_arrays(..., return_host=True)`) on quad, triangle and
  strip meshes over a bumpy bed, with the boundary edges permuted: every
  index equal, every bed to 1e-12.
- The HR slots: the neighbour and normal that K1b and its plain version
  derive from each slot's edge id equal the JAX package's per-slot tables
  (hr_nbr_cell where the slot's coefficient is non-zero, hr_cn and hr_sn
  everywhere).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdycore_tpu import mesh as jax_mesh
from rdycore_tpu.operator import build_operator as jax_build_operator
from rdycore_tpu.ops.swe import bs2002 as jbs
from rdycore_tpu_torch import mesh as port_mesh
from rdycore_tpu_torch.ops.kernels.cell_stage import hr_slots
from rdycore_tpu_torch.ops.kernels.eta_vertex import swe_eta_vertex
from rdycore_tpu_torch.ops.swe import bs2002 as pbs

from test_torch_operator import assert_rel_close
from test_torch_wb_operator import bumpy, port_wb_operator

TINY_H = 1e-7
MESHES = {
    "quad": ("structured_quad", (24, 16, 0.0, 2.0, 0.0, 1.0)),
    "tri": ("structured_tri", (12, 10, 0.0, 2.0, 0.0, 1.0)),
    "strip": ("structured_quad", (8, 1, 0.0, 2.0, 0.0, 0.25)),
}


def meshes(name):
    gen, args = MESHES[name]
    return (getattr(jax_mesh, gen)(*args, z_fn=bumpy),
            getattr(port_mesh, gen)(*args, z_fn=bumpy))


def branch_inputs(seed, n=4000):
    """Sorted beds z1 <= z2 <= z3 and depths reaching every branch of
    eta_cells; returns them with the branch of each cell."""
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(-1.0, 1.0, (n, 3)), axis=1)
    z[: n // 8, 2] = z[: n // 8, 1]  # z2 = z3: h2 falls back to h3
    z[n // 8: n // 4] = z[n // 8: n // 4, :1]  # a flat cell
    z1, z2, z3 = z.T
    h3 = z3 - (z1 + z2 + z3) / 3.0
    h = h3 * rng.uniform(0.0, 1.5, n)
    h[rng.uniform(size=n) < 0.1] = rng.uniform(0.0, TINY_H, 1)
    dz31 = z3 - z1
    h2 = np.where(z2 < z3, (z2 - z1) ** 2 / (3.0 * np.where(dz31 != 0, dz31,
                                                            1.0)), h3)
    branch = np.where(h <= TINY_H, 0, np.where(
        h >= h3, 1, np.where((h > 0) & (h <= h2), 2, 3)))
    return (z1, z2, z3, h), branch


def test_eta_cells_every_branch():
    args, branch = branch_inputs(1)
    assert set(np.unique(branch)) == {0, 1, 2, 3}
    want = np.asarray(jbs.eta_cells(*(jnp.asarray(x) for x in args),
                                    TINY_H))
    got = pbs.eta_cells(*(torch.as_tensor(x) for x in args), TINY_H)
    for b in range(4):
        sel = branch == b
        assert_rel_close(want[sel], got.numpy()[sel], 1e-12, f"branch {b}")


@pytest.mark.parametrize("mesh", ["tri", "quad"])
def test_eta_vertices_and_correction(mesh):
    jm, pm = meshes(mesh)
    Ei = jm.num_internal_edges
    perm = np.arange(jm.num_edges)
    jarr = jbs.build_bs2002_arrays(jm, perm, Ei, jnp.float64)
    parr = pbs.bs2002_arrays_from_numpy(pbs.build_bs2002_host(pm, perm, Ei),
                                        torch.device("cpu"), torch.float64)
    rng = np.random.default_rng(2)
    # partly wet cells: depths around the cells' bed relief
    h = np.where(rng.uniform(size=pm.num_cells) < 0.2, 0.0,
                 rng.uniform(0.0, 0.4, pm.num_cells))
    want = np.asarray(jbs.eta_vertices(jarr, jnp.asarray(h), TINY_H))
    for got in (pbs.eta_vertices(parr, torch.as_tensor(h), TINY_H),
                swe_eta_vertex(parr, torch.as_tensor(h), TINY_H)):
        assert got.shape == (pm.num_vertices,)
        assert_rel_close(want, got.numpy(), 1e-12, "eta_v")
    cn, sn = np.cos(rng.uniform(0, 6.3, Ei)), np.sin(rng.uniform(0, 6.3, Ei))
    dj = jbs.dhv_correction(jnp.asarray(want), jarr.int_vbeg, jarr.int_vend,
                            jarr.int_zvbeg, jarr.int_zvend, jnp.asarray(cn),
                            jnp.asarray(sn))
    dp = pbs.dhv_correction(torch.tensor(want), parr.int_vbeg,
                            parr.int_vend, parr.int_zvbeg, parr.int_zvend,
                            torch.as_tensor(cn), torch.as_tensor(sn))
    for a, b in zip(dj, dp):
        assert float(np.abs(np.asarray(a)).max()) > 0.0
        assert_rel_close(a, b.numpy(), 1e-12, "dhv correction")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_builder_matches_jax(mesh):
    jm, pm = meshes(mesh)
    Ei, E = jm.num_internal_edges, jm.num_edges
    perm = np.concatenate([np.arange(Ei), Ei + np.random.default_rng(
        4).permutation(E - Ei)])
    jarr, jhost = jbs.build_bs2002_arrays(jm, perm, Ei, jnp.float64,
                                          return_host=True)
    host = pbs.build_bs2002_host(pm, perm, Ei)
    np.testing.assert_array_equal(jhost["bs_vertex_cells"],
                                  host["vertex_cells"])
    np.testing.assert_array_equal(1.0 / jhost["bs_vertex_count"],
                                  host["vertex_inv_count"])
    for k in pbs.BS2002Arrays._fields:
        want = np.asarray(getattr(jarr, k))
        assert want.shape == host[k].shape, k
        if k in pbs.INDEX_FIELDS:
            np.testing.assert_array_equal(want, host[k], err_msg=k)
        else:
            assert_rel_close(want, host[k], 1e-12, k)


@pytest.mark.parametrize("mesh", ["tri", "quad"])
def test_hr_slots_match_jax_tables(mesh):
    jm, _ = meshes(mesh)
    jop = jax_build_operator(jm, bc_types={"left": 0, "right": 2},
                             well_balancing_hr=True, dtype=jnp.float64)
    top = port_wb_operator(jop)
    nbr, cn, sn = hr_slots(top.arrays, top.num_cells)
    used = np.asarray(jop.arrays.cell_edge_coef) != 0.0
    np.testing.assert_array_equal(np.asarray(jop.arrays.hr_nbr_cell)[used],
                                  nbr.numpy()[used])
    np.testing.assert_array_equal(np.asarray(jop.arrays.hr_cn), cn.numpy())
    np.testing.assert_array_equal(np.asarray(jop.arrays.hr_sn), sn.numpy())
