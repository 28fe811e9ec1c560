"""Bradford & Sanders (2002) well-balancing (plain PyTorch): the vertex
free-surface eta and the edge flux correction.

The numerics of rdycore_tpu/ops/swe/bs2002.py:25-148, which mirror the
reference:
- SWEEtaVertex (swe_well_balancing.h:30-85): per cell, a partial-wetting
  free-surface elevation eta_cell from the SORTED vertex elevations
  z1 <= z2 <= z3 (quads use their first three vertices) and the cell
  depth h; each vertex averages the eta of its adjacent cells (weight
  1/num_cells, operator_fluxes_ceed.c:798-826);
- the flux correction (swe_roe_flux_ceed.h:117-119): with
  dhv = max(eta_end - zv_end, 0) - max(eta_beg - zv_beg, 0) the momentum
  fluxes gain g * dhv^2 / 24 * (cn, sn).

`eta_vertices` is the plain version of the kernel K5 `swe_eta_vertex`
(ops/kernels/eta_vertex.py); K1a repeats `dhv_correction` per edge. The
JAX package's slot-routed twin (`eta_slotted`) is TPU layout and has no
counterpart here: the card gathers.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ...constants import GRAVITY
from ..math import cbrt, maximum0

INDEX_FIELDS = ("vertex_cells", "int_vbeg", "int_vend", "bnd_vbeg",
                "bnd_vend")


class BS2002Arrays(NamedTuple):
    # per-cell sorted vertex elevations (z1 <= z2 <= z3; quads use the
    # first 3 vertices, as operator_fluxes_ceed.c:807-815 reads 3)
    z1: torch.Tensor  # [C]
    z2: torch.Tensor
    z3: torch.Tensor
    # vertex -> adjacent cells, cells ascending, padded with C
    vertex_cells: torch.Tensor  # [NV, K] int32
    vertex_inv_count: torch.Tensor  # [NV] 1 / max(cells, 1)
    # edge endpoint vertex ids and elevations, in the operator's edge order
    int_vbeg: torch.Tensor  # [Ei] int32
    int_vend: torch.Tensor
    int_zvbeg: torch.Tensor  # [Ei]
    int_zvend: torch.Tensor
    bnd_vbeg: torch.Tensor  # [Eb] int32
    bnd_vend: torch.Tensor
    bnd_zvbeg: torch.Tensor
    bnd_zvend: torch.Tensor


def vertex_cell_lists(mesh):
    """(vertex_cells [NV, K] int64 padded with C, count [NV] float64 with
    an empty vertex counted 1): the cells of each vertex, ascending. A
    stable sort of the (vertex, cell) pairs, taken cell by cell, keeps the
    order of the JAX package's loop over cells and vertex slots."""
    C, NV = mesh.num_cells, mesh.num_vertices
    cv = np.asarray(mesh.cell_vertices)
    valid = np.arange(cv.shape[1])[None, :] < np.asarray(
        mesh.cell_num_vertices)[:, None]
    cells = np.broadcast_to(np.arange(C)[:, None], cv.shape)[valid]
    verts = cv[valid].astype(np.int64)
    order = np.argsort(verts, kind="stable")
    verts, cells = verts[order], cells[order]
    counts = np.bincount(verts, minlength=NV)
    K = int(counts.max()) if NV else 1
    rank = np.arange(verts.size) - (np.cumsum(counts) - counts)[verts]
    vc = np.full((NV, K), C, dtype=np.int64)
    vc[verts, rank] = cells
    return vc, np.maximum(counts, 1).astype(np.float64)


def build_bs2002_host(mesh, edge_perm: np.ndarray, Ei: int
                      ) -> Dict[str, np.ndarray]:
    """The fields of BS2002Arrays as host arrays (float64 and int64), for
    the operator edge order `edge_perm` (interior edges first)."""
    pts_z = np.asarray(mesh.points[:, 2], dtype=np.float64)
    v3 = np.asarray(mesh.cell_vertices[:, :3])
    z3 = np.sort(pts_z[np.where(v3 >= 0, v3, 0)], axis=1)
    vc, cnt = vertex_cell_lists(mesh)
    ev = np.asarray(mesh.edge_vertices)[edge_perm].astype(np.int64)
    return dict(
        z1=z3[:, 0], z2=z3[:, 1], z3=z3[:, 2],
        vertex_cells=vc, vertex_inv_count=1.0 / cnt,
        int_vbeg=ev[:Ei, 0], int_vend=ev[:Ei, 1],
        int_zvbeg=pts_z[ev[:Ei, 0]], int_zvend=pts_z[ev[:Ei, 1]],
        bnd_vbeg=ev[Ei:, 0], bnd_vend=ev[Ei:, 1],
        bnd_zvbeg=pts_z[ev[Ei:, 0]], bnd_zvend=pts_z[ev[Ei:, 1]],
    )


def bs2002_arrays_from_numpy(d: Dict[str, np.ndarray], device: torch.device,
                             dtype: torch.dtype) -> BS2002Arrays:
    """BS2002Arrays from host arrays: the vertex and endpoint ids as int32,
    the rest as `dtype`, all on `device`."""
    return BS2002Arrays(**{
        k: torch.as_tensor(np.array(d[k]), device=device,
                           dtype=torch.int32 if k in INDEX_FIELDS else dtype)
        for k in BS2002Arrays._fields
    })


def eta_cells(z1, z2, z3, h, tiny_h: float):
    """Per-cell partial-wetting free-surface eta (the elementwise part of
    SWEEtaVertex, swe_well_balancing.h:30-85)."""
    dz31 = z3 - z1
    dz31_safe = torch.where(dz31 != 0.0, dz31, 1.0)
    h3 = z3 - (z1 + z2 + z3) / 3.0
    h2 = torch.where(z2 < z3, (z2 - z1) * (z2 - z1) / (3.0 * dz31_safe), h3)
    # wet-bed sub-cases: all, one or two vertices submerged
    all_sub = (z1 + z2 + z3) / 3.0 + h
    one_sub = z1 + cbrt(maximum0(3.0 * h * (z2 - z1) * dz31))
    b = z3 - 3.0 * z1
    c = z1 * z2 + z1 * z1 - z3 * z2 - 3.0 * h * dz31
    two_sub = 0.5 * (-b + torch.sqrt(maximum0(b * b - 4.0 * c)))
    return torch.where(
        h <= tiny_h, z1,
        torch.where(h >= h3, all_sub,
                    torch.where((h > 0.0) & (h <= h2), one_sub, two_sub)),
    )


def eta_vertices(bs: BS2002Arrays, h, tiny_h: float):
    """eta at the mesh vertices [NV] from the cell depths h [C] (the plain
    version of K5)."""
    eta_cell = eta_cells(bs.z1, bs.z2, bs.z3, h, tiny_h)
    eta_pad = torch.cat([eta_cell, eta_cell.new_zeros(1)])
    return eta_pad[bs.vertex_cells].sum(dim=1) * bs.vertex_inv_count


def dhv_correction(eta_v, vbeg, vend, zvbeg, zvend, cn, sn):
    """(df_hu, df_hv): the momentum flux correction g*dhv^2/24*(cn, sn)."""
    hv_beg = maximum0(eta_v[vbeg] - zvbeg)
    hv_end = maximum0(eta_v[vend] - zvend)
    dhv = hv_end - hv_beg
    corr = GRAVITY * dhv * dhv / 24.0
    return corr * cn, corr * sn
