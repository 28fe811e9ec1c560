"""MUSCL second-order reconstruction in gather form (plain PyTorch).

The numerics of rdycore_tpu/ops/swe/muscl.py, after the reference's
weighted least-squares gradient and limited linear extrapolation
(operator_fluxes_ceed.c:860-1208):

- `precompute_ls_coefficients` (host numpy, float64) builds each cell's
  2x2 normal matrix from centroid deltas with 1/d weights, inverts it
  analytically (a cell whose matrix is degenerate, |det| < 1e-15, gets a
  zero gradient) and gives each (cell, slot) of `cell_edges` its
  coefficient, so that a cell *gathers* its gradient as
  sum_k c[c, k] * (q[right] - q[left]) over its interior edges;
- `ls_gradients` is that gather (the plain version of the kernel K3a);
- `limit_slope` is minmod / van Leer / none
  (operator_fluxes_ceed.c:1109-1134), and `reconstruct_interior_states`
  the face values q_cell + limit(grad . d, +-dq/2) with h clamped >= 0
  (ReconstructFaceValues :1199-1201).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..math import maximum0

# limiter codes of the CUDA kernels (csrc/swe_physics.cuh kLim*)
LIMITERS = {"minmod": 1, "van_leer": 2, "none": 3}


def precompute_ls_coefficients(mesh, edge_perm, Ei):
    """Per-(cell, slot) LS gradient coefficients aligned to
    mesh.cell_edges, and the centroid -> edge-midpoint displacements of the
    interior edges in the operator's edge order.

    Returns (cell_ls_cx, cell_ls_cy) [C, K] (zero on non-interior slots)
    and (dxl, dyl, dxr, dyr) [Ei], all float64.
    """
    C = mesh.num_cells
    left = mesh.edge_cells[edge_perm, 0]
    right = mesh.edge_cells[edge_perm, 1]
    cent = mesh.cell_centroid

    il = left[:Ei]
    ir = right[:Ei]
    dx = cent[ir, 0] - cent[il, 0]
    dy = cent[ir, 1] - cent[il, 1]
    d = np.sqrt(dx * dx + dy * dy)
    w = np.where(d > 0.0, 1.0 / np.where(d > 0, d, 1.0), 0.0)

    # per-cell normal matrix [[m00, m01], [m01, m11]]
    m00 = np.zeros(C)
    m01 = np.zeros(C)
    m11 = np.zeros(C)
    for cells in (il, ir):
        np.add.at(m00, cells, w * dx * dx)
        np.add.at(m01, cells, w * dx * dy)
        np.add.at(m11, cells, w * dy * dy)

    det = m00 * m11 - m01 * m01
    degen = np.abs(det) < 1e-15
    inv_det = np.where(degen, 0.0, 1.0 / np.where(degen, 1.0, det))
    i00 = m11 * inv_det
    i01 = -m01 * inv_det
    i11 = m00 * inv_det

    wdx = w * dx
    wdy = w * dy
    cx_lr = i00[il] * wdx + i01[il] * wdy
    cy_lr = i01[il] * wdx + i11[il] * wdy
    cx_rl = i00[ir] * wdx + i01[ir] * wdy
    cy_rl = i01[ir] * wdx + i11[ir] * wdy

    # slot k of cell c on interior edge e takes e's left coefficient when c
    # is e's left cell, its right one when c is the right cell
    inv_perm = np.empty(len(edge_perm) + 1, dtype=np.int64)
    inv_perm[edge_perm] = np.arange(len(edge_perm))
    inv_perm[len(edge_perm)] = len(edge_perm)
    ce_op = inv_perm[mesh.cell_edges]  # [C, K] in the operator's edge order
    cells_idx = np.arange(C)[:, None]
    is_int = ce_op < Ei
    e_idx = np.where(is_int, ce_op, 0)
    is_left = is_int & (il[e_idx] == cells_idx)
    is_right = is_int & (ir[e_idx] == cells_idx)
    cell_ls_cx = np.where(is_left, cx_lr[e_idx],
                          np.where(is_right, cx_rl[e_idx], 0.0))
    cell_ls_cy = np.where(is_left, cy_lr[e_idx],
                          np.where(is_right, cy_rl[e_idx], 0.0))

    ev = mesh.edge_vertices[edge_perm[:Ei]]
    xm = (mesh.points[ev[:, 0], 0] + mesh.points[ev[:, 1], 0]) / 2.0
    ym = (mesh.points[ev[:, 0], 1] + mesh.points[ev[:, 1], 1]) / 2.0
    return (cell_ls_cx, cell_ls_cy, xm - cent[il, 0], ym - cent[il, 1],
            xm - cent[ir, 0], ym - cent[ir, 1])


def ls_gradients(a, q: torch.Tensor) -> torch.Tensor:
    """LS gradients [6, C] (d/dx of h, hu, hv, then d/dy) of the flow rows
    of q [3, C] on operator arrays `a` (muscl.py
    reconstruct_interior_states :136-143)."""
    Ei = a.int_left.shape[0]
    E = Ei + a.bnd_left.shape[0]
    dq = q[:3, a.int_right] - q[:3, a.int_left]
    dq_pad = q.new_zeros((3, E + 1))
    dq_pad[:, :Ei] = dq
    gathered = dq_pad[:, a.cell_edges]  # [3, C, K]
    return torch.cat([(gathered * a.cell_ls_cx).sum(dim=-1),
                      (gathered * a.cell_ls_cy).sum(dim=-1)])


def limit_slope(limiter: str, extrap, half_dq):
    """minmod / van Leer / none (operator_fluxes_ceed.c:1109-1134)."""
    if limiter == "none":
        return extrap
    prod = extrap * half_dq
    if limiter == "van_leer":
        s = extrap + half_dq
        s_safe = torch.where(s != 0.0, s, 1.0)
        return torch.where(prod > 0.0, 2.0 * prod / s_safe, 0.0)
    if limiter != "minmod":
        raise ValueError(f"limiter: {limiter!r}")
    return torch.where(
        prod <= 0.0, 0.0,
        torch.where(torch.abs(extrap) < torch.abs(half_dq), extrap, half_dq),
    )


def reconstruct_interior_states(
    a, q: torch.Tensor, grad: torch.Tensor, limiter: str
) -> Tuple[Tuple, Tuple]:
    """Second-order face states of the interior edges from the gradients
    grad [6, C]: ((h, hu, hv)_L, (h, hu, hv)_R), h clamped >= 0."""
    il, ir = a.int_left, a.int_right
    dq = q[:3, ir] - q[:3, il]
    gx, gy = grad[:3], grad[3:]
    extrap_l = gx[:, il] * a.int_dxl + gy[:, il] * a.int_dyl
    extrap_r = gx[:, ir] * a.int_dxr + gy[:, ir] * a.int_dyr
    ql = q[:3, il] + limit_slope(limiter, extrap_l, 0.5 * dq)
    qr = q[:3, ir] + limit_slope(limiter, extrap_r, -0.5 * dq)
    return ((maximum0(ql[0]), ql[1], ql[2]),
            (maximum0(qr[0]), qr[1], qr[2]))
