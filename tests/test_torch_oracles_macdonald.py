"""MacDonald's (1997) steady subcritical channel (tests/test_macdonald.py)
on rdycore_tpu_torch's interval advancer on the CPU, in f64, at the JAX
tests' sizes and thresholds (slow there and here): unit discharge q = 2
m^2/s on a 1000 m channel with Manning n = 0.033 and the analytic depth

    h(x) = (4/g)^(1/3) * (1 + 0.5 * exp(-16 (x/L - 1/2)^2))

over the bed that makes it exact (from the steady momentum equation). A
drift of the Roe flux, the bed-slope term or the Manning friction from the
standard form converges to the wrong profile.
"""

import numpy as np
import pytest

from rdycore_tpu_torch.constants import GRAVITY
from rdycore_tpu_torch.mesh import structured_quad
from rdycore_tpu_torch.ops.swe.boundary import BC_DIRICHLET

from test_torch_oracles import (  # noqa: F401  (an autouse fixture)
    advance, cpu_operator, one_torch_thread)

L = 1000.0
Q = 2.0  # unit discharge [m^2/s]
N_MANNING = 0.033


def h_exact(x):
    return (4.0 / GRAVITY) ** (1.0 / 3.0) * (
        1.0 + 0.5 * np.exp(-16.0 * (x / L - 0.5) ** 2))


def dh_dx(x):
    return ((4.0 / GRAVITY) ** (1.0 / 3.0) * 0.5
            * np.exp(-16.0 * (x / L - 0.5) ** 2) * (-32.0 * (x / L - 0.5) / L))


def dz_dx(x):
    h = h_exact(x)
    return ((Q * Q / (GRAVITY * h**3) - 1.0) * dh_dx(x)
            - N_MANNING**2 * Q * Q / h ** (10.0 / 3.0))


def z_of(x):
    """Bed elevation by dense trapezoid integration of dz/dx (smooth)."""
    xs = np.linspace(0.0, L, 20001)
    zs = np.concatenate(
        [[0.0], np.cumsum((dz_dx(xs[1:]) + dz_dx(xs[:-1])) / 2 * np.diff(xs))])
    return np.interp(x, xs, zs)


def _run(nx, t_end=1500.0):
    ny = 4
    mesh = structured_quad(nx, ny, 0.0, L, 0.0, 40.0,
                           z_fn=lambda x, y: z_of(x))
    op = cpu_operator(mesh, mannings_n=np.full(mesh.num_cells, N_MANNING),
                      bc_types={"left": BC_DIRICHLET, "right": BC_DIRICHLET})
    # Dirichlet values: exact (h, q, 0) at both ends
    bv = np.zeros((3, op.num_boundary_edges))
    for seg in op.segments:
        sl = slice(seg.start, seg.start + seg.count)
        if seg.name == "left":
            bv[0, sl], bv[1, sl] = h_exact(0.0), Q
        elif seg.name == "right":
            bv[0, sl], bv[1, sl] = h_exact(L), Q
    x = mesh.cell_centroid[:, 0]
    q0 = np.zeros((3, mesh.num_cells))
    q0[0] = h_exact(x)  # start from the exact profile; must STAY there
    q0[1] = Q
    dx = L / nx
    c = np.sqrt(GRAVITY * h_exact(L / 2)) + Q / h_exact(L / 2)
    dt = 0.4 * dx / c
    q1 = advance(op, q0, dt, int(np.ceil(t_end / dt)), t_end, bv,
                 accumulate=False)
    h = q1[0].reshape(ny, nx).mean(axis=0)
    return h, x.reshape(ny, nx)[0]


@pytest.mark.slow
def test_macdonald_steady_profile_converges():
    """Relative L2 error of h small, and falling with resolution like a
    first-order scheme's."""
    errs = []
    for nx in (100, 200):
        h, xs = _run(nx)
        hx = h_exact(xs)
        errs.append(np.sqrt(np.mean((h - hx) ** 2)) / np.sqrt(np.mean(hx**2)))
    assert errs[0] < 0.01, errs
    assert errs[1] < errs[0] * 0.65, errs


@pytest.mark.slow
def test_macdonald_discharge_uniform():
    """The steady profile stays subcritical, as the benchmark's."""
    h, xs = _run(200)
    froude = (Q / h) / np.sqrt(GRAVITY * h)
    assert froude.max() < 1.0
