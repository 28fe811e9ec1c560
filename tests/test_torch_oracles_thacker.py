"""Thacker's (1981) parabolic-bowl oscillation (tests/test_thacker.py) on
rdycore_tpu_torch's interval advancer on the CPU, in f64, at the JAX
tests' size (80 x 80 quads, dt = 2e-3 s, one period) and thresholds: the
moving wet/dry front's quantitative benchmark (the deck of
tools/torch_thacker.py). The axisymmetric solution

  z(r)      = -h0 (1 - r^2/a^2)
  eta(r, t) = h0 [ sqrt(1-A^2)/(1-A cos wt) - 1
                   - (r^2/a^2) ((1-A^2)/(1-A cos wt)^2 - 1) ]
  w = sqrt(8 g h0) / a,   A = ((h0+e0)^2 - h0^2) / ((h0+e0)^2 + h0^2)

is periodic with period T = 2 pi / w: after one period the first-order
state is back to the IC up to its dissipation, and MUSCL with the
positivity limiter stays finite and at least as accurate. The first-order
run is made once for both tests (the JAX MUSCL test makes it again).
`test_thacker.py::test_thacker_bowl_muscl_pallas_limited` tests the JAX
package's Pallas backend and has no counterpart here.
"""

import numpy as np
import pytest

from rdycore_tpu_torch.constants import GRAVITY

from test_torch_oracles import (  # noqa: F401  (an autouse fixture)
    advance, cpu_operator, one_torch_thread)
from tools.torch_thacker import ETA0, H0, thacker_case, thacker_eta

N = 80
DT = 2e-3  # a Courant number near 0.05 at dx = 0.055 m


def one_period(mesh, h0, T, second_order):
    q0 = np.zeros((3, mesh.num_cells))
    q0[0] = h0
    op = cpu_operator(mesh, second_order=second_order)
    return advance(op, q0, DT, int(np.ceil(T / DT)), T)


def rel_l1(h1, h0):
    wet = (h0 > 1e-4) | (h1 > 1e-4)
    return np.abs(h1 - h0)[wet].mean() / h0[wet].mean()


@pytest.fixture(scope="module")
def first_order():
    mesh, r2, w, A, T, h0 = thacker_case(N)
    return mesh, r2, w, A, T, h0, one_period(mesh, h0, T, False)


def test_thacker_bowl_one_period(first_order):
    mesh, r2, w, A, T, h0, q1 = first_order
    assert (h0 == 0).any() and (h0 > 0).any()  # partially wet IC
    h1 = q1[0]
    assert np.isfinite(h1).all() and (h1 >= 0).all()
    # mass is conserved exactly (reflecting box, no sources)
    np.testing.assert_allclose(float((h1 * mesh.cell_area).sum()),
                               float((h0 * mesh.cell_area).sum()),
                               rtol=1e-12)
    # the wet/dry front moved (mid-period eta at the initial front radius
    # is below the bed there)
    h_mid = np.maximum(thacker_eta(r2, T / 2.0, w, A) - mesh.cell_z, 0.0)
    assert ((h_mid > 0) != (h0 > 0)).sum() > 50
    # back to the IC up to first-order dissipation
    err = rel_l1(h1, h0)
    assert err < 0.08, f"L1/mean = {err:.3f}"
    # momenta back to ~zero relative to their mid-period magnitude
    c_ref = ETA0 * np.sqrt(GRAVITY * H0)
    assert np.abs(q1[1]).max() < 0.5 * c_ref * H0 + 1e-4


def test_thacker_bowl_muscl_positivity(first_order):
    """MUSCL on a drying front: the positivity limiter keeps it bounded
    and at least as accurate as first order over a full period."""
    mesh, r2, w, A, T, h0, q1 = first_order
    h1 = one_period(mesh, h0, T, True)[0]
    assert np.isfinite(h1).all(), "second order blew up"
    errs = {False: rel_l1(q1[0], h0), True: rel_l1(h1, h0)}
    assert errs[True] <= errs[False] * 1.05, errs
