"""The JAX package's analytic oracles, run on rdycore_tpu_torch's interval
advancer on the CPU (the kernels' plain versions), in f64, at the JAX
tests' sizes and against their thresholds:

- Stoker's wet-bed and Ritter's dry-bed dam breaks (tests/test_stoker.py);
- a passive and a sediment blob in uniform flow
  (tests/test_tracer_advection.py; the passive one is slow there and here).

The steady flows over a bump (tests/test_bump_steady.py) are in
tests/test_torch_oracles_bump.py and tests/test_torch_oracles_bump_trans.py,
Thacker's bowl in tests/test_torch_oracles_thacker.py and MacDonald's
channel (slow there and here) in tests/test_torch_oracles_macdonald.py:
the port's plain versions take 5-20 ms a step on the CPU, and these run
thousands of steps.
"""

import numpy as np
import pytest
import torch

from rdycore_tpu_torch.constants import GRAVITY
from rdycore_tpu_torch.mesh import structured_quad
from rdycore_tpu_torch.operator import build_operator
from rdycore_tpu_torch.ops.swe.boundary import BC_DIRICHLET
from rdycore_tpu_torch.timestepping import make_interval_advancer

G = GRAVITY


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these loops run thousands of small operations,
    which several threads per test worker only slow down (the workers
    already fill the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_operator(mesh, **kw):
    """A frictionless f64 operator on the CPU, unless kw says otherwise."""
    kw.setdefault("mannings_n", np.zeros(mesh.num_cells))
    return build_operator(mesh, device="cpu", **kw)


def advance(op, q0, dt, n_steps, t_end, bv=None, scheme="euler", **kw):
    """The end state of one interval from q0 (numpy), as numpy."""
    q0 = torch.as_tensor(np.asarray(q0, np.float64))
    bv = op.zero_boundary_values() if bv is None else torch.as_tensor(bv)
    res = make_interval_advancer(op, scheme, **kw)(
        q0, 0.0, dt, n_steps, t_end, bv, torch.zeros_like(q0))
    return res.q.numpy()


# ---------------------------------------------------------------- Stoker
HL, HR = 10.0, 5.0


def _middle_state():
    """hm via bisection on the rarefaction/shock matching relation."""
    cl = np.sqrt(G * HL)

    def f(hm):
        cm = np.sqrt(G * hm)
        u_rare = 2.0 * (cl - cm)
        u_shock = (hm - HR) * np.sqrt(G * (hm + HR) / (2.0 * hm * HR))
        return u_rare - u_shock

    lo, hi = HR, HL
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if f(mid) > 0:
            lo = mid
        else:
            hi = mid
    hm = 0.5 * (lo + hi)
    um = 2.0 * (cl - np.sqrt(G * hm))
    S = um * hm / (hm - HR)  # shock speed (mass jump condition)
    return hm, um, S


def _exact_h(x, t):
    cl = np.sqrt(G * HL)
    hm, um, S = _middle_state()
    cm = np.sqrt(G * hm)
    xi = x / t
    h = np.where(xi < -cl, HL, HR)
    fan = (xi >= -cl) & (xi < um - cm)
    h = np.where(fan, ((2.0 * cl - xi) ** 2) / (9.0 * G), h)
    mid = (xi >= um - cm) & (xi < S)
    return np.where(mid, hm, h)


@pytest.mark.parametrize("second_order,tol", [(False, 0.020), (True, 0.012)])
def test_stoker_dam_break(second_order, tol):
    nx, ny = 400, 4
    L = 100.0
    mesh = structured_quad(nx, ny, -L, L, 0.0, 2.0)
    x = mesh.cell_centroid[:, 0]
    q0 = np.zeros((3, mesh.num_cells))
    q0[0] = np.where(x < 0.0, HL, HR)
    op = cpu_operator(mesh, second_order=second_order)

    t_end = 4.0  # waves stay well inside [-L, L]: cl*t = 40, S*t ~ 36
    dt = 0.01  # CFL ~ 0.3 at dx = 0.5, max speed ~ 14 m/s
    h1 = advance(op, q0, dt, int(round(t_end / dt)), t_end)[0]
    h_exact = _exact_h(x, t_end)

    assert np.isfinite(h1).all()
    rel_l1 = np.abs(h1 - h_exact).mean() / h_exact.mean()
    assert rel_l1 < tol, f"rel L1 = {rel_l1:.4f} (tol {tol})"
    # the computed shock sits within a few cells of the exact position
    _, _, S = _middle_state()
    x_shock = S * t_end
    row = np.abs(mesh.cell_centroid[:, 1] - 0.25) < 0.26
    xs, hs = x[row], h1[row]
    o = np.argsort(xs)
    xs, hs = xs[o], hs[o]
    hm = _middle_state()[0]
    thresh = 0.5 * (hm + HR)
    # first cell from the right whose depth exceeds the mid-state mean
    x_num = xs[len(xs) - 1 - np.argmax(hs[::-1] > thresh)]
    assert abs(x_num - x_shock) < 2.0, (x_num, x_shock)


def test_ritter_dry_bed_dam_break():
    """Ritter (1892): a pure rarefaction with the wetting front at x = 2
    c_l t; the bulk profile matches and the front lags the analytic tip
    (tiny_h cutoff) by under 20%, never leads it."""
    nx, ny = 400, 4
    L = 100.0
    mesh = structured_quad(nx, ny, -L, L, 0.0, 2.0)
    x = mesh.cell_centroid[:, 0]
    q0 = np.zeros((3, mesh.num_cells))
    q0[0] = np.where(x < 0.0, HL, 0.0)
    op = cpu_operator(mesh)

    cl = np.sqrt(G * HL)
    t_end = 3.0  # front at 2*cl*t ~ 59 m, inside the box
    dt = 0.005
    h1 = advance(op, q0, dt, int(round(t_end / dt)), t_end)[0]
    assert np.isfinite(h1).all() and (h1 >= 0).all()

    xi = x / t_end
    h_exact = np.where(xi < -cl, HL, 0.0)
    fan = (xi >= -cl) & (xi < 2.0 * cl)
    h_exact = np.where(fan, ((2.0 * cl - xi) ** 2) / (9.0 * G), h_exact)

    wet = h_exact > 0.05
    rel_l1 = np.abs(h1 - h_exact)[wet].mean() / h_exact[wet].mean()
    assert rel_l1 < 0.03, f"rel L1 = {rel_l1:.4f}"

    x_front = x[h1 > 0.01].max()
    x_exact = 2.0 * cl * t_end
    assert x_front < x_exact, "dry front must not outrun the analytic tip"
    assert (x_exact - x_front) / x_exact < 0.20, (x_front, x_exact)


# ---------------------------------------------------------------- tracers
H, U = 2.0, 1.0


def blob(nx, ny, num_sediment):
    """A Gaussian blob of tracer at x = 8 in uniform flow (H, U) with the
    uniform state on both Dirichlet ends: (mesh, op, q0, bv, c0)."""
    mesh = structured_quad(nx, ny, 0.0, 40.0, 0.0, 6.0)
    x, y = mesh.cell_centroid[:, 0], mesh.cell_centroid[:, 1]
    op = cpu_operator(mesh, num_tracers=1, num_sediment=num_sediment,
                      bc_types={"left": BC_DIRICHLET, "right": BC_DIRICHLET})
    c0 = np.exp(-((x - 8.0) ** 2 + (y - 3.0) ** 2) / 2.0)
    q0 = np.zeros((4, mesh.num_cells))
    q0[0], q0[1], q0[3] = H, H * U, H * c0
    bv = np.zeros((4, op.num_boundary_edges))
    bv[0], bv[1] = H, H * U  # steady inflow and outflow, no tracer inflow
    return mesh, op, q0, bv, c0


@pytest.mark.slow
def test_tracer_blob_advects_at_flow_speed():
    """A passive tracer's centre of mass moves at exactly U, its mass kept
    (the blob stays off both ends)."""
    mesh, op, q0, bv, c0 = blob(160, 24, 0)
    x, y = mesh.cell_centroid[:, 0], mesh.cell_centroid[:, 1]
    t_end = 16.0  # blob moves 8 -> 24, stays away from both ends
    dt = 0.02  # CFL ~ 0.43: c + u ~ 5.4, dx = 0.25
    hc1 = advance(op, q0, dt, int(round(t_end / dt)), t_end, bv)[3]
    area = mesh.cell_area
    assert np.isfinite(hc1).all()
    m0 = float((H * c0 * area).sum())
    m1 = float((hc1 * area).sum())
    np.testing.assert_allclose(m1, m0, rtol=1e-10)
    x0 = float((H * c0 * area * x).sum()) / m0
    x1 = float((hc1 * area * x).sum()) / m1
    assert abs((x1 - x0) - U * t_end) < 0.05 * U * t_end, (x0, x1)
    y0 = float((H * c0 * area * y).sum()) / m0
    y1 = float((hc1 * area * y).sum()) / m1
    assert abs(y1 - y0) < 0.05


def test_sediment_blob_deposits():
    """The same blob as a sediment class loses mass to deposition
    (Hairsine-Rose settling), boundedly over 4 s."""
    mesh, op, q0, bv, c0 = blob(80, 12, 1)
    hc1 = advance(op, q0, 0.02, 200, 1e9, bv)[3]
    m0 = float((H * c0 * mesh.cell_area).sum())
    m1 = float((hc1 * mesh.cell_area).sum())
    assert m1 < 0.995 * m0  # deposition sink active
    assert m1 > 0.5 * m0  # but bounded over 4 s
