"""The MMS driver of rdycore_tpu_torch on the CPU, without the JAX package.

- every hand-written derivative of the manufactured solution
  (tools/torch_mms_decks.py) against a central difference of its own
  expression, so that a wrong derivative cannot pass as a slow rate;
- the torch expression backend: numbers beside tensors, constant
  expressions, floor-mod, `if ... else`, the sign of cbrt, a 0-d time
  tensor, the expression's variables;
- `Mesh.with_vertex_elevations` equal to a rebuild of the mesh;
- the boundary-edge midpoints of an MMS level in the operator's segment
  order (each on its edge's own cell);
- the advancer's bc_fn and src_fn: called once a step at t + dt_i/2, their
  values held over the stages;
- `python -m rdycore_tpu_torch deck.yaml --mms --cpu`: PASS exits 0, a
  threshold above the rates FAIL and 1, a deck without a convergence
  section its error norms and 0.
"""

import math

import numpy as np
import pytest
import torch
import yaml

from rdycore_tpu_torch.__main__ import main
from rdycore_tpu_torch.config.expressions import compile_expression
from rdycore_tpu_torch.config.yaml_input import config_from_dict
from rdycore_tpu_torch.mesh import (
    build_mesh,
    refine_uniform,
    save_mesh_npz,
    structured_tri,
)
from rdycore_tpu_torch.mesh.core import named_boundary_sets
from rdycore_tpu_torch.mms import MMSDriver, MMSProblem, setup_mms_level
from rdycore_tpu_torch.operator import build_operator
from rdycore_tpu_torch.ops.swe.boundary import BC_DIRICHLET
from rdycore_tpu_torch import timestepping
from rdycore_tpu_torch.timestepping import make_interval_advancer
from tools.torch_mms_decks import (
    CONSTANTS,
    SEDIMENT,
    SWE,
    base_mesh,
    mms_deck,
)

# (derivative, field, variable) of every hand-written derivative
DERIVATIVES = [
    (d, d[1:-2], d[-1]) for d in list(SWE) + list(SEDIMENT)
    if d.startswith("d") and d[-2:] in ("dx", "dy", "dt")
]


@pytest.mark.parametrize("deriv, field, var", DERIVATIVES,
                         ids=[d[0] for d in DERIVATIVES])
def test_derivative_matches_central_difference(deriv, field, var):
    exprs = {**SWE, **SEDIMENT}
    f = compile_expression(exprs[field], CONSTANTS, backend="torch")
    df = compile_expression(exprs[deriv], CONSTANTS, backend="torch")
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.uniform(0.0, 4.0, 200))
    y = torch.as_tensor(rng.uniform(0.0, 2.75, 200))
    t = torch.as_tensor(rng.uniform(0.0, 1.0, 200))
    eps = 1e-5
    args = {"x": x, "y": y, "t": t}
    hi = dict(args, **{var: args[var] + eps})
    lo = dict(args, **{var: args[var] - eps})
    fd = (f(**hi) - f(**lo)) / (2.0 * eps)
    got = df(x, y, t)
    scale = float(got.abs().max())
    assert scale > 0.0
    assert float((got - fd).abs().max()) <= 1e-7 * scale


def test_fields_read_the_variables_they_should():
    names = {k: compile_expression(e, CONSTANTS, backend="torch").names
             for k, e in SWE.items()}
    assert all("t" not in names[k] for k in ("z", "dzdx", "dzdy", "n"))
    assert all(names[k] == {"x", "y", "t"} for k in ("h", "u", "v", "dhdt"))


def test_torch_backend_numbers_and_tensors():
    x = torch.tensor([-1.5, -0.2, 0.0, 0.7, 2.5], dtype=torch.float64)
    y = 2.0 * x

    def ev(expr, t=0.0, consts=None):
        return compile_expression(expr, consts, backend="torch")(x, y, t)

    # constant expressions come back as Python numbers
    assert ev("0") == 0 and ev("2*K", consts={"K": 1.5}) == 3.0
    assert isinstance(ev("sin(pi/4)"), float)
    assert ev("sin(pi/4)") == pytest.approx(math.sin(math.pi / 4), abs=0)
    # a number beside a tensor in a call takes the tensor's dtype
    got = ev("max(x, 0.5) + pow(2, x) + atan2(1, x) + hypot(x, 3)")
    want = (torch.clamp(x, min=0.5) + 2.0 ** x + torch.atan2(
        torch.ones_like(x), x) + torch.hypot(x, torch.full_like(x, 3.0)))
    assert torch.equal(got, want) and got.dtype == torch.float64
    # floor-mod, like Python's %
    got = ev("x % 0.75")
    assert got.tolist() == [v % 0.75 for v in x.tolist()]
    # if ... else: torch.where, and a number as a branch
    assert ev("1 if x < 0 else y").tolist() == [1.0, 1.0, 0.0, 1.4, 5.0]
    # cbrt keeps the sign of its argument
    assert ev("cbrt(x)").tolist() == pytest.approx(
        [math.copysign(abs(v) ** (1 / 3), v) for v in x.tolist()],
        rel=1e-15)
    # t as a 0-d tensor, and an expression of t alone
    t = torch.tensor(0.25, dtype=torch.float64)
    assert torch.equal(ev("x*exp(t)", t), x * torch.exp(t))
    assert ev("t*2", t).shape == ()
    # float32 tensors stay float32
    x32 = x.float()
    f = compile_expression("max(x, 0.5) * 3 if x > 0 else -1", backend="torch")
    assert f(x32, x32, 0.0).dtype == torch.float32


def test_numpy_backend_unchanged():
    f = compile_expression("sin(x) if x > 0 else cbrt(x)")
    x = np.array([-8.0, 1.0])
    assert np.array_equal(f(x, x, 0.0), np.where(x > 0, np.sin(x),
                                                 np.cbrt(x)))
    with pytest.raises(ValueError):
        compile_expression("x", backend="jax")


def test_with_vertex_elevations_equals_a_rebuild():
    m = refine_uniform(structured_tri(6, 4, 0.0, 3.0, 0.0, 2.0), 1)
    z = np.sin(m.points[:, 0]) * m.points[:, 1]
    got = m.with_vertex_elevations(z)
    pts = m.points.copy()
    pts[:, 2] = z
    want = build_mesh(pts, m.cell_vertices, m.cell_num_vertices,
                      regions=m.regions,
                      boundary_edges={n: m.edge_vertices[e] for n, e in
                                      named_boundary_sets(m).items()})
    for name in ("points", "cell_vertices", "cell_area", "cell_centroid",
                 "cell_dz_dx", "cell_dz_dy", "cell_z", "edge_cells",
                 "edge_cn", "edge_sn", "edge_length", "edge_vertices",
                 "cell_edges", "cell_edge_sign"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.boundaries.keys() == want.boundaries.keys()


def small_config(refinements=0, **kw):
    return config_from_dict(mms_deck("unused.npz", 5e-3, 0.02, refinements,
                                     **kw)).validate()


@pytest.mark.parametrize("tri", [False, True])
def test_level_boundary_midpoints_follow_the_segments(tri):
    """bc_fn's points are the boundary-edge midpoints in the operator's
    segment order: each lies on an edge of the cell that the operator's
    boundary slot reads, and the solution there is that of the midpoint."""
    problem = MMSProblem(small_config())
    level = setup_mms_level(problem, base_mesh(6, 4, tri), device="cpu")
    mesh, op = level.mesh, level.op
    eids = np.concatenate([s.edge_ids for s in op.segments])
    left = mesh.edge_cells[eids, 0]
    assert np.array_equal(op.arrays.bnd_left.numpy(), left)
    assert {s.name for s in op.segments} == {"left", "right", "bottom", "top"}
    assert all(s.bc_type == BC_DIRICHLET for s in op.segments)
    ev = mesh.edge_vertices[eids]
    mid = (mesh.points[ev[:, 0], :2] + mesh.points[ev[:, 1], :2]) / 2.0
    t = torch.tensor(0.01, dtype=torch.float64)
    want = problem.solution(torch.as_tensor(mid[:, 0]),
                            torch.as_tensor(mid[:, 1]), t)
    assert torch.equal(level.bc_fn(t), want)
    # the vertices sit on the analytic bed, the Manning values per cell
    z = problem.host_field("z", mesh.points[:, 0], mesh.points[:, 1])
    assert np.array_equal(mesh.points[:, 2], z)
    n = op.arrays.mannings_n.numpy()
    assert n.std() > 0.0 and n.min() >= CONSTANTS["N"]


def test_constant_fields_broadcast():
    """A constant expression (u = 0, n = 0.03) becomes a full field."""
    cfg = small_config()
    cfg.mms.swe.update(u="0", dudx="0", dudy="0", dudt="0", n="0.03")
    problem = MMSProblem(cfg)
    x = torch.linspace(0.0, 4.0, 7, dtype=torch.float64)
    q = problem.solution(x, x, 0.0)
    assert q.shape == (3, 7) and torch.all(q[1] == 0.0)
    assert problem.source_terms(x, x, 0.5).shape == (3, 7)
    assert np.array_equal(problem.host_field("n", x.numpy(), x.numpy()),
                          np.full(7, 0.03))


@pytest.mark.parametrize("scheme", ["euler", "ssprk3", "rk4", "ark_imex",
                                    "beuler"])
def test_forcing_is_evaluated_once_a_step_at_the_half_step(scheme,
                                                           monkeypatch):
    """Every scheme, beuler (one Newton iteration of GMRES(1)) with its
    residuals and JVPs, sees the step's forcing."""
    monkeypatch.setattr(timestepping, "NEWTON_ITERS", 1)
    monkeypatch.setattr(timestepping, "KRYLOV_M", 1)
    mesh = base_mesh(4, 3)
    op = build_operator(mesh, bc_types={n: BC_DIRICHLET
                                        for n in mesh.boundaries},
                        mannings_n=np.full(mesh.num_cells, 0.02),
                        device="cpu")
    Eb, C = op.num_boundary_edges, op.num_cells
    seen = {"bc": [], "src": []}

    def bc_fn(t):
        seen["bc"].append(float(t))
        return torch.full((3, Eb), 0.1, dtype=torch.float64) * torch.tensor(
            [1.0, 0.1, 0.0], dtype=torch.float64)[:, None]

    def src_fn(t):
        seen["src"].append(float(t))
        return torch.full((3, C), 1e-4, dtype=torch.float64)

    q = torch.zeros((3, C), dtype=torch.float64)
    q[0] = 0.1
    dt, n, t_end = 0.01, 4, 0.035
    res = make_interval_advancer(op, scheme, bc_fn=bc_fn, src_fn=src_fn)(
        q, 0.0, dt, n, t_end, op.zero_boundary_values(), None)
    want = [0.005, 0.015, 0.025, 0.0325]  # the last step cut to 0.005
    assert seen["bc"] == pytest.approx(want, abs=1e-15)
    assert seen["src"] == pytest.approx(want, abs=1e-15)
    # the same as the constant values passed in as the interval's own
    ref = make_interval_advancer(op, scheme)(
        q, 0.0, dt, n, t_end, bc_fn(0.0), src_fn(0.0))
    assert torch.equal(res.q, ref.q)


def write_deck(tmp_path, refinements, expected_rates=None):
    save_mesh_npz(base_mesh(8, 6), str(tmp_path / "base.npz"))
    deck = mms_deck("base.npz", 5e-3, 0.02, refinements,
                    expected_rates=expected_rates)
    path = tmp_path / "mms.yaml"
    path.write_text(yaml.safe_dump(deck))
    return str(path)


LOW = {"h": {"L1": 0.5, "L2": 0.5, "Linf": 0.3}}
HIGH = {"h": {"L1": 0.5, "L2": 5.0, "Linf": 0.3}}


def test_cli_mms_pass_and_fail(tmp_path, capsys):
    path = write_deck(tmp_path, 1, LOW)
    assert main([path, "--mms", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "Convergence rates:" in out and "PASS" in out
    path = write_deck(tmp_path, 1, HIGH)
    assert main([path, "--mms", "--cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAIL: L2 convergence rate for h" in out and "PASS" not in out


def test_cli_mms_single_run_prints_norms(tmp_path, capsys):
    path = write_deck(tmp_path, 0)
    assert main([path, "--mms", "--cpu", "--dt", "0.01"]) == 0
    out = capsys.readouterr().out
    assert "Error norms at t = 0.02:" in out and "Avg-length-scale" in out


def test_driver_keeps_each_level(tmp_path):
    from rdycore_tpu_torch.config.yaml_input import load_config

    drv = MMSDriver(load_config(write_deck(tmp_path, 1, LOW)), device="cpu")
    assert drv.run(log=lambda *_: None)
    assert [r.num_cells for r in drv.results] == [48, 192]
    assert drv.last_level.mesh.num_cells == 192
    assert all(r.n_steps == 4 and r.run_seconds > 0 for r in drv.results)
    assert set(drv.rates) == {"L1", "L2", "Linf"}
