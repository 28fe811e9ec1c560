"""ARS(2,2,2) ARK-IMEX (`temporal: ark_imex`) of rdycore_tpu_torch against
the JAX package's, on the CPU, in f64.

- `friction_implicit_stage_solve` against the JAX one on random states
  with dry cells, zero momentum and dt_imp = 0: the stage state to 1e-14
  of each row's largest magnitude, and F_I, a difference of stage values
  over dt_imp, at their scale (dt_imp * F_I to 1e-14 of the row's
  largest |m|); the h and tracer rows pass through exactly;
- a whole ark_imex interval (`make_interval_advancer(op, "ark_imex")`) on
  structured_quad(24, 16) with Dirichlet, critical-outflow and reflecting
  walls, Manning n 0.01-0.05, external sources and a half last step, flow
  only and with two tracer rows (one sediment class): every field of the
  interval result to 1e-11 of its largest magnitude, the Courant edge
  equal. Each JAX advancer is compiled once (module fixture) for both of
  its calls;
- `source.method: ark_imex`: a ConfigError naming ROADMAP fault 11 under
  any other scheme, accepted under `temporal: ark_imex`; ark_imex on the
  raster kinds keeps the JAX package's ConfigError;
- `python -m rdycore_tpu_torch deck.yaml --cpu` runs an ark_imex deck
  (one step on a 4x3 mesh) to its end; the beuler one is in
  tests/test_torch_beuler_raster.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdycore_tpu.mesh import structured_quad
from rdycore_tpu.operator import build_operator as jax_build_operator
from rdycore_tpu.ops.swe.sources import (
    friction_implicit_stage_solve as jax_friction_solve,
)
from rdycore_tpu.timestepping import make_interval_advancer as jax_advancer
from rdycore_tpu_torch import Simulation
from rdycore_tpu_torch.__main__ import main as cli_main
from rdycore_tpu_torch.config.schema import ConfigError
from rdycore_tpu_torch.config.yaml_input import config_from_dict
from rdycore_tpu_torch.mesh import save_mesh_npz
from rdycore_tpu_torch.mesh import structured_quad as port_quad
from rdycore_tpu_torch.ops.swe.sources import friction_implicit_stage_solve
from rdycore_tpu_torch.timestepping import make_interval_advancer

from test_torch_operator import (
    BC_TYPES,
    assert_rel_close,
    port_operator,
    random_inputs,
)

TINY_H = 1e-7
NT, NS = 2, 1
DT, N_STEPS, T0 = 0.002, 6, 0.1
T_END = T0 + (N_STEPS - 0.5) * DT


def friction_states(seed):
    """Random stage inputs m [5, C] (two tracer rows): a fifth of the
    cells dry, some exactly 0, a tenth with zero momentum; Manning n."""
    rng = np.random.default_rng(seed)
    C = 400
    h = rng.uniform(0.01, 2.0, C)
    h = np.where(rng.uniform(size=C) < 0.2, rng.uniform(0, 5e-8, C), h)
    h = np.where(rng.uniform(size=C) < 0.05, 0.0, h)
    hu, hv = h * rng.normal(0, 1.0, (2, C))
    still = rng.uniform(size=C) < 0.1
    hu, hv = np.where(still, 0.0, hu), np.where(still, 0.0, hv)
    m = np.stack([h, hu, hv, 0.01 * h, 0.02 * h])
    return m, rng.uniform(0.01, 0.05, C)


@pytest.mark.parametrize("dt_imp", [0.0, 1e-3, 0.05, 2.0])
def test_friction_solve_matches_jax(dt_imp):
    m, n = friction_states(7)
    qj, fj = jax.jit(jax_friction_solve, static_argnums=3)(
        jnp.asarray(m), jnp.asarray(n), jnp.asarray(dt_imp), TINY_H)
    qt, ft = friction_implicit_stage_solve(
        torch.as_tensor(m), torch.as_tensor(n),
        torch.tensor(dt_imp, dtype=torch.float64), TINY_H)
    # F_I = (q - m) / dt_imp is formed from a difference of the stage
    # values: it is held at their scale, dt_imp * F_I against |m|
    for k in range(5):
        assert_rel_close(np.asarray(qj)[k], qt[k].numpy(), 1e-14, f"q{k}")
        assert_rel_close(np.concatenate([m[k], dt_imp * np.asarray(fj)[k]]),
                         np.concatenate([m[k], dt_imp * ft[k].numpy()]),
                         1e-14, f"F_I{k}")
    assert torch.equal(qt[[0, 3, 4]], torch.as_tensor(m[[0, 3, 4]]))
    assert not ft[[0, 3, 4]].any()
    if dt_imp == 0.0:
        assert torch.equal(qt, torch.as_tensor(m)) and not ft.any()
    else:
        # friction only slows the flow, colinear with the momentum
        assert (qt[1].abs() <= torch.as_tensor(np.abs(m[1]))).all()


@pytest.fixture(scope="module")
def ark_imex_cases():
    """Per case (flow, tracers): the JAX interval result, compiled once,
    and the port's operator and inputs."""
    m = structured_quad(24, 16, 0.0, 2.0, 0.0, 1.0)
    rng = np.random.default_rng(31)
    C = m.num_cells
    n = rng.uniform(0.01, 0.05, C)
    out = {}
    for case, kw in (("flow", {}),
                     ("tracers", dict(num_tracers=NT, num_sediment=NS))):
        jop = jax_build_operator(m, bc_types=BC_TYPES, mannings_n=n, **kw)
        q, bv, ext = random_inputs(jop, 5)
        if kw:
            q = np.concatenate([q, q[0] * rng.uniform(0, 0.02, (NT, C))])
            bv = np.concatenate([bv, bv[0] * rng.uniform(0, 0.02,
                                                        (NT, bv.shape[1]))])
            ext = np.concatenate([ext, rng.normal(0, 1e-5, (NT, C))])
        args = tuple(jnp.asarray(x) for x in (q, bv, ext))
        rj = jax.jit(jax_advancer(jop, "ark_imex"))(
            jop.arrays, args[0], T0, DT, N_STEPS, T_END, *args[1:])
        out[case] = (rj, port_operator(jop, torch.float64), (q, bv, ext))
    return out


@pytest.mark.parametrize("case", ["flow", "tracers"])
def test_ark_imex_interval_matches_jax(ark_imex_cases, case):
    rj, top, (q, bv, ext) = ark_imex_cases[case]
    rt = make_interval_advancer(top, "ark_imex")(
        torch.as_tensor(q), T0, DT, N_STEPS, T_END,
        torch.as_tensor(bv), torch.as_tensor(ext))
    assert float(rt.t) == pytest.approx(T_END, abs=1e-15)
    for field in rj._fields:
        if field == "courant_edge":
            assert int(rt.courant_edge) == int(rj.courant_edge)
        else:
            assert_rel_close(np.asarray(getattr(rj, field)),
                             getattr(rt, field).numpy(), 1e-11, field)
    # the implicit friction acted: the interval differs from ssprk2's
    rs = make_interval_advancer(top, "ssprk2")(
        torch.as_tensor(q), T0, DT, N_STEPS, T_END, torch.as_tensor(bv),
        torch.as_tensor(ext))
    assert not torch.allclose(rs.q, rt.q, rtol=0.0, atol=1e-9)


def deck(temporal, method, backend="xla"):
    return config_from_dict({
        "numerics": {"temporal": temporal, "edge_flux_backend": backend},
        "physics": {"flow": {"source": {"method": method}}},
        "time": {"stop": 0.004, "time_step": 0.002},
        "logging": {"level": "none"},
    }).validate()


@pytest.mark.parametrize("temporal",
                         ["euler", "ssprk2", "ssprk3", "rk4", "beuler"])
def test_ark_imex_source_method_needs_ark_imex(temporal):
    with pytest.raises(ConfigError, match="ROADMAP fault 11"):
        Simulation(deck(temporal, "ark_imex"),
                   mesh=port_quad(4, 3, 0.0, 1.0, 0.0, 1.0), device="cpu")


@pytest.mark.parametrize("method",
                         ["ark_imex", "semi_implicit", "implicit_xq2018"])
def test_ark_imex_runs_with_any_source_method(method):
    """Under temporal: ark_imex the DIRK stages own the friction: every
    source method gives the same run."""
    mesh = port_quad(8, 6, 0.0, 1.0, 0.0, 1.0)
    sims = [Simulation(deck("ark_imex", m), mesh=mesh, device="cpu")
            for m in (method, "semi_implicit")]
    h = 0.2 + 0.1 * mesh.cell_centroid[:, 0]
    for sim in sims:
        sim.set_height(h)
        sim.set_manning_n(np.full(mesh.num_cells, 0.03))
        sim.run()
    assert sims[0].step == 2
    assert np.array_equal(sims[0].get_solution(), sims[1].get_solution())


@pytest.mark.parametrize("backend", ["structured", "fused_structured"])
def test_ark_imex_on_a_raster_is_a_config_error(backend):
    mesh = port_quad(128, 8, 0.0, 2.0, 0.0, 0.125)
    with pytest.raises(ConfigError, match="supports temporal"):
        Simulation(deck("ark_imex", "semi_implicit", backend), mesh=mesh,
                   device="cpu")



def test_cli_runs_an_ark_imex_deck_on_cpu(tmp_path):
    assert cli_main([write_box_deck(tmp_path, "ark_imex", "ark_imex"),
                     "--cpu"]) == 0


def write_box_deck(tmp_path, temporal, method):
    """A one-step deck of `temporal` with `source.method` on a 4x3 mesh
    (box.npz beside it); returns its path."""
    save_mesh_npz(port_quad(4, 3, 0.0, 1.0, 0.0, 1.0,
                            region_fn=lambda cx, cy: np.ones_like(cx)),
                  os.path.join(tmp_path, "box.npz"))
    path = os.path.join(tmp_path, f"{temporal}.yaml")
    with open(path, "w") as f:
        f.write(f"""
numerics: {{temporal: {temporal}}}
physics: {{flow: {{source: {{method: {method}}}}}}}
time: {{stop: 0.01, time_step: 0.01, unit: seconds}}
grid: {{file: box.npz}}
logging: {{level: none}}
output: {{format: none}}
regions: [{{name: all, grid_region_id: 1}}]
initial_conditions: [{{region: all, flow: mound}}]
flow_conditions:
  - {{name: mound, type: dirichlet, height: "0.2 + 0.1*x",
     x_momentum: 0, y_momentum: 0}}
""")
    return path
