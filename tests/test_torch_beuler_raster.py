"""Backward Euler on the fused raster (`edge_flux_backend:
fused_structured`, `temporal: beuler`) through rdycore_tpu_torch's
Simulation, on the CPU (K2's and K2 MUSCL's plain rhs, the float32
`StructuredSWEOperator` JVPs), in f32.

- First order: the raster beuler against the port's unstructured beuler
  on the same structured_quad(128, 16) deck (the JAX package's
  tests/test_structured_backend.py:444-471, dam front in a closed box over
  a wavy bed), relative to 1 + |q| below 2e-5, without that test's 115 s
  fused oracle. Both paths solve with the same F and, their JVPs going
  through first-order operators of the same physics, the same Jacobian
  up to rounding, so their Newton iterates agree whatever the number of
  iterations.
- Second order (K2 MUSCL's rhs mode, JVPs still first order as in the JAX
  package), 2 steps: finite, h >= -1e-6, the volume of the closed box
  kept to 1e-5 (every GMRES update is a sum of Krylov vectors of zero net
  volume), the front advanced.
- The refusals of both packages: beuler in row strips (ConfigError) and
  with tracers ("fused raster beuler is flow-only", ValueError).
- `python -m rdycore_tpu_torch deck.yaml --cpu` runs a beuler deck (one
  step on a 4x3 mesh) to its end.

Forward-mode AD through the raster operator costs about 0.1-0.2 s a JVP
on the CPU, so these runs take 2 Newton iterations of GMRES(2) a step
(`timestepping.NEWTON_ITERS`, `KRYLOV_M`); tests/test_torch_beuler.py
runs a step at the JAX package's 6 and 16, and `chip_smoke.py` phase 9
the raster at full size.
"""

import numpy as np
import pytest

from rdycore_tpu.config.schema import ConfigError as JaxConfigError
from rdycore_tpu.config.yaml_input import config_from_dict as jax_config
from rdycore_tpu.mesh import structured_quad as jax_quad
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, timestepping
from rdycore_tpu_torch.__main__ import main as cli_main
from rdycore_tpu_torch.config.schema import ConfigError
from rdycore_tpu_torch.config.yaml_input import config_from_dict
from rdycore_tpu_torch.mesh import structured_quad

from test_torch_imex import write_box_deck

DT = 4e-3


def z_fn(x, y):
    return 0.05 * np.sin(x) * np.cos(y)


def raster_deck(backend, steps, second_order=False, extra=None):
    d = {"numerics": {"temporal": "beuler", "edge_flux_backend": backend,
                      "precision": "single", "second_order": second_order},
         "time": {"stop": steps * DT, "time_step": DT,
                  "coupling_interval": 1.0},
         "logging": {"level": "none"}}
    d.update(extra or {})
    return d


@pytest.fixture(scope="module")
def mesh():
    return structured_quad(128, 16, 0, 32, 0, 4, z_fn=z_fn)


@pytest.fixture
def few_iterations(monkeypatch):
    monkeypatch.setattr(timestepping, "NEWTON_ITERS", 2)
    monkeypatch.setattr(timestepping, "KRYLOV_M", 2)


def run(mesh, backend, steps, second_order=False):
    sim = Simulation(config_from_dict(raster_deck(
        backend, steps, second_order)).validate(), mesh=mesh, device="cpu")
    x = mesh.cell_centroid[:, 0]
    q0 = np.zeros((3, mesh.num_cells))
    q0[0] = np.where(x < 16.0, 2.0, 1.0)
    sim.set_solution(q0)
    sim.set_manning_n(np.full(mesh.num_cells, 0.02))
    sim.run()
    assert sim.step == steps
    return sim, q0


@pytest.fixture(scope="module")
def first_order_raster(mesh):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(timestepping, "NEWTON_ITERS", 2)
        mp.setattr(timestepping, "KRYLOV_M", 2)
        sim, q0 = run(mesh, "fused_structured", 1)
    return sim, q0


def test_raster_beuler_matches_unstructured(mesh, first_order_raster,
                                            few_iterations):
    raster, q0 = first_order_raster
    st = raster._structured
    assert st["kind"] == "fused" and st["scheme"] == "beuler"
    assert st["lin_op"] is not None
    unstructured, _ = run(mesh, "xla", 1)
    q_r, q_u = raster.get_solution(), unstructured.get_solution()
    rel = np.abs(q_r - q_u) / (1.0 + np.abs(q_u))
    assert rel.max() < 2e-5, rel.max()
    # the implicit step advanced the dam front
    assert np.abs(q_r - q0).max() > 1e-3
    assert raster.prev_max_courant > 0.0


def test_raster_muscl_beuler(mesh, few_iterations):
    sim, q0 = run(mesh, "fused_structured", 2, second_order=True)
    assert sim._structured["op"].second_order
    q = sim.get_solution().astype(np.float64)
    assert np.isfinite(q).all() and q[0].min() >= -1e-6
    v0, v1 = q0[0].sum(), q[0].sum()
    assert abs(v1 - v0) <= 1e-5 * v0
    assert np.abs(q - q0).max() > 1e-3


def test_raster_beuler_refusals_match_jax(mesh):
    strips = raster_deck("fused_structured", 1,
                         extra={"parallel": {"n_devices": 2}})
    tracers = raster_deck("fused_structured", 1,
                          extra={"physics": {"salinity": True}})
    jmesh = jax_quad(128, 16, 0, 32, 0, 4, z_fn=z_fn)
    for d, jerr, err, match in (
            (strips, JaxConfigError, ConfigError, "supports temporal"),
            (tracers, ValueError, ValueError, "flow-only")):
        with pytest.raises(jerr, match=match):
            JaxSimulation(jax_config(d).validate(), mesh=jmesh)
        with pytest.raises(err, match=match):
            Simulation(config_from_dict(d).validate(), mesh=mesh,
                       device="cpu")


def test_cli_runs_a_beuler_deck_on_cpu(tmp_path, few_iterations):
    assert cli_main([write_box_deck(tmp_path, "beuler", "semi_implicit"),
                     "--cpu"]) == 0
