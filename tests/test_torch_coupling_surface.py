"""The coupling surface of rdycore_tpu_torch's Simulation against the JAX
package's, on the CPU.

Each of the 26 members that the port's Simulation gained with the rest of
the coupling surface (boundary metadata, momentum sources and regional
Manning values, time units, version and build strings, the log file,
arrays shaped like the state, one-DOF PETSc-binary files and the
checkpoint pair) is called on both packages' simulations of one 40x20 dam
break in f64 (a Dirichlet inflow on the left, critical outflow on the
right, the implicit reflecting wall elsewhere), and must give the same
answer. A run with a regional momentum source, a domain momentum source
and a regional Manning field set between intervals agrees with the JAX
package to 1e-12. On the raster (`fused_structured`), whose kernel takes
water sources only, a momentum setter makes the next advance raise a
ConfigError in both packages.
"""

import os

import numpy as np
import pytest

from rdycore_tpu.config.schema import ConfigError as JaxConfigError
from rdycore_tpu.config.yaml_input import load_config as jax_load_config
from rdycore_tpu.io.petsc_binary import write_petsc_vec
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, load_config
from rdycore_tpu_torch.config.schema import ConfigError
from rdycore_tpu_torch.mesh import structured_quad
from rdycore_tpu_torch.mesh.core import save_mesh_npz

from test_torch_checkpoint import write_deck as write_raster_deck

DECK = """
physics: {flow: {mode: swe}}
numerics: {spatial: fv, temporal: euler, riemann: roe, precision: double}
logging: {level: info}
time: {stop: 0.0004, unit: minutes, time_step: 0.00001,
       coupling_interval: 0.0001}
output: {format: none}
grid: {file: dam_break.npz}
regions:
  - {name: reservoir, grid_region_id: 1}
  - {name: floodplain, grid_region_id: 2}
surface_composition:
  - {region: reservoir, material: smooth}
  - {region: floodplain, material: smooth}
materials: [{name: smooth, properties: {manning: {value: 0.018}}}]
initial_conditions:
  - {region: reservoir, flow: column}
  - {region: floodplain, flow: wet_bed}
boundaries:
  - {name: left, grid_boundary_id: 1}
  - {name: right, grid_boundary_id: 2}
boundary_conditions:
  - {boundaries: [right], flow: outflow}
  - {boundaries: [left], flow: inflow}
flow_conditions:
  - {name: column, type: dirichlet, height: 0.25, x_momentum: 0, y_momentum: 0}
  - {name: wet_bed, type: dirichlet, height: 0.05, x_momentum: 0, y_momentum: 0}
  - {name: outflow, type: critical-outflow}
  - {name: inflow, type: dirichlet, height: 0.25, x_momentum: 0.01, y_momentum: 0}
"""


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    d = tmp_path_factory.mktemp("surface")
    mesh = structured_quad(40, 20, 0.0, 2.0, 0.0, 1.0,
                           region_fn=lambda cx, cy: np.where(cx < 1.0, 1, 2))
    save_mesh_npz(mesh, os.path.join(d, "dam_break.npz"))
    path = os.path.join(d, "dam_break.yaml")
    with open(path, "w") as f:
        f.write(DECK)
    return path


@pytest.fixture(scope="module")
def sims(deck):
    """(JAX simulation, port simulation) of the deck, before any step."""
    return JaxSimulation(jax_load_config(deck)), Simulation(
        load_config(deck), device="cpu")


def fresh(deck):
    return JaxSimulation(jax_load_config(deck)), Simulation(
        load_config(deck), device="cpu")


BOUNDARIES = ("left", "right", "__auto_reflecting__")


def same(a, b):
    """Equal values (arrays compared element by element, after moving
    tensors to numpy)."""
    a, b = (np.asarray(x.cpu() if hasattr(x, "cpu") else x) for x in (a, b))
    assert a.shape == b.shape and a.dtype.kind == b.dtype.kind
    np.testing.assert_array_equal(a, b)


def per_boundary(name):
    def case(js, ts, tmp):
        for b in BOUNDARIES:
            same(getattr(js, name)(b), getattr(ts, name)(b))
    return case


def setter(call, attr):
    """Call a setter on fresh simulations of both packages; compare `attr`
    after it."""
    def case(js, ts, tmp, deck):
        js, ts = fresh(deck)
        call(js)
        call(ts)
        same(getattr(js, attr), getattr(ts, attr))
    case.fresh = True
    return case


def from_file(js, ts, tmp, deck):
    a = JaxSimulation.from_file(deck, **{"time.stop": 0.0002})
    b = Simulation.from_file(deck, device="cpu", **{"time.stop": 0.0002})
    same(a.get_solution(), b.get_solution())
    assert a.t_final == b.t_final == pytest.approx(0.012)
    assert b.device.type == "cpu"


from_file.fresh = True


def log_file(js, ts, tmp):
    for name, sim in (("jax", js), ("port", ts)):
        sim.set_log_file(os.path.join(tmp, f"{name}.log"))
        sim.log.info("coupling interval 1")
        sim.log.detail("not at level info")
    text = [open(os.path.join(tmp, f"{n}.log")).read() for n in ("jax", "port")]
    assert text[0] == text[1] == "[INFO] coupling interval 1\n"


def build_configuration(js, ts, tmp):
    a, b = js.get_build_configuration(), ts.get_build_configuration()
    assert a.startswith("rdycore_tpu 0.1.0") and "dtype float64" in a
    assert b.startswith(f"rdycore_tpu_torch {ts.get_version()} (torch ")
    assert "device cpu (cpu)" in b and b.endswith("dtype float64)")
    assert "jax" not in b


def read_one_dof(js, ts, tmp):
    path = os.path.join(tmp, "natural.bin")
    write_petsc_vec(path, np.arange(js.num_cells, dtype=np.float64) ** 1.5)
    same(js.read_one_dof_vec_from_binary(path),
         ts.read_one_dof_vec_from_binary(path))
    with pytest.raises(ValueError, match="expected 800 values"):
        write_petsc_vec(path, np.zeros(3))
        ts.read_one_dof_vec_from_binary(path)


def write_one_dof(js, ts, tmp):
    vals = np.linspace(0.0, 1.0, js.num_cells) ** 3
    for name, sim in (("jax", js), ("port", ts)):
        sim.write_one_dof_vec_to_binary(os.path.join(tmp, f"{name}.bin"), vals)
    files = [open(os.path.join(tmp, f"{n}.bin"), "rb").read()
             for n in ("jax", "port")]
    assert files[0] == files[1]


def state_of(sim):
    return np.asarray(sim.get_solution()), sim.t, sim.dt, sim.step


def write_ckpt(js, ts, tmp, deck):
    js, ts = fresh(deck)
    q = state_of(js)[0] * 1.25
    for sim in (js, ts):
        sim.set_solution(q)
        sim.t, sim.dt, sim.step = 0.75, 0.005, 30
    for ext in ("bin", "h5"):
        if ext == "h5":
            pytest.importorskip("h5py")
        paths = [os.path.join(tmp, f"{n}.{ext}") for n in ("jax", "port")]
        js.write_checkpoint(paths[0])
        ts.write_checkpoint(paths[1])
        if ext == "bin":
            assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
            continue
        import h5py

        with h5py.File(paths[0]) as a, h5py.File(paths[1]) as b:
            assert dict(a.attrs) == dict(b.attrs) and set(a) == set(b)
            same(a["solution"][...], b["solution"][...])


write_ckpt.fresh = True


def read_ckpt(js, ts, tmp, deck):
    js, ts = fresh(deck)
    path = os.path.join(tmp, "r.bin")
    src = Simulation(load_config(deck), device="cpu")
    src.set_solution(src.get_solution() + 0.5)
    src.t, src.dt, src.step = 0.5, 0.0025, 12
    src.write_checkpoint(path)
    for reinit in (True, False):
        js.read_checkpoint(path, reinitialize=reinit)
        ts.read_checkpoint(path, reinitialize=reinit)
        for a, b in zip(state_of(js), state_of(ts)):
            same(a, b)


read_ckpt.fresh = True


CASES = {
    "from_file": from_file,
    "set_momentum_source": setter(
        lambda s: s.set_momentum_source(2, np.linspace(0, 1e-3, 800)),
        "ext_src"),
    "set_regional_momentum_source": setter(
        lambda s: s.set_regional_momentum_source("floodplain", 0, 2e-4),
        "ext_src"),
    "set_regional_manning_n": setter(
        lambda s: s.set_regional_manning_n(
            "reservoir", np.linspace(0.01, 0.05, 400)), "mannings_n"),
    "convert_time": lambda js, ts, tmp: [
        same(JaxSimulation.convert_time(v, a, b),
             Simulation.convert_time(v, a, b))
        for v, a, b in ((2.0, "minutes", "seconds"), (36.0, "hours", "days"),
                        (1.5, "days", "minutes"))],
    "get_time_unit": lambda js, ts, tmp: same(js.get_time_unit(),
                                              ts.get_time_unit()),
    "get_version": lambda js, ts, tmp: same(js.get_version(),
                                            ts.get_version()),
    "set_log_file": log_file,
    "get_build_configuration": build_configuration,
    "create_prognostic_array": lambda js, ts, tmp: same(
        js.create_prognostic_array(), ts.create_prognostic_array()),
    "create_one_dof_array": lambda js, ts, tmp: same(
        js.create_one_dof_array(), ts.create_one_dof_array()),
    "read_one_dof_vec_from_binary": read_one_dof,
    "write_one_dof_vec_to_binary": write_one_dof,
    "boundary_names": lambda js, ts, tmp: same(js.boundary_names,
                                               ts.boundary_names),
    "get_num_global_cells": lambda js, ts, tmp: same(
        js.get_num_global_cells(), ts.get_num_global_cells()),
    "get_num_boundary_conditions": lambda js, ts, tmp: same(
        js.get_num_boundary_conditions(), ts.get_num_boundary_conditions()),
    "get_boundary_id": per_boundary("get_boundary_id"),
    "get_boundary_condition_flow_type": per_boundary(
        "get_boundary_condition_flow_type"),
    "get_boundary_edge_centers": per_boundary("get_boundary_edge_centers"),
    "get_boundary_edge_centroids": per_boundary("get_boundary_edge_centroids"),
    "get_boundary_cells": per_boundary("get_boundary_cells"),
    "get_boundary_cell_centroids": per_boundary("get_boundary_cell_centroids"),
    "get_boundary_cell_natural_ids": per_boundary(
        "get_boundary_cell_natural_ids"),
    "write_checkpoint": write_ckpt,
    "read_checkpoint": read_ckpt,
    "restarted": lambda js, ts, tmp: same(js.restarted, ts.restarted),
}


def test_the_cases_are_the_coupling_surface():
    """One case for each member item 18 and item 5b ported, and each is
    now real on the port's Simulation (rebuild_on_mesh, ported last with
    AMR, is held in tests/test_torch_surface.py and test_torch_amr*.py)."""
    from test_torch_surface import PORTED_LAST

    assert len(CASES) == 26 and not set(CASES) & set(PORTED_LAST)
    for name in CASES:
        member = Simulation.__dict__[name]
        fn = getattr(member, "fget", None) or getattr(member, "__func__",
                                                      member)
        assert "Not ported" not in (fn.__doc__ or "")


@pytest.mark.parametrize("name", sorted(CASES))
def test_member_agrees_with_the_jax_package(sims, deck, tmp_path, name):
    case = CASES[name]
    if getattr(case, "fresh", False):
        case(*sims, str(tmp_path), deck)
    else:
        case(*sims, str(tmp_path))


def test_sources_and_manning_run_agrees_to_1e12(deck):
    """Two intervals (10 steps each) with a regional momentum source, then
    a domain momentum source and a regional Manning field for two more."""
    runs = []
    for sim in fresh(deck):
        sim.set_regional_momentum_source("reservoir", 0, 0.02)
        sim.advance()
        sim.advance()
        sim.set_momentum_source(2, np.linspace(-5e-3, 5e-3, sim.num_cells))
        sim.set_regional_manning_n("floodplain",
                                   np.linspace(0.02, 0.06, sim.num_cells // 2))
        sim.run()
        runs.append(sim)
    js, ts = runs
    assert js.step == ts.step == 40 and js.t == pytest.approx(ts.t, abs=0)
    qj, qt = np.asarray(js.get_solution()), ts.get_solution()
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-12)
    # the sources moved the state: the same run without them differs
    plain = Simulation(load_config(deck), device="cpu")
    plain.run()
    assert np.abs(plain.get_solution() - qt).max() > 1e-4


def test_raster_momentum_sources_raise(tmp_path):
    path = write_raster_deck(tmp_path, backend="fused_structured",
                             interval=0)
    for call in (lambda s: s.set_momentum_source(1, 1e-3),
                 lambda s: s.set_regional_momentum_source("reservoir", 1,
                                                          1e-3)):
        for sim, error in ((Simulation(load_config(path), device="cpu"),
                            ConfigError),
                           (JaxSimulation(jax_load_config(path)),
                            JaxConfigError)):
            call(sim)  # after setup; the next advance refuses it
            with pytest.raises(error, match=r"water \(row 0\)"):
                sim.advance()
