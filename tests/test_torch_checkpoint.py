"""Checkpoints and restart of rdycore_tpu_torch (io/checkpoint.py), on the
CPU.

The restart-equivalence oracle of tests/test_simulation.py: run A takes 2N
steps with `checkpoint.interval: N`, so `CheckpointMonitor` writes a
checkpoint mid-run at step N; run B restarts from it through
`restart.file` and runs to step 2N. B ends bit for bit where A does (q, t
and step), in the PETSc-binary `.bin` and the HDF5 `.h5` format, on the
unstructured path, on the raster (`fused_structured`) and on the raster in
2 row strips. The deck's dt is fixed: the Courant number of the last
interval is not in a checkpoint (in neither package), so an adaptive-dt
run does not restart bit for bit. `restart.reinitialize` takes the state
and keeps the deck's clock. A checkpoint written by the JAX package's
`write_checkpoint` restarts the port, and one written by the port restarts
the JAX package, in both formats. Where h5py does not import, every HDF5
request (checkpoints, XDMF, CGNS, an HDF5 restart file) is a ConfigError
naming h5py.
"""

import os
import sys

import numpy as np
import pytest

from rdycore_tpu.config.yaml_input import load_config as jax_load_config
from rdycore_tpu.io.checkpoint import write_checkpoint as jax_write_checkpoint
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, load_config
from rdycore_tpu_torch.config.schema import ConfigError
from rdycore_tpu_torch.io.writers import attach_output_monitors
from rdycore_tpu_torch.mesh import structured_quad
from rdycore_tpu_torch.mesh.core import save_mesh_npz

N = 20  # steps before the checkpoint; runs take 2N
DECK = """
physics: {flow: {mode: swe}}
numerics: {spatial: fv, temporal: euler, riemann: roe,
           precision: %(precision)s, edge_flux_backend: %(backend)s}
logging: {level: none}
time: {stop_n: %(steps)d, unit: seconds, time_step: 0.0009765625,
       coupling_interval: 0.009765625}
output: {format: none}
checkpoint: {format: %(fmt)s, interval: %(interval)d, prefix: ck}
grid: {file: raster.npz}
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
  - {name: right, grid_boundary_id: 2}
boundary_conditions:
  - {boundaries: [right], flow: outflow}
flow_conditions:
  - {name: column, type: dirichlet, height: 0.25, x_momentum: 0, y_momentum: 0}
  - {name: wet_bed, type: dirichlet, height: 0.05, x_momentum: 0, y_momentum: 0}
  - {name: outflow, type: critical-outflow}
%(extra)s"""

PATHS = {
    "unstructured": dict(backend="xla"),
    "raster": dict(backend="fused_structured"),
    "raster 2 strips": dict(backend="fused_structured",
                            extra="parallel: {n_devices: 2}\n"),
}


def write_deck(tmp_path, name="deck", backend="xla", fmt="binary",
               interval=N, steps=2 * N, precision="single", extra=""):
    """A 128x16 dam break of 1/64 m cells (a raster both packages take),
    every time exact in binary."""
    mesh_path = os.path.join(tmp_path, "raster.npz")
    if not os.path.exists(mesh_path):
        save_mesh_npz(structured_quad(
            128, 16, 0.0, 2.0, 0.0, 0.25,
            region_fn=lambda cx, cy: np.where(cx < 1.0, 1, 2)), mesh_path)
    path = os.path.join(tmp_path, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(DECK % dict(backend=backend, fmt=fmt, interval=interval,
                            steps=steps, precision=precision, extra=extra))
    return path


@pytest.mark.parametrize("fmt", ["binary", "hdf5"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_restart_from_a_mid_run_checkpoint_is_bit_for_bit(tmp_path, path,
                                                          fmt):
    if fmt == "hdf5":
        pytest.importorskip("h5py")
    deck = write_deck(tmp_path, fmt=fmt, **PATHS[path])
    a = Simulation(load_config(deck), device="cpu")
    attach_output_monitors(a)
    assert a.monitor_stride == N
    a.run()
    ext = "h5" if fmt == "hdf5" else "bin"
    ckpt = os.path.join(tmp_path, "output", f"ck.rdycore.r.{N:04d}.{ext}")
    assert os.path.exists(ckpt) and a.step == 2 * N

    cfg = load_config(deck)
    cfg.checkpoint.interval = 0
    cfg.restart.file = ckpt
    b = Simulation(cfg, device="cpu")
    assert b.restarted and b.step == N and 0.0 < b.t < a.t
    assert b.q.is_contiguous()  # the kernels take nothing else
    b.run()
    assert b.step == a.step and b.t == a.t
    assert np.array_equal(b.get_solution(), a.get_solution())


def test_restart_reinitialize_keeps_the_decks_clock(tmp_path):
    deck = write_deck(tmp_path, interval=0, steps=N)
    a = Simulation(load_config(deck), device="cpu")
    a.run()
    ckpt = os.path.join(tmp_path, "a.bin")
    a.write_checkpoint(ckpt)
    cfg = load_config(deck)
    cfg.restart.file, cfg.restart.reinitialize = ckpt, True
    b = Simulation(cfg, device="cpu")
    assert b.restarted and b.step == 0 and b.t == 0.0 and b.dt == a.dt
    assert np.array_equal(b.get_solution(), a.get_solution())
    assert not Simulation(load_config(deck), device="cpu").restarted
    # read_checkpoint without reinitialize takes the file's clock too
    b.read_checkpoint(ckpt)
    assert (b.step, b.t) == (a.step, a.t)


def random_state(sim, seed):
    """A state, clock and step that no run reaches by chance."""
    rng = np.random.default_rng(seed)
    q = sim.get_solution()
    q = q * rng.uniform(0.5, 1.5, q.shape) + rng.uniform(0.0, 1e-3, q.shape)
    return q, 0.0078125 * (1 + seed), 0.0009765625 / (1 + seed), 8 + seed


@pytest.mark.parametrize("fmt", ["binary", "hdf5"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_the_packages(tmp_path, writer, fmt):
    if fmt == "hdf5":
        pytest.importorskip("h5py")
    deck = write_deck(tmp_path, interval=0, precision="double")
    ckpt = os.path.join(tmp_path, "x." + ("h5" if fmt == "hdf5" else "bin"))
    if writer == "jax":
        src = JaxSimulation(jax_load_config(deck))
        q, t, dt, step = random_state(src, 1)
        src.set_solution(q)
        src.t, src.dt, src.step = t, dt, step
        jax_write_checkpoint(src, ckpt)
    else:
        src = Simulation(load_config(deck), device="cpu")
        q, t, dt, step = random_state(src, 2)
        src.set_solution(q)
        src.t, src.dt, src.step = t, dt, step
        src.write_checkpoint(ckpt)
    restart = f"restart: {{file: {os.path.basename(ckpt)}}}\n"
    deck2 = write_deck(tmp_path, name="restart", interval=0,
                       precision="double", extra=restart)
    dst = (Simulation(load_config(deck2), device="cpu") if writer == "jax"
           else JaxSimulation(jax_load_config(deck2)))
    assert (dst.t, dst.dt, dst.step) == (t, dt, step)
    assert np.array_equal(np.asarray(dst.get_solution()), q)


@pytest.mark.parametrize("deck, match", [
    (dict(fmt="hdf5"), "checkpoint.format: binary"),
    (dict(extra="output: {format: xdmf}\n"), "output.format: binary"),
    (dict(extra="output: {format: cgns}\n"), "output.format: binary"),
    (dict(extra="restart: {file: r.h5}\n"), r"\.bin"),
])
def test_hdf5_without_h5py_is_a_config_error(tmp_path, monkeypatch, deck,
                                              match):
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py fails
    path = write_deck(tmp_path, **deck)
    with pytest.raises(ConfigError, match="h5py") as exc:
        Simulation(load_config(path), device="cpu")
    assert exc.match(match)


def test_hdf5_checkpoint_calls_without_h5py_raise(tmp_path, monkeypatch):
    sim = Simulation(load_config(write_deck(tmp_path, interval=0)),
                     device="cpu")
    monkeypatch.setitem(sys.modules, "h5py", None)
    for call in (sim.write_checkpoint, sim.read_checkpoint):
        with pytest.raises(ConfigError, match=r"h5py.*\.bin"):
            call(os.path.join(tmp_path, "c.h5"))
    sim.write_checkpoint(os.path.join(tmp_path, "c.bin"))  # needs no h5py
