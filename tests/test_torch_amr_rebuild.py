"""The rebuild under AMR in the port's Simulation against the JAX
package's, f64 on the CPU: the cases where the re-initialization on the
refined mesh meets the deck.

The errors are the JAX package's: the raster's ConfigError on a
fused_structured deck (the refined mesh is no raster), IndexError on a
deck whose `grid.cell_elevation.file` holds one value per base cell (the
rebuild reads it again for the refined mesh). Under `cell_ordering: rcm`
the JAX package scrambles the state (its rebuild reorders the refined
mesh, and the state is injected in the unreordered order); the port
refuses with a ConfigError naming ROADMAP fault 24. A failed rebuild
leaves the port's simulation as it was. A source set by a setter on the
coarse mesh still streams on the fine one, in both packages (within
1e-10). The rebuild keeps the time state and the logger. The
boundary-flux time series goes on across the rebuild in the port; the
JAX package's fails (ROADMAP fault 26).
"""

import os

import numpy as np
import pytest

from rdycore_tpu import amr as jax_amr
from rdycore_tpu.config.schema import ConfigError as JaxConfigError
from rdycore_tpu.config.yaml_input import load_config as jax_load_config
from rdycore_tpu.io.writers import (
    attach_output_monitors as jax_attach_output_monitors,
)
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, amr, load_config
from rdycore_tpu_torch.config.schema import ConfigError
from rdycore_tpu_torch.io.petsc_binary import write_petsc_vec
from rdycore_tpu_torch.io.writers import attach_output_monitors
from rdycore_tpu_torch.mesh import generate
from tests.test_torch_amr_cli import write_case
from tests.test_torch_amr_simulation import PACKAGES, deck, volume


def test_raster_deck_raises_and_keeps_the_simulation():
    """A fused_structured deck: the refined mesh is no raster, the JAX
    package's ConfigError; the port's simulation is left whole."""
    sims = {}
    for p in PACKAGES:
        _, make, gen, _ = PACKAGES[p]
        mesh = gen.structured_quad(128, 8, 0.0, 2.0, 0.0, 0.125)
        sims[p] = make(deck(p, 0.004, 0.002,
                            edge_flux_backend="fused_structured"), mesh)
        q = np.zeros((3, mesh.num_cells))
        q[0] = 0.1
        sims[p].set_solution(q)
    marked = np.zeros(sims["port"].num_cells, bool)
    marked[:3] = True
    with pytest.raises(JaxConfigError, match="uniform row-major") as want:
        jax_amr.perform_amr(sims["jax"], marked)
    with pytest.raises(ConfigError, match="uniform row-major") as got:
        sims["port"].mark_cells_for_amr(marked)
        sims["port"].perform_amr()
    assert str(got.value) == str(want.value)
    sim = sims["port"]
    assert sim.num_cells == 1024 and sim._structured["kind"] == "fused"
    sim.run()
    assert sim.finished and np.allclose(sim.get_height(), 0.1)


def test_rcm_scrambles_in_jax_and_is_refused():
    """Under cell_ordering: rcm the JAX package injects the parents' state
    in the unreordered order (ROADMAP fault 24): the refined cells do not
    hold their parents' depths; the port refuses before refining."""
    def dam(package):
        _, make, gen, _ = PACKAGES[package]
        sim = make(deck(package, 0.4, 0.2, cell_ordering="rcm"),
                   gen.structured_quad(10, 8, 0, 10, 0, 8))
        x = sim.mesh.cell_centroid[:, 0]
        q = np.zeros((3, sim.num_cells))
        q[0] = np.where(x < 5.0, 2.0, 1.0)
        sim.set_solution(q)
        return sim, sim.mesh.cell_centroid[:, 0] < 3.0

    sim, marked = dam("jax")
    jax_amr.perform_amr(sim, marked)
    x = sim.mesh.cell_centroid[:, 0]
    scrambled = sim.get_height() != np.where(x < 5.0, 2.0, 1.0)
    assert scrambled.sum() > 0.1 * sim.num_cells
    sim, marked = dam("port")
    with pytest.raises(ConfigError, match="ROADMAP fault 24"):
        amr.perform_amr(sim, marked)
    assert sim.num_cells == 80


def test_cell_elevation_file_raises(tmp_path):
    """grid.cell_elevation.file holds a value per base cell; both rebuilds
    read it again for the refined mesh and fail with IndexError."""
    path = str(tmp_path / "z.bin")
    write_petsc_vec(path, 0.01 * np.arange(80))
    for p in PACKAGES:
        _, make, gen, amr_mod = PACKAGES[p]
        cfg = deck(p, 0.4, 0.2)
        cfg.grid.cell_elevation.file = path
        sim = make(cfg, gen.structured_quad(10, 8, 0, 10, 0, 8))
        with pytest.raises(IndexError, match="out of bounds"):
            amr_mod.perform_amr(sim, sim.mesh.cell_centroid[:, 0] < 3.0)
    assert sim.num_cells == 80 and sim.get_solution().shape == (3, 80)


def setter_source(package):
    _, make, gen, amr_mod = PACKAGES[package]
    mesh = gen.structured_quad(10, 8, 0, 10, 0, 8)
    sim = make(deck(package, 0.4, 0.2), mesh)
    sim.set_domain_water_source(1e-3)
    sim.advance()
    v0 = volume(sim)
    amr_mod.perform_amr(sim, mesh.cell_centroid[:, 0] < 3.0)
    sim.advance()
    return sim.get_solution(), volume(sim) - v0


def test_setter_source_streams_on_the_fine_mesh():
    (q, gain), (q_jax, gain_jax) = setter_source("port"), setter_source("jax")
    assert gain == pytest.approx(1e-3 * 0.2 * 80.0, rel=1e-10)
    np.testing.assert_allclose(q, q_jax, rtol=0, atol=1e-10)
    assert gain == pytest.approx(gain_jax, rel=1e-10)


def test_rebuild_keeps_the_time_state_and_the_log(tmp_path):
    """rebuild_on_mesh keeps the logger: a log file set before the rebuild
    goes on receiving the AMR line; the time state is kept."""
    log = str(tmp_path / "run.log")
    cfg = deck("port", 0.4, 0.2)
    cfg.logging.level = "info"
    sim = Simulation(cfg, mesh=generate.structured_quad(10, 8, 0, 10, 0, 8),
                     device="cpu")
    sim.set_log_file(log)
    sim.set_height(np.full(80, 1.0))
    sim.advance()
    t, step, dt, c = sim.t, sim.step, sim.dt, sim.prev_max_courant
    sim.mark_cells_for_amr(sim.mesh.cell_centroid[:, 0] < 3.0)
    sim.perform_amr()
    assert (sim.t, sim.step, sim.dt, sim.prev_max_courant) == (t, step, dt, c)
    sim.log.close()
    assert "AMR: refined 24 cells -> 184 total cells" in open(log).read()
    assert os.path.getsize(log) > 0


def test_boundary_flux_series_across_amr(tmp_path):
    """The boundary-flux time series (every 5 steps) across an AMR event
    that splits the top and bottom walls' edges: the JAX package's monitor
    keeps the old mesh's accumulator and fails at its next line (ROADMAP
    fault 26); the port's writes the steps since its last line before the
    rebuild, and its lines add up to the volume that left the box."""
    deck = write_case(tmp_path)
    runs = {"jax": (jax_load_config, JaxSimulation, jax_attach_output_monitors,
                    jax_amr),
            "port": (load_config, lambda c: Simulation(c, device="cpu"),
                     attach_output_monitors, amr)}
    for p, (load, make, attach, amr_mod) in runs.items():
        cfg = load(deck)
        cfg.output.format = "none"
        cfg.output.directory = str(tmp_path / p)
        cfg.output.time_series.boundary_fluxes = 5
        sim = make(cfg)
        attach(sim)
        v0 = volume(sim)
        sim.advance()
        sim.advance()
        amr_mod.perform_amr(sim, np.abs(sim.mesh.cell_centroid[:, 0] - 2.0)
                            < 0.5)
        if p == "jax":
            with pytest.raises(ValueError, match="broadcast"):
                sim.advance()
            continue
        sim.run()
    assert sim.step == 30 and sim.num_cells == 288
    lines = [ln.split() for ln in open(tmp_path / "port" /
                                       "boundary_fluxes.dat")
             if not ln.startswith("#")]
    right = [float(ln[2]) for ln in lines if ln[1] == "right"]
    assert len(right) == 6  # steps 5, 10, ..., 30; the event at step 20
    assert sum(right) == pytest.approx(v0 - volume(sim), rel=1e-10)
