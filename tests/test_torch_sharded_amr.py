"""Adaptive mesh refinement in shards (parallel.n_devices > 1 in one
process) through the port's `Simulation`, f64 on the CPU: advance, refine
where the water is deep (`amr.perform_amr`: the state gathered from the
shards, injected on the host, the refined mesh partitioned again and the
state scattered to its shards), advance again. With `partitioning: none`
in 2 and 4 shards it is the one-process run bit for bit after the
refinement and after the next interval (state, Manning's n, time, step),
and the closed box keeps its volume. Under `partitioning: auto` the
rebuild would reorder the refined mesh by RCM, which the JAX package's
injection ignores (tests/test_torch_sharded_amr_jax.py): a ConfigError
naming ROADMAP fault 24.
"""

import numpy as np
import pytest
import torch

from rdycore_tpu_torch import Simulation, amr
from rdycore_tpu_torch.config.schema import Config, ConfigError
from rdycore_tpu_torch.mesh import generate


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deck(P=1, partitioning="none"):
    cfg = Config()
    cfg.time.stop = 0.4
    cfg.time.time_step = 0.002
    cfg.time.coupling_interval = 0.2
    cfg.logging.level = "none"
    cfg.parallel.n_devices = P
    cfg.parallel.partitioning = partitioning
    return cfg.validate()


def volume(sim):
    return float((sim.get_height() * sim.mesh.cell_area).sum())


def refine_mid_run(kind, P, partitioning="none"):
    if kind == "tri":
        mesh = generate.structured_tri(10, 8, 0, 10, 0, 8)
        offset, threshold = 1.4, 0.1
    else:
        mesh = generate.structured_quad(10, 8, 0, 10, 0, 8)
        offset, threshold = 1.2, 0.5
    sim = Simulation(deck(P, partitioning), mesh=mesh, device="cpu")
    q0 = np.zeros((3, mesh.num_cells))
    q0[0] = np.where(mesh.cell_centroid[:, 0] < 5.0, 2.0, 1.0)
    sim.set_solution(q0)
    sim.advance()
    marked = amr.mark_cells_from_raster(
        sim.get_height() - offset, sim.mesh.cell_area,
        area_threshold=threshold)
    v_mid = volume(sim)
    amr.perform_amr(sim, marked)
    after = dict(q=sim.get_solution(), n=sim.get_manning_n(),
                 cells=sim.mesh.num_cells, v=volume(sim))
    sim.advance()
    return sim, dict(after=after, v_mid=v_mid, end=sim.get_solution(),
                     t=sim.t, step=sim.step, base=mesh.num_cells)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("kind", ["tri", "quad"])
def test_amr_in_shards_is_the_one_process_run(kind, P):
    sim, got = refine_mid_run(kind, P)
    _, want = refine_mid_run(kind, 1)
    assert sim._sharded is not None and sim._sharded.P == P
    # the refined mesh's partition: P shards over its cells
    assert sim._sharded.ref_op.num_cells == got["after"]["cells"]
    assert got["after"]["cells"] > got["base"]
    for k in ("q", "n"):
        np.testing.assert_array_equal(got["after"][k], want["after"][k])
    np.testing.assert_array_equal(got["end"], want["end"])
    assert (got["t"], got["step"]) == (want["t"], want["step"])
    assert got["after"]["v"] == pytest.approx(got["v_mid"], rel=1e-12)
    assert volume(sim) == pytest.approx(got["v_mid"], rel=1e-12)


def test_amr_under_partitioning_auto_is_refused():
    with pytest.raises(ConfigError, match="fault 24"):
        refine_mid_run("tri", 2, "auto")
