"""What the JAX package does with AMR in shards under `parallel.
partitioning: auto` (ROADMAP fault 24), f64 on the CPU: its rebuild runs
`Simulation.__init__` again, which reorders the refined mesh by RCM for
the shard split, and `perform_amr` then sets the injected state in the
refined mesh's own order. The state it holds is not the injection: read
in natural order, a refinement of a still lake breaks it. The port raises
a ConfigError naming fault 24 there (tests/test_torch_sharded_amr.py),
and runs AMR in shards under `partitioning: none`.
"""

import numpy as np

from rdycore_tpu import amr as jax_amr
from rdycore_tpu.config.schema import Config as JaxConfig
from rdycore_tpu.mesh import generate as jax_generate
from rdycore_tpu.simulation import Simulation as JaxSimulation


def test_the_jax_shards_scramble_the_state_under_rcm():
    cfg = JaxConfig()
    cfg.time.stop = 0.4
    cfg.time.time_step = 0.002
    cfg.time.coupling_interval = 0.2
    cfg.logging.level = "none"
    cfg.parallel.n_devices = 2
    cfg.parallel.partitioning = "auto"
    cfg = cfg.validate()
    mesh = jax_generate.structured_tri(10, 8, 0, 10, 0, 8)
    sim = JaxSimulation(cfg, mesh=mesh)
    assert sim._sharded is not None
    # depth by x, in natural order: 2 m to the left of x = 5, 1 m beyond
    nat = sim.get_natural_ids()
    x = mesh.cell_centroid[nat, 0]
    q = np.zeros((3, mesh.num_cells))
    q[0] = np.where(x < 5.0, 2.0, 1.0)
    sim.set_solution(q)
    marked = jax_amr.mark_cells_from_raster(
        sim.get_height() - 1.4, sim.mesh.cell_area, area_threshold=0.1)
    assert marked.any()
    jax_amr.perform_amr(sim, marked)
    assert sim.mesh.num_cells > mesh.num_cells
    # children inherit their parents' depth: a cell left of x = 5 holds
    # 2 m, to the right 1 m, wherever RCM put it
    x_new = sim.mesh.cell_centroid[:, 0]
    want = np.where(x_new < 5.0, 2.0, 1.0)
    wrong = np.mean(sim.get_height() != want)
    assert wrong > 0.1
