"""Two faults of the JAX package's BS2002 well-balancing that the port
meets (ROADMAP faults 18 and 19), on the CPU in float64.

- Fault 18: on the JAX package's operator, BS2002 changes the hu flux
  divergence without tracers (by 0.1 or more on a bumpy bed) and leaves it
  exactly as without well-balancing once the state carries one tracer;
  the port refuses such a deck (tests/test_torch_wb_simulation.py) and
  such an operator (tests/test_torch_wb_bs2002.py).
- Fault 19: BS2002 is no well-balancing of still water, and over dry bump
  tops it diverges, in both packages alike.
"""

import jax
import jax.numpy as jnp
import numpy as np

from rdycore_tpu.mesh import structured_tri
from rdycore_tpu.operator import build_operator as jax_build_operator


def test_jax_bs2002_drops_its_correction_with_a_tracer():
    mesh = structured_tri(8, 6, 0, 8, 0, 6, z_fn=lambda x, y: 0.3 * np.sin(x)
                          * np.cos(y) + 0.02 * x)
    C = mesh.num_cells
    h = 1.0 + np.random.default_rng(2).random(C)
    ops, states = [], []
    for nt in (0, 1):
        states.append(jnp.asarray(np.concatenate(
            [[h], np.zeros((2, C)), 0.1 * h[None].repeat(nt, 0)])))
        ops.append([jax_build_operator(mesh, mannings_n=np.zeros(C),
                                       num_tracers=nt,
                                       well_balancing_bs2002=bs)
                    for bs in (False, True)])

    def run(states):
        return [[op.apply(q, 0.01, op.zero_boundary_values(),
                          jnp.zeros_like(q)).flux_div[1] for op in pair]
                for pair, q in zip(ops, states)]

    (n0, b0), (n1, b1) = jax.jit(run)(states)
    assert float(jnp.abs(b0 - n0).max()) > 0.1
    assert float(jnp.abs(b1 - n1).max()) == 0.0


def test_bs2002_diverges_over_dry_bump_tops_in_both():
    """ROADMAP fault 19: a dam break onto a floodplain whose bump tops are
    dry (the deck of chip_smoke.py phase 7, cut to 64x44 triangles of the
    same size) drives BS2002 to negative depths within 20 steps in both
    packages, in f64 (and to NaN or blow-up later); without
    well-balancing the depths stay >= 0. The two packages agree."""
    from rdycore_tpu.config.yaml_input import config_from_dict as jax_cfg
    from rdycore_tpu.simulation import Simulation as JaxSimulation
    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.config.yaml_input import config_from_dict
    from rdycore_tpu_torch.mesh import structured_tri as port_tri

    nx, ny, dt, steps = 64, 44, 0.0002, 20

    def bed(x, y):
        return 0.035 * (1.0 + np.sin(4 * np.pi * x) * np.sin(4 * np.pi * y))

    def deck(wb):
        return {
            "physics": {"flow": {"mode": "swe", "well_balancing": wb}},
            "numerics": {"temporal": "euler", "precision": "double"},
            "logging": {"level": "none"},
            "time": {"stop": steps * dt, "time_step": dt,
                     "coupling_interval": steps * dt},
            "regions": [{"name": "domain", "grid_region_id": 1}],
            "surface_composition": [{"region": "domain",
                                     "material": "smooth"}],
            "materials": [{"name": "smooth",
                           "properties": {"manning": {"value": 0.018}}}],
            "initial_conditions": [{"region": "domain", "flow": "still"}],
            "flow_conditions": [{"name": "still", "type": "dirichlet",
                                 "height": 0.0, "x_momentum": 0,
                                 "y_momentum": 0}],
        }

    def state(mesh):
        eta = np.where(mesh.cell_centroid[:, 0] < nx / 724, 0.25, 0.05)
        q = np.zeros((3, mesh.num_cells))
        q[0] = np.maximum(eta - mesh.cell_z, 0.0)
        return q

    args = (nx, ny, 0.0, nx * 4.0 / 1448, 0.0, ny * 2.75 / 996)
    meshes = [structured_tri(*args, z_fn=bed), port_tri(*args, z_fn=bed)]
    for m in meshes:
        m.regions["__id_1"] = np.arange(m.num_cells, dtype=np.int32)
    js = JaxSimulation(jax_cfg(deck("bs2002")).validate(), mesh=meshes[0])
    js.set_solution(state(meshes[0]))
    sims = {wb: Simulation(config_from_dict(deck(wb)).validate(),
                           mesh=meshes[1], device="cpu")
            for wb in ("bs2002", "none")}
    for sim in (js, *sims.values()):
        if sim is not js:
            sim.set_solution(state(meshes[1]))
        sim.run()
        assert sim.step == steps
    hj = np.asarray(js.q)[0]
    ht = sims["bs2002"].get_height()
    assert hj.min() < -1e-6 and ht.min() < -1e-6
    assert_rel = np.abs(ht - hj).max() / np.abs(hj).max()
    assert assert_rel < 1e-8
    assert sims["none"].get_height().min() >= 0.0
