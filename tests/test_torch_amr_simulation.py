"""AMR in the middle of a run through the port's Simulation against the JAX
package's, f64 on the CPU.

The decks of tests/test_amr.py (`test_amr_mid_simulation` and its quad
variant with the centroid fans) run in both packages: after `perform_amr` the mesh, the
state and Manning's n agree within 1e-12, after a further advance within
1e-10, and the volume of the closed box is kept.
(tests/test_torch_amr_workflow.py holds the mark-then-perform workflow
and its errors, tests/test_torch_amr_rebuild.py the rebuild's other
cases: raster decks, RCM, the cell-elevation file, setter sources, the
boundary-flux series and the log.)
"""

import numpy as np
import pytest

from rdycore_tpu import amr as jax_amr
from rdycore_tpu.config.schema import Config as JaxConfig
from rdycore_tpu.mesh import generate as jax_generate
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, amr
from rdycore_tpu_torch.config.schema import Config
from rdycore_tpu_torch.mesh import generate

PACKAGES = {
    "jax": (JaxConfig, lambda cfg, mesh: JaxSimulation(cfg, mesh=mesh),
            jax_generate, jax_amr),
    "port": (Config, lambda cfg, mesh: Simulation(cfg, mesh=mesh,
                                                  device="cpu"),
             generate, amr),
}


def deck(package, stop, interval, **numerics):
    cfg = PACKAGES[package][0]()
    cfg.time.stop = stop
    cfg.time.time_step = 0.002
    cfg.time.coupling_interval = interval
    cfg.logging.level = "none"
    for k, v in numerics.items():
        setattr(cfg.numerics, k, v)
    return cfg.validate()


def volume(sim):
    return float((sim.get_height() * sim.mesh.cell_area).sum())


def mid_simulation(package, kind):
    """test_amr_mid_simulation (tri) and its quad variant: advance, refine
    where the water is deep, advance again; the snapshots of each stage."""
    _, make, gen, amr_mod = PACKAGES[package]
    if kind == "tri":
        mesh = gen.structured_tri(10, 8, 0, 10, 0, 8)
        offset, threshold = 1.4, 0.1
    else:
        mesh = gen.structured_quad(10, 8, 0, 10, 0, 8)
        offset, threshold = 1.2, 0.5
    sim = make(deck(package, 0.4, 0.2), mesh)
    q0 = np.zeros((3, mesh.num_cells))
    q0[0] = np.where(mesh.cell_centroid[:, 0] < 5.0, 2.0, 1.0)
    sim.set_solution(q0)
    v_before = volume(sim)
    sim.advance()
    marked = amr_mod.mark_cells_from_raster(
        sim.get_height() - offset, sim.mesh.cell_area,
        area_threshold=threshold)
    v_mid = volume(sim)
    amr_mod.perform_amr(sim, marked)
    after = (sim.get_solution(), sim.get_manning_n(), sim.mesh.num_cells,
             sim.mesh.cell_centroid.copy(), volume(sim),
             sim.amr_base_map.copy())
    sim.advance()
    return dict(v_before=v_before, v_mid=v_mid, after=after,
                end=sim.get_solution(), v_end=volume(sim), t=sim.t,
                step=sim.step, finished=sim.finished, base=mesh.num_cells)


@pytest.fixture(scope="module", params=["tri", "quad"])
def mid_runs(request):
    return {p: mid_simulation(p, request.param) for p in PACKAGES}


def test_amr_mid_simulation(mid_runs):
    got, want = mid_runs["port"], mid_runs["jax"]
    q, n, cells, centroids, v_after, base_map = got["after"]
    assert cells == want["after"][2] > got["base"]
    np.testing.assert_allclose(q, want["after"][0], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(n, want["after"][1])
    np.testing.assert_array_equal(centroids, want["after"][3])
    np.testing.assert_array_equal(base_map, want["after"][5])
    assert v_after == pytest.approx(got["v_mid"], rel=1e-12)
    np.testing.assert_allclose(got["end"], want["end"], rtol=0, atol=1e-10)
    assert got["finished"] and (got["t"], got["step"]) == (want["t"],
                                                           want["step"])
    assert np.isfinite(got["end"]).all() and (got["end"][0] >= 0).all()
    assert got["v_end"] == pytest.approx(got["v_before"], rel=1e-10)


def test_quad_fans(mid_runs):
    """On the quad mesh the refined block's neighbours become fans of 5
    triangles, each a child of its quad."""
    q, _, cells, _, _, base_map = mid_runs["port"]["after"]
    kids = np.bincount(base_map)
    expected = {1, 4, 5} if mid_runs["port"]["base"] == 80 else {1, 2, 4}
    assert expected <= set(kids.tolist())
