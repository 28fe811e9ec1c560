"""The reference driver's two-call AMR workflow (driver/amr.c:
RDyMarkOwnedCellsForAMR, then RDyPerformAMR) through the port's
Simulation methods against the JAX package's, f64 on the CPU: the deck of
tests/test_amr.py's `test_rdy_style_mark_then_perform`. The errors are
the JAX package's (RuntimeError for `perform_amr` before any mark,
ValueError for marks of the wrong shape, the same messages); after
`perform_amr` the state agrees within 1e-12 and the volume is kept, after
a further advance within 1e-10.
"""

import numpy as np
import pytest

from tests.test_torch_amr_simulation import PACKAGES, deck, volume


def rdy_style(package):
    """test_rdy_style_mark_then_perform through the Simulation methods."""
    _, make, gen, _ = PACKAGES[package]
    mesh = gen.structured_tri(10, 8, 0, 10, 0, 8)
    sim = make(deck(package, 0.2, 0.1), mesh)
    q = np.zeros((3, mesh.num_cells))
    q[0] = 1.0
    q[0, mesh.cell_centroid[:, 0] < 5.0] = 2.0
    sim.set_solution(q)
    errors = []
    for call in (sim.perform_amr, lambda: sim.mark_cells_for_amr(
            np.ones(3, bool))):
        with pytest.raises((RuntimeError, ValueError)) as exc:
            call()
        errors.append((type(exc.value), str(exc.value)))
    sim.advance()
    v0 = volume(sim)
    sim.mark_cells_for_amr(sim.get_height() > 1.5)
    sim.perform_amr()
    v1 = volume(sim)
    mid = sim.get_solution()
    sim.advance()
    return dict(errors=errors, v0=v0, v1=v1, mid=mid,
                end=sim.get_solution(), finished=sim.finished,
                cells=sim.mesh.num_cells, base=mesh.num_cells,
                restarted=sim.restarted)


def test_rdy_style_mark_then_perform():
    got, want = rdy_style("port"), rdy_style("jax")
    assert got["errors"] == want["errors"]
    assert [e[0] for e in got["errors"]] == [RuntimeError, ValueError]
    assert got["cells"] == want["cells"] > got["base"]
    assert got["v1"] == pytest.approx(got["v0"], rel=1e-12)
    np.testing.assert_allclose(got["mid"], want["mid"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["end"], want["end"], rtol=0, atol=1e-10)
    assert got["finished"] and not got["restarted"]
