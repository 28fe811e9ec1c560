"""MMS levels of rdycore_tpu_torch against the JAX package's
`rdycore_tpu.mms`, on the CPU, in f64, on the MMS deck of
tools/torch_mms_decks.py: `run_mms_level`'s L1, L2 and Linf norms of every
component to 1e-10 relative, at first order (euler) and at second order
(MUSCL minmod with the positivity limiter, ssprk2, on triangles). With two
sediment classes: tests/test_torch_mms_sediment_jax.py; the rates of a
ladder: tests/test_torch_mms_rates_jax.py.
"""

import numpy as np
import pytest

from rdycore_tpu.config.yaml_input import config_from_dict as jax_config
from rdycore_tpu.mesh import generate as jax_generate
from rdycore_tpu.mms import MMSProblem as JaxMMSProblem
from rdycore_tpu.mms import run_mms_level as jax_run_level
from rdycore_tpu_torch.config.yaml_input import config_from_dict
from rdycore_tpu_torch.mms import MMSProblem, run_mms_level
from tools.torch_mms_decks import LX, LY, base_mesh, mms_deck

LEVELS = {
    "first_order": dict(),
    "muscl": dict(second_order=True, temporal="ssprk2"),
    "sediment_roe": dict(num_sediment=2),
    "sediment_upwind_roe": dict(num_sediment=2, riemann="upwind_roe"),
}


def level_norms_match_jax(case):
    deck = mms_deck("unused.npz", 0.004, 0.04, 0, **LEVELS[case])
    tri = case == "muscl"
    jmesh = (jax_generate.structured_tri if tri
             else jax_generate.structured_quad)(10, 7, 0.0, LX, 0.0, LY)
    want = jax_run_level(JaxMMSProblem(jax_config(deck).validate()), jmesh)
    got = run_mms_level(MMSProblem(config_from_dict(deck).validate()),
                        base_mesh(10, 7, tri), device="cpu")
    assert got.num_cells == want.num_cells and got.area == want.area
    ndof = 3 + LEVELS[case].get("num_sediment", 0)
    for norm in ("L1", "L2", "Linf"):
        g, w = getattr(got, norm), getattr(want, norm)
        assert g.shape == w.shape == (ndof,)
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=0, err_msg=norm)


@pytest.mark.parametrize("case", ["first_order", "muscl"])
def test_level_norms_match_jax(case):
    level_norms_match_jax(case)
