"""The rates of an MMS convergence ladder through rdycore_tpu_torch's
`MMSDriver` against the JAX package's `estimate_convergence_rates`, on the
CPU, in f64: the MMS deck of tools/torch_mms_decks.py on a 6 x 4 quad
base mesh (an .npz file, as a user's deck names it) and two uniform
refinements, every rate to 1e-8.
"""

import numpy as np

from rdycore_tpu.config.yaml_input import config_from_dict as jax_config
from rdycore_tpu.mesh import generate as jax_generate
from rdycore_tpu.mms import MMSProblem as JaxMMSProblem
from rdycore_tpu.mms import estimate_convergence_rates as jax_rates
from rdycore_tpu_torch.config.yaml_input import config_from_dict
from rdycore_tpu_torch.mesh import save_mesh_npz
from rdycore_tpu_torch.mms import MMSDriver
from tools.torch_mms_decks import LX, LY, base_mesh, mms_deck


def test_driver_rates_match_jax(tmp_path):
    save_mesh_npz(base_mesh(6, 4), str(tmp_path / "base.npz"))
    deck = mms_deck(str(tmp_path / "base.npz"), 0.005, 0.03, 2)
    drv = MMSDriver(config_from_dict(deck).validate(), device="cpu")
    drv.run(log=lambda *_: None)
    jcfg = jax_config(deck).validate()
    want = jax_rates(JaxMMSProblem(jcfg),
                     jax_generate.structured_quad(6, 4, 0.0, LX, 0.0, LY),
                     log=lambda *_: None)
    assert [r.num_cells for r in drv.results] == [24, 96, 384]
    for norm in ("L1", "L2", "Linf"):
        np.testing.assert_allclose(drv.rates[norm], want[norm], rtol=0,
                                   atol=1e-8, err_msg=norm)
