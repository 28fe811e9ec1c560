"""BS2002 at second order through the port's `Simulation`, on the CPU in
float64: MUSCL (minmod) with the positivity limiter under ssprk2 over a
dry floodplain, the dam break over a bumpy bed of
tests/test_torch_wb_simulation.py against the JAX package, to 1e-10 in
the final state, the accumulators and the Courant number
(`check_runs_agree`). The port's operator refuses BS2002 with a tracer
(ROADMAP fault 18, tests/test_torch_wb_faults.py).
"""

import pytest

from rdycore_tpu_torch.mesh import structured_quad
from rdycore_tpu_torch.operator import build_operator

from test_torch_wb_simulation import check_runs_agree


def test_bs2002_muscl_ssprk2_matches_jax(tmp_path):
    check_runs_agree(tmp_path, wb="bs2002", scheme="ssprk2",
                     second_order=True, plain=0.0)


def test_port_operator_refuses_bs2002_with_a_tracer():
    with pytest.raises(ValueError, match="BS2002"):
        build_operator(structured_quad(4, 3, 0.0, 1.0, 0.0, 1.0),
                       num_tracers=1, well_balancing_bs2002=True,
                       device="cpu")
