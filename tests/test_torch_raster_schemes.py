"""The raster deck of tests/test_torch_raster_simulation.py under ssprk2
and ssprk3 in both packages, on the CPU: the fused kind (stage mode with
qA; ssprk3's last stage takes float32 1/3 and 1 - 1/3 as the JAX package
does) to the same steps, dt sequence and float32 time, the state to 2e-6
and the accumulators to 1e-5. rk4 is in tests/test_torch_raster_rk4.py.
"""

import numpy as np
import pytest

from rdycore_tpu_torch.ops.structured import FUSED_STAGES

from test_torch_raster_simulation import fused_run_matches_jax


@pytest.mark.parametrize("scheme", ["ssprk2", "ssprk3"])
def test_fused_run_matches_jax(tmp_path, scheme):
    fused_run_matches_jax(tmp_path, scheme)


def test_ssprk3_last_stage_is_float32_third():
    alpha, beta, gamma = FUSED_STAGES["ssprk3"][2]
    third = np.float32(1.0 / 3.0)
    assert (alpha, beta, gamma) == (third, np.float32(1.0) - third,
                                    np.float32(1.0) - third)
    assert beta != np.float32(2.0 / 3.0)  # not the unstructured tableau's
