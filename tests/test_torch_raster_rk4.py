"""The raster deck of tests/test_torch_raster_simulation.py under rk4 in
both packages, on the CPU: the fused kind (four rhs-mode raster steps a
step, the Courant number from k1) to the same steps, dt sequence and
float32 time, the state to 2e-6 and the accumulators to 1e-5.
"""

from test_torch_raster_simulation import fused_run_matches_jax


def test_fused_run_matches_jax(tmp_path):
    fused_run_matches_jax(tmp_path, "rk4")
