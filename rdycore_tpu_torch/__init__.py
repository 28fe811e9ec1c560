"""rdycore_tpu_torch: the PyTorch + CUDA port of rdycore_tpu.

A second package beside the JAX one (which stays the reference), with
hand-written CUDA kernels for Hopper (sm_90a) on the hot paths
(ops/kernels/): `Simulation` on unstructured meshes (first or second
order, well-balanced, with tracers and sediment; explicit, IMEX or
implicit stepping) and on uniform rasters (whole or in row strips), the
coupling surface and the embedded C API, mesh files, forcing datasets,
output and checkpoints, the MMS driver, and the modules imported on
their own as in the JAX package: `ensemble` (EnsembleSimulation), `amr`
(adaptive mesh refinement) and `profiling`. It imports torch and never
jax, and nothing of rdycore_tpu. Entry points run on the CUDA device
unless the caller passes device="cpu", where the kernels' plain PyTorch
versions run instead.
"""

__version__ = "0.1.0"

from .config.yaml_input import load_config  # noqa: E402
from .operator import build_operator  # noqa: E402
from .simulation import Simulation  # noqa: E402

__all__ = ["Simulation", "build_operator", "load_config", "__version__"]
