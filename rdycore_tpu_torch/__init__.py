"""rdycore_tpu_torch: the PyTorch + CUDA port of rdycore_tpu.

A second package beside the JAX one (which stays the reference): the
first-order, flow-only, single-device unstructured path through
`Simulation`, with hand-written CUDA kernels for Hopper (sm_90a) on the hot
path (ops/kernels/). It imports torch and never jax, and nothing of
rdycore_tpu. Entry points run on the CUDA device unless the caller passes
device="cpu", where the kernels' plain PyTorch versions run instead.
"""

__version__ = "0.1.0"

from .config.yaml_input import load_config  # noqa: E402
from .operator import build_operator  # noqa: E402
from .simulation import Simulation  # noqa: E402

__all__ = ["Simulation", "build_operator", "load_config", "__version__"]
