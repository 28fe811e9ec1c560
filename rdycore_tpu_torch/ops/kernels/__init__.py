"""Hand-written CUDA kernels of the package (the counterpart of the JAX
package's ops/pallas/), each beside its plain PyTorch version:

- K1a `swe_edge_flux` (edge_flux.py, csrc/swe_edge_flux.cu)
- K1b `swe_cell_stage` (cell_stage.py, csrc/swe_cell_stage.cu)
- K1c `courant_argmax` (courant.py, csrc/courant_argmax.cu)
- K2 `swe_raster_step` (raster_step.py, csrc/swe_raster_step.cu)

A wrapper launches its kernel for CUDA tensors and takes the plain version
for CPU tensors; `launches` on each wrapper counts its kernel's launches.
"""

from .cell_stage import swe_cell_stage
from .courant import courant_argmax
from .edge_flux import swe_edge_flux
from .raster_step import swe_raster_step

KERNELS = (swe_edge_flux, swe_cell_stage, courant_argmax, swe_raster_step)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0
