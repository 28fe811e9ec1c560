"""Hand-written CUDA kernels of the package (the counterpart of the JAX
package's ops/pallas/), each beside its plain PyTorch version:

- K1a `swe_edge_flux` (edge_flux.py, csrc/swe_edge_flux.cu)
- K1b `swe_cell_stage` (cell_stage.py, csrc/swe_cell_stage.cu)
- K1c `courant_argmax` (courant.py, csrc/courant_argmax.cu)
- K2 `swe_raster_step` (raster_step.py, csrc/swe_raster_step.cu)
- K3a `swe_muscl_grad`, K3b `swe_positivity_drain` and
  `swe_positivity_scale` (muscl.py, csrc/swe_muscl_grad.cu,
  csrc/swe_positivity.cu)
- K2 MUSCL `swe_raster_muscl_step` (raster_muscl.py,
  csrc/swe_raster_muscl.cu)
- K5 `swe_eta_vertex` (eta_vertex.py, csrc/swe_eta_vertex.cu), the BS2002
  vertex eta

K1a and K1b also carry the well-balancing modes (K4): hydrostatic
reconstruction in both, the BS2002 correction in K1a. K1a hands its
fluxes on as records, each edge's ndof values side by side (a [ndof,
E + 1] view of an [E + 1, ndof] buffer), the layout K1b and K3b read.

A wrapper launches its kernel for CUDA tensors and takes the plain version
for CPU tensors; `launches` on each wrapper counts its kernel's launches.
"""

from .cell_stage import swe_cell_stage
from .courant import courant_argmax
from .edge_flux import swe_edge_flux
from .eta_vertex import swe_eta_vertex
from .muscl import swe_muscl_grad, swe_positivity_drain, swe_positivity_scale
from .raster_muscl import swe_raster_muscl_step
from .raster_step import swe_raster_step

KERNELS = (swe_edge_flux, swe_cell_stage, courant_argmax, swe_raster_step,
           swe_muscl_grad, swe_positivity_drain, swe_positivity_scale,
           swe_raster_muscl_step, swe_eta_vertex)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0
