"""dprast_torch: differentiable point rasterisation in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package `dprast`, which stays the reference.  This
package imports neither JAX nor `dprast`.  So far it covers `raster`
(differentiable through autograd) and `raster_pullback` on the ``"xla"``
oracle (any rank, any device) and the ``"binned"`` backend for 2-D and
3-D grids, with its ``"binned_bf16"`` fast mode.
"""

from dprast_torch.api import RasterGrads, raster, raster_pullback
from dprast_torch.ops.dispatch import available_backends, default_backend

__version__ = "0.2.0"

__all__ = ["raster", "raster_pullback", "RasterGrads", "available_backends",
           "default_backend", "__version__"]
