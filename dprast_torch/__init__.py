"""dprast_torch: differentiable point rasterisation in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package `dprast`, which stays the reference.  This
package imports neither JAX nor `dprast`.  It covers `raster`
(differentiable through autograd) and `raster_pullback` on the five
backends of the JAX package (``"xla"``, ``"matmul"``, ``"matmul_bf16"``,
``"binned"``, ``"binned_bf16"``), and in `dprast_torch.parallel` the
("poses", "points") distribution layer over `torch.distributed`, which
is imported only by who uses it.
"""

from dprast_torch.api import RasterGrads, raster, raster_pullback
from dprast_torch.ops.dispatch import available_backends, default_backend

__version__ = "0.2.0"

__all__ = ["raster", "raster_pullback", "RasterGrads", "available_backends",
           "default_backend", "__version__"]
