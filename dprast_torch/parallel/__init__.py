"""Multi-device distribution layer (PyTorch port of `dprast/parallel/`).

The two logical work axes, points and poses, are the axes of a process
mesh over `torch.distributed` (one process per device; NCCL between
cards, Gloo on the CPU):

- forward: per-process partial images, summed over the ``points`` group;
- backward: pose gradients summed over ``points``, point gradients summed
  over ``poses``, by transposes written by hand in
  `dprast_torch.parallel.sharded`.

`dprast_torch.parallel.multihost` forms the process group from the
environment and builds the mesh of a multi-host run.
"""

from dprast_torch.parallel.sharded import (
    make_mesh,
    raster_sharded,
    raster_sharded_local,
    shard_raster_args,
)

__all__ = ["make_mesh", "raster_sharded", "raster_sharded_local",
           "shard_raster_args"]
