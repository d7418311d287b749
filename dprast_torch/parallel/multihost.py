"""Process-group initialisation and multi-host mesh construction (PyTorch
port of `dprast/parallel/multihost.py`).

`torch.distributed` does the heavy lifting: `init_process_group` forms the
group of one process per device, and the same `raster_sharded`
(`dprast_torch.parallel.sharded`) runs unchanged over it, its sums riding
NVLink inside a host and the network across hosts (NCCL), or host memory
(Gloo).

Typical run, the same script in every process (`torchrun` sets the
environment):

    from dprast_torch.parallel import multihost, raster_sharded
    multihost.initialize()                  # env-driven
    mesh = multihost.pod_mesh(points_axis_per_host=True)
    out = raster_sharded(grid, pts, rots, trs, mesh=mesh)
    multihost.shutdown()
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from dprast_torch.parallel.sharded import make_mesh

# what the launchers call a process's rank, the world size, and the rank
# and the number of processes on its host: torchrun, Open MPI, Slurm
_RANK = ("RANK", "OMPI_COMM_WORLD_RANK", "SLURM_PROCID")
_WORLD_SIZE = ("WORLD_SIZE", "OMPI_COMM_WORLD_SIZE", "SLURM_NTASKS")
_LOCAL_RANK = ("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK", "SLURM_LOCALID")
_LOCAL_WORLD_SIZE = ("LOCAL_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_SIZE",
                     "SLURM_NTASKS_PER_NODE")


def _env_int(names) -> int | None:
    """The first of the environment variables `names` that holds an
    integer."""
    for name in names:
        try:
            return int(os.environ[name])
        except (KeyError, ValueError):
            continue
    return None


def _multiprocess_env() -> bool:
    """True when the environment indicates a multi-process launch.  When it
    does (or explicit arguments are given) a failure to form the process
    group is a real misconfiguration and must surface loudly: silently
    degrading to one process would have every process compute in
    isolation."""
    if any(os.environ.get(v) for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return True
    return any((_env_int((var,)) or 1) > 1
               for var in ("SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE"))


def _local_world_size(world_size: int) -> int:
    """Processes on this host; all of them where no launcher says."""
    return _env_int(_LOCAL_WORLD_SIZE) or world_size


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               timeout: float | None = None) -> None:
    """Form the process group.

    Returns at once where a group exists.  Single-process environments (no
    explicit argument and no cluster environment variable) return without
    touching `torch.distributed` at all.  In a configured environment
    every error from `init_process_group` propagates: a misconfigured run
    must fail loudly, not degrade to isolated single-process compute.

    `init_method` is `init_process_group`'s (default ``env://``:
    `MASTER_ADDR` and `MASTER_PORT`); `world_size` and `rank` default to
    what the launcher set.  `backend`: NCCL where every process of this
    host has a card of its own, which the process then makes its current
    device (its local rank's), else Gloo; a name overrides the choice.
    `timeout` (seconds) bounds the rendezvous and every collective.
    """
    if dist.is_available() and dist.is_initialized():
        return
    explicit = (init_method is not None or world_size is not None
                or rank is not None)
    if not explicit and not _multiprocess_env():
        return  # single-process run: no group to form
    if world_size is None:
        world_size = _env_int(_WORLD_SIZE)
    if rank is None:
        rank = _env_int(_RANK)
    local_rank = _env_int(_LOCAL_RANK)
    if local_rank is None:
        local_rank = rank or 0
    own_card = (torch.cuda.is_available() and world_size is not None
                and _local_world_size(world_size)
                <= torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if own_card and dist.is_nccl_available() else "gloo"
    if own_card:
        torch.cuda.set_device(local_rank)
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, **kwargs)


def pod_mesh(points_axis_per_host: bool = True):
    """A ("poses", "points") mesh over every process of the group.

    With `points_axis_per_host` the "points" axis spans the processes
    within each host (the sum of partial images over it, the hot
    collective of the forward, stays on the host's own links) and "poses"
    spans hosts (its gradient sums cross the network once per step,
    amortised over the whole pose batch).  Ranks must be contiguous per
    host, as `torchrun` numbers them.
    """
    n = dist.get_world_size() if (dist.is_available()
                                  and dist.is_initialized()) else 1
    local = _local_world_size(n)
    hosts = max(1, n // max(1, local))
    if points_axis_per_host and n % local == 0:
        return make_mesh(hosts, local)
    return make_mesh(n, 1)


def shutdown() -> None:
    """Destroy the process group, if there is one.  Call it before the
    process exits: a group left to the interpreter's teardown can hang."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
