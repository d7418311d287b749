"""Multi-device rasterisation over a ("poses", "points") process mesh
(PyTorch port of `dprast/parallel/sharded.py`).

**The process model is SPMD**, as the JAX package's multi-process runs
are: one process per device, and every process makes the same calls with
the same *global* arguments.  `raster_sharded` hands every process the
same global image, and under autograd every process gets the same full
gradients of the (replicated) loss it computed from that image.  Nothing
is scattered from a root rank and nothing is gathered to one.

Sharding layout (the JAX package's):

    points       (P, N_in)        sharded over "points", replicated over "poses"
    point_weight (P,)             sharded over "points"
    rotation     (B, N_out, N_in) sharded over "poses",  replicated over "points"
    translation  (B, N_out)       sharded over "poses"
    background   (B,)             sharded over "poses"
    out_weight   (B,)             sharded over "poses"
    output       (B, *grid)       sharded over "poses",  replicated over "points"

Forward: process (i, j) rasterises points block j under pose block i into
a partial image (background excluded) with the ordinary
`ad.raster_canonical`, the partials are summed over the "points" group,
the per-pose background is added once after the sum, and the pose rows
are assembled over the "poses" group.

Backward: `jax.shard_map` derives its collectives from the variance
types of the forward; torch derives nothing, so each primitive below is a
`torch.autograd.Function` whose backward is the transpose written by
hand:

    forward                                   backward
    ----------------------------------------  ---------------------------------
    `_Vary`     identity (mark a block as     sum of the cotangent over that
                used by every process of a    group
                group)
    `_PSum`     sum over a group              identity (the cotangent is the
                                              same on every process of it)
    `_Slice`    this process's block of a     the blocks assembled over that
                replicated tensor             axis' group
    `_Assemble` blocks assembled over a       this process's block of the
                group into a replicated       cotangent
                tensor

So point gradients are summed over "poses", pose gradients over
"points", and the background gradient needs no sum.  Each backward is the
forward of its dual, so the `xla` backend keeps its second derivative
through the sharded call.  `torch.distributed.nn.functional`'s
differentiable collectives are not used: their transposes treat each
process's loss as a separate summand (the backward of `all_reduce` is an
`all_reduce`), which would count every gradient here once per process of
the group.

Collectives: every sum is `torch.distributed.all_reduce` on the tensor's
own device, and a block is assembled as the `all_reduce` of the block
embedded in zeros.  Gloo takes CUDA tensors for `all_reduce` but not for
`all_gather`, so this one form runs on NCCL (one card per process) and on
Gloo (CPU tensors, or several processes on one card).  Gloo sums in host
memory: it copies a CUDA tensor out and back itself, ordered after the
work already queued on the tensor's current stream and before what is
queued next, which is also the stream the kernels are launched on.  An
axis of one process has no group and no collective: on the 1 x 1 mesh,
which needs no `torch.distributed` at all, the call runs exactly the
single-device operations.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dprast_torch import ad, api
from dprast_torch.ops import dispatch

POSES_AXIS = "poses"
POINTS_AXIS = "points"


class Mesh:
    """A ("poses", "points") process mesh: `shape` maps each axis to its
    number of shards, `coords` are this process's (poses, points)
    coordinates.  Ranks are laid out row-major: rank = i * n_points + j.
    `groups` maps an axis name to the process group this process
    reduces over along that axis: for "points" the ranks of its row i,
    for "poses" the ranks of its column j.  An axis of one shard has no
    group.  Without groups a mesh still slices (`shard_raster_args`); a
    collective on an axis of several shards then raises."""

    def __init__(self, n_poses_shards: int, n_points_shards: int,
                 rank: int = 0):
        n = n_poses_shards * n_points_shards
        if n_poses_shards < 1 or n_points_shards < 1 or not 0 <= rank < n:
            raise ValueError(
                f"mesh {n_poses_shards}x{n_points_shards} has no rank {rank}")
        self.shape = {POSES_AXIS: n_poses_shards,
                      POINTS_AXIS: n_points_shards}
        self.rank = rank
        self.coords = divmod(rank, n_points_shards)
        self.groups = {}

    def index(self, axis: str) -> int:
        """This process's coordinate along `axis`."""
        return self.coords[0 if axis == POSES_AXIS else 1]

    def group_ranks(self, axis: str, rank: int | None = None) -> list[int]:
        """The global ranks that `rank` (default: this process) reduces
        with along `axis`."""
        i, j = divmod(self.rank if rank is None else rank,
                      self.shape[POINTS_AXIS])
        if axis == POSES_AXIS:
            return [ii * self.shape[POINTS_AXIS] + j
                    for ii in range(self.shape[POSES_AXIS])]
        return [i * self.shape[POINTS_AXIS] + jj
                for jj in range(self.shape[POINTS_AXIS])]

    def all_reduce_(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum the contiguous tensor `x` in place, on its own device, over
        this process's group along `axis` -> `x`."""
        if axis not in self.groups:
            raise RuntimeError(
                f"this mesh has {self.shape[axis]} {axis!r} shards and no "
                f"process group for them; build it with make_mesh() after "
                f"torch.distributed is initialised")
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.groups[axis])
        return x

    def __repr__(self):
        return (f"Mesh(poses={self.shape[POSES_AXIS]}, "
                f"points={self.shape[POINTS_AXIS]}, coords={self.coords})")


def make_mesh(n_poses_shards: int | None = None,
              n_points_shards: int | None = None) -> Mesh:
    """A 2-axis process mesh ("poses", "points") over the default process
    group.

    Defaults: every process on the "poses" axis (pose batches are the
    embarrassingly parallel axis), one "points" shard.  Where
    `torch.distributed` is not initialised this is the 1 x 1 mesh, which
    has no group and no collective.  Otherwise the call is collective:
    every process must make it, with the same arguments, since every
    process takes part in creating every row's and every column's
    group."""
    initialised = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialised else 1
    if n_poses_shards is None and n_points_shards is None:
        n_poses_shards, n_points_shards = n, 1
    elif n_poses_shards is None:
        n_poses_shards = n // n_points_shards
    elif n_points_shards is None:
        n_points_shards = n // n_poses_shards
    if n_poses_shards * n_points_shards != n:
        raise ValueError(
            f"mesh {n_poses_shards}x{n_points_shards} != {n} processes")
    mesh = Mesh(n_poses_shards, n_points_shards,
                dist.get_rank() if initialised else 0)
    for axis in (POSES_AXIS, POINTS_AXIS):
        if mesh.shape[axis] == 1:
            continue
        # one group per column ("poses") or row ("points"), found from
        # its first member; `new_group` must be called by every process
        # for every group, in one order
        for first in range(n):
            ranks = mesh.group_ranks(axis, first)
            if ranks[0] != first:
                continue
            group = dist.new_group(ranks)
            if mesh.rank in ranks:
                mesh.groups[axis] = group
    return mesh


class _Vary(torch.autograd.Function):
    """Mark a block as used by every process of the `axis` group: the
    identity, whose cotangents (one per process, each from that process's
    partial result) sum over the group."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _PSum.apply(g, ctx.mesh, ctx.axis), None, None


class _PSum(torch.autograd.Function):
    """The sum over the `axis` group.  Every process of the group holds
    the same result and so the same cotangent, which is each summand's."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        # a copy: the summands are the caller's, and a cotangent may be
        # shared with other nodes of the graph
        return mesh.all_reduce_(
            x.clone(memory_format=torch.contiguous_format), axis)

    @staticmethod
    def backward(ctx, g):
        return _Vary.apply(g, ctx.mesh, ctx.axis), None, None


class _Slice(torch.autograd.Function):
    """This process's block, along dimension 0, of a tensor that is
    replicated over the `axis` group (its length a multiple of the
    group's size)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        size = x.shape[0] // mesh.shape[axis]
        return x.narrow(0, mesh.index(axis) * size, size).clone()

    @staticmethod
    def backward(ctx, g):
        return _Assemble.apply(g, ctx.mesh, ctx.axis), None, None


class _Assemble(torch.autograd.Function):
    """The blocks of the `axis` group's processes joined along dimension
    0 into one tensor that every process of the group holds: the sum over
    the group of each block embedded in zeros."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        size = x.shape[0]
        full = x.new_zeros((size * mesh.shape[axis],) + tuple(x.shape[1:]))
        full.narrow(0, mesh.index(axis) * size, size).copy_(x)
        return mesh.all_reduce_(full, axis)

    @staticmethod
    def backward(ctx, g):
        return _Slice.apply(g, ctx.mesh, ctx.axis), None, None


def _on_axis(fn, x, mesh, axis):
    """`fn` over `axis`, or `x` untouched where the axis has one shard."""
    return x if mesh.shape[axis] == 1 else fn.apply(x, mesh, axis)


def _pad_to_multiple(x, multiple):
    """`x` padded with zeros along dimension 0 to a multiple of
    `multiple`."""
    extra = -x.shape[0] % multiple
    if extra == 0:
        return x
    return torch.nn.functional.pad(x, (0, 0) * (x.ndim - 1) + (0, extra))


def shard_raster_args(mesh: Mesh, points, rotation, translation, background,
                      out_weight, point_weight):
    """Pad canonical batched args to shardable sizes and take this
    process's blocks, with the module-level layout.  Padded points get
    weight 0 (their splats are dropped by the zero weight, not by
    masking); padded poses get out_weight 0 and background 0 (all-zero
    images the caller slices away).  Differentiable: the gradient of each
    global argument is assembled over the axis it is sharded on.

    Returns (local 6-tuple, original n_points, original batch).
    """
    np_shards = mesh.shape[POINTS_AXIS]
    nb_shards = mesh.shape[POSES_AXIS]
    p = points.shape[0]
    b = rotation.shape[0]

    def block(x, axis, shards):
        return _on_axis(_Slice, _pad_to_multiple(x, shards), mesh, axis)

    local = (
        block(points, POINTS_AXIS, np_shards),
        # uneven pose batches: inert poses (out_weight 0: their splats
        # vanish; background 0: their images are all-zero), cut off the
        # output by the caller
        block(rotation, POSES_AXIS, nb_shards),
        block(translation, POSES_AXIS, nb_shards),
        block(background, POSES_AXIS, nb_shards),
        block(out_weight, POSES_AXIS, nb_shards),
        block(point_weight, POINTS_AXIS, np_shards),
    )
    return local, p, b


def _local_rows(grid_size, args, pw_uniform, backend, mesh):
    """This process's pose rows of the image, padding rows included ->
    ((B_padded / poses shards, *grid), original batch)."""
    n_out = len(grid_size)
    # The uniform-weight fast path survives sharding only when no
    # points-axis padding is needed: padding relies on weight-0 rows to
    # drop the padded points, so the weight plane becomes load-bearing.
    pw_fast = pw_uniform and args[0].shape[0] % mesh.shape[POINTS_AXIS] == 0
    # resolved on the global point count, so that every process picks one
    # backend
    resolved = dispatch.resolve_pair(
        backend, n_out, grid_size, args[0].shape[0],
        accelerator=args[0].device.type == "cuda",
        f64=args[0].dtype == torch.float64)
    (pts, rot, tr, bg, ow, pw), _, b = shard_raster_args(mesh, *args)
    # cross-axis operands: a points block is used by every pose block
    # and a pose block by every points block
    pts = _on_axis(_Vary, pts, mesh, POSES_AXIS)
    pw = _on_axis(_Vary, pw, mesh, POSES_AXIS)
    rot = _on_axis(_Vary, rot, mesh, POINTS_AXIS)
    tr = _on_axis(_Vary, tr, mesh, POINTS_AXIS)
    ow = _on_axis(_Vary, ow, mesh, POINTS_AXIS)
    partial = ad.raster_canonical(grid_size, resolved, pw_fast, pts, rot, tr,
                                  torch.zeros_like(bg), ow, pw)
    # partial images per points block, one reduction, the background once
    total = _on_axis(_PSum, partial, mesh, POINTS_AXIS)
    return total + bg.reshape((-1,) + (1,) * n_out), b


def _prepare(grid_size, points, rotation, translation, background,
             out_weight, point_weight, dtype, backend, device):
    """Normalise and validate a sharded call -> (grid, canonical args,
    pw_uniform, the image of an empty cloud or None)."""
    grid_size, args, batched, pw_uniform = api._normalise(
        grid_size, points, rotation, translation, background, out_weight,
        point_weight, dtype, device)
    if not batched:
        raise ValueError("raster_sharded requires batched poses")
    empty = None
    if args[0].shape[0] == 0:
        # empty cloud: the background image (backends chunk by points and
        # cannot run P = 0); the backend's name is still validated
        dispatch.resolve(backend, len(grid_size), grid_size, 0,
                         accelerator=args[0].device.type == "cuda",
                         f64=args[0].dtype == torch.float64)
        b = args[1].shape[0]
        empty = args[3].reshape((b,) + (1,) * len(grid_size)).expand(
            (b,) + grid_size).contiguous()
    return grid_size, args, pw_uniform, empty


def raster_sharded(grid_size, points, rotation, translation, background=None,
                   out_weight=None, point_weight=None, *, mesh: Mesh,
                   dtype=None, backend: str = "auto", device=None):
    """Differentiable multi-device rasterisation.

    Same semantics, arguments and device rules as
    :func:`dprast_torch.raster` on batched poses, run over `mesh` (axes
    "poses" and "points"): every process passes the same global
    arguments and gets the same (B, *grid_size) image, and under autograd
    the same full gradients of all six inputs.  A collective call: every
    process of the mesh must make it.
    """
    grid_size, args, pw_uniform, empty = _prepare(
        grid_size, points, rotation, translation, background, out_weight,
        point_weight, dtype, backend, device)
    if empty is not None:
        return empty
    rows, b = _local_rows(grid_size, args, pw_uniform, backend, mesh)
    out = _on_axis(_Assemble, rows, mesh, POSES_AXIS)
    return out if out.shape[0] == b else out[:b]


def raster_sharded_local(grid_size, points, rotation, translation,
                         background=None, out_weight=None, point_weight=None,
                         *, mesh: Mesh, dtype=None, backend: str = "auto",
                         device=None):
    """`raster_sharded` without the last gather, for a caller that keeps
    its loss sharded over poses: this process's pose rows of the image
    and their range -> ((stop - start, *grid_size), (start, stop)), the
    rows ``[start:stop]`` of what `raster_sharded` returns (none where
    the process holds padding poses only).  Every process of one "points"
    group holds the same rows.  If the loss is the sum over pose blocks
    of a term that each process computes from its own rows, a backward
    from that term alone gives every process the full gradients of the
    whole loss."""
    grid_size, args, pw_uniform, empty = _prepare(
        grid_size, points, rotation, translation, background, out_weight,
        point_weight, dtype, backend, device)
    b = args[1].shape[0]
    size = -(-b // mesh.shape[POSES_AXIS])
    start = min(mesh.index(POSES_AXIS) * size, b)
    stop = min(start + size, b)
    if empty is not None:
        return empty[start:stop], (start, stop)
    rows, _ = _local_rows(grid_size, args, pw_uniform, backend, mesh)
    return rows[:stop - start], (start, stop)
