"""Plain-torch scatter oracle (the ``"xla"`` backend), forward only
(PyTorch port of `dprast/ops/core.py`).

Works for any (N_in, N_out) with N_in >= N_out, on any device.  All
functions take canonical batched arguments:

    points       (P, N_in)
    rotation     (B, N_out, N_in)
    translation  (B, N_out)
    background   (B,)
    out_weight   (B,)
    point_weight (P,)
    out          (B, *grid_size)
"""

from __future__ import annotations

import math

import torch

from dprast_torch.ops import geometry


def _neighbour_data(points, rotation, translation, grid_size):
    """Neighbour indices, per-shift multilinear weights and deltas.

    Returns (idx_flat (B, P, S) int64 with out-of-grid neighbours mapped to
    ``total``, wsplat (B, P, S), dl (B, P, N_out), shifts (S, N_out))."""
    dev = points.device
    n_out = len(grid_size)
    shifts = torch.from_numpy(geometry.voxel_shifts(n_out)).to(dev)
    r0, dl = geometry.pose_voxel_and_deltas(points, rotation, translation,
                                            grid_size)
    idx = r0[..., None, :] + shifts                          # (B, P, S, N)
    sizes = torch.tensor(grid_size, dtype=torch.int32, device=dev)
    inb = torch.all((idx >= 0) & (idx < sizes), dim=-1)     # (B, P, S)
    strides = torch.from_numpy(geometry.flat_strides(grid_size)).to(dev)
    total = int(math.prod(grid_size))
    idx_flat = torch.sum(idx.long() * strides.long(), dim=-1)
    # out-of-grid -> one past the end: the scatter buffer's last slot
    # absorbs it (the reference's silent per-neighbour drop)
    idx_flat = torch.where(inb, idx_flat, total)
    wsplat = geometry.splat_weights(dl, shifts)             # (B, P, S)
    return idx_flat, wsplat, dl, shifts


def raster_fwd(grid_size, points, rotation, translation, background,
               out_weight, point_weight, *, pw_uniform: bool = False):
    """Forward rasterisation on canonical batched args -> (B, *grid_size):
    background per pose, every point splats ``out_weight[b] *
    point_weight[p]`` multilinearly onto its 2^N neighbours, out-of-grid
    neighbours dropped.  (`pw_uniform` is accepted for dispatch
    uniformity; the weight multiply is fused into the scatter operand.)"""
    del pw_uniform
    b = rotation.shape[0]
    total = int(math.prod(grid_size))
    idx_flat, wsplat, _, _ = _neighbour_data(points, rotation, translation,
                                             grid_size)
    w = wsplat * out_weight[:, None, None] * point_weight[None, :, None]
    # one flat buffer of B blocks of total + 1: block b's last slot is its
    # out-of-grid sink
    out = background[:, None].expand(b, total + 1).contiguous()
    base = torch.arange(b, device=points.device)[:, None, None] * (total + 1)
    out.view(-1).index_add_(0, (idx_flat + base).reshape(-1), w.reshape(-1))
    return out[:, :total].reshape((b,) + tuple(grid_size))
