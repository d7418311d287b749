"""Plain-torch scatter/gather oracle (the ``"xla"`` backend)
(PyTorch port of `dprast/ops/core.py`).

Works for any (N_in, N_out) with N_in >= N_out, on any device.  The
forward is a scatter-add in a fixed order (`_scatter_add`); the pullback
is a pure gather.  All functions take canonical batched arguments:

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
from typing import NamedTuple

import torch

from dprast_torch.ops import geometry


class PullbackResult(NamedTuple):
    """Gradients w.r.t. the six canonical inputs."""

    points: torch.Tensor        # (P, N_in)
    rotation: torch.Tensor      # (B, N_out, N_in)
    translation: torch.Tensor   # (B, N_out)
    background: torch.Tensor    # (B,)
    out_weight: torch.Tensor    # (B,)
    point_weight: torch.Tensor  # (P,)


def _neighbour_data(points, rotation, translation, grid_size):
    """Neighbour indices, per-shift multilinear weights and deltas.

    Returns (idx_flat (B, P, S) int64 with out-of-grid neighbours mapped to
    ``total``, wsplat (B, P, S), dl (B, P, N_out), shifts (S, N_out))."""
    dev = points.device
    n_out = len(grid_size)
    shifts = geometry.shift_table(n_out, dev)
    r0, dl = geometry.pose_voxel_and_deltas(points, rotation, translation,
                                            grid_size)
    idx = r0[..., None, :] + shifts                          # (B, P, S, N)
    sizes = geometry.axis_values(grid_size, torch.int32, dev)
    inb = torch.all((idx >= 0) & (idx < sizes), dim=-1)     # (B, P, S)
    strides = geometry.axis_values(
        [math.prod(grid_size[i + 1:]) for i in range(n_out)], torch.int64,
        dev)
    total = int(math.prod(grid_size))
    idx_flat = torch.sum(idx.long() * strides, dim=-1)
    # out-of-grid -> one past the end: the scatter buffer's last slot
    # absorbs it, and the gather reads the zero appended there (the
    # reference's silent per-neighbour drop)
    idx_flat = torch.where(inb, idx_flat, total)
    wsplat = geometry.splat_weights(dl, shifts)             # (B, P, S)
    return idx_flat, wsplat, dl, shifts


def _scatter_add(flat, idx, w):
    """``flat[idx[i]] += w[i]`` for every i, in place, each entry's terms
    added in the order of i, so that a call repeats bit for bit.  On the
    card `index_put_` with ``accumulate=True`` sorts by index (stably) and
    adds each entry's run of terms in turn, where `index_add_` adds them
    with float atomics in the order they land; on the CPU `index_add_` adds
    in the order of i, where `index_put_` adds from several threads at
    once."""
    if flat.device.type == "cuda":
        return flat.index_put_((idx,), w, accumulate=True)
    return flat.index_add_(0, idx, w)


def raster_fwd(grid_size, points, rotation, translation, background,
               out_weight, point_weight, *, pw_uniform: bool = False):
    """Forward rasterisation on canonical batched args -> (B, *grid_size):
    background per pose, every point splats ``out_weight[b] *
    point_weight[p]`` multilinearly onto its 2^N neighbours, out-of-grid
    neighbours dropped.  (`pw_uniform` is accepted for dispatch
    uniformity; the weight multiply is fused into the scatter operand.)"""
    del pw_uniform
    out, _ = raster_fwd_res(grid_size, points, rotation, translation,
                            background, out_weight, point_weight)
    return out


def raster_fwd_res(grid_size, points, rotation, translation, background,
                   out_weight, point_weight, *, pw_uniform: bool = False):
    """Forward + the neighbour-geometry residuals ``(idx_flat, wsplat,
    dl)`` of `_neighbour_data`, so that the pullback of the fused
    autograd pair skips the compensated transform and the neighbour
    enumeration."""
    del pw_uniform
    b = rotation.shape[0]
    total = int(math.prod(grid_size))
    idx_flat, wsplat, dl, _ = _neighbour_data(points, rotation, translation,
                                              grid_size)
    w = wsplat * out_weight[:, None, None] * point_weight[None, :, None]
    # one flat buffer of B blocks of total + 1: block b's last slot is its
    # out-of-grid sink
    out = background[:, None].expand(b, total + 1).contiguous()
    base = torch.arange(b, device=points.device)[:, None, None] * (total + 1)
    _scatter_add(out.view(-1), (idx_flat + base).reshape(-1), w.reshape(-1))
    return (out[:, :total].reshape((b,) + tuple(grid_size)),
            (idx_flat, wsplat, dl))


def raster_pullback_res(grid_size, residuals, args, ds_dout, *,
                        pw_uniform: bool = False) -> PullbackResult:
    """Pullback reusing the `raster_fwd_res` residuals."""
    del pw_uniform
    points, rotation, _, _, out_weight, point_weight = args
    idx_flat, wsplat, dl = residuals
    return _pullback_impl(grid_size, points, rotation, out_weight,
                          point_weight, ds_dout, idx_flat, wsplat, dl)


def raster_pullback(grid_size, points, rotation, translation, background,
                    out_weight, point_weight, ds_dout, *,
                    pw_uniform: bool = False) -> PullbackResult:
    """Analytic pullback on canonical batched args.

    A pure gather: recompute the forward's neighbour geometry, read the
    2^N cotangent values per (pose, point) and contract:

      ds/du_i  = sum_s g * ow * pw * dW_s/ddl_i
      scaled   = ds/du * (n/2)
      ds/dt    = sum_p scaled
      ds/dR    = sum_p scaled (x) p
      ds/dp    = sum_b R^T scaled
      ds/dbg   = sum_grid ds_dout
      ds/dow   = sum_{p,s} g * W_s * pw
      ds/dpw   = sum_{b,s} g * W_s * ow
    """
    del pw_uniform
    idx_flat, wsplat, dl, _ = _neighbour_data(points, rotation,
                                              translation, grid_size)
    return _pullback_impl(grid_size, points, rotation, out_weight,
                          point_weight, ds_dout, idx_flat, wsplat, dl)


def _pullback_impl(grid_size, points, rotation, out_weight, point_weight,
                   ds_dout, idx_flat, wsplat, dl) -> PullbackResult:
    shifts = geometry.shift_table(len(grid_size), points.device)
    b = rotation.shape[0]
    g_flat = ds_dout.reshape(b, -1)
    # a zero appended to each pose's cotangent: out-of-grid neighbours
    # (mapped to `total`) gather it
    g_pad = torch.cat([g_flat, g_flat.new_zeros((b, 1))], dim=1)
    g = torch.gather(g_pad, 1, idx_flat.reshape(b, -1)).reshape(
        idx_flat.shape)                                      # (B, P, S)

    gw = g * wsplat
    ds_dout_weight = torch.einsum("bps,p->b", gw, point_weight)
    ds_dpoint_weight = torch.einsum("bps,b->p", gw, out_weight)

    factor = g * (out_weight[:, None] * point_weight[None, :])[..., None]
    dw_ddl = geometry.splat_weight_grads(dl, shifts)        # (B, P, S, N)
    ds_du = torch.einsum("bps,bpsn->bpn", factor, dw_ddl)
    scale = geometry.axis_values([g / 2 for g in grid_size], ds_du.dtype,
                                 ds_du.device)
    scaled = ds_du * scale                                   # (B, P, N)

    return PullbackResult(
        points=torch.einsum("boi,bpo->pi", rotation, scaled),
        rotation=torch.einsum("bpo,pi->boi", scaled, points),
        translation=torch.sum(scaled, dim=1),
        background=torch.sum(g_flat, dim=-1),
        out_weight=ds_dout_weight,
        point_weight=ds_dpoint_weight,
    )
