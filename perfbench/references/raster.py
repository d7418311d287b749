"""Plain reference of `raster`, its pullback and one fit step, in torch.

The semantics are DiffPointRasterisation.jl's (v0.2.2, `src/raster.jl`,
`src/raster_pullback.jl`): a point p lands at q = R p + t; on an output
axis of g voxels its grid coordinate is u = (q + 1) g / 2 - 1/2; its
weight out_weight * point_weight goes to the 2^N voxels around u by
multilinear interpolation, and a voxel outside the grid is dropped.  The
output starts at the pose's background.  The weights are a `Weights`:
a background and an out_weight shared by the poses, and a point_weight
that is a number or one value a point (the configuration's `weights`,
made by the benchmark; the defaults are 0, 1 and 1).

Everything is computed in `dtype` (float64 by default) and sparsely: only
the voxels that the points touch are formed, so that a 1024^3 volume needs
no dense float64 copy, and the poses are taken a block at a time.  A
voxel's sum is formed by `index_put_(accumulate=True)`, which adds in a
fixed order.  This module imports torch alone: no kernel, no JAX, nothing
of the package under test.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# at most this many (pose, point, corner) terms in one block of poses
BLOCK_TERMS = 1 << 24


def corners(n_out: int) -> list[tuple[int, ...]]:
    """The 2^N corner shifts, bit i of the corner's number on axis i."""
    return [tuple((s >> i) & 1 for i in range(n_out))
            for s in range(2 ** n_out)]


def pose_blocks(n_poses: int, n_points: int, n_out: int):
    """(start, stop) of the blocks of poses the reference takes at once."""
    per = max(1, BLOCK_TERMS // max(1, n_points * 2 ** n_out))
    return [(b, min(b + per, n_poses)) for b in range(0, n_poses, per)]


class Weights(NamedTuple):
    background: float = 0.0
    out_weight: float = 1.0
    point_weight: float | torch.Tensor = 1.0   # a number, or (P,)


DEFAULT = Weights()


def factors(weights, n_poses, n_points, dtype, device):
    """out_weight (B,) and point_weight (P,) in `dtype`."""
    ow = torch.full((n_poses,), float(weights.out_weight), dtype=dtype,
                    device=device)
    pw = weights.point_weight
    if isinstance(pw, torch.Tensor):
        pw = pw.to(device=device, dtype=dtype)
    else:
        pw = torch.full((n_points,), float(pw), dtype=dtype, device=device)
    return ow, pw


class Terms(NamedTuple):
    flat: torch.Tensor   # (C, B, P) int64: b * V + voxel, -1 outside
    wsel: torch.Tensor   # (C, B, P, N) the corner's factor on each axis
    ok: torch.Tensor     # (C, B, P) bool: the corner lies in the grid


def terms(grid, points, rot, tr, dtype=torch.float64) -> Terms:
    """Every (corner, pose, point) term of a block of poses."""
    n_out = len(grid)
    sizes = torch.tensor(grid, dtype=dtype, device=points.device)
    q = torch.einsum("pi,boi->bpo", points.to(dtype), rot.to(dtype)) \
        + tr.to(dtype)[:, None, :]
    u = (q + 1) * (sizes / 2) - 0.5
    r0f = torch.ceil(u) - 1
    dl = u - r0f
    r0 = r0f.to(torch.int64)
    sizes_i = torch.tensor(grid, dtype=torch.int64, device=points.device)
    strides = torch.tensor([math.prod(grid[i + 1:]) for i in range(n_out)],
                           dtype=torch.int64, device=points.device)
    base = torch.arange(rot.shape[0], device=points.device) \
        * math.prod(grid)
    flats, wsels, oks = [], [], []
    for shift in corners(n_out):
        sh = torch.tensor(shift, dtype=torch.int64, device=points.device)
        idx = r0 + sh
        ok = ((idx >= 0) & (idx < sizes_i)).all(-1)
        flat = (idx * strides).sum(-1) + base[:, None]
        flats.append(torch.where(ok, flat, -1))
        oks.append(ok)
        pick = sh.to(torch.bool)
        wsels.append(torch.where(pick, dl, 1 - dl))
    return Terms(torch.stack(flats), torch.stack(wsels), torch.stack(oks))


class Splat(NamedTuple):
    idx: torch.Tensor    # (K,) the block's touched flat voxels, sorted
    val: torch.Tensor    # (K,) the sum of the weights there (no background)
    inv: torch.Tensor    # (number of in-grid terms,) each term's voxel in idx
    t: Terms
    w: torch.Tensor      # (C, B, P) each term's weight


def splat(grid, points, rot, tr, out_weight, point_weight,
          dtype=torch.float64) -> Splat:
    """The forward of a block of poses, sparsely."""
    t = terms(grid, points, rot, tr, dtype)
    w = t.wsel.prod(-1) * out_weight.to(dtype)[None, :, None] \
        * point_weight.to(dtype)[None, None, :]
    idx, inv = torch.unique(t.flat[t.ok], return_inverse=True)
    val = torch.zeros(idx.numel(), dtype=dtype, device=points.device)
    val.index_put_((inv,), w[t.ok], accumulate=True)
    return Splat(idx, val, inv, t, w)


def pullback(grid, points, rot, t: Terms, g_terms, out_weight, point_weight,
             dtype=torch.float64):
    """Gradients of points (P, n_in), rotation (B, N, n_in), translation
    (B, N) and point_weight (P,) of a block of poses, from the cotangent at each term's voxel
    (`g_terms`, (C, B, P), 0 outside the grid)."""
    n_out = len(grid)
    sizes = torch.tensor(grid, dtype=dtype, device=points.device)
    ds_du = torch.zeros(t.wsel.shape[1:], dtype=dtype, device=points.device)
    for c, shift in enumerate(corners(n_out)):
        for i in range(n_out):
            others = torch.ones_like(g_terms[c])
            for j in range(n_out):
                if j != i:
                    others = others * t.wsel[c, ..., j]
            sign = 1.0 if shift[i] else -1.0
            ds_du[..., i] += sign * g_terms[c] * others
    ds_du = ds_du * out_weight.to(dtype)[:, None, None] \
        * point_weight.to(dtype)[None, :, None]
    scaled = ds_du * (sizes / 2)
    p, r = points.to(dtype), rot.to(dtype)
    d_pw = (g_terms * t.wsel.prod(-1)
            * out_weight.to(dtype)[None, :, None]).sum((0, 1))
    return (torch.einsum("bpo,boi->pi", scaled, r),
            torch.einsum("bpo,pi->boi", scaled, p),
            scaled.sum(1), d_pw)


def render(grid, points, rot, tr, out, dtype=torch.float64,
           weights=DEFAULT):
    """Write the images or volumes of every pose into `out` ((B, *grid),
    any float dtype)."""
    ow, pw = factors(weights, rot.shape[0], points.shape[0], dtype,
                      points.device)
    bg = float(weights.background)
    flat_out = out.view(out.shape[0], -1)
    for b0, b1 in pose_blocks(rot.shape[0], points.shape[0], len(grid)):
        s = splat(grid, points, rot[b0:b1], tr[b0:b1], ow[b0:b1], pw, dtype)
        block = flat_out[b0:b1].reshape(-1)
        block.fill_(bg)
        block[s.idx] = (s.val + bg).to(out.dtype)
        del s
    return out


def forward_error(grid, out, points, rot, tr, dtype=torch.float64,
                  chunk=1 << 26, weights=DEFAULT) -> float:
    """max |out - reference| / max(max |reference|, 1) over every voxel of
    `out` ((B, *grid)): at the voxels the points touch against the
    background plus the reference's sums, elsewhere against the
    background."""
    ow, pw = factors(weights, rot.shape[0], points.shape[0], dtype,
                      points.device)
    bg = float(weights.background)
    dev = points.device
    worst = torch.zeros((), dtype=dtype, device=dev)
    ref_max = torch.full((), max(1.0, abs(bg)), dtype=dtype, device=dev)
    flat_out = out.reshape(out.shape[0], -1)
    for b0, b1 in pose_blocks(rot.shape[0], points.shape[0], len(grid)):
        s = splat(grid, points, rot[b0:b1], tr[b0:b1], ow[b0:b1], pw, dtype)
        block = flat_out[b0:b1].reshape(-1)
        if s.idx.numel():
            worst = torch.maximum(
                worst, (block[s.idx].to(dtype) - bg - s.val).abs().max())
            ref_max = torch.maximum(ref_max, (s.val + bg).abs().max())
        bounds = torch.arange(0, block.numel() + chunk, chunk, device=dev)
        cuts = torch.searchsorted(s.idx, bounds.clamp(max=block.numel()))
        cuts = cuts.tolist()
        for k, c0 in enumerate(range(0, block.numel(), chunk)):
            d = (block[c0:c0 + chunk].to(dtype) - bg).abs()
            d[s.idx[cuts[k]:cuts[k + 1]] - c0] = 0
            worst = torch.maximum(worst, d.max())
        del s
    return float(worst / ref_max)


class FitStep(NamedTuple):
    loss: float
    d_points: torch.Tensor
    d_rotation: torch.Tensor
    d_translation: torch.Tensor
    d_point_weight: torch.Tensor


def fit_step(grid, points, rot, tr, target, dtype=torch.float64,
             weights=DEFAULT) -> FitStep:
    """One step of the fit's loss, mean((raster(points) - target)^2) over
    the batch's (B, *grid) elements, and its gradients with respect to the
    points, the rotations, the translations and the point weights."""
    ow, pw = factors(weights, rot.shape[0], points.shape[0], dtype,
                      points.device)
    bg = float(weights.background)
    n_out = len(grid)
    b = rot.shape[0]
    v = math.prod(grid)
    n = b * v
    dev = points.device
    flat_t = target.reshape(b, -1)
    # the loss as if no point landed: the sum of (background - target)^2
    # over every voxel
    total = torch.zeros((), dtype=dtype, device=dev)
    for i in range(b):
        for c0 in range(0, v, 1 << 26):
            total = total + ((bg - flat_t[i, c0:c0 + (1 << 26)].to(dtype))
                             ** 2).sum()
    d_points = torch.zeros(points.shape, dtype=dtype, device=dev)
    d_pw = torch.zeros(points.shape[0], dtype=dtype, device=dev)
    d_rot = torch.zeros(rot.shape, dtype=dtype, device=dev)
    d_tr = torch.zeros(tr.shape, dtype=dtype, device=dev)
    for b0, b1 in pose_blocks(b, points.shape[0], n_out):
        s = splat(grid, points, rot[b0:b1], tr[b0:b1], ow[b0:b1], pw, dtype)
        t_v = bg - flat_t[b0:b1].reshape(-1)[s.idx].to(dtype)
        total = total + ((s.val + t_v) ** 2 - t_v ** 2).sum()
        g_v = 2 * (s.val + t_v) / n
        g_terms = torch.zeros_like(s.w)
        g_terms[s.t.ok] = g_v[s.inv]
        dp, dr, dt, dw = pullback(grid, points, rot[b0:b1], s.t, g_terms,
                                  ow[b0:b1], pw, dtype)
        d_points += dp
        d_pw += dw
        d_rot[b0:b1] = dr
        d_tr[b0:b1] = dt
        del s, g_terms
    return FitStep(float(total / n), d_points, d_rot, d_tr, d_pw)
