"""Shared splat geometry: pose transform, reference-voxel/delta computation,
and the 2^N neighbour-shift enumeration (PyTorch port of
`dprast/ops/geometry.py`).

Semantics match the reference exactly, in 0-based indexing: an axis of
``n`` voxels discretises (-1, 1), voxel ``j`` has its centre at

    u = (q + 1) * (n / 2) - 1/2,        q = R @ p + t,

the reference voxel is ``r0 = ceil(u) - 1`` and ``dl = u - r0`` lies in
``(0, 1]``.  A point splats onto ``r0 + s`` for each shift ``s in {0,1}^N``
with weight ``prod_i(s_i ? dl_i : 1 - dl_i)``; out-of-grid neighbours are
dropped.

Every function runs in eager torch on the device of its inputs.  The
compensated (double-f32) pipeline relies on each ``+``, ``-`` and ``*``
being rounded on its own: eager torch runs every operator as its own
kernel, so nothing is contracted into an FMA.  Do not put these functions
under ``torch.compile``.
"""

from __future__ import annotations

import numpy as np
import torch


def voxel_shifts(n_out: int) -> np.ndarray:
    """All 2^N neighbour shifts, LSB-first bit order:
    ``shifts[k, i] = (k >> i) & 1``, int32 of shape (2**n_out, n_out)."""
    k = np.arange(2**n_out, dtype=np.int32)
    i = np.arange(n_out, dtype=np.int32)
    return ((k[:, None] >> i[None, :]) & 1).astype(np.int32)


def transform_points(points: torch.Tensor, rotation: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """``q = R @ p + t``: points (P, N_in), rotation (B, N_out, N_in),
    translation (B, N_out) -> (B, P, N_out).

    Written as a sum of N_in broadcast products rather than a matmul so it
    never reaches a TF32 tensor-core path on the card."""
    q = rotation[:, None, :, 0] * points[None, :, None, 0]
    for j in range(1, points.shape[1]):
        q = q + rotation[:, None, :, j] * points[None, :, None, j]
    return q + translation[:, None, :]


def grid_coords(q: torch.Tensor, grid_size: tuple[int, ...]) -> torch.Tensor:
    """Fractional 0-based grid coordinates ``u = (q + 1) * n/2 - 1/2``."""
    scale = torch.tensor(grid_size, dtype=q.dtype, device=q.device) / 2
    return (q + 1) * scale - 0.5


def reference_voxel_and_deltas(q: torch.Tensor, grid_size: tuple[int, ...]):
    """``(r0, dl)`` with ``r0 = ceil(u) - 1`` (int32) and ``dl = u - r0`` in
    (0, 1]: a point on a voxel centre gets ``dl == 1``."""
    u = grid_coords(q, grid_size)
    r0f = torch.ceil(u) - 1
    dl = u - r0f
    return r0f.to(torch.int32), dl


def splat_weights(dl: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """dl (..., N_out), shifts (S, N_out) -> (..., S) multilinear weights
    ``w[..., k] = prod_i (shifts[k,i] ? dl_i : 1 - dl_i)``."""
    sel = torch.where(shifts.to(torch.bool), dl[..., None, :],
                      1 - dl[..., None, :])
    return torch.prod(sel, dim=-1)


# ---------------------------------------------------------------------------
# Compensated (double-float32) coordinate pipeline.  A plain f32 transform
# has absolute coordinate error ~n/2 * 2^-23 (3e-5 at n=1024), above the
# 1e-5 parity target by itself; these helpers carry an (hi, lo) pair through
# q = R@p + t and u = (q+1)*n/2 - 1/2 so `dl` is accurate to ~2^-23.
# ---------------------------------------------------------------------------


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (s = fl(a+b))."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _split_f32(a):
    """Veltkamp split of an f32 into 12+12-bit halves."""
    c = a * 4097.0  # 2^12 + 1
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Dekker TwoProd: p + e == a * b exactly (p = fl(a*b))."""
    p = a * b
    ah, al = _split_f32(a)
    bh, bl = _split_f32(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def grid_coords_2f(points: torch.Tensor, rotation: torch.Tensor,
                   translation: torch.Tensor, grid_size: tuple[int, ...]):
    """Double-f32 fractional grid coordinates of transformed points.

    points (P, N_in), rotation (B, N_out, N_in), translation (B, N_out)
    -> (u_hi, u_lo), each (B, P, N_out) f32, with
    ``u_hi + u_lo ~= (R@p + t + 1) * n/2 - 1/2`` to ~2^-46 relative."""
    f32 = torch.float32
    pts = points.to(f32)
    rot = rotation.to(f32)
    tr = translation.to(f32)
    b, n_out, n_in = rot.shape
    p = pts.shape[0]
    hi = tr[:, None, :].expand(b, p, n_out)
    lo = torch.zeros((b, p, n_out), dtype=f32, device=pts.device)
    for j in range(n_in):
        pr, pe = _two_prod(rot[:, None, :, j], pts[None, :, None, j])
        hi, e = _two_sum(hi, pr)
        lo = lo + (pe + e)
    # u = (q + 1) * scale - 1/2   (scale = n/2 is exact in f32)
    hi, e = _two_sum(hi, 1.0)
    lo = lo + e
    scale = torch.tensor(grid_size, dtype=f32, device=pts.device) / 2
    hi, e = _two_prod(hi, scale)
    lo = lo * scale + e
    hi, e = _two_sum(hi, -0.5)
    lo = lo + e
    hi, e = _two_sum(hi, lo)  # renormalise
    return hi, e


def reference_voxel_and_deltas_2f(u_hi: torch.Tensor, u_lo: torch.Tensor):
    """(r0, dl) from a double-f32 coordinate, keeping ``dl in (0, 1]``: the
    `u_lo` correction can push `dl` across a voxel boundary, and one fix-up
    step restores the invariant."""
    r0f = torch.ceil(u_hi) - 1
    dl = (u_hi - r0f) + u_lo  # u_hi - r0f is exact (both near integers)
    shift_up = dl > 1.0
    shift_dn = dl <= 0.0
    r0f = r0f + shift_up.to(r0f.dtype) - shift_dn.to(r0f.dtype)
    dl = torch.where(shift_up, dl - 1.0, torch.where(shift_dn, dl + 1.0, dl))
    return r0f.to(torch.int32), dl


def pose_voxel_and_deltas(points: torch.Tensor, rotation: torch.Tensor,
                          translation: torch.Tensor,
                          grid_size: tuple[int, ...]):
    """(r0, dl) for the full pose pipeline at double-f32 accuracy; f64
    inputs are already beyond the target accuracy and keep f64."""
    if torch.float64 in (points.dtype, rotation.dtype, translation.dtype):
        q = transform_points(points, rotation, translation)
        return reference_voxel_and_deltas(q, grid_size)
    u_hi, u_lo = grid_coords_2f(points, rotation, translation, grid_size)
    return reference_voxel_and_deltas_2f(u_hi, u_lo)


def flat_strides(grid_size: tuple[int, ...]) -> np.ndarray:
    """Row-major strides for flattening an N-d grid index."""
    return np.array(
        [int(np.prod(grid_size[i + 1:], dtype=np.int64))
         for i in range(len(grid_size))],
        dtype=np.int32,
    )
