"""Test fixtures and float64 oracles of dprast_torch, in numpy alone.

The port's own copy of what it needs of `dprast/utils/testing.py` (random
points / rotations / orthographic projections / translations / per-pose
backgrounds and weights / per-point weights, and the explicit-loop float64
oracles for the forward splat and its pullback), so that the package and
its smoke run take nothing from the JAX package; `tests/
test_torch_coords.py` holds the copies to the originals.  It adds the
edge set of the coordinate stage (`coords_edge_set`), which the CPU tests
and the smoke run on the card share.
"""

from __future__ import annotations

import numpy as np


def batch_size_coprime_to(n: int, minimum: int = 6) -> int:
    b = max(minimum, 2)
    while np.gcd(b, max(n, 1)) != 1:
        b += 1
    return b


def random_rotation(rng: np.random.Generator, n: int) -> np.ndarray:
    """Random proper rotation matrix via QR."""
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def fixtures(seed=0, n_points=10, batch_size=None, n_in=3, n_out=None,
             devices=8):
    """Random-but-deterministic argument set, as a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    if batch_size is None:
        batch_size = batch_size_coprime_to(devices)
    if n_out is None:
        n_out = n_in
    rotations = np.stack(
        [random_rotation(rng, n_in) for _ in range(batch_size)])
    if n_out < n_in:
        # orthographic projection: drop rows (P @ R with P = [I 0])
        rotations = rotations[:, :n_out, :]
    return dict(
        points=0.4 * rng.standard_normal((n_points, n_in)),
        rotation=rotations,
        translation=0.1 * rng.standard_normal((batch_size, n_out)),
        background=0.1 * rng.standard_normal(batch_size),
        out_weight=rng.uniform(0.1, 10.0, batch_size),
        point_weight=rng.uniform(0.1, 10.0, n_points),
    )


def raster_numpy(grid_size, points, rotation, translation, background,
                 out_weight, point_weight):
    """Independent float64 numpy oracle for the forward splat: explicit
    loops over the 2^N neighbours, sharing no code with the backends.

    Canonical batched args -> (B, *grid_size) float64.
    """
    points = np.asarray(points, np.float64)
    rotation = np.asarray(rotation, np.float64)
    translation = np.asarray(translation, np.float64)
    background = np.asarray(background, np.float64)
    out_weight = np.asarray(out_weight, np.float64)
    point_weight = np.asarray(point_weight, np.float64)
    b = rotation.shape[0]
    n_out = len(grid_size)
    out = np.empty((b,) + tuple(grid_size))
    sizes = np.asarray(grid_size)
    for ib in range(b):
        out[ib] = background[ib]
        q = points @ rotation[ib].T + translation[ib]        # (P, n_out)
        u = (q + 1.0) * (sizes / 2.0) - 0.5
        r0 = np.ceil(u) - 1
        dl = u - r0
        for s in range(2 ** n_out):
            shift = [(s >> i) & 1 for i in range(n_out)]
            idx = (r0 + shift).astype(np.int64)              # (P, n_out)
            wgt = out_weight[ib] * point_weight.copy()
            for i in range(n_out):
                wgt = wgt * np.where(shift[i], dl[:, i], 1 - dl[:, i])
            ok = np.all((idx >= 0) & (idx < sizes), axis=1)
            np.add.at(out[ib], tuple(idx[ok].T), wgt[ok])
    return out


def raster_pullback_numpy(grid_size, points, rotation, translation,
                          background, out_weight, point_weight, ds_dout):
    """Independent float64 numpy oracle for the analytic pullback.  Returns
    a dict with the six gradient arrays."""
    points = np.asarray(points, np.float64)
    rotation = np.asarray(rotation, np.float64)
    translation = np.asarray(translation, np.float64)
    out_weight = np.asarray(out_weight, np.float64)
    point_weight = np.asarray(point_weight, np.float64)
    g = np.asarray(ds_dout, np.float64)
    b = rotation.shape[0]
    p, n_in = points.shape
    n_out = len(grid_size)
    sizes = np.asarray(grid_size)
    d_points = np.zeros((p, n_in))
    d_rot = np.zeros_like(rotation)
    d_tr = np.zeros_like(translation)
    d_bg = g.reshape(b, -1).sum(axis=1)
    d_ow = np.zeros(b)
    d_pw = np.zeros(p)
    scale = sizes / 2.0
    for ib in range(b):
        q = points @ rotation[ib].T + translation[ib]
        u = (q + 1.0) * scale - 0.5
        r0 = np.ceil(u) - 1
        dl = u - r0
        ds_du = np.zeros((p, n_out))
        for s in range(2 ** n_out):
            shift = [(s >> i) & 1 for i in range(n_out)]
            idx = (r0 + shift).astype(np.int64)
            ok = np.all((idx >= 0) & (idx < sizes), axis=1)
            gv = np.zeros(p)
            gv[ok] = g[ib][tuple(idx[ok].T)]
            wsel = np.stack([np.where(shift[i], dl[:, i], 1 - dl[:, i])
                             for i in range(n_out)], axis=1)  # (P, n_out)
            w = wsel.prod(axis=1)
            d_ow[ib] += np.sum(gv * w * point_weight)
            d_pw += gv * w * out_weight[ib]
            for i in range(n_out):
                exact = np.prod(np.delete(wsel, i, axis=1), axis=1)
                sign = 1.0 if shift[i] else -1.0
                ds_du[:, i] += gv * sign * exact * out_weight[ib] \
                    * point_weight
        scaled = ds_du * scale                                # (P, n_out)
        d_tr[ib] = scaled.sum(axis=0)
        d_rot[ib] = scaled.T @ points
        d_points += scaled @ rotation[ib]
    return dict(points=d_points, rotation=d_rot, translation=d_tr,
                background=d_bg, out_weight=d_ow, point_weight=d_pw)


# ---------------------------------------------------------------------------
# the edge set of the coordinate stage
# ---------------------------------------------------------------------------

# the grids the coordinate stage is held to on its edge set: the two main
# 2-D grids, a multi-tile grid whose edges cut a tile, a one-column strip,
# a volume that is no multiple of its tiles, and the main volume
COORDS_EDGE_GRIDS = ((128, 128), (1024, 1024), (300, 200), (130, 1),
                     (16, 16, 130), (128, 128, 128))
# the poses of `coords_edge_set`, in order
COORDS_EDGE_POSES = ("identity", "small shift", "rotation", "tiny rotation",
                     "large shift", "far shift")


def _around(q, steps=(0, 1, 2, 3, 4, 8)):
    """The float32 values `steps` ulps below and above each of `q`."""
    q = np.asarray(q, np.float32)
    out = [q]
    lo, hi = q, q
    for k in range(1, max(steps) + 1):
        lo = np.nextafter(lo, np.float32(-np.inf))
        hi = np.nextafter(hi, np.float32(np.inf))
        if k in steps:
            out += [lo, hi]
    return np.concatenate(out)


def _axis_candidates(g, t):
    """float32 coordinates q on one output axis of `g` voxels and tile body
    `t` whose grid coordinate ``u = (q + 1) * g / 2 - 1 / 2`` sits on, or a
    few ulps beside, a voxel centre (``dl == 1``) or a cell boundary
    (``dl == 1/2``): at both edges of the grid, one voxel in and two voxels
    out on either side, at the first tile boundary, and at the grid's
    middle, where q is small and finer than u (the place where the
    compensation term alone moves a point across a centre)."""
    ks = {-2, -1, 0, 1, 2, t - 1, t, t + 1, g // 2 - 1, g // 2, g // 2 + 1,
          g - 3, g - 2, g - 1, g, g + 1}
    ks = np.array(sorted(ks), np.float64)
    centres = (ks + 0.5) * 2.0 / g - 1.0
    bounds = ks * 2.0 / g - 1.0
    return _around(np.concatenate([centres, bounds]))


def coords_edge_set(grid_size, n_in=3, seed=0):
    """Inputs that probe every branch of the coordinate stage
    (`dprast_torch.ops.splat_binned._keys_and_local`) on `grid_size` ->
    dict of float32 arrays ``points (P, n_in)``, ``rotation (B, n_out,
    n_in)``, ``translation (B, n_out)``, with the poses of
    `COORDS_EDGE_POSES`:

    - *identity*, ``[I 0]`` and no shift: the points' own coordinates are
      the candidates of `_axis_candidates`, one axis at a time beside
      random in-grid values on the others and all axes together, so voxel
      centres, cell boundaries and both sides of every grid edge and of a
      tile boundary are hit to the ulp; near the grid's middle the
      compensation term pushes ``dl`` above 1 and the fix-up's `shift_up`
      branch fires;
    - *small shift*: the same with translations of ~1e-3, which make the
      sums inexact;
    - *rotation*: a random rotation (projected where ``n_out < n_in``) and
      0.1-sigma translations, the generic case in which every compensation
      term is live;
    - *tiny rotation*: that rotation times 1e-20, every point within a
      hair of the translation;
    - *large shift*: translations of ~1e4, far outside the grid (``key ==
      nt``, planes 0) at coordinates that still fit an int32;
    - *far shift*: translations of ``2^25 / g`` per axis, grid coordinates
      just above 2^24, where consecutive floats are 2 apart and ``ceil(u) -
      1`` rounds back onto ``u``: the one place where ``dl <= 0`` and the
      fix-up's `shift_dn` branch fires.

    The cloud ends with 512 points of a 0.4-sigma Gaussian."""
    n_out = len(grid_size)
    rng = np.random.default_rng(seed)
    # the tile bodies of the binned backend: (127, 127) and (7, 15, 127)
    tiles = (127, 127) if n_out == 2 else (7, 15, 127)
    n_ctl = min(n_in, n_out)
    cands = [_axis_candidates(grid_size[i], tiles[i]) for i in range(n_ctl)]
    rows = []
    for i, cand in enumerate(cands):
        block = rng.uniform(-0.9, 0.9, (cand.size, n_in))
        block[:, i] = cand
        rows.append(block)
    most = max(c.size for c in cands)
    block = rng.uniform(-0.9, 0.9, (most, n_in))
    for i, cand in enumerate(cands):
        block[:, i] = np.resize(cand, most)
    rows.append(block)
    rows.append(0.4 * rng.standard_normal((512, n_in)))
    points = np.concatenate(rows).astype(np.float32)

    eye = np.eye(n_out, n_in)
    n = max(n_in, n_out)
    rot = random_rotation(rng, n)[:n_out, :n_in]
    sizes = np.asarray(grid_size, np.float64)
    rotation = np.stack([eye, eye, rot, rot * 1e-20, eye, eye])
    translation = np.stack([
        np.zeros(n_out),
        1e-3 * rng.standard_normal(n_out),
        0.1 * rng.standard_normal(n_out),
        0.1 * rng.standard_normal(n_out),
        1e4 * np.where(np.arange(n_out) % 2 == 0, 1.0, -1.0),
        2.0 ** 25 / sizes])
    return dict(points=points, rotation=rotation.astype(np.float32),
                translation=translation.astype(np.float32))
