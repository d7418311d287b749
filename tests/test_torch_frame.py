"""The frame of dprast_torch's binned backend as its main path on the card
writes and reads it, against the JAX package on the same float32 numpy
inputs.

On the card B6 writes a single tile's frame itself (`direct_frame`), one
gather kernel writes a multi-tile frame after the sort (`frame_gather`),
and B1 and B4 read the frame's encoded planes and decode each row
themselves (`fwd_splat_enc`, `bwd_gather_enc`).  On the CPU each of these
runs its plain version: `_prep_direct`, the sort's gather, and
`_planes_fwd` / `_planes_bwd` followed by the lane twins.  Here those
plain versions are held to the JAX package:
- the frames to `_prep_direct` / `_prep_binned`, int32 views bit for bit,
  on the packed and the stable (payload) id path;
- B1 on the frame to JAX's `_planes_fwd` + `_fwd_kernel` through the
  Pallas interpreter within 1e-5 scaled (the order of fp32 sums);
- B4 on the frame to JAX's `_planes_bwd` + `_bwd_kernel` within 1e-6
  scaled, at terms=0 against JAX's three-term split (which represents
  every fp32 window value) and at terms=1 against its terms=1: not bit for
  bit, since the interpreter's one-hot products and combinations round
  apart from the twin's direct reads (`tests/test_torch_bf16.py` measures
  the same), while B4 on the frame is its lane twin's bits exactly;
- the decode on hand-made rows at its edges (enc 0, a zero fraction, the
  first and last voxel of a window, 3-D flat rows that leave it).

`chip_smoke.py`'s [B7 frame] phase holds the CUDA writers and instances
to these plain versions on the card.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from dprast.ops import splat_binned as jbin  # noqa: E402
from dprast.utils.testing import fixtures  # noqa: E402
from dprast_torch.ops import splat_binned as tbin  # noqa: E402

torch.set_num_threads(2)

# a single tile, a multi-tile grid whose edges cut tiles, a small volume
GRIDS = [(40, 56), (300, 200), (8, 16, 200)]
IDS = ["x".join(map(str, g)) for g in GRIDS]
# B1 on the frame against JAX's kernel (scaled max-abs): the same rounded
# products, summed in another order
B1_TOL = 1e-5
# B4 against JAX's kernel: the interpreter's one-hot products and
# combinations round apart from the twin's direct reads (3.6e-7 absolute
# at terms=0 on the single tile)
B4_TOL = 1e-6
# the JAX kernels' bf16 split that represents every fp32 value, for terms=0
EXACT_SPLIT = 3


def _scaled_err(out, ref):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(out.astype(np.float64) - ref))
                 / max(float(np.max(np.abs(ref))), 1.0))


def _bits(t):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _cloud(grid, seed=7):
    """float32 points, rotations, translations and point weights: 3 poses x
    300 points in 2-D, 2 x 200 in 3-D."""
    n_out = len(grid)
    fx = fixtures(seed=seed, n_points=300 if n_out == 2 else 200,
                  batch_size=3 if n_out == 2 else 2, n_in=3, n_out=n_out)
    arrays = [np.asarray(v, np.float32) for v in fx.values()]
    return arrays[0], arrays[1], arrays[2], arrays[5]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _window_rows(grid, ts, halo):
    """The rows and columns of a JAX window at `grid`."""
    if len(grid) == 2:
        return ts[0] + halo, ts[1] + halo
    return (ts[0] + 1) * (ts[1] + 1), ts[2] + 1


def _jax_splat(slot_tile, lane, grid, chunk, with_w, terms):
    """JAX's B1, `_fwd_kernel` through the interpreter, on the lane planes
    `lane` (B, L, s_pad) of a frame whose every tile holds a slot."""
    ts = jbin.tile_shape_for(grid)
    halo = not jbin._single_tile(grid)
    rows_e, cols_e = _window_rows(grid, ts, halo)
    bsz, n_lane, s_pad = lane.shape
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(bsz, s_pad // chunk),
        in_specs=[pl.BlockSpec((1, n_lane, chunk),
                               lambda b, s, st: (b, 0, s),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 1, rows_e, cols_e),
                               lambda b, s, st: (b, st[b, s], 0, 0),
                               memory_space=pltpu.VMEM))
    return np.asarray(pl.pallas_call(
        functools.partial(jbin._fwd_kernel, ts=ts, chunk=chunk, halo=halo,
                          n_out=len(grid), with_w=with_w, skip_dead=False,
                          terms=terms),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct(
            (bsz, jbin.n_tiles(grid, ts), rows_e, cols_e), jnp.float32),
        interpret=True)(jnp.asarray(slot_tile.numpy()), lane))


def _jax_gather(slot_tile, lane_b, grid, g, chunk, terms):
    """JAX's B4, `_bwd_kernel` through the interpreter, on the lane planes
    `lane_b` with the cotangent `g` cut into transposed windows as JAX's
    pullback feeds it -> raw rows (B, n_out + 1, s_pad)."""
    ts = jbin.tile_shape_for(grid)
    n_out = len(grid)
    halo = not jbin._single_tile(grid)
    bsz, n_lane, s_pad = lane_b.shape
    g = jnp.asarray(g)
    if halo:
        g_in = jbin._unfold(g, grid, ts, transposed=True)
        g_spec = pl.BlockSpec((1, 1) + g_in.shape[2:],
                              lambda b, s, st: (b, st[b, s], 0, 0),
                              memory_space=pltpu.VMEM)
    else:
        g_in = jnp.swapaxes(g, 1, 2)
        g_spec = pl.BlockSpec((1, ts[1], ts[0]), lambda b, s, st: (b, 0, 0),
                              memory_space=pltpu.VMEM)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(bsz, s_pad // chunk),
        in_specs=[pl.BlockSpec((1, n_lane, chunk),
                               lambda b, s, st: (b, 0, s),
                               memory_space=pltpu.VMEM), g_spec],
        out_specs=pl.BlockSpec((1, n_out + 1, chunk),
                               lambda b, s, st: (b, 0, s),
                               memory_space=pltpu.VMEM))
    return np.asarray(pl.pallas_call(
        functools.partial(jbin._bwd_kernel, ts=ts, chunk=chunk, halo=halo,
                          n_out=n_out, skip_dead=False, terms=terms),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((bsz, n_out + 1, s_pad), jnp.float32),
        interpret=True)(jnp.asarray(slot_tile.numpy()), lane_b, g_in))


def _gather_source(grid, g):
    """What the main path hands B4 with the cotangent `g`: the cotangent
    itself on a single tile and, as its grid source, on several 2-D tiles;
    the unfolded windows in 3-D -> (window source, layout)."""
    ts = tbin.tile_shape_for(grid)
    if len(grid) == 3:
        return tbin._unfold(g, grid, ts), "natural"
    if tbin._single_tile(grid):
        return g, "natural"
    return g, "grid"


def _check_b1(slot_tile, data, grid, chunk, terms):
    """B1 on the frame `data` (the CPU's plain version of `fwd_splat_enc`)
    against JAX's `_planes_fwd` + `_fwd_kernel` on the same frame."""
    n_out = len(grid)
    nt = tbin.n_tiles(grid)
    with_w = data.shape[1] == n_out + 2
    ext = tbin.fwd_splat_enc(slot_tile, data, nt, tbin._window(grid), chunk,
                             terms=terms)
    coord = jnp.asarray(data[:, :n_out].numpy())
    w = jnp.asarray(data[:, n_out].numpy()) if with_w else None
    lane = jbin._planes_fwd(coord, w, jbin.tile_shape_for(grid), n_out)
    ref = _jax_splat(slot_tile, lane, grid, chunk, with_w,
                     EXACT_SPLIT if terms == 0 else terms)
    assert ext.shape == ref.shape
    err = _scaled_err(ext, ref)
    assert err < B1_TOL, f"B1 on the frame vs JAX, terms={terms}: {err:.3e}"
    # the wrapper's plain version is the lane twin on `_planes_fwd`
    lane_t = tbin._planes_fwd(data[:, :n_out],
                              data[:, n_out] if with_w else None)
    assert torch.equal(ext, tbin._fwd_splat_plain(
        slot_tile, lane_t, nt, tbin._window(grid), chunk, terms))


def _check_b4(slot_tile, coord, grid, g, chunk, terms):
    """B4 on the frame's encoded planes `coord` (the CPU's plain version of
    `bwd_gather_enc`) against JAX's `_planes_bwd` + `_bwd_kernel` on the
    same frame and cotangent `g`."""
    ts = tbin.tile_shape_for(grid)
    src, layout = _gather_source(grid, torch.from_numpy(g))
    rows = tbin.bwd_gather_enc(slot_tile, coord, ts, src, chunk, terms=terms,
                               layout=layout)
    lane_b = jbin._planes_bwd(jnp.asarray(coord.numpy()), ts, len(grid))
    ref = _jax_gather(slot_tile, lane_b, grid, g, chunk,
                      EXACT_SPLIT if terms == 0 else terms)
    assert rows.shape == ref.shape
    err = _scaled_err(rows, ref)
    assert err < B4_TOL, f"B4 terms={terms} vs JAX rows: {err:.3e}"
    assert torch.equal(rows, tbin._bwd_gather_plain(
        slot_tile, tbin._planes_bwd(coord, ts), src, chunk, terms, layout))


# ---------------------------------------------------------------------------
# the frame writers
# ---------------------------------------------------------------------------


def _jax_planes(locs, weight, p):
    """JAX's frame planes and fills as its `_fwd_impl` makes them."""
    planes = list(locs)
    fills = [0.0] * len(locs)
    shape = locs[0].shape
    if weight is not None:
        planes.append(jnp.broadcast_to(jnp.asarray(weight)[None, :], shape))
        fills.append(0.0)
    planes.append(jnp.broadcast_to(jnp.arange(p, dtype=jnp.float32)[None, :],
                                   shape))
    fills.append(float(p))
    return planes, fills


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("grid", [(40, 56), (128, 128)])
def test_single_tile_frame_matches_jax_prep_direct(grid, weighted):
    """`direct_frame` (B6's single-tile frame; plain: `_prep_direct` of the
    twin's planes) gives JAX's `_prep_direct` frame and slot table bit for
    bit, and is the frame the CPU's forward builds."""
    pts, rot, tr, pw = _cloud(grid)
    ts = tbin.tile_shape_for(grid)
    p = pts.shape[0]
    chunk = tbin._default_chunk(grid, p)
    weight = torch.from_numpy(pw) if weighted else None
    data, slot_tile = tbin.direct_frame(grid, ts, *_torch(pts, rot, tr),
                                        weight, chunk)
    assert data.shape == (rot.shape[0], len(grid) + 1 + weighted,
                          -(-p // chunk) * chunk)
    _, j_locs, _ = jbin._keys_and_local(grid, ts, *map(jnp.asarray,
                                                       (pts, rot, tr)))
    planes, fills = _jax_planes(j_locs, pw if weighted else None, p)
    for b in range(rot.shape[0]):
        j_data, j_st = jbin._prep_direct([pl_[b] for pl_ in planes], fills,
                                         chunk)
        np.testing.assert_array_equal(_bits(data[b]), _bits(j_data))
        np.testing.assert_array_equal(slot_tile[b].numpy(), np.asarray(j_st))
    fwd = tbin._fwd_prep(grid, *_torch(pts, rot, tr, pw), not weighted)
    assert torch.equal(fwd[0].view(torch.int32), data.view(torch.int32))
    assert torch.equal(fwd[1], slot_tile)


BINNED = [(grid, pack_idx, weighted, min_chunk)
          for grid in ((300, 200), (8, 16, 200))
          for pack_idx in (True, False)
          for weighted in (False, True)
          for min_chunk in (True, False)
          if min_chunk or not weighted]


@pytest.mark.parametrize(
    "grid,pack_idx,weighted,min_chunk", BINNED,
    ids=[f"{'x'.join(map(str, g))}-{'packed' if k else 'payload'}-"
         f"{'weighted' if w else 'uniform'}-"
         f"{'forward' if m else 'standalone'}" for g, k, w, m in BINNED])
def test_binned_frame_matches_jax_prep_binned(grid, pack_idx, weighted,
                                              min_chunk):
    """The binning sort (`_slot_order`) and the frame gather after it
    (`frame_gather`; plain on the CPU) give JAX's `_prep_binned` frame and
    slot table bit for bit: with the point id packed into the sort key and
    as the payload of a stable sort, with and without a weight plane, for
    the forward's frame and the standalone pullback's."""
    pts, rot, tr, pw = _cloud(grid)
    ts = tbin.tile_shape_for(grid)
    p = pts.shape[0]
    chunk = tbin._default_chunk(grid, p)
    key, locs, nt = tbin._keys_and_local(grid, ts, *_torch(pts, rot, tr))
    weight = torch.from_numpy(pw) if weighted else None
    perm, sorted_keys, slot_tile = tbin._slot_order(key, nt, chunk,
                                                    min_chunk, pack_idx)
    assert (sorted_keys is not None) == pack_idx
    data = tbin.frame_gather(perm, locs, weight)
    assert data.shape == (rot.shape[0], len(grid) + 1 + weighted,
                          perm.shape[1])
    planes, fills = _jax_planes([jnp.asarray(x.numpy()) for x in locs],
                                pw if weighted else None, p)
    for b in range(rot.shape[0]):
        j_data, j_st = jbin._prep_binned(
            jnp.asarray(key[b].numpy()), [pl_[b] for pl_ in planes], fills,
            nt, chunk, min_chunk, pack_idx=pack_idx)
        np.testing.assert_array_equal(_bits(data[b]), _bits(j_data))
        np.testing.assert_array_equal(slot_tile[b].numpy(), np.asarray(j_st))
    # the port's own plain writer, which the CPU's frame runs
    t_data, t_st = tbin._prep_binned(key, *tbin._frame_planes(locs, weight),
                                     nt, chunk, min_chunk, pack_idx=pack_idx)
    assert torch.equal(t_data.view(torch.int32), data.view(torch.int32))
    assert torch.equal(t_st, slot_tile)


@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_card_frame_composition_is_the_cpu_frame(grid):
    """The frame the card's path writes, composed of its plain versions
    (B6's planes, then `direct_frame` or `_slot_order` + `frame_gather`),
    is the frame `_fwd_prep` and `_bwd_frame` build on the CPU, bit for
    bit, with and without a weight plane."""
    pts, rot, tr, pw = _torch(*_cloud(grid))
    ts = tbin.tile_shape_for(grid)
    chunk = tbin._default_chunk(grid, pts.shape[0])
    for weight, min_chunk in ((None, True), (pw, True), (None, False)):
        if tbin._single_tile(grid):
            data, st = tbin.direct_frame(grid, ts, pts, rot, tr, weight,
                                         chunk)
        else:
            key, locs, nt = tbin._keys_and_local(grid, ts, pts, rot, tr)
            perm, _, st = tbin._slot_order(key, nt, chunk, min_chunk, True)
            data = tbin.frame_gather(perm, locs, weight)
        if min_chunk:
            want = tbin._fwd_prep(grid, pts, rot, tr, pw, weight is None)[:2]
        else:
            want = tbin._bwd_frame(grid, pts, rot, tr)[:2]
        assert torch.equal(data.view(torch.int32), want[0].view(torch.int32))
        assert torch.equal(st, want[1])


# ---------------------------------------------------------------------------
# B1 and B4 on the frame
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("terms", [0, 1])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_b1_on_the_frame_matches_jax_kernel(grid, weighted, terms):
    """`fwd_splat_enc` on the forward's frame (plain on the CPU: the
    frame's lane planes, then B1's twin) against JAX's lane planes and
    `_fwd_kernel` at the same terms (terms=0 against the exact split)."""
    pts, rot, tr, pw = _torch(*_cloud(grid))
    data, slot_tile, _, chunk = tbin._fwd_prep(grid, pts, rot, tr, pw,
                                               not weighted)
    _check_b1(slot_tile, data, grid, chunk, terms)


@pytest.mark.parametrize("terms", [0, 1])
@pytest.mark.parametrize("frame", ["forward", "standalone"])
@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_b4_on_the_frame_matches_jax_kernel(grid, frame, terms):
    """`bwd_gather_enc` on the encoded planes of the forward's frame and of
    the standalone pullback's (plain on the CPU: `_planes_bwd`, then B4's
    twin), with the window source the main path gives it, against JAX's
    `_planes_bwd` and `_bwd_kernel` within 1e-6."""
    pts, rot, tr, pw = _torch(*_cloud(grid))
    n_out = len(grid)
    if frame == "forward":
        data, slot_tile, _, chunk = tbin._fwd_prep(grid, pts, rot, tr, pw,
                                                   True)
    else:
        data, slot_tile, chunk = tbin._bwd_frame(grid, pts, rot, tr)
    g = np.random.default_rng(4).standard_normal(
        (rot.shape[0],) + grid).astype(np.float32)
    _check_b4(slot_tile, data[:, :n_out], grid, g, chunk, terms)


# ---------------------------------------------------------------------------
# the decode at its edges
# ---------------------------------------------------------------------------


def _enc(r_loc, frac):
    """The encoded coordinate of local voxel `r_loc` and fraction `frac`,
    as `_keys_and_local` writes it."""
    return ((r_loc + 2) << tbin._FIX) + frac


# fractions: none (dl = 1, the stencil one voxel down), the least, a half,
# the most below one
FRACS = (0, 1, 1 << 22, (1 << 23) - 1)


def _edge_axis(t):
    """Encodings on one axis of a window of body `t`: 0 (no overlap), and
    local voxels -1 (the halo before the body), 0, t - 1 and t, at every
    fraction of `FRACS`."""
    return [0] + [_enc(r, f) for r in (-1, 0, t - 1, t) for f in FRACS]


def _edge_frame(grid, chunk=64):
    """A frame of hand-made rows: every combination of `_edge_axis` values
    over the axes, shuffled over one slot per tile and padded with enc 0,
    with random weights -> (data (1, n_out + 2, s_pad) [enc..., w, id],
    slot_tile, chunk)."""
    ts = tbin.tile_shape_for(grid)
    n_out = len(grid)
    axes = [np.asarray(_edge_axis(t), np.int64) for t in ts]
    mesh = np.stack(np.meshgrid(*axes, indexing="ij"), 0).reshape(n_out, -1)
    rng = np.random.default_rng(3)
    nt = tbin.n_tiles(grid)
    per_slot = chunk * max(1, -(-mesh.shape[1] // (chunk * nt)))
    pick = rng.permutation(mesh.shape[1])[:per_slot * nt]
    rows = np.zeros((n_out, per_slot * nt), np.int64)
    rows[:, :pick.size] = mesh[:, pick]
    enc = rows.astype(np.int32).view(np.float32)
    w = rng.uniform(0.5, 2.0, enc.shape[1]).astype(np.float32)
    ids = np.arange(enc.shape[1], dtype=np.float32)
    data = torch.from_numpy(np.concatenate([enc, w[None], ids[None]])[None])
    n_slots = enc.shape[1] // per_slot
    slot_tile = torch.tensor(
        [list(np.arange(n_slots) * nt // n_slots) + [n_slots]],
        dtype=torch.int32)
    return data, slot_tile, per_slot


@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_decode_edges_bit_equal(grid):
    """`_decode_coord` and the lane planes made from it, `_planes_fwd` and
    `_planes_bwd` (the first step of B1's and B4's plain versions, and
    what their CUDA instances compute per row), give JAX's bits on
    hand-made rows: enc 0 (r0 = -3, dl = 1), a zero fraction (dl = 1, one
    voxel down), the first and last voxel of the window and its halo."""
    data, _, _ = _edge_frame(grid)
    n_out = len(grid)
    ts = tbin.tile_shape_for(grid)
    coord = data[:, :n_out]
    j_coord = jnp.asarray(coord.numpy())
    r0, dl = tbin._decode_coord(coord)
    j_r0, j_dl = jbin._decode_coord(j_coord)
    np.testing.assert_array_equal(r0.numpy(), np.asarray(j_r0))
    np.testing.assert_array_equal(_bits(dl), _bits(j_dl))
    enc = coord.view(torch.int32)
    frac = enc & ((1 << tbin._FIX) - 1)
    assert bool((r0 == -3)[enc == 0].all())
    assert bool((dl == 1.0)[frac == 0].all())
    assert bool((dl < 1.0)[frac != 0].all())
    for w in (None, data[:, n_out]):
        lane = tbin._planes_fwd(coord, w)
        j_lane = jbin._planes_fwd(j_coord, None if w is None
                                  else jnp.asarray(w.numpy()), ts, n_out)
        np.testing.assert_array_equal(_bits(lane), _bits(j_lane))
    np.testing.assert_array_equal(
        _bits(tbin._planes_bwd(coord, ts)),
        _bits(jbin._planes_bwd(j_coord, ts, n_out)))


def test_flat_rows_3d_at_the_window_edges():
    """The four flat rows of a 3-D row are -9 exactly where z leaves [0,
    tz] or y leaves [0, ty], and ``z (ty + 1) + y`` elsewhere, as JAX makes
    them; the decoded z and y of the edge rows reach both sides."""
    grid = (8, 16, 200)
    ts = tbin.tile_shape_for(grid)
    data, _, _ = _edge_frame(grid)
    coord = data[:, :3]
    iz0, _ = tbin._decode_coord(coord[:, 0])
    iy0, _ = tbin._decode_coord(coord[:, 1])
    rows = tbin._flat_rows_3d(iz0, iy0, ts)
    j_rows, _ = jbin._flat_rows_3d(*(jnp.asarray(x.numpy()) for x in (
        iz0, iz0.float(), iy0, iy0.float())), ts)
    for sz in (0, 1):
        for sy in (0, 1):
            z, y = iz0 + sz, iy0 + sy
            inside = (z >= 0) & (z <= ts[0]) & (y >= 0) & (y <= ts[1])
            want = torch.where(inside, z * (ts[1] + 1) + y, -9).float()
            got = rows[2 * sz + sy]
            assert torch.equal(got, want)
            np.testing.assert_array_equal(_bits(got),
                                          _bits(j_rows[2 * sz + sy]))
    for axis, t in ((iz0, ts[0]), (iy0, ts[1])):
        assert {-3, -1, 0, t} <= set(axis.unique().tolist())
    assert bool((rows[0] == -9).any()) and bool((rows[3] >= 0).any())


@pytest.mark.parametrize("terms", [0, 1])
@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_b1_and_b4_on_edge_rows_match_jax(grid, terms):
    """B1 and B4 on the hand-made edge frame (weighted B1; B4 with the
    window source the main path gives it) against JAX's kernels on its
    lane planes: B1 within 1e-5, B4 within 1e-6."""
    data, slot_tile, chunk = _edge_frame(grid)
    n_out = len(grid)
    _check_b1(slot_tile, data, grid, chunk, terms)
    _check_b1(slot_tile, torch.cat([data[:, :n_out], data[:, -1:]], 1),
              grid, chunk, terms)
    g = np.random.default_rng(5).standard_normal((1,) + grid).astype(
        np.float32)
    _check_b4(slot_tile, data[:, :n_out], grid, g, chunk, terms)
