"""B9, the binning sort's preparation (`slot_prep`), and the frame gather
from the sort's packed keys, on the CPU.

On the card two kernels of `csrc/slot_prep.cu` write the sort's input
keys, the slot table and the per-tile counts, and the frame gather reads
each row's id from the packed sorted keys; on the CPU each runs its plain
version.  Here:
- `_slot_prep_plain` against a numpy loop of the function's definition,
  packed and unpacked, with and without a slot for every tile, on empty
  tiles, every key at the sentinel, P no multiple of the chunk, one tile
  and close to the `binned` path's 4,096;
- the slot table and the frame (`_slot_order`, then `frame_gather` from
  the packed keys) against JAX's `_prep_binned`, bit for bit;
- the plain gather from the packed sorted keys equal to the plain gather
  from the sort's permutation;
- the CUDA wrapper raising on a tensor that is not on a card and on
  arguments outside the kernel's bounds;
- the frame gather's view of B6's interleaved planes, as B6 writes them
  on the card.

`chip_smoke.py`'s [B9 slot prep] phase holds the kernels to
`_slot_prep_plain` on the card, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dprast.ops import splat_binned as jbin  # noqa: E402
from dprast.utils.testing import fixtures  # noqa: E402
from dprast_torch.ops import splat_binned as tbin  # noqa: E402

torch.set_num_threads(2)


def _spec(key, nt, chunk, min_chunk, packed):
    """The function B9 computes, a pose and a tile at a time in numpy ->
    (keys2, slot_tile, counts) as int64."""
    bsz, p = key.shape
    s_pad = -(-p // chunk) * chunk + nt * chunk
    n_slots = s_pad // chunk
    p2 = 1 << max(p.bit_length(), 1)
    keys2 = np.empty((bsz, s_pad), np.int64)
    slot_tile = np.empty((bsz, n_slots + 1), np.int64)
    counts = np.zeros((bsz, nt + 1), np.int64)
    for b in range(bsz):
        for t in range(nt + 1):
            counts[b, t] = np.sum(key[b] == t)
        poffs = [0]
        for t in range(nt):
            padded = -(-counts[b, t] // chunk) * chunk
            if min_chunk:
                padded = max(padded, chunk)
            k = np.arange(chunk)
            fill = np.where(k < padded - counts[b, t], 2 * t + 1, 2 * nt + 1)
            keys2[b, p + t * chunk:p + (t + 1) * chunk] = fill
            poffs.append(poffs[-1] + padded)
        keys2[b, :p] = 2 * key[b]
        keys2[b, p + nt * chunk:] = 2 * nt + 1
        if packed:
            ids = np.concatenate([np.arange(p), np.full(s_pad - p, p)])
            keys2[b] = keys2[b] * p2 + ids
        for s in range(n_slots):
            ends = np.asarray(poffs[1:])
            slot_tile[b, s] = min(int(np.sum(ends <= s * chunk)), nt - 1)
        slot_tile[b, n_slots] = poffs[nt] // chunk
    return keys2, slot_tile, counts


def _keys(case, rng):
    """(key (B, P) int32, nt, chunk) of a named case."""
    if case == "skewed":      # a dense centre, every tile and the sentinel
        nt, p = 81, 3000
        key = np.clip(np.round(rng.normal(nt / 2, nt / 8, (3, p))), 0, nt)
        key[:, :nt + 1] = np.arange(nt + 1)
        return key.astype(np.int32), nt, 256
    if case == "empty-tiles":  # half the tiles hold no point
        nt, p = 20, 1000
        key = 2 * rng.integers(0, nt // 2, (2, p))
        return key.astype(np.int32), nt, 128
    if case == "all-sentinel":  # no point overlaps a tile
        return np.full((2, 700), 9, np.int32), 9, 128
    if case == "ragged":      # P no multiple of the chunk, crowded tiles
        return rng.integers(0, 6, (2, 1301)).astype(np.int32), 5, 128
    if case == "one-tile":
        return rng.integers(0, 2, (3, 517)).astype(np.int32), 1, 128
    if case == "many-tiles":  # close to the `binned` path's bound of 4,096
        nt = 4093
        return rng.integers(0, nt + 1, (2, 9000)).astype(np.int32), nt, 128
    raise ValueError(case)


CASES = ["skewed", "empty-tiles", "all-sentinel", "ragged", "one-tile",
         "many-tiles"]


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "payload"])
@pytest.mark.parametrize("min_chunk", [True, False],
                         ids=["forward", "standalone"])
@pytest.mark.parametrize("case", CASES)
def test_slot_prep_plain_matches_the_spec(case, min_chunk, packed):
    key, nt, chunk = _keys(case, np.random.default_rng(len(case)))
    keys2, slot_tile, counts = tbin._slot_prep_plain(
        torch.from_numpy(key), nt, chunk, min_chunk, packed)
    for got in (keys2, slot_tile, counts):
        assert got.dtype == torch.int32
    want = _spec(key, nt, chunk, min_chunk, packed)
    for got, ref in zip((keys2, slot_tile, counts), want):
        np.testing.assert_array_equal(got.numpy(), ref)
    # the wrapper takes the plain version for a CPU tensor
    for got, ref in zip(tbin.slot_prep(torch.from_numpy(key), nt, chunk,
                                       min_chunk, packed),
                        (keys2, slot_tile, counts)):
        assert torch.equal(got, ref)


def _cloud(grid, seed):
    fx = fixtures(seed=seed, n_points=1200, batch_size=2, n_in=3,
                  n_out=len(grid))
    return [torch.from_numpy(np.asarray(fx[k], np.float32))
            for k in ("points", "rotation", "translation", "point_weight")]


@pytest.mark.parametrize("pack_idx", [True, False],
                         ids=["packed", "payload"])
@pytest.mark.parametrize("min_chunk", [True, False],
                         ids=["forward", "standalone"])
@pytest.mark.parametrize("grid", [(300, 200), (8, 16, 200)],
                         ids=["300x200", "8x16x200"])
def test_slot_table_and_frame_match_jax_prep_binned(grid, min_chunk,
                                                    pack_idx):
    """`_slot_order` (B9's plain version and the sort) and the frame gather
    from its index (the packed keys, or the permutation of the stable
    sort) give JAX's `_prep_binned` frame and slot table bit for bit."""
    pts, rot, tr, pw = _cloud(grid, 7)
    p = pts.shape[0]
    chunk = tbin._default_chunk(grid, p)
    key, locs, nt = tbin._keys_and_local(grid, tbin.tile_shape_for(grid),
                                         pts, rot, tr)
    perm, sorted_keys, slot_tile = tbin._slot_order(key, nt, chunk,
                                                    min_chunk, pack_idx)
    data = tbin.frame_gather(perm if sorted_keys is None else sorted_keys,
                             locs, pw)
    planes = [jnp.asarray(x.numpy()) for x in locs]
    fills = [0.0] * len(planes) + [0.0, float(p)]
    for b in range(key.shape[0]):
        jp = [pl_[b] for pl_ in planes] + [
            jnp.asarray(pw.numpy()), jnp.arange(p, dtype=jnp.float32)]
        j_data, j_st = jbin._prep_binned(
            jnp.asarray(key[b].numpy()), jp, fills, nt, chunk, min_chunk,
            pack_idx=pack_idx)
        np.testing.assert_array_equal(data[b].numpy().view(np.int32),
                                      np.asarray(j_data).view(np.int32))
        np.testing.assert_array_equal(slot_tile[b].numpy(), np.asarray(j_st))


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["uniform", "weighted"])
@pytest.mark.parametrize("grid", [(300, 200), (8, 16, 200)],
                         ids=["300x200", "8x16x200"])
def test_gather_from_sorted_keys_is_the_gather_from_perm(grid, weighted):
    """The frame gather's plain version reading each row's id off the
    packed sorted keys (``key & (P2 - 1)``) writes the frame it writes
    from the sort's permutation, bit for bit."""
    pts, rot, tr, pw = _cloud(grid, 11)
    p = pts.shape[0]
    key, locs, nt = tbin._keys_and_local(grid, tbin.tile_shape_for(grid),
                                         pts, rot, tr)
    perm, sorted_keys, _ = tbin._slot_order(
        key, nt, tbin._default_chunk(grid, p), True, True)
    assert sorted_keys is not None and sorted_keys.dtype == torch.int32
    assert torch.equal(tbin._frame_ids(sorted_keys, p),
                       torch.where(perm < p, perm, p))
    weight = pw if weighted else None
    from_keys = tbin._frame_gather_plain(sorted_keys, locs, weight)
    from_perm = tbin._frame_gather_plain(perm, locs, weight)
    assert torch.equal(from_keys.view(torch.int32),
                       from_perm.view(torch.int32))


def test_slot_prep_cuda_wrapper_raises():
    """`slot_prep` on a tensor that is on no card, and on arguments outside
    its kernels' bounds, raises rather than running anything; 70,000 poses
    are inside them and fail for want of a card alone."""
    meta = torch.zeros((2, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbin.slot_prep(meta, 4, 128, True, True)
    with pytest.raises(ValueError, match="CUDA"):
        tbin.slot_prep(meta.float(), 4, 128, True, False)
    with pytest.raises(ValueError, match="launch bounds"):
        tbin.slot_prep(meta, 4097, 128, True, False)
    with pytest.raises(ValueError, match="launch bounds"):
        tbin.slot_prep(meta, 4, 130, True, False)
    with pytest.raises(ValueError, match="CUDA"):
        tbin.slot_prep(torch.zeros((70000, 4), dtype=torch.int32,
                                   device="meta"), 4, 128, True, False)
    with pytest.raises(ValueError, match="int32"):
        tbin.slot_prep(torch.zeros((1, 2 ** 22), dtype=torch.int32,
                                   device="meta"), 342, 256, True, True)


@pytest.mark.parametrize("n_out", [2, 3])
def test_frame_gather_reads_b6s_interleaved_planes(n_out):
    """On the card B6 writes a point's planes side by side, (B, P, 2) in
    2-D and (B, P, 4) in 3-D, and hands out views of them; the frame
    gather takes the tensor behind such views and refuses separate
    planes."""
    lanes = tbin._lanes(n_out)
    base = torch.arange(2 * 10 * lanes, dtype=torch.float32).reshape(
        2, 10, lanes)
    views = list(base.unbind(-1)[:n_out])
    got = tbin._interleaved(views)
    assert got.data_ptr() == base.data_ptr() and torch.equal(got, base)
    with pytest.raises(ValueError, match="interleaved"):
        tbin._interleaved([v.contiguous() for v in views])
    with pytest.raises(ValueError, match="interleaved"):
        tbin._interleaved(views[::-1])
