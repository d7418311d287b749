"""B10, the binning sort as a counting scatter (`bin_scatter`), on the CPU.

On the card one kernel of `csrc/bin_scatter.cu` writes the sorted frame
keys straight to their places from B9's counts and bases (`slot_prep`);
on the CPU the wrapper runs its plain version, `torch.sort` of B9's plain
sort input.  Here:
- a numpy spec of the counting scatter, which places each row from the
  counts and each stretch's bases alone (a tile's points in id order,
  then its fillers; the points with no tile; the unused fillers), held bit
  for bit to `torch.sort`'s output, packed (the sorted keys) and unpacked
  (the stable sort's permutation), on the cases of
  `test_torch_slot_prep.py`, with and without a slot for every tile;
- B9's bases (`slot_prep` on the CPU) against the spec's;
- the card's composition of plain versions (`slot_prep`, `bin_scatter`,
  `frame_gather` on its index) against the frame `_fwd_prep` and
  `_bwd_frame` build on the CPU;
- the CUDA wrapper raising on a tensor that is not on a card and on
  arguments outside the kernel's bounds (the stand-in card's checks are
  in `test_torch_bounds.py`).

`chip_smoke.py`'s [B9 slot prep] phase holds the kernel to `torch.sort`
on the card, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dprast.utils.testing import fixtures  # noqa: E402
from dprast_torch.ops import splat_binned as tbin  # noqa: E402
from test_torch_slot_prep import CASES, _keys  # noqa: E402

torch.set_num_threads(2)


def _scatter_spec(key, nt, chunk, min_chunk, packed):
    """The counting scatter, a pose at a time in numpy, from the counts
    and the stretch bases alone -> (frame keys (B, s_pad), bases (B,
    stretches, nt + 1)) as int64: where `packed` the sort keys ``(2t (+1
    for a filler)) P2 + id`` (id P for a filler), else the index of the
    row in B9's plain sort input (the point's id, P + f for its filler f)."""
    bsz, p = key.shape
    s_pad = -(-p // chunk) * chunk + nt * chunk
    p2 = 1 << max(p.bit_length(), 1)
    n_str = -(-p // tbin._STRETCH)
    out = np.full((bsz, s_pad), -1, np.int64)
    written = np.zeros((bsz, s_pad), np.int64)
    bases = np.empty((bsz, n_str, nt + 1), np.int64)
    for b in range(bsz):
        counts = np.bincount(key[b], minlength=nt + 1)
        padded = -(-counts[:nt] // chunk) * chunk
        if min_chunk:
            padded = np.maximum(padded, chunk)
        poffs = np.concatenate([[0], np.cumsum(padded)])  # nt + 1 entries
        need = padded - counts[:nt]
        # the points: a stretch's first row of each tile from the points
        # of the stretches before, then each point at the next row of its
        # tile, in id order
        for j in range(n_str):
            lo = j * tbin._STRETCH
            bases[b, j] = poffs + np.bincount(key[b, :lo], minlength=nt + 1)
            at = bases[b, j].copy()
            for i in range(lo, min(p, lo + tbin._STRETCH)):
                t = int(key[b, i])
                out[b, at[t]] = (2 * t) * p2 + i if packed else i
                written[b, at[t]] += 1
                at[t] += 1
        # filler f of the plain input: tile t's k-th (f = t chunk + k), or
        # a topping row (f >= nt chunk), placed as tile nt - 1's unused
        f = np.arange(s_pad - p)
        t = np.minimum(f // chunk, nt - 1)
        k = f - t * chunk
        used = k < need[t]
        after = poffs[nt] + counts[nt]           # the points with no tile
        need_through = np.cumsum(need)           # sum of need[0 .. t]
        q = np.where(used, poffs[t] + counts[t] + k,
                     after + f - need_through[t])
        out[b, q] = (np.where(used, 2 * t + 1, 2 * nt + 1) * p2 + p
                     if packed else p + f)
        np.add.at(written[b], q, 1)
    assert (written == 1).all(), "every row written once"
    return out, bases


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "payload"])
@pytest.mark.parametrize("min_chunk", [True, False],
                         ids=["forward", "standalone"])
@pytest.mark.parametrize("case", CASES)
def test_counting_scatter_is_the_sort(case, min_chunk, packed):
    """The spec's frame keys are `torch.sort`'s of B9's plain sort input
    bit for bit (the sorted keys where packed, the stable sort's
    permutation else), and so are `bin_scatter`'s on the CPU; its bases are
    `slot_prep`'s."""
    key, nt, chunk = _keys(case, np.random.default_rng(len(case)))
    want, bases = _scatter_spec(key, nt, chunk, min_chunk, packed)
    keys2 = tbin._slot_prep_plain(torch.from_numpy(key), nt, chunk,
                                  min_chunk, packed)[0]
    values, perm = torch.sort(keys2, dim=1, stable=not packed)
    np.testing.assert_array_equal((values if packed else perm).numpy(), want)
    got_bases, _, counts = tbin.slot_prep(torch.from_numpy(key), nt, chunk,
                                          min_chunk)
    assert got_bases.dtype == torch.int32
    np.testing.assert_array_equal(got_bases.numpy(), bases)
    got = tbin.bin_scatter(torch.from_numpy(key), counts, got_bases, nt,
                           chunk, min_chunk, packed)
    assert got.dtype == (torch.int32 if packed else torch.int64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("grid", [(300, 200), (8, 16, 200)],
                         ids=["300x200", "8x16x200"])
def test_card_composition_is_the_cpu_frame(grid):
    """B9 (`slot_prep`), B10 (`bin_scatter`) and the frame gather on
    B10's index, as the card composes them (each its plain version
    here), give the frame and slot table that `_fwd_prep` and
    `_bwd_frame` build on the CPU, bit for bit, packed and unpacked, with
    and without a weight plane."""
    fx = fixtures(seed=5, n_points=5000, batch_size=2, n_in=3,
                  n_out=len(grid))
    pts, rot, tr, pw = (torch.from_numpy(np.asarray(fx[k], np.float32))
                        for k in ("points", "rotation", "translation",
                                  "point_weight"))
    ts = tbin.tile_shape_for(grid)
    chunk = tbin._default_chunk(grid, pts.shape[0])
    key, locs, nt = tbin._keys_and_local(grid, ts, pts, rot, tr)
    for weight, min_chunk in ((None, True), (pw, True), (None, False)):
        bases, st, counts = tbin.slot_prep(key, nt, chunk, min_chunk)
        if min_chunk:
            want = tbin._fwd_prep(grid, pts, rot, tr, pw, weight is None)[:2]
        else:
            want = tbin._bwd_frame(grid, pts, rot, tr)[:2]
        for packed in (True, False):
            index = tbin.bin_scatter(key, counts, bases, nt, chunk,
                                     min_chunk, packed)
            data = tbin.frame_gather(index, locs, weight)
            assert torch.equal(data.view(torch.int32),
                               want[0].view(torch.int32))
            assert torch.equal(st, want[1])


def test_bin_scatter_cuda_wrapper_raises():
    """`bin_scatter` on tensors that are on no card, and on arguments
    outside its kernel's bounds, raises rather than running anything;
    70,000 poses are inside them and fail for want of a card alone."""
    def meta(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    key, counts, bases = meta(2, 128), meta(2, 5), meta(2, 1, 5)
    with pytest.raises(ValueError, match="CUDA"):
        tbin.bin_scatter(key, counts, bases, 4, 128, True, True)
    with pytest.raises(ValueError, match="CUDA"):
        tbin.bin_scatter(key.float(), counts, bases, 4, 128, True, False)
    with pytest.raises(ValueError, match="launch bounds"):
        tbin.bin_scatter(key, counts, bases, 4097, 128, True, False)
    with pytest.raises(ValueError, match="launch bounds"):
        tbin.bin_scatter(key, counts, bases, 4, 130, True, False)
    with pytest.raises(ValueError, match="CUDA"):
        tbin.bin_scatter(meta(70000, 4), meta(70000, 5), meta(70000, 1, 5),
                         4, 128, True, False)
    with pytest.raises(ValueError, match="int32"):
        tbin.bin_scatter(meta(1, 2 ** 22), meta(1, 343), meta(1, 1024, 343),
                         342, 256, True, True)
