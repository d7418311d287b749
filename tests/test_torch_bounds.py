"""The `binned` path's kernel wrappers past 65,535 poses and grid rows, on
the CPU.

CUDA caps a launch grid's y and z extents at 65,535.  The kernels of the
`binned` path take any number of poses (`dprast_torch/csrc/poses.cuh`)
and B2 any number of grid rows, so no wrapper refuses a pose count or a
row count, and every shape that `splat_binned.supported` admits runs on
the card through `auto`, as it runs in the JAX package.  Here:
- every wrapper, on `meta` tensors at 70,000 poses (B2 also at 70,000
  rows), refuses only for want of a card;
- every wrapper, on a stand-in card (`meta` tensors taken for CUDA ones,
  the launch recorded instead of made), reaches its kernel's launch with
  the 70,000 poses or rows and the shapes that go with them;
- `auto` takes `binned` on the card for a (70,000, 64) grid, as the JAX
  package's `profitable` has it.

`chip_smoke.py`'s [poses] and [poses rows] phases run these shapes on
the card against the `xla` backend.
"""

import pytest

torch = pytest.importorskip("torch")

from dprast.ops import splat_binned as jbin  # noqa: E402
from dprast_torch import ad  # noqa: E402
from dprast_torch.ops import core as tcore  # noqa: E402
from dprast_torch.ops import dispatch, splat_binned as tbin  # noqa: E402

# past CUDA's 65,535 on a grid's y and z
MANY = 70_000
P = 1000
META = torch.device("meta")
F32, I32 = torch.float32, torch.int32


def _empty(shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device=META)


def _frame(grid, bsz, weighted=False):
    """A frame of `grid` on `meta` tensors -> (data, slot_tile, nt, win,
    chunk): the shapes `_fwd_prep` gives."""
    n_out = len(grid)
    nt = tbin.n_tiles(grid)
    chunk = tbin._default_chunk(grid, P)
    s_pad = (-(-P // chunk) * chunk if tbin._single_tile(grid)
             else tbin._slot_frame_size(P, nt, chunk))
    data = _empty((bsz, n_out + (2 if weighted else 1), s_pad))
    slot_tile = _empty((bsz, s_pad // chunk + 1), I32)
    return data, slot_tile, nt, tbin._window(grid), chunk


def _poses(grid, bsz):
    return (_empty((P, 3)), _empty((bsz, len(grid), 3)),
            _empty((bsz, len(grid))))


def _coords(bsz):
    grid = (300, 200)
    return lambda: tbin._keys_and_local(grid, tbin.tile_shape_for(grid),
                                        *_poses(grid, bsz))


def _direct_frame(bsz):
    grid = (64, 64)
    return lambda: tbin.direct_frame(grid, tbin.tile_shape_for(grid),
                                     *_poses(grid, bsz), _empty((P,)), 1024)


def _slot_prep(bsz):
    return lambda: tbin.slot_prep(_empty((bsz, P), I32), 2, 256, True)


def _bin_scatter(bsz, packed=True):
    return lambda: tbin.bin_scatter(_empty((bsz, P), I32),
                                    _empty((bsz, 3), I32),
                                    _empty((bsz, 1, 3), I32), 2, 256, True,
                                    packed)


def _frame_gather(bsz):
    planes = _empty((bsz, P, 2))
    locs = list(planes.unbind(-1))
    index = _empty((bsz, 1536), I32)
    return lambda: tbin.frame_gather(index, locs, _empty((P,)))


def _fwd_splat_enc(bsz, grid=(127, 130)):
    data, slot_tile, nt, win, chunk = _frame(grid, bsz, weighted=True)
    return lambda: tbin.fwd_splat_enc(slot_tile, data, nt, win, chunk)


def _fwd_splat(bsz):
    grid = (7, 15, 130)
    _, slot_tile, nt, win, chunk = _frame(grid, bsz)
    lane = _empty((bsz, 6, slot_tile.shape[1] * chunk - chunk))
    return lambda: tbin.fwd_splat(slot_tile, lane, nt, win, chunk)


def _band_fold(bsz, grid=(127, 130)):
    ts = tbin.tile_shape_for(grid)
    ext = _empty((bsz, tbin.n_tiles(grid), ts[0] + 1, ts[1] + 1))
    return lambda: tbin.band_fold(ext, grid, ts, _empty((bsz,)),
                                  _empty((bsz,)))


def _band_unfold(bsz):
    grid = (127, 130)
    return lambda: tbin.band_unfold(_empty((bsz,) + grid), grid,
                                    tbin.tile_shape_for(grid))


def _bwd_gather_enc(bsz, grid=(127, 130)):
    data, slot_tile, _, win, chunk = _frame(grid, bsz)
    ts = tbin.tile_shape_for(grid)
    if len(grid) == 3:
        g, layout = _empty((bsz, tbin.n_tiles(grid), 8 * 16, 128)), "natural"
    elif tbin._single_tile(grid):
        g, layout = _empty((bsz,) + grid), "natural"
    else:
        g, layout = _empty((bsz,) + grid), "grid"
    return lambda: tbin.bwd_gather_enc(slot_tile, data[:, :len(grid)], ts, g,
                                       chunk, layout=layout)


def _bwd_gather(bsz):
    grid = (127, 130)
    data, slot_tile, nt, _, chunk = _frame(grid, bsz)
    lane_b = _empty((bsz, 4, data.shape[2]))
    return lambda: tbin.bwd_gather(slot_tile, lane_b,
                                   _empty((bsz, nt, 128, 128)), chunk)


def _epilogue(bsz, grid=(127, 130)):
    data, slot_tile, _, _, chunk = _frame(grid, bsz)
    buf = _empty((bsz, len(grid) + 1, data.shape[2]))
    pts, rot, _ = _poses(grid, bsz)
    return lambda: tbin.pullback_epilogue(
        grid, buf, data[:, -1], pts, rot, _empty((bsz,)), _empty((P,)))


def _xla_neighbours(bsz, grid=(64, 64)):
    return lambda: tcore.xla_neighbours(grid, *_poses(grid, bsz),
                                        _empty((bsz,)), _empty((P,)))


def _xla_scatter(bsz, grid=(64, 64), keys=I32):
    n = bsz * P * 2 ** len(grid)
    return lambda: tcore.xla_scatter(_empty((bsz,)), grid, _empty((n,), keys),
                                     _empty((n,), torch.int64), _empty((n,)))


def _xla_gather(bsz, grid=(64, 64)):
    res = (_empty((bsz, P, len(grid)), I32), _empty((bsz, P, len(grid))))
    return lambda: tcore.xla_gather(grid, _empty((bsz,) + grid), res,
                                    _empty((bsz,)), _empty((P,)))


# every wrapper of the `binned` path's kernels at `MANY` poses (B2 also at
# `MANY` grid rows), and of the `xla` path's (X2 also with int64 keys, on
# a volume of more than 2^31 voxels) -> (call, the launch it reaches: the
# name it counts under and the C entry point it calls)
WRAPPERS = {
    "B6 coords": (_coords(MANY), "coords"),
    "B6 direct_frame": (_direct_frame(MANY), "coords"),
    "B9 slot_prep": (_slot_prep(MANY), "slot_prep"),
    "B10 bin_scatter": (_bin_scatter(MANY), "bin_scatter"),
    "B10 bin_scatter unpacked": (_bin_scatter(MANY, False), "bin_scatter"),
    "frame_gather": (_frame_gather(MANY), "frame_gather"),
    "B1 fwd_splat_enc": (_fwd_splat_enc(MANY), "fwd_splat"),
    "B1 fwd_splat_enc single tile": (_fwd_splat_enc(MANY, (64, 64)),
                                     "fwd_splat"),
    "B1 fwd_splat_enc 3-D": (_fwd_splat_enc(MANY, (7, 15, 130)),
                             "fwd_splat"),
    "B1 fwd_splat": (_fwd_splat(MANY), "fwd_splat"),
    "B2 band_fold": (_band_fold(MANY), "band_fold"),
    "B2 band_fold rows": (_band_fold(4, (MANY, 64)), "band_fold"),
    "B3 band_unfold": (_band_unfold(MANY), "band_unfold"),
    "B4 bwd_gather_enc grid": (_bwd_gather_enc(MANY), "bwd_gather"),
    "B4 bwd_gather_enc single tile": (_bwd_gather_enc(MANY, (64, 64)),
                                      "bwd_gather"),
    "B4 bwd_gather_enc 3-D": (_bwd_gather_enc(MANY, (7, 15, 130)),
                              "bwd_gather"),
    "B4 bwd_gather": (_bwd_gather(MANY), "bwd_gather"),
    "B8 epilogue": (_epilogue(MANY), "epilogue_rows"),
    "B8 epilogue single tile": (_epilogue(MANY, (64, 64)), "epilogue_tile"),
    "X1 xla_neighbours": (_xla_neighbours(MANY), "xla_neighbours"),
    "X1 xla_neighbours 4-D": (_xla_neighbours(MANY, (5, 4, 6, 3)),
                              "xla_neighbours"),
    "X2 xla_scatter": (_xla_scatter(MANY), "xla_scatter"),
    "X2 xla_scatter int64 keys": (_xla_scatter(MANY, (256, 256),
                                               torch.int64), "xla_scatter"),
    "X1 xla_neighbours 3-D int64 keys": (_xla_neighbours(MANY, (64, 64, 64)),
                                         "xla_neighbours"),
    "X3 xla_gather": (_xla_gather(MANY), "xla_gather"),
    "X3 xla_gather 1-D": (_xla_gather(MANY, (4096,)), "xla_gather"),
    "X3 xla_gather 3-D past 2^31 voxels": (_xla_gather(MANY, (64, 64, 64)),
                                           "xla_gather"),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_refuses_only_for_want_of_a_card(name):
    """On `meta` tensors, which lie on no card, each wrapper raises the
    CUDA error and no launch bound: nothing in it refuses 70,000 poses or
    (B2) 70,000 rows."""
    call, _ = WRAPPERS[name]
    with pytest.raises(ValueError, match="CUDA") as caught:
        call()
    assert "launch bounds" not in str(caught.value)


class _Library:
    """The kernel library's stand-in: every entry point is a name."""

    def __getattr__(self, name):
        return name


@pytest.fixture
def stand_in_card(monkeypatch):
    """`meta` tensors taken for tensors on a card, and each launch
    recorded as ``(counter, entry point, int arguments)`` in place of
    being made -> the list of launches; the wrappers' launch counters are
    restored afterwards."""
    launched = []
    counts = dict(tbin.LAUNCHES)

    def launch(name, device, entry, *args):
        launched.append((name, entry, [a for a in args if type(a) is int]))

    monkeypatch.setattr(tbin, "_on_card", lambda t: t.device == META)
    monkeypatch.setattr(tbin, "_launch", launch)
    monkeypatch.setattr(tbin._build, "load", _Library)
    # the card's occupancy and SM count, which the cluster size and B4's
    # splits are read from
    monkeypatch.setattr(tbin, "_clusters_held",
                        lambda *a, **kw: (1,) * tbin._MAX_CLUSTER)
    monkeypatch.setattr(tbin, "_b1_cluster", lambda *a, **kw: 1)
    monkeypatch.setattr(tbin, "_split_count", lambda *a: 1)
    yield launched
    tbin.LAUNCHES.update(counts)


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_launches_past_65535(name, stand_in_card):
    """On a stand-in card each wrapper reaches its kernel's launch, and
    hands the kernel the 70,000 poses (B2 also the 70,000 rows)."""
    call, counter = WRAPPERS[name]
    before = dict(tbin.LAUNCHES)
    call()
    counted = {k: v - before[k] for k, v in tbin.LAUNCHES.items()
               if v != before[k]}
    assert stand_in_card, "no launch was reached"
    assert stand_in_card[0][0] == counter
    assert stand_in_card[0][1] == "dprast_" + counter
    assert all(MANY in ints for _, _, ints in stand_in_card)
    assert sum(counted.values()) == len(stand_in_card)


# grids of the fused step on the stand-in card: one tile, 2-D tiles, a 3-D
# grid of one tile in z and y (whose unfolded windows were a view), a 3-D
# grid of several, and 70,000 grid rows -> (poses, points, entry points)
STEP_GRIDS = {
    (64, 64): (MANY, P, ("coords", "fwd_splat", "bwd_gather",
                         "epilogue_tile", "epilogue_poses")),
    (127, 130): (MANY, P, ("coords", "slot_prep", "bin_scatter",
                           "frame_gather", "fwd_splat", "band_fold",
                           "bwd_gather", "epilogue_rows",
                           "epilogue_points")),
    (7, 15, 130): (MANY, P, ("coords", "slot_prep", "bin_scatter",
                             "frame_gather", "fwd_splat", "bwd_gather",
                             "epilogue_rows", "epilogue_points")),
    (16, 40, 300): (MANY, P, ("coords", "slot_prep", "bin_scatter",
                              "frame_gather", "fwd_splat", "bwd_gather",
                              "epilogue_rows", "epilogue_points")),
    (MANY, 64): (4, 100_000, ("coords", "slot_prep", "bin_scatter",
                              "frame_gather", "fwd_splat", "band_fold",
                              "bwd_gather", "epilogue_rows",
                              "epilogue_points")),
}


@pytest.mark.parametrize("grid", list(STEP_GRIDS), ids=str)
def test_fused_step_reaches_every_launch(grid, stand_in_card):
    """The fused step (`raster_fwd_res`, then `raster_pullback_res`) at
    70,000 poses (and at 70,000 grid rows) on the stand-in card: the plain
    torch between the kernels runs on `meta` tensors, every wrapper's
    checks hold (a 3-D grid of one tile in z and y once handed B4 a view
    of the unfolded windows, which it refuses), and each kernel of the
    path is reached once, in order."""
    bsz, p, entries = STEP_GRIDS[grid]
    args = (_empty((p, 3)), _empty((bsz, len(grid), 3)),
            _empty((bsz, len(grid))), _empty((bsz,)), _empty((bsz,)),
            _empty((p,)))
    out, res = tbin.raster_fwd_res(grid, *args)
    grads = tbin.raster_pullback_res(grid, res, args,
                                     _empty((bsz,) + grid))
    assert out.shape == (bsz,) + grid
    assert [g.shape for g in grads] == [a.shape for a in args]
    assert tuple(name for name, _, _ in stand_in_card) == entries
    assert all(bsz in ints for _, _, ints in stand_in_card)


def test_unfold_gives_contiguous_windows():
    """`_unfold` (B3's plain version and the 3-D path's unfold) gives
    contiguous windows, also where one tile on every axis but the last
    makes its reshape a view."""
    for grid in ((7, 15, 130), (16, 40, 300), (127, 130)):
        g = torch.randn((2,) + grid)
        win = tbin._unfold(g, grid, tbin.tile_shape_for(grid))
        assert win.is_contiguous()


def test_stand_in_card_keeps_the_wrappers_checks(stand_in_card):
    """The stand-in card refuses what the wrappers still bound: a window
    wider than the kernel's shared memory, so it runs the wrappers' own
    checks and not around them."""
    slot_tile = _empty((2, 3), I32)
    lane = _empty((2, 5, 256))
    with pytest.raises(ValueError, match="launch bounds"):
        tbin.fwd_splat(slot_tile, lane, 1, (129, 129), 128)
    assert not stand_in_card


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_bin_scatter_on_the_stand_in_card(packed, stand_in_card):
    """B10 (`bin_scatter`) on the stand-in card refuses, launching
    nothing, more than 4,096 tiles, a slot that is no multiple of 4 rows,
    packed keys past an int32, keys that are no int32 and counts or bases
    that are not B9's of the keys; then it reaches its launch with the
    frame's shape, int32 rows where packed and int64 else, and hands the
    kernel its shape, slot, packing and id span."""
    key = _empty((3, 9000), I32)
    counts, bases = _empty((3, 82), I32), _empty((3, 3, 82), I32)
    refused = [((key, counts, bases, 4097, 256), "launch bounds"),
               ((key, counts, bases, 81, 130), "launch bounds"),
               ((key.float(), counts, bases, 81, 256), "contiguous"),
               ((key, _empty((3, 81), I32), bases, 81, 256), "B9's"),
               ((key, counts, _empty((3, 2, 82), I32), 81, 256), "B9's")]
    if packed:
        refused.append(((_empty((1, 2 ** 22), I32), _empty((1, 343), I32),
                         _empty((1, 1024, 343), I32), 342, 256), "int32"))
    for args, match in refused:
        with pytest.raises(ValueError, match=match):
            tbin.bin_scatter(*args, True, packed)
    assert not stand_in_card
    out = tbin.bin_scatter(key, counts, bases, 81, 256, True, packed)
    assert out.shape == (3, tbin._slot_frame_size(9000, 81, 256))
    assert out.dtype == (torch.int32 if packed else torch.int64)
    ((name, entry, ints),) = stand_in_card
    assert (name, entry) == ("bin_scatter", "dprast_bin_scatter")
    assert ints == [3, 9000, 81, 256, 1, int(packed), tbin._id_span(9000)]


def test_auto_takes_binned_for_70000_grid_rows():
    """A (70,000, 64) grid of 10^5 points is 552 tiles, inside the `binned`
    path's 4,096, and dense enough: `auto` takes `binned` on the card, as
    the JAX package's `profitable` has it (it runs B2 on 70,000 rows)."""
    grid, p = (MANY, 64), 100_000
    assert tbin.n_tiles(grid) == 552
    assert tbin.supported(2, grid, p) and jbin.supported(2, grid, p)
    assert tbin.profitable(2, grid, p) and jbin.profitable(2, grid, p)
    assert dispatch.resolve("auto", 2, grid, p, accelerator=True) == "binned"



# grids of the `xla` path on the stand-in card at `MANY` poses: 2-D, 1-D
# and rank 4, which `binned` does not take
XLA_GRIDS = ((64, 64), (4096,), (5, 4, 6, 3))


@pytest.mark.parametrize("grid", XLA_GRIDS, ids=str)
def test_xla_fused_step_reaches_every_launch(grid, stand_in_card):
    """The `xla` fused pair at 70,000 poses on the stand-in card: X1 (keys,
    terms and residuals), the sort, X2 and X3, each reached once, in
    order, with the 70,000 poses; no graph-recording form."""
    before = tcore.GRAPH_FORM_CALLS["xla_plain"]
    n = len(grid)
    args = (_empty((P, n)), _empty((MANY, n, n)), _empty((MANY, n)),
            _empty((MANY,)), _empty((MANY,)), _empty((P,)))
    out, res = tcore.raster_fwd_res(grid, *args)
    grads = tcore.raster_pullback_res(grid, res, args,
                                      _empty((MANY,) + grid))
    assert out.shape == (MANY,) + grid
    assert [g.shape for g in grads] == [a.shape for a in args]
    assert tuple(name for name, _, _ in stand_in_card) == tcore.XLA_KERNELS
    assert all(MANY in ints for _, _, ints in stand_in_card)
    assert tcore.GRAPH_FORM_CALLS["xla_plain"] == before


def test_xla_keys_past_int32(stand_in_card):
    """Two poses of a 1024^3 volume: X1 writes int64 keys (B * total =
    2^31) and hands X2 its volume as two poses of 2^30 voxels."""
    grid = (1024, 1024, 1024)
    keys, _, _ = tcore.xla_neighbours(grid, *_poses(grid, 2), _empty((2,)),
                                      _empty((P,)), residuals=False)
    assert keys.dtype == torch.int64 and keys.shape == (2, P, 8)
    order, perm = torch.sort(keys.reshape(-1), stable=True)
    out = tcore.xla_scatter(_empty((2,)), grid, order, perm,
                            _empty((2 * P * 8,)))
    assert out.shape == (2,) + grid
    (_, _, x1), (_, _, x2) = stand_in_card
    assert 1 in x1 and 2 in x1           # key64, B
    # the background's stride, key64, n, B, total
    assert x2[:5] == [1, 1, 2 * P * 8, 2, 1024 ** 3]
    with pytest.raises(ValueError, match="int32 keys"):
        tcore.xla_scatter(_empty((2,)), grid, order.to(I32), perm,
                          _empty((2 * P * 8,)))


@pytest.mark.parametrize("create_graph", [False, True])
def test_xla_second_derivative_runs_the_graph_form(create_graph,
                                                    stand_in_card):
    """Autograd through `xla` on the stand-in card: a plain backward runs
    X3 on the forward's residuals; a backward under ``create_graph=True``
    runs the plain torch form from the inputs (`GRAPH_FORM_CALLS`), which
    records the graph, and launches nothing."""
    grid, bsz = (16, 16), 3
    leaves = [_empty(s).requires_grad_() for s in
              ((P, 2), (bsz, 2, 2), (bsz, 2), (bsz,), (bsz,), (P,))]
    out = ad.raster_canonical(grid, "xla", False, *leaves)
    assert tuple(name for name, _, _ in stand_in_card) == (
        "xla_neighbours", "xla_scatter")
    before = tcore.GRAPH_FORM_CALLS["xla_plain"]
    (d_pts,) = torch.autograd.grad(out.sum(), leaves[0],
                                   create_graph=create_graph)
    backward = tuple(name for name, _, _ in stand_in_card[2:])
    if create_graph:
        assert backward == ()
        assert tcore.GRAPH_FORM_CALLS["xla_plain"] == before + 1
        assert d_pts.requires_grad
    else:
        assert backward == ("xla_gather",)
        assert tcore.GRAPH_FORM_CALLS["xla_plain"] == before
        assert not d_pts.requires_grad
