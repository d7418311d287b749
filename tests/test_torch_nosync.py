"""No host round trip inside a call of dprast_torch (the CPU-side witness).

On the card, a host value made into a device tensor (`torch.tensor`,
`torch.as_tensor` of numpy or Python values, `torch.from_numpy(...).to`),
a read of a device value on the host (`.item()`, `.tolist()`, `.cpu()`)
and an op that reads a size back (`torch.bincount`) each wait for the
card.  The code that makes the constants and the defaults is the same on
both devices (the per-tile counts are an integer kernel on the card and
its plain version here, and the fixed-point splat's shift is made in the
kernel and by `_fixed_shift` here), so spies on those functions show here
that a call runs none of them: `raster`, the fused pair
(`raster_fwd_res` + `raster_pullback_res`), `raster_pullback` and an
autograd step, with tensor inputs and default weights, on every backend.
`chip_smoke.py` [no sync] makes the real check on the card, under
``torch.cuda.set_sync_debug_mode("error")``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dprast_torch  # noqa: E402
from dprast_torch import api  # noqa: E402
from dprast_torch.ops import dispatch, geometry  # noqa: E402
from dprast_torch.utils.testing import fixtures  # noqa: E402

torch.set_num_threads(2)

SPIED = (("torch", torch, ("tensor", "as_tensor", "from_numpy", "bincount")),
         ("Tensor", torch.Tensor, ("item", "tolist", "cpu")))

# (backend, grid, poses, points): one tile, several tiles, a volume; the
# `xla` path at ranks 1-3
CASES = {
    "binned-one-tile": ("binned", (64, 64), 2, 500),
    "binned-multi-tile": ("binned", (300, 200), 2, 500),
    "binned-3d": ("binned", (8, 16, 200), 2, 300),
    "binned_bf16": ("binned_bf16", (300, 200), 2, 500),
    "xla": ("xla", (40, 56), 2, 500),
    "xla-1d": ("xla", (64,), 2, 500),
    "xla-3d": ("xla", (6, 7, 5), 2, 500),
    "matmul": ("matmul", (40, 56), 2, 500),
}


@pytest.fixture
def spies(monkeypatch):
    """Every spied function records its name when called; returns the
    list of names."""
    fired = []
    for _, owner, names in SPIED:
        for name in names:
            real = getattr(owner, name)

            def spy(*a, _real=real, _name=name, **kw):
                fired.append(_name)
                return _real(*a, **kw)

            monkeypatch.setattr(owner, name, spy)
    return fired


def _inputs(grid, n_poses, n_points):
    fx = fixtures(seed=3, n_points=n_points, batch_size=n_poses, n_in=3,
                  n_out=len(grid))
    pts, rot, tr = (torch.from_numpy(np.asarray(fx[k], np.float32))
                    for k in ("points", "rotation", "translation"))
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (n_poses,) + grid).astype(np.float32))
    return pts, rot, tr, g


@pytest.mark.parametrize("case", list(CASES))
def test_no_host_round_trip(case, spies):
    backend, grid, n_poses, n_points = CASES[case]
    pts, rot, tr, g = _inputs(grid, n_poses, n_points)
    canon = (pts, rot, tr, torch.zeros(n_poses), torch.ones(n_poses),
             torch.ones(n_points))
    pts_req = pts.clone().requires_grad_()
    tr_req = tr.clone().requires_grad_()
    spies.clear()          # what made the inputs does not count
    out = dprast_torch.raster(grid, pts, rot, tr, backend=backend)
    grads = dprast_torch.raster_pullback(g, pts, rot, tr, backend=backend)
    loss = (dprast_torch.raster(grid, pts_req, rot, tr_req,
                                backend=backend) * g).sum()
    d_pts, d_tr = torch.autograd.grad(loss, (pts_req, tr_req))
    pair = dispatch.vjp_pair(backend)
    if pair is not None:
        out_f, res = pair[0](grid, *canon, pw_uniform=True)
        pair[1](grid, res, canon, g, pw_uniform=True)
    assert spies == [], f"host round trips inside the calls: {spies}"
    assert out.shape == (n_poses,) + grid
    assert grads.points.shape == pts.shape
    assert d_pts.shape == pts.shape and d_tr.shape == tr.shape
    if pair is not None:
        assert torch.equal(out_f, out)


def test_spies_see_the_old_forms(spies):
    """The spies fire on what the repaired sites used to run."""
    torch.tensor((128, 128), dtype=torch.float32)
    torch.bincount(torch.arange(3))
    torch.ones(2).sum().item()
    assert spies == ["tensor", "bincount", "item"]


def test_python_scalars_keep_numpy_dtypes():
    """A Python scalar becomes a 0-d tensor of the dtype numpy gives it,
    made by a fill; arrays are copied as before."""
    for value, dtype in ((1.0, torch.float64), (2, torch.int64),
                         (True, torch.bool), (np.float64(0.5), torch.float64)):
        t = api._as_tensor(value, "cpu")
        assert t.dtype == dtype and t.ndim == 0
        assert t.item() == value
    assert api._as_tensor(np.float32(1.5), "cpu").dtype == torch.float32
    assert api._as_tensor([1.0, 2.0], "cpu").dtype == torch.float64


@pytest.mark.parametrize("value", [np.float64(0.5), np.float32(1.5),
                                   np.int64(2), np.bool_(True),
                                   np.array(0.5)],
                         ids=["float64", "float32", "int64", "bool_", "0-d"])
def test_numpy_scalars_are_filled_not_copied(value, spies):
    """A numpy scalar or 0-d array background and weights are made on the
    device by a fill, with their own dtype, as Python scalars are: no
    copy from the host, which would wait for the card."""
    pts, rot, tr, _ = _inputs((16, 16), 2, 20)
    spies.clear()
    _, args, _, uniform = api._normalise(
        (16, 16), pts, rot, tr, value, value, value, None, "cpu")
    assert spies == [], f"host round trips: {spies}"
    assert uniform
    want = torch.promote_types(torch.float32, api._NUMPY_DTYPES[
        np.asarray(value).dtype])
    assert all(a.dtype == want for a in args)
    assert float(args[4][0]) == float(value)


@pytest.mark.parametrize("point_weight", [None, 1.7])
def test_defaults_keep_dtype_and_uniform_flag(point_weight):
    """Defaulted and scalar weights are weakly typed (the call stays
    float32) and still mark the point weight as uniform."""
    pts, rot, tr, _ = _inputs((16, 16), 2, 20)
    _, args, batched, uniform = api._normalise(
        (16, 16), pts, rot, tr, None, 0.5, point_weight, None, "cpu")
    assert batched and uniform
    assert all(a.dtype == torch.float32 for a in args)
    assert args[3].tolist() == [0.0, 0.0] and args[4].tolist() == [0.5, 0.5]
    want = 1.0 if point_weight is None else 1.7
    assert torch.equal(args[5], torch.full((20,), want, dtype=torch.float32))
    _, args, _, uniform = api._normalise(
        (16, 16), pts, rot, tr, None, None, torch.ones(20), None, "cpu")
    assert not uniform


@pytest.mark.parametrize("n_out", [1, 2, 3])
def test_device_constants_equal_the_numpy_tables(n_out):
    np.testing.assert_array_equal(geometry.shift_table(n_out, "cpu").numpy(),
                                  geometry.voxel_shifts(n_out))
    grid = (7, 7, 5)[:n_out]
    for dtype in (torch.float32, torch.float64):
        got = geometry.axis_values([g / 2 for g in grid], dtype, "cpu")
        assert torch.equal(got, torch.tensor(grid, dtype=dtype) / 2)
    strides = geometry.axis_values(
        [int(s) for s in geometry.flat_strides(grid)], torch.int64, "cpu")
    np.testing.assert_array_equal(strides.numpy(),
                                  geometry.flat_strides(grid))


@pytest.mark.parametrize("grid", [(300, 200), (8, 16, 200)])
def test_tile_count_and_scale_make_no_host_round_trip(grid, spies):
    """The binning sort's preparation and tile count (`slot_prep`: the
    eager chain around the ranged `histc` on the CPU, two integer kernels
    on the card), the binning sort (`bin_scatter`: `torch.sort` on the
    CPU, one integer kernel on the card) and the fixed-point splat's shift
    and sums (`_fixed_shift`, `_fixed_sums`: the kernel's function) read
    nothing back to the host."""
    from dprast_torch.ops import splat_binned as tbin
    pts, rot, tr, _ = _inputs(grid, 2, 500)
    pw = torch.from_numpy(np.random.default_rng(6).uniform(
        -2.0, 2.0, 500).astype(np.float32))
    key, _, nt = tbin._keys_and_local(grid, tbin.tile_shape_for(grid), pts,
                                      rot, tr)
    splat_args, _ = tbin._fwd_frame(grid, pts, rot, tr, pw, False)
    wmax = torch.tensor([0.0, 1.0, float("inf")])
    spies.clear()          # what made the inputs does not count
    chunk = tbin._default_chunk(grid, 500)
    bases, slot_tile, counts = tbin.slot_prep(key, nt, chunk, True)
    index = tbin.bin_scatter(key, counts, bases, nt, chunk, True, True)
    k = tbin._fixed_shift(torch.full((3,), 1000, dtype=torch.int64), wmax)
    sums, shifts, bad = tbin._fixed_sums(*splat_args)
    assert spies == [], f"host round trips: {spies}"
    assert counts.shape == (2, nt + 1) and int(counts.sum()) == 2 * 500
    assert bases.shape[0] == slot_tile.shape[0] == index.shape[0] == 2
    assert k.tolist() == [52, 52, 52]
    assert sums.dtype == torch.int64 and shifts.shape == (2, nt)


def _epilogue_round_trips(grid, uniform, spies, n_poses):
    """`pullback_epilogue` and `_epilogue_fixed_plain` at `n_poses` poses
    of 500 points read nothing back to the host."""
    from dprast_torch.ops import splat_binned as tbin
    pts, rot, tr, g = _inputs(grid, n_poses, 500)
    ow = torch.ones(n_poses)
    pw = torch.full((500,), 1.5) if uniform else torch.from_numpy(
        np.random.default_rng(6).uniform(0.5, 2.0, 500).astype(np.float32))
    caught = []

    def catch(*args, **kw):
        caught.append((args, kw))
        return tbin.pullback_epilogue(*args, **kw)

    data, slot_tile, chunk = tbin._bwd_frame(grid, pts, rot, tr)
    spies.clear()          # what made the inputs does not count
    tbin._pullback_from_frame(grid, data[:, :-1], data[:, -1], slot_tile,
                              pts, rot, ow, pw, g, chunk=chunk,
                              pw_uniform=uniform, epilogue=catch)
    args, kw = caught[0]
    fixed = tbin._epilogue_fixed_plain(*args, **kw)
    assert spies == [], f"host round trips: {spies}"
    assert fixed[0].shape == pts.shape and fixed[4].shape == (500,)


@pytest.mark.parametrize("grid", [(64, 64), (300, 200), (8, 16, 200)])
@pytest.mark.parametrize("uniform", [False, True])
def test_epilogue_makes_no_host_round_trip(grid, uniform, spies):
    """The pullback's epilogue (`pullback_epilogue`: its torch form on the
    CPU, two kernels on the card) and the kernels' function in torch
    (`_epilogue_fixed_plain`) read nothing back to the host."""
    _epilogue_round_trips(grid, uniform, spies, 2)


@pytest.mark.parametrize("grid", [(64, 64), (300, 200)])
@pytest.mark.parametrize("n_poses", [1, 9])
def test_epilogue_pose_groups_make_no_host_round_trip(grid, n_poses, spies):
    """The same at 1 and 9 poses (one pose group and eight on a single
    tile), with per-point weights."""
    _epilogue_round_trips(grid, False, spies, n_poses)


class _Library:
    """The kernel library's stand-in: every entry point is a name."""

    def __getattr__(self, name):
        return name


@pytest.fixture
def stand_in_card(monkeypatch):
    """`meta` tensors taken for tensors on a card, and each launch recorded
    by its counter's name in place of being made -> the list of names; the
    launch counters are restored afterwards."""
    from dprast_torch.ops import splat_binned as tbin
    launched = []
    counts = dict(tbin.LAUNCHES)
    monkeypatch.setattr(tbin, "_on_card", lambda t: t.device.type == "meta")
    monkeypatch.setattr(tbin, "_launch",
                        lambda name, *args: launched.append(name))
    monkeypatch.setattr(tbin._build, "load", _Library)
    yield launched
    tbin.LAUNCHES.update(counts)


@pytest.mark.parametrize("grid", [(40, 56), (64,), (6, 7, 5), (5, 4, 6, 3)],
                         ids=str)
def test_xla_kernel_wrappers_make_no_host_round_trip(grid, stand_in_card,
                                                     spies):
    """The `xla` path's wrappers on the card's side of their branch (X1
    `xla_neighbours`, X2 `xla_scatter` after the sort, X3 `xla_gather` on
    the voxel-and-deltas residuals; a stand-in card: `meta` tensors taken
    for CUDA ones, each launch recorded), through the fused pair and
    `raster_pullback`, read nothing back to the host."""
    from dprast_torch.ops import core as tcore
    n, bsz, p = len(grid), 3, 500
    meta = torch.device("meta")
    args = [torch.empty(shape, device=meta) for shape in
            ((p, n), (bsz, n, n), (bsz, n), (bsz,), (bsz,), (p,))]
    g = torch.empty((bsz,) + grid, device=meta)
    spies.clear()
    out, res = tcore.raster_fwd_res(grid, *args)
    fused = tcore.raster_pullback_res(grid, res, args, g)
    alone = tcore.raster_pullback(grid, *args, g)
    assert spies == [], f"host round trips: {spies}"
    assert stand_in_card == ["xla_neighbours", "xla_scatter", "xla_gather",
                             "xla_neighbours", "xla_gather"]
    assert out.shape == (bsz,) + grid
    assert [r.dtype for r in res] == [torch.int32, torch.float32]
    for grads in (fused, alone):
        assert [x.shape for x in grads] == [a.shape for a in args]
