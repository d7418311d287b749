"""What repeats bit for bit in dprast_torch, on the CPU.

On the card B1 sums each window in 64-bit fixed point, so its sum does not
depend on the order in which its atomics land, on the cluster size or on
the run; `splat_binned._fwd_splat_fixed_plain` is that function bit for
bit (`chip_smoke.py` [B1 clusters] holds the kernel to it on the card).
The CPU's path keeps the fp32 twin `_fwd_splat_plain`, whose bits are
pinned in `tests/test_torch_bf16.py`.  Here, on the same float32 numpy
inputs:
- the fixed-point version against the fp32 twin (within 1e-6 scaled: the
  twin's own fp32 rounding) and against JAX's B1 stage through the Pallas
  interpreter (within `tests/test_torch_bf16.py`'s 1e-5), in 2-D on one
  tile and several and in 3-D, terms 0 and 1, uniform, positive and
  signed weights;
- its sum against a permutation of the rows within each tile: the same
  bits;
- a crafted worst case, every row on one pixel with |w| = max|w|, against
  the exact integer sum: no overflow;
- the shift helper `_fixed_shift` at 0, subnormal, large and non-finite
  max|w|, against its closed form;
- NaN and infinite weights: where the fp32 twin puts them;
- the tile count's plain version (the ranged `histc`; B9, `slot_prep`,
  counts with integer atomics on the card) against `np.bincount`, and
  `slot_prep`'s counts against it;
- every entry point under ``torch.use_deterministic_algorithms(True)``,
  twice, to the same bits.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dprast_torch  # noqa: E402
from dprast.ops import splat_binned as jbin  # noqa: E402
from dprast.utils.testing import fixtures  # noqa: E402
from dprast_torch.ops import dispatch  # noqa: E402
from dprast_torch.ops import splat_binned as tbin  # noqa: E402
from dprast_torch.parallel import make_mesh, raster_sharded  # noqa: E402

torch.set_num_threads(2)

# a single tile, a multi-tile strip, a small volume
GRIDS = [(8, 8), (8, 192), (8, 16, 200)]
IDS = ["x".join(map(str, g)) for g in GRIDS]
WEIGHTS = ("uniform", "positive", "signed")
# the fixed-point sum against the fp32 twin's frame-order sum (scaled
# max-abs): the twin's own rounding
FP32_TOL = 1e-6
# against JAX's B1 stage: the same rounded products, summed apart
# (`tests/test_torch_bf16.py::test_b1_twin_matches_jax_stage`)
JAX_TOL = 1e-5
# the JAX kernels' bf16 split that represents every fp32 value, for terms=0
EXACT_SPLIT = 3


def _scaled_err(out, ref):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(out.astype(np.float64) - ref))
                 / max(float(np.max(np.abs(ref))), 1.0))


def _args(grid, weights="positive"):
    """Six float32 arrays: 3 poses x 300 points in 2-D, 2 x 200 in 3-D;
    the point weights as `weights` asks."""
    n_out = len(grid)
    fx = fixtures(seed=7, n_points=300 if n_out == 2 else 200,
                  batch_size=3 if n_out == 2 else 2, n_in=3, n_out=n_out)
    args = [np.asarray(v, np.float32) for v in fx.values()]
    if weights == "uniform":
        args[5] = np.ones_like(args[5])
    elif weights == "signed":
        signs = np.random.default_rng(5).choice([-1.0, 1.0], args[5].shape)
        args[5] = (args[5] * signs).astype(np.float32)
    return args


def _frame(grid, args, weights):
    pts, rot, tr, _, _, pw = map(torch.from_numpy, args)
    splat_args, _ = tbin._fwd_frame(grid, pts, rot, tr, pw,
                                    weights == "uniform")
    return splat_args


def _jax_ext(grid, args, weighted, terms, monkeypatch):
    """JAX's B1 windows: `raster_fwd` through the interpreter, with the
    fold's input captured."""
    seen = []
    jbin_fold = jbin._fold

    def fold(ext, *rest):
        seen.append(np.asarray(ext))
        return jbin_fold(ext, *rest)

    monkeypatch.setattr(jbin, "_fold", fold)
    jbin.raster_fwd(grid, *map(jnp.asarray, args), pw_uniform=not weighted,
                    terms=terms)
    monkeypatch.setattr(jbin, "_fold", jbin_fold)
    (ext,) = seen
    return ext


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("terms", [0, 1])
@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_fixed_point_matches_fp32_twin_and_jax(grid, terms, weights,
                                               monkeypatch):
    args = _args(grid, weights)
    splat_args = _frame(grid, args, weights)
    fixed = tbin._fwd_splat_fixed_plain(*splat_args, terms=terms)
    twin = tbin._fwd_splat_plain(*splat_args, terms=terms)
    assert fixed.shape == twin.shape and fixed.dtype == torch.float32
    assert _scaled_err(fixed, twin) < FP32_TOL
    ref = _jax_ext(grid, args, weights != "uniform",
                   EXACT_SPLIT if terms == 0 else terms, monkeypatch)
    assert fixed.shape == ref.shape
    err = _scaled_err(fixed, ref)
    assert err < JAX_TOL, f"fixed-point B1 vs JAX, terms={terms}: {err:.3e}"


def _shuffled_within_tiles(splat_args, seed):
    """The frame's lane planes with the rows of each (pose, tile)'s live
    slots permuted at random among themselves (dead rows stay)."""
    slot_tile, lane, nt, win, chunk = splat_args
    n_slots = slot_tile.shape[1] - 1
    tile = torch.repeat_interleave(slot_tile[:, :n_slots].long(), chunk,
                                   dim=1)
    live = torch.repeat_interleave(
        torch.arange(n_slots) < slot_tile[:, n_slots:], chunk, dim=1)
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy(rng.uniform(0.0, 0.5, tile.shape))
    # a live row keeps its tile's stretch of the frame, a dead row its place
    order = torch.where(live, tile.double() + noise,
                        nt + torch.arange(tile.shape[1]).double())
    perm = torch.argsort(order, dim=1, stable=True)
    assert not torch.equal(perm, torch.arange(tile.shape[1]).expand_as(perm))
    shuffled = torch.gather(lane, 2, perm[:, None, :].expand_as(lane))
    return (slot_tile, shuffled.contiguous(), nt, win, chunk)


@pytest.mark.parametrize("weights", ["uniform", "signed"])
@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_fixed_point_sum_ignores_row_order(grid, weights):
    """Integer sums do not depend on the order of their terms: rows
    permuted within each tile give the same bits (in 3-D the slots of a
    tile hold many rows; the fp32 twin's sum moves with the order)."""
    args = _args(grid, weights)
    splat_args = _frame(grid, args, weights)
    shuffled = _shuffled_within_tiles(splat_args, seed=len(grid))
    for terms in (0, 1):
        a = tbin._fixed_sums(*splat_args, terms=terms)
        b = tbin._fixed_sums(*shuffled, terms=terms)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert torch.equal(
            tbin._fwd_splat_fixed_plain(*splat_args, terms=terms),
            tbin._fwd_splat_fixed_plain(*shuffled, terms=terms))


def _one_pixel_frame(n_points, w, chunk=128):
    """A single tile's lane planes (8 x 8 window) whose `n_points` rows all
    put their whole weight `w` on pixel (4, 5): dl = 1 on both axes puts
    the hats (0, 1) on (3, 4) and (4, 5).  The frame's last rows are
    fillers."""
    s_pad = -(-n_points // chunk) * chunk
    lane = torch.zeros((1, 5, s_pad))
    real = torch.arange(s_pad) < n_points
    for plane, value, fill in ((0, 3.0, -3.0), (1, 1.0, 0.0), (2, w, 0.0),
                               (3, 1.0, 0.0), (4, 4.0, -3.0)):
        lane[0, plane] = torch.where(real, value, fill)
    n_slots = s_pad // chunk
    slot_tile = torch.tensor([[0] * n_slots + [n_slots]], dtype=torch.int32)
    return slot_tile, lane, 1, (8, 8), chunk


@pytest.mark.parametrize("w", [1.0, -7.5, 1e30, 3.0e38])
def test_worst_case_does_not_overflow(w):
    """Every row on one pixel with |w| = max|w| at P = 10^5: the integer
    sum is the exact P q, and the stored value its one rounding."""
    n_points = 100_000
    frame = _one_pixel_frame(n_points, w)
    sums, k, bad = tbin._fixed_sums(*frame)
    rows = frame[1].shape[2]
    wmax = torch.tensor([abs(w)], dtype=torch.float32)
    assert int(k) == int(tbin._fixed_shift(torch.tensor([rows]), wmax)[0])
    # the term is exact: |w| 2^k is an integer below 2^62 / rows
    q = math.ldexp(float(np.float32(w)), int(k))
    assert q == int(q) and abs(q) * rows <= 2 ** 62
    total = n_points * int(q)
    assert int(sums[0, 0, 4, 5]) == total
    assert int(sums.abs().sum()) == abs(total)
    assert not bool(bad.any())
    ext = tbin._fwd_splat_fixed_plain(*frame)
    want = torch.tensor(total, dtype=torch.int64).to(torch.float32) \
        * tbin._pow2(-k.reshape(()))
    assert torch.equal(ext[0, 0, 4, 5], want)
    # the fp32 twin agrees where its own sum is exact (and overflows alike)
    twin = tbin._fwd_splat_plain(*frame)
    if abs(w) <= 1.0:
        assert torch.equal(ext, twin)
    assert bool(torch.isinf(ext).any()) == bool(torch.isinf(twin).any())


def _ceil_log2(x):
    """ceil(log2 x) for a positive finite float, exactly."""
    m, e = math.frexp(x)
    return e - 1 if m == 0.5 else e


@pytest.mark.parametrize("wmax,rows", [
    (1.0, 100_000), (0.75, 100_000), (1.5, 100_000), (0.0, 100_000),
    (1e-40, 10), (2.0 ** -149, 1), (2.0 ** -127, 7), (3.0e38, 1_000_000),
    (float("inf"), 100_000), (float("nan"), 100_000), (1.0, 2 ** 17),
    (1.0, 2 ** 17 - 1)],
    ids=["one", "three-quarters", "one-and-a-half", "zero", "subnormal",
         "least-subnormal", "subnormal-power", "large", "inf", "nan",
         "rows-power", "rows-below-power"])
def test_fixed_shift(wmax, rows):
    """The shift of a (pose, tile): the largest k with rows max|w| 2^k <
    2^62 from the closed form, 0 in place of log2 max|w| where max|w| is 0
    or not finite, clamped to [-126, 126]."""
    w32 = float(np.float32(wmax))
    k = int(tbin._fixed_shift(torch.tensor([rows]),
                              torch.tensor([w32], dtype=torch.float32))[0])
    e = _ceil_log2(w32) if math.isfinite(w32) and w32 > 0 else 0
    want = max(-126, min(126, 62 - rows.bit_length() - e))
    assert k == want
    assert -126 <= k <= 126
    if math.isfinite(w32) and w32 > 0 and -126 < want < 126:
        assert rows * w32 * 2.0 ** k < 2.0 ** 62
        assert rows * w32 * 2.0 ** (k + 1) >= 2.0 ** 61
    if wmax == 1.0 and rows == 100_000:
        assert k == 45   # the flagship: each term off by at most 2^-46
    # a power of two is exact
    assert float(tbin._pow2(torch.tensor([k]))[0]) == 2.0 ** k


@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_nonfinite_weights_land_where_the_fp32_twin_puts_them(grid):
    """A NaN, an infinite and a negative infinite weight make every pixel
    they touch NaN or infinite, as the fp32 twin does; every other pixel
    stays finite and close."""
    args = _args(grid)
    args[5][:3] = [np.nan, np.inf, -np.inf]
    splat_args = _frame(grid, args, "positive")
    for terms in (0, 1):
        fixed = tbin._fwd_splat_fixed_plain(*splat_args, terms=terms)
        twin = tbin._fwd_splat_plain(*splat_args, terms=terms)
        assert bool(torch.isnan(twin).any()) and bool(torch.isinf(twin).any())
        assert torch.equal(torch.isnan(fixed), torch.isnan(twin))
        assert torch.equal(torch.isposinf(fixed), torch.isposinf(twin))
        assert torch.equal(torch.isneginf(fixed), torch.isneginf(twin))
        fin = torch.isfinite(twin)
        assert _scaled_err(fixed[fin], twin[fin]) < FP32_TOL


# (grid, poses, points) of the main path's three shapes
COUNT_SHAPES = [((128, 128), 64, 100_000), ((1024, 1024), 64, 100_000),
                ((128, 128, 128), 1, 1_000_000)]


@pytest.mark.parametrize("grid,n_poses,n_points", COUNT_SHAPES,
                         ids=["128sq", "1024sq", "128cube"])
def test_tile_count_plain_matches_bincount(grid, n_poses, n_points):
    """The ranged `histc` of (pose, tile) bins against `np.bincount` per
    pose, on keys of every tile and the no-tile sentinel at the main
    path's shapes (a skewed draw: a dense centre as the clouds have), and
    on the keys of a real cloud."""
    nt = tbin.n_tiles(grid)
    rng = np.random.default_rng(len(grid))
    centre = rng.normal(nt / 2, max(nt / 8, 1), (n_poses, n_points))
    key = np.clip(np.round(centre), 0, nt).astype(np.int32)
    key[:, :nt + 1] = np.arange(nt + 1)
    got = tbin._tile_count_plain(torch.from_numpy(key), nt)
    assert got.dtype == torch.int32 and got.shape == (n_poses, nt + 1)
    want = np.stack([np.bincount(k, minlength=nt + 1) for k in key])
    np.testing.assert_array_equal(got.numpy(), want)
    chunk = tbin._default_chunk(grid, n_points)
    assert torch.equal(tbin.slot_prep(torch.from_numpy(key), nt, chunk, True,
                                      False)[2], got)
    # the keys B6's twin gives a small cloud at this grid
    fx = fixtures(seed=3, n_points=2000, batch_size=2, n_in=3,
                  n_out=len(grid))
    pts, rot, tr = (torch.from_numpy(np.asarray(fx[k], np.float32))
                    for k in ("points", "rotation", "translation"))
    key_t, _, nt_t = tbin._keys_and_local_plain(
        grid, tbin.tile_shape_for(grid), pts, rot, tr)
    want = np.stack([np.bincount(k, minlength=nt_t + 1)
                     for k in key_t.numpy()])
    np.testing.assert_array_equal(
        tbin._tile_count_plain(key_t, nt_t).numpy(), want)


def _epilogue_args(grid, weights, bsz):
    """What the binned pullback hands its epilogue on the standalone
    pullback's frame, `bsz` poses of 401 points -> (args, kw)."""
    fx = fixtures(seed=5, n_points=401, batch_size=bsz, n_in=3,
                  n_out=len(grid))
    pts, rot, tr, _, ow, pw = (torch.from_numpy(np.asarray(v, np.float32))
                               for v in fx.values())
    uniform = weights == "uniform"
    if uniform:
        pw = torch.full_like(pw, 1.5)
    else:
        pw = pw - 1.2
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (bsz,) + grid).astype(np.float32))
    caught = []

    def catch(*args, **kw):
        caught.append((args, kw))
        return tbin._epilogue_plain(*args, **kw)

    data, slot_tile, chunk = tbin._bwd_frame(grid, pts, rot, tr)
    tbin._pullback_from_frame(grid, data[:, :-1], data[:, -1], slot_tile,
                              pts, rot, ow, pw, g, chunk=chunk,
                              pw_uniform=uniform, epilogue=catch)
    return caught[0]


def _fixed_order_repeats(args, kw):
    """`_epilogue_fixed_plain` twice, the second under
    ``torch.use_deterministic_algorithms(True)``: the same bits, within
    1e-6 scaled of the torch form."""
    first = tbin._epilogue_fixed_plain(*args, **kw)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        second = tbin._epilogue_fixed_plain(*args, **kw)
    finally:
        torch.use_deterministic_algorithms(was)
    for a, b, c in zip(first, second, tbin._epilogue_plain(*args, **kw)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert _scaled_err(a, c) <= FP32_TOL


@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
@pytest.mark.parametrize("weights", ("uniform", "signed"))
def test_epilogue_fixed_order_repeats(grid, weights):
    """The pullback epilogue's kernel function (`_epilogue_fixed_plain`,
    every sum in a fixed order: `csrc/epilogue.cu` on the card) gives the
    same bits twice, under ``torch.use_deterministic_algorithms(True)``
    too, and stays within 1e-6 scaled of the torch form."""
    _fixed_order_repeats(*_epilogue_args(grid, weights, 3))


@pytest.mark.parametrize("grid", GRIDS[:2], ids=IDS[:2])
@pytest.mark.parametrize("bsz", (1, 5, 9))
def test_epilogue_fixed_order_repeats_in_pose_groups(grid, bsz):
    """The same at 1, 5 and 9 poses, which a single tile's kernel splits
    into 1, 4 and 8 pose groups, with signed weights."""
    _fixed_order_repeats(*_epilogue_args(grid, "signed", bsz))


@pytest.fixture
def deterministic():
    """torch's deterministic mode on for the test, then as it was."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


# (backend, grid, poses, points): `auto` on one tile, several and a
# volume, and every backend by name (`xla` at ranks 1-3)
DET_CASES = {
    "auto-one-tile": ("auto", (64, 64), 2, 500),
    "auto-multi-tile": ("auto", (300, 200), 2, 500),
    "auto-3d": ("auto", (8, 16, 200), 2, 300),
    "binned": ("binned", (300, 200), 2, 500),
    "binned_bf16": ("binned_bf16", (300, 200), 2, 500),
    "xla": ("xla", (40, 56), 2, 500),
    "xla-1d": ("xla", (64,), 2, 500),
    "xla-3d": ("xla", (6, 7, 5), 2, 500),
    "matmul": ("matmul", (40, 56), 2, 500),
    "matmul_bf16": ("matmul_bf16", (40, 56), 2, 500),
}


def _twice(fn):
    """`fn` run twice -> both results as flat lists of tensors."""
    def flat(r):
        return [r.detach()] if isinstance(r, torch.Tensor) else [
            t for x in r for t in flat(x)]
    return flat(fn()), flat(fn())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", list(DET_CASES))
def test_entry_points_repeat_under_deterministic_mode(case, weighted,
                                                      deterministic):
    """The forward, `raster_pullback`, the autograd step of all six
    inputs, the fused pair and (through `auto`) `raster_sharded` on the
    1 x 1 mesh run under ``torch.use_deterministic_algorithms(True)`` and
    give the same bits twice."""
    backend, grid, n_poses, n_points = DET_CASES[case]
    fx = fixtures(seed=3, n_points=n_points, batch_size=n_poses, n_in=3,
                  n_out=len(grid))
    canon = [torch.from_numpy(np.asarray(v, np.float32)) for v in fx.values()]
    pw = canon[5] if weighted else None
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (n_poses,) + grid).astype(np.float32))

    def step():
        leaves = [t.clone().requires_grad_() for t in canon[:5]]
        if weighted:
            leaves.append(pw.clone().requires_grad_())
        out = dprast_torch.raster(grid, *leaves[:5],
                                  point_weight=leaves[5] if weighted
                                  else None, backend=backend, device="cpu")
        return (out, *torch.autograd.grad((out * g).sum(), leaves))

    calls = {
        "forward": lambda: dprast_torch.raster(
            grid, *canon[:5], point_weight=pw, backend=backend,
            device="cpu"),
        "raster_pullback": lambda: dprast_torch.raster_pullback(
            g, *canon[:5], point_weight=pw, backend=backend, device="cpu"),
        "autograd step": step}
    pair = dispatch.vjp_pair(dispatch.resolve(backend, len(grid), grid,
                                              n_points))
    if pair is not None:
        args = canon if weighted else canon[:5] + [torch.ones(n_points)]

        def fused():
            out, res = pair[0](grid, *args, pw_uniform=not weighted)
            return out, pair[1](grid, res, args, g, pw_uniform=not weighted)

        calls["fused pair"] = fused
    if backend == "auto":
        mesh = make_mesh()
        calls["raster_sharded"] = lambda: raster_sharded(
            grid, *canon[:5], pw, mesh=mesh)
    for name, fn in calls.items():
        first, second = _twice(fn)
        assert len(first) == len(second) >= 1, name
        for a, b in zip(first, second):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    assert torch.are_deterministic_algorithms_enabled()
