"""B8, the binned pullback's epilogue, on the CPU: the unsort of B4's rows
by the point-id plane and the products and sums that finish the
gradients.

On the card `splat_binned.pullback_epilogue` launches the kernels of
`dprast_torch/csrc/epilogue.cu` (two on a single tile, three on several),
whose function bit for bit is
`_epilogue_fixed_plain` (`chip_smoke.py` [B8 epilogue] holds them to it);
CPU tensors take the torch form `_epilogue_plain`.  Here, on the same
float32 numpy inputs:
- both plain versions, driven through `_pullback_from_frame(...,
  epilogue=...)`, against the f64 oracle `raster_pullback_numpy` (1e-5
  scaled max-abs; the fast mode's 2e-2 at terms=1) and the JAX binned
  pullback through the Pallas interpreter (2e-5), on one tile, two, several
  and a volume, uniform and per-point weights, terms 0 and 1, B = 1 and 3
  (2 in 3-D), 301 points (no multiple of 4);
- the fixed order against the exact (f64) sums of the same fp32 terms
  (1e-7 scaled; measured at most 5.6e-8: it sums in fp64 and rounds once)
  and against the torch form on the same rows (1e-6 scaled beyond the
  torch form's own distance from the exact sums; measured at most
  1.06e-6, in one case of 24 (8x16x200, weighted, one pose, on both
  frames), where the torch form is itself 1.02e-6 from exact --
  everywhere else below 1e-6);
- the fixed order's sums (`_tree`, `_block_sums`; E1's `_row_sums`, E2's
  `_chunk_sums` and `_pose_group_sums`) against numpy loops in the
  kernels' order, bit for bit, E2's warp sums written as its recursive
  halving lane by lane;
- the fixed order at 1, 3 and 64 poses (E2's 1, 2 and 8 pose groups) and
  point counts that leave a chunk and a block part empty, on one tile and
  two;
- filler rows (id P) and the zero rows of dead slots move nothing, and
  every point id sits in each pose's frame exactly once, which the
  kernel's plain stores rely on;
- a NaN in the cotangent, an infinite point weight: NaN and infinities
  wherever the torch form has them;
- `pullback_epilogue` on CPU tensors is `_epilogue_plain` bit for bit.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dprast.ops import splat_binned as jbin  # noqa: E402
from dprast.utils.testing import fixtures, raster_pullback_numpy  # noqa: E402
from dprast_torch.ops import splat_binned as tbin  # noqa: E402

torch.set_num_threads(2)

# one tile, two tiles along x, several, a volume
GRIDS = {"8x128": (8, 128), "8x192": (8, 192), "300x200": (300, 200),
         "8x16x200": (8, 16, 200)}
N_POINTS = 301
FIELDS = ("points", "rotation", "translation", "background", "out_weight",
          "point_weight")
# the parity contract against the f64 oracle, the fast mode's envelope,
# and the cross-backend bound against JAX's binned pullback (its gathers
# round through a bf16 split)
TOL = {0: 1e-5, 1: 2e-2}
JAX_TOL = 2e-5
# the fixed order against the torch form on the same rows, beyond the
# torch form's own rounding, and against the exact sums of its terms
FIXED_TOL = 1e-6
EXACT_TOL = 1e-7
EPILOGUES = {"plain": tbin._epilogue_plain,
             "fixed": tbin._epilogue_fixed_plain}
UNIFORM_PW = 1.7


def _scaled_err(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(out - ref)) / max(float(np.max(np.abs(ref))),
                                                 1.0))


def _poses(grid, bsz):
    """3-D volumes run the JAX interpreter slowly: at most two poses."""
    return min(bsz, 2) if len(grid) == 3 else bsz


def _arrays(grid, uniform, bsz, seed=4, n_in=3):
    """(points, rotation, translation, background, out_weight,
    point_weight, cotangent) as float32 numpy arrays."""
    fx = fixtures(seed=seed, n_points=N_POINTS, batch_size=bsz, n_in=n_in,
                  n_out=len(grid))
    arrays = [np.asarray(v, np.float32) for v in fx.values()]
    if uniform:
        arrays[5] = np.full_like(arrays[5], UNIFORM_PW)
    g = np.random.default_rng(seed + 2).standard_normal(
        (bsz,) + grid).astype(np.float32)
    return arrays + [g]


def _weight(arrays, uniform):
    """The point weight as the API hands it to a backend: a broadcast
    scalar on the uniform path."""
    if uniform:
        return torch.tensor(UNIFORM_PW, dtype=torch.float32).expand(N_POINTS)
    return torch.from_numpy(arrays[5])


def _pullback(grid, arrays, uniform, terms, epilogue):
    """The binned pullback on the standalone pullback's frame with the
    epilogue stage `epilogue`."""
    pts, rot, tr, _, ow, _, g = map(torch.from_numpy, arrays)
    data, slot_tile, chunk = tbin._bwd_frame(grid, pts, rot, tr)
    return tbin._pullback_from_frame(
        grid, data[:, :-1], data[:, -1], slot_tile, pts, rot, ow,
        _weight(arrays, uniform), g, chunk=chunk, pw_uniform=uniform,
        terms=terms, epilogue=epilogue)


def _epilogue_args(grid, arrays, uniform, terms=0, forward=False):
    """What the pullback hands its epilogue stage on the standalone
    pullback's frame, or (`forward`) on the forward's -> (args, kw)."""
    pts, rot, tr, bg, ow, _, g = map(torch.from_numpy, arrays)
    pw = _weight(arrays, uniform)
    caught = []

    def catch(*args, **kw):
        caught.append((args, kw))
        return tbin._epilogue_plain(*args, **kw)

    if forward:
        res = tbin.raster_fwd_res(grid, pts, rot, tr, bg, ow, pw,
                                  pw_uniform=uniform, terms=terms)[1]
        coord, idx_rows, slot_tile = tbin._residual_planes(res, uniform)
        chunk = tbin._default_chunk(grid, N_POINTS)
    else:
        data, slot_tile, chunk = tbin._bwd_frame(grid, pts, rot, tr)
        coord, idx_rows = data[:, :-1], data[:, -1]
    tbin._pullback_from_frame(grid, coord, idx_rows, slot_tile, pts, rot, ow,
                              pw, g, chunk=chunk, pw_uniform=uniform,
                              terms=terms, epilogue=catch)
    return caught[0]


def _exact(grid, buf, idx_rows, points, rotation, out_weight, point_weight,
           *, pw_uniform):
    """The epilogue as the exact sums (float64) of the torch form's fp32
    terms ``scaled = (du * (g/2)) * (ow * pw)`` and ``gw``."""
    n_out = len(grid)
    p = points.shape[0]
    halo = not tbin._single_tile(grid)
    per = tbin._unsort(buf, idx_rows, p) if halo else buf[:, :, :p]
    scale = torch.tensor([g / 2 for g in grid], dtype=torch.float32)
    s = ((per[:, :n_out] * scale[None, :, None])
         * (out_weight[:, None, None] * point_weight[None, None, :])).double()
    gw = per[:, n_out].double()
    ow, pw = out_weight.double(), point_weight.double()
    if pw_uniform and halo:
        sums = buf[:, n_out].double().sum(-1)
        d_ow, d_pw = sums * pw[0], (sums @ ow / p).repeat(p)
    else:
        d_ow, d_pw = gw @ pw, ow @ gw
    return (torch.einsum("bns,bni->si", s, rotation.double()),
            torch.einsum("bns,si->bni", s, points.double()), s.sum(-1),
            d_ow, d_pw)


@functools.lru_cache(maxsize=None)
def _jax_pullback(grid, uniform, terms, bsz):
    arrays = _arrays(grid, uniform, bsz)
    kw = {} if terms == 0 else {"terms": terms}
    res = jbin.raster_pullback(grid, *map(jnp.asarray, arrays),
                               pw_uniform=uniform, **kw)
    return {name: np.asarray(getattr(res, name)) for name in FIELDS}


CASES = [(grid, form, terms, bsz) for grid in GRIDS
         for form in ("uniform", "weighted") for terms in (0, 1)
         for bsz in (1, 3) if bsz == 3 or terms == 0]


@pytest.mark.parametrize("grid,form,terms,bsz", CASES)
def test_epilogues_match_oracle_and_jax(grid, form, terms, bsz):
    """All six gradients through either epilogue against the f64 oracle
    and JAX's binned pullback, which takes the same branch; on the uniform
    path d_pw is held to the oracle by its sum (its contract; JAX's summed
    d_pw carries its bf16-split gathers' error into the sum, 3.2e-5 at
    8x128)."""
    size = GRIDS[grid]
    bsz = _poses(size, bsz)
    uniform = form == "uniform"
    arrays = _arrays(size, uniform, bsz)
    ref_np = raster_pullback_numpy(size, *arrays)
    ref_j = _jax_pullback(size, uniform, terms, bsz)
    for name, epilogue in EPILOGUES.items():
        res = _pullback(size, arrays, uniform, terms, epilogue)
        for field in FIELDS:
            out = getattr(res, field).numpy()
            assert out.dtype == np.float32 and out.shape == np.shape(
                ref_np[field]), (name, field)
            assert _scaled_err(out, ref_j[field]) < JAX_TOL, (name, field)
            ref = ref_np[field]
            if uniform and field == "point_weight":
                out, ref = out.sum(), ref.sum()
            assert _scaled_err(out, ref) < TOL[terms], (name, field)


@pytest.mark.parametrize("forward", [False, True],
                         ids=["standalone-frame", "forward-frame"])
@pytest.mark.parametrize("grid,form,terms,bsz", CASES)
def test_fixed_order_matches_torch_form(grid, form, terms, bsz, forward):
    """The kernels' order of summation against the exact sums of the same
    terms and against the torch form, on the same B4 rows of the
    standalone pullback's frame and of the forward's."""
    size = GRIDS[grid]
    uniform = form == "uniform"
    arrays = _arrays(size, uniform, bsz)
    args, kw = _epilogue_args(size, arrays, uniform, terms, forward)
    fixed = tbin._epilogue_fixed_plain(*args, **kw)
    plain = tbin._epilogue_plain(*args, **kw)
    for a, b, x in zip(fixed, plain, _exact(*args, **kw)):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
        assert _scaled_err(a.numpy(), x.numpy()) < EXACT_TOL
        assert _scaled_err(a.numpy(), b.numpy()) < FIXED_TOL + _scaled_err(
            b.numpy(), x.numpy())


@pytest.mark.parametrize("n_in", [4, 5])
@pytest.mark.parametrize("form", ["uniform", "weighted"])
@pytest.mark.parametrize("grid", ["8x128", "300x200", "8x16x200"])
def test_any_number_of_input_axes(grid, form, n_in):
    """Points of 4 or 5 input axes, which the kernels take in their
    runtime-n_in instance (n_in 2 and 3 are unrolled): both plain forms
    through the pullback against the f64 oracle, and the fixed order
    against the exact sums of its terms and the torch form."""
    size = GRIDS[grid]
    uniform = form == "uniform"
    arrays = _arrays(size, uniform, _poses(size, 3), n_in=n_in)
    ref_np = raster_pullback_numpy(size, *arrays)
    for name, epilogue in EPILOGUES.items():
        res = _pullback(size, arrays, uniform, 0, epilogue)
        for field in FIELDS:
            out, ref = getattr(res, field).numpy(), ref_np[field]
            assert out.shape == np.shape(ref), (name, field)
            if uniform and field == "point_weight":
                out, ref = out.sum(), ref.sum()
            assert _scaled_err(out, ref) < TOL[0], (name, field)
    args, kw = _epilogue_args(size, arrays, uniform)
    assert args[3].shape == (N_POINTS, n_in)
    plain = tbin._epilogue_plain(*args, **kw)
    for a, b, x in zip(tbin._epilogue_fixed_plain(*args, **kw), plain,
                       _exact(*args, **kw)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert _scaled_err(a.numpy(), x.numpy()) < EXACT_TOL
        assert _scaled_err(a.numpy(), b.numpy()) < FIXED_TOL + _scaled_err(
            b.numpy(), x.numpy())


def _kernel_order(x, per_thread):
    """`_block_sums` written as the kernels run it, one float32 add at a
    time: per block, thread t adds its elements t, t + 256, ... (+0 past
    the end), lanes add lane + 16, + 8, .. + 1, then the eight warp sums
    + 4, + 2, + 1."""
    span = 256 * per_thread
    n_blk = -(-x.size // span)
    x = np.concatenate([x, np.zeros(n_blk * span - x.size, x.dtype)])
    out = []
    for q in range(n_blk):
        threads = []
        for t in range(256):
            acc = x[q * span + t]
            for m in range(1, per_thread):
                acc = x.dtype.type(acc + x[q * span + m * 256 + t])
            threads.append(acc)
        warps = []
        for w in range(8):
            lanes = threads[32 * w:32 * w + 32]
            for off in (16, 8, 4, 2, 1):
                lanes = [x.dtype.type(lanes[i] + lanes[i + off])
                         for i in range(off)]
            warps.append(lanes[0])
        for off in (4, 2, 1):
            warps = [x.dtype.type(warps[i] + warps[i + off])
                     for i in range(off)]
        out.append(warps[0])
    return np.array(out, x.dtype)


@pytest.mark.parametrize("n,per_thread", [(1, 4), (1000, 4), (3000, 4),
                                          (300, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_block_sums_are_the_kernels_order(n, per_thread, dtype):
    """`_block_sums` adds in the kernels' order, bit for bit, on values of
    mixed sign and size (whose sum depends on the order)."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)).astype(
        dtype)
    got = tbin._block_sums(torch.from_numpy(x), per_thread).numpy()
    np.testing.assert_array_equal(got, _kernel_order(x, per_thread))


def _off_grid_arrays(grid, bsz=3):
    """A cloud whose first ten points leave the grid in every pose (their
    frame rows are dead-slot rows on several tiles)."""
    arrays = _arrays(grid, False, bsz, seed=9)
    arrays[0][:10] += 50.0
    return arrays


@pytest.mark.parametrize("grid", ["8x192", "300x200", "8x16x200"])
@pytest.mark.parametrize("forward", [False, True],
                         ids=["standalone-frame", "forward-frame"])
def test_every_point_once_per_pose(grid, forward):
    """On several tiles each pose's id plane names every point exactly
    once (the no-overlap points in dead slots) and fillers carry P: the
    epilogue kernel stores each point's row through it with no zero fill
    first."""
    size = GRIDS[grid]
    arrays = _off_grid_arrays(size)
    args, _ = _epilogue_args(size, arrays, False, forward=forward)
    ids = args[2].long()
    for b in range(ids.shape[0]):
        real = ids[b][ids[b] < N_POINTS]
        assert torch.equal(torch.sort(real).values, torch.arange(N_POINTS))
        assert bool((ids[b][ids[b] >= N_POINTS] == N_POINTS).all())


@pytest.mark.parametrize("grid", ["8x192", "300x200", "8x16x200"])
@pytest.mark.parametrize("form", ["uniform", "weighted"])
def test_fillers_and_dead_slots_move_nothing(grid, form):
    """NaN in the filler rows (id P) changes no bit of either epilogue,
    and the points off the grid, whose rows B4 zeroes, get exact zeros.
    (The torch form's uniform path sums the whole gw plane, fillers
    included, where B4 wrote zeros: there only the du planes are
    poisoned for it; the fixed order reads no filler row at all.)"""
    size = GRIDS[grid]
    uniform = form == "uniform"
    arrays = _off_grid_arrays(size)
    if uniform:
        arrays[5] = np.full_like(arrays[5], UNIFORM_PW)
    args, kw = _epilogue_args(size, arrays, uniform)
    buf, idx_rows = args[1], args[2]
    filler = (idx_rows == N_POINTS)[:, None]
    n_du = len(size)
    planes = torch.arange(buf.shape[1])[None, :, None]
    for name, epilogue in EPILOGUES.items():
        poison = filler if name == "fixed" or not uniform else \
            filler & (planes < n_du)
        dirty = torch.where(poison, float("nan"), buf)
        assert bool(torch.isnan(dirty).any())
        clean = epilogue(*args, **kw)
        for a, b in zip(clean, epilogue(args[0], dirty, *args[2:], **kw)):
            assert torch.equal(a, b), name
        d_points, _, _, _, d_pw = clean
        assert not bool(d_points[:10].any())
        if not uniform:
            assert not bool(d_pw[:10].any())


@pytest.mark.parametrize("grid", list(GRIDS))
def test_nan_cotangent_lands_where_the_torch_form_puts_it(grid):
    """A NaN on a pixel that points touch: the fixed order gives NaN in
    exactly the entries where the torch form does, and the finite ones
    within `FIXED_TOL`."""
    size = GRIDS[grid]
    arrays = _arrays(size, False, 3)
    pts, rot, tr, bg, ow, pw, _ = map(torch.from_numpy, arrays)
    img = tbin.raster_fwd(size, pts, rot, tr, bg, ow, pw)[1]
    arrays[6][1].reshape(-1)[int(img.argmax())] = np.nan
    args, kw = _epilogue_args(size, arrays, False)
    n_nan = 0
    for a, b in zip(tbin._epilogue_fixed_plain(*args, **kw),
                    tbin._epilogue_plain(*args, **kw)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        fin = torch.isfinite(b)
        assert _scaled_err(a[fin].numpy(), b[fin].numpy()) < FIXED_TOL
        n_nan += int(torch.isnan(a).sum())
    assert n_nan > 0


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("form", ["uniform", "weighted"])
def test_cpu_wrapper_is_the_torch_form(grid, form):
    """`pullback_epilogue` on CPU tensors runs `_epilogue_plain`, bit for
    bit, and counts no launch."""
    size = GRIDS[grid]
    uniform = form == "uniform"
    args, kw = _epilogue_args(size, _arrays(size, uniform, 3), uniform)
    before = dict(tbin.LAUNCHES)
    for a, b in zip(tbin.pullback_epilogue(*args, **kw),
                    tbin._epilogue_plain(*args, **kw)):
        assert torch.equal(a, b)
    assert tbin.LAUNCHES == before


def _warp_scatter_loop(vals, off=16):
    """The kernels' `warp_scatter` written lane by lane: `vals` (32, N) ->
    {value index: its warp sum} as the lanes hold them.  At offset `off`
    each lane keeps half of its values (the lower half where its `off` bit
    is clear), adds its partner's copy and passes the rest on; a pad of an
    odd count is 0 and ends in no result."""
    lanes = [[(i, v) for i, v in enumerate(row)] for row in vals]
    while off:
        n = len(lanes[0])
        h = (n + 1) // 2
        nxt = []
        for lane in range(32):
            mine, theirs = lanes[lane], lanes[lane ^ off]
            if n == 1:
                keep = [(mine[0][0], mine[0][1] + theirs[0][1])]
            else:
                pad = [(None, vals.dtype.type(0))] * (2 * h - n)
                mine, theirs = mine + pad, theirs + pad
                half = slice(h, 2 * h) if lane & off else slice(0, h)
                keep = [(i, a + b) for (i, a), (_, b) in
                        zip(mine[half], theirs[half])]
            nxt.append(keep)
        lanes, off = nxt, off // 2
    out = {}
    for lane in lanes:
        (i, v), = lane
        if i is not None:
            assert out.setdefault(i, v) == v or np.isnan(v)
    return out


def _chunk_order(x, groups):
    """`_chunk_sums` as E2 runs it: per block of 8 / groups chunks of 128
    points, lane l adds its points 4 l .. 4 l + 3 of its chunk in order (+0
    past P), `_warp_scatter_loop` adds the lanes, and the block's chunks
    add in chunk order.  `x` (K, P) -> (K, n_blk)."""
    k, n = x.shape
    cpb = 8 // groups
    n_blk = -(-n // (cpb * 128))
    x = np.concatenate([x, np.zeros((k, n_blk * cpb * 128 - n), x.dtype)], 1)
    out = np.zeros((k, n_blk), x.dtype)
    for q in range(n_blk):
        chunks = []
        for c in range(cpb):
            base = (q * cpb + c) * 128
            lanes = []
            for lane in range(32):
                acc = x[:, base + 4 * lane].copy()
                for r in range(1, 4):
                    acc = acc + x[:, base + 4 * lane + r]
                lanes.append(acc)
            sums = _warp_scatter_loop(np.stack(lanes))
            chunks.append(np.array([sums[i] for i in range(k)], x.dtype))
        acc = chunks[0]
        for c in range(1, cpb):
            acc = acc + chunks[c]
        out[:, q] = acc
    return out


def _row_order(x):
    """`_row_sums` as E1 runs it: per block of 1,024 frame rows thread t
    adds rows t, t + 256, t + 512, t + 768 in order (+0 past the end),
    each warp adds its lanes (`_warp_scatter_loop`) and the eight warp
    sums add in warp order.  `x` (K, n) -> (K, n_blk)."""
    k, n = x.shape
    n_blk = -(-n // 1024)
    x = np.concatenate([x, np.zeros((k, n_blk * 1024 - n), x.dtype)], 1)
    out = np.zeros((k, n_blk), x.dtype)
    for q in range(n_blk):
        warps = []
        for w in range(8):
            lanes = []
            for lane in range(32):
                t = 32 * w + lane
                acc = x[:, q * 1024 + t].copy()
                for m in range(1, 4):
                    acc = acc + x[:, q * 1024 + 256 * m + t]
                lanes.append(acc)
            sums = _warp_scatter_loop(np.stack(lanes))
            warps.append(np.array([sums[i] for i in range(k)], x.dtype))
        acc = warps[0]
        for w in range(1, 8):
            acc = acc + warps[w]
        out[:, q] = acc
    return out


def _mixed(rng, shape, dtype=np.float64):
    """Values of mixed sign and size, whose sum depends on the order."""
    return (rng.standard_normal(shape)
            * 10.0 ** rng.integers(-6, 7, shape)).astype(dtype)


@pytest.mark.parametrize("kind,size", [
    ("rows", 1), ("rows", 1024), ("rows", 5000),
    ("chunks-1", 301), ("chunks-1", 2100), ("chunks-2", 1000),
    ("chunks-4", 1029), ("chunks-8", 128), ("chunks-8", 301),
    ("chunks-8", 1000), ("pose-groups", 1), ("pose-groups", 3),
    ("pose-groups", 9), ("pose-groups", 64)])
def test_e1_e2_sums_are_the_kernels_order(kind, size):
    """The sums of the redesigned E1 and E2 in `_epilogue_fixed_plain`
    against numpy loops in the kernels' order, bit for bit, on values of
    mixed sign and size: E1's sums over the frame rows of a pose
    (`_row_sums`: nine terms of `size` rows), the single tile's sums over
    the points of a pose (`_chunk_sums`: nine terms of `size` points, with
    1, 2, 4 or 8 pose groups, which set the chunks a block adds) and its sums over the poses of a point
    (`_pose_group_sums`: `size` poses of two terms, in the pose groups
    `_pose_groups` picks for a single tile)."""
    rng = np.random.default_rng(size)
    if kind == "rows":
        x = _mixed(rng, (9, size))
        got = tbin._row_sums(torch.from_numpy(x)).numpy()
        want = _row_order(x)
    elif kind.startswith("chunks"):
        groups = int(kind.split("-")[1])
        x = _mixed(rng, (9, size))
        got = tbin._chunk_sums(torch.from_numpy(x), groups).numpy()
        want = _chunk_order(x, groups)
    else:
        groups = tbin._pose_groups(size)
        assert groups == min(8, 2 ** int(np.log2(size)))
        t = _mixed(rng, (size, 2, 5))
        got = tbin._pose_group_sums(torch.from_numpy(t), groups).numpy()
        want = np.zeros(5)
        for j in range(5):
            total = None
            for g in range(groups):
                lo, hi = g * size // groups, (g + 1) * size // groups
                terms = [t[b, i, j] for b in range(lo, hi) for i in range(2)]
                acc = terms[0]
                for v in terms[1:]:
                    acc = acc + v
                total = acc if total is None else total + acc
            want[j] = total
    np.testing.assert_array_equal(got, want)


# the single tile (8x128: E2 on B4's rows) and two tiles (8x192: E1's
# copy); 1, 3 and 64 poses take 1, 2 and 8 pose groups; 301 and 1,029
# points are no multiple of a chunk (128) nor of a one-group block (1,024)
FUSED_CASES = [(grid, bsz, p) for grid in ("8x128", "8x192")
               for bsz in (1, 3, 64) for p in (301, 1029)]


@pytest.mark.parametrize("grid,bsz,n_points", FUSED_CASES)
@pytest.mark.parametrize("form", ["uniform", "weighted"])
def test_pose_groups_and_ragged_chunks(grid, bsz, n_points, form):
    """The kernels' order at 1, 3 and 64 poses and point counts that leave
    a chunk and a block part empty: the pullback through the fixed order
    against the f64 oracle, and the fixed order against the exact sums of
    its terms and the torch form on the same rows.  The uniform path's
    d_pw is held to the exact sum of B4's gw rows only: at one pose of
    8x192 and 301 points its sum is 1.16e-5 scaled from the oracle through
    the fixed order (7.2e-6 through the torch form), B4's fp32 rows
    summed under cancellation, which no order of the epilogue's sums
    removes."""
    size = GRIDS[grid]
    uniform = form == "uniform"
    fx = fixtures(seed=bsz, n_points=n_points, batch_size=bsz, n_in=3,
                  n_out=2)
    arrays = [np.asarray(v, np.float32) for v in fx.values()]
    if uniform:
        arrays[5] = np.full_like(arrays[5], UNIFORM_PW)
    arrays.append(np.random.default_rng(bsz + 2).standard_normal(
        (bsz,) + size).astype(np.float32))
    pts, rot, tr, _, ow, pw, g = map(torch.from_numpy, arrays)
    if uniform:
        pw = torch.tensor(UNIFORM_PW).expand(n_points)
    caught = []

    def catch(*args, **kw):
        caught.append((args, kw))
        return tbin._epilogue_fixed_plain(*args, **kw)

    data, slot_tile, chunk = tbin._bwd_frame(size, pts, rot, tr)
    res = tbin._pullback_from_frame(
        size, data[:, :-1], data[:, -1], slot_tile, pts, rot, ow, pw, g,
        chunk=chunk, pw_uniform=uniform, epilogue=catch)
    ref = raster_pullback_numpy(size, *arrays)
    for field in FIELDS:
        if not (uniform and field == "point_weight"):
            assert _scaled_err(getattr(res, field).numpy(),
                               ref[field]) < TOL[0], field
    args, kw = caught[0]
    plain = tbin._epilogue_plain(*args, **kw)
    for a, b, x in zip(tbin._epilogue_fixed_plain(*args, **kw), plain,
                       _exact(*args, **kw)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert _scaled_err(a.numpy(), x.numpy()) < EXACT_TOL
        assert _scaled_err(a.numpy(), b.numpy()) < FIXED_TOL + _scaled_err(
            b.numpy(), x.numpy())


@pytest.mark.parametrize("grid", list(GRIDS))
def test_infinite_weight_lands_where_the_torch_form_puts_it(grid):
    """An infinite point weight: the fixed order gives NaN and infinities
    in exactly the entries where the torch form does, and the finite ones
    within `FIXED_TOL`."""
    size = GRIDS[grid]
    arrays = _arrays(size, False, 3)
    arrays[5][N_POINTS // 3] = np.inf
    args, kw = _epilogue_args(size, arrays, False)
    n_bad = 0
    for a, b in zip(tbin._epilogue_fixed_plain(*args, **kw),
                    tbin._epilogue_plain(*args, **kw)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.isinf(a), torch.isinf(b))
        fin = torch.isfinite(b)
        if bool(fin.any()):
            assert _scaled_err(a[fin].numpy(), b[fin].numpy()) < FIXED_TOL
        n_bad += int((~torch.isfinite(a)).sum())
    assert n_bad > 0
