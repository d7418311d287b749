"""dprast_torch's binned backend vs the JAX package on the same float32
numpy inputs, stage by stage (slot frame, lane planes, fold, unfold,
unsort: bit-equal) and as a whole (forward and pullback within 1e-5
scaled max-abs of the f64 oracle and of the JAX backend, which runs its
Pallas kernels through the interpreter here).

On the CPU the kernel wrappers run their plain twins; the CUDA kernels
themselves are checked against the twins by `chip_smoke.py` on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dprast_torch  # noqa: E402
from dprast.ops import splat_binned as jbin  # noqa: E402
from dprast.utils.testing import (  # noqa: E402
    fixtures, raster_numpy, raster_pullback_numpy)
from dprast_torch.ops import splat_binned as tbin  # noqa: E402

torch.set_num_threads(2)


def _raster(*args, **kw):
    """`dprast_torch.raster` on the CPU (the entry points default to the
    card)."""
    return dprast_torch.raster(*args, device="cpu", **kw)


def _raster_pullback(*args, **kw):
    """`dprast_torch.raster_pullback` on the CPU."""
    return dprast_torch.raster_pullback(*args, device="cpu", **kw)

# the parity contract of the faithful backends (max-abs error scaled by
# max(|reference|, 1)), as in tests_tpu/test_hardware_parity.py
TOL = 1e-5


def _scaled_err(out, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(out, np.float64) - ref))
                 / max(float(np.max(np.abs(ref))), 1.0))


def _f32(fx):
    return [np.asarray(v, np.float32) for v in fx.values()]


def _frame_planes(grid, pts, rot, tr, pw, weighted):
    """The forward's pre-sort planes (coords, optional weight, point id)
    and fills, with the tile keys."""
    ts = tbin.tile_shape_for(grid)
    key, locs, nt = tbin._keys_and_local(
        grid, ts, torch.from_numpy(pts), torch.from_numpy(rot),
        torch.from_numpy(tr))
    b, p = key.shape
    planes = list(locs)
    fills = [0.0] * len(grid)
    if weighted:
        planes.append(torch.from_numpy(pw)[None].expand(b, p))
        fills.append(0.0)
    planes.append(torch.arange(p, dtype=torch.float32)[None].expand(b, p))
    fills.append(float(p))
    return key, planes, fills, nt


def _sparse_cloud():
    rng = np.random.default_rng(8)
    pts = (rng.standard_normal((50, 2)) * 0.02 + 0.5).astype(np.float32)
    rot = np.tile(np.eye(2, dtype=np.float32), (2, 1, 1))
    tr = (rng.standard_normal((2, 2)) * 0.01).astype(np.float32)
    return (512, 512), pts, rot, tr, np.ones(50, np.float32)


def _random_cloud(grid=(300, 200), n_points=700):
    pts, rot, tr, _, _, pw = _f32(fixtures(seed=11, n_points=n_points,
                                           batch_size=3, n_in=3, n_out=2))
    return grid, pts, rot, tr, pw


def _volume_cloud(grid=(9, 17, 130), n_points=300):
    pts, rot, tr, _, _, pw = _f32(fixtures(seed=11, n_points=n_points,
                                           batch_size=2, n_in=3, n_out=3))
    return grid, pts, rot, tr, pw


FRAMES = {
    "packed": (_random_cloud, True, True),
    "payload": (_random_cloud, False, True),
    "payload-uniform": (_random_cloud, False, False),
    "sparse-packed": (_sparse_cloud, True, False),
    "sparse-payload": (_sparse_cloud, False, True),
    "3d-packed": (_volume_cloud, True, False),
    "3d-payload": (_volume_cloud, False, True),
}


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_prep_binned_frame_bit_equal(case):
    make, pack_idx, weighted = FRAMES[case]
    grid, pts, rot, tr, pw = make()
    key, planes, fills, nt = _frame_planes(grid, pts, rot, tr, pw, weighted)
    chunk = 128
    data, slot_tile = tbin._prep_binned(key, planes, fills, nt, chunk, True,
                                        pack_idx=pack_idx)
    assert data.dtype == torch.float32 and slot_tile.dtype == torch.int32
    for b in range(key.shape[0]):
        j_data, j_st = jbin._prep_binned(
            jnp.asarray(key[b].numpy()),
            [jnp.asarray(pl_[b].numpy()) for pl_ in planes], fills, nt,
            chunk, True, pack_idx=pack_idx)
        np.testing.assert_array_equal(data[b].numpy().view(np.int32),
                                      np.asarray(j_data).view(np.int32))
        np.testing.assert_array_equal(slot_tile[b].numpy(), np.asarray(j_st))


def test_prep_direct_and_lane_planes_bit_equal():
    fx = fixtures(seed=3, n_points=300, batch_size=3, n_in=3, n_out=2)
    grid, pts, rot, tr, pw = (128, 128), *_f32(fx)[:3], _f32(fx)[5]
    for weighted in (False, True):
        key, planes, fills, _ = _frame_planes(grid, pts, rot, tr, pw,
                                              weighted)
        data, slot_tile = tbin._prep_direct(planes, fills, 1024)
        j_data, j_st = jax.vmap(
            lambda *pls: jbin._prep_direct(list(pls), fills, 1024))(
                *(jnp.asarray(pl_.numpy()) for pl_ in planes))
        np.testing.assert_array_equal(data.numpy().view(np.int32),
                                      np.asarray(j_data).view(np.int32))
        np.testing.assert_array_equal(slot_tile.numpy(), np.asarray(j_st))
        w = data[:, 2] if weighted else None
        lane = tbin._planes_fwd(data[:, :2], w)
        j_lane = jbin._planes_fwd(j_data[:, :2],
                                  j_data[:, 2] if weighted else None,
                                  (128, 128), 2)
        assert lane.shape == (3, 5 if weighted else 4, 1024)
        np.testing.assert_array_equal(lane.numpy().view(np.int32),
                                      np.asarray(j_lane).view(np.int32))


@pytest.mark.parametrize("weighted", [False, True])
def test_lane_planes_multi_tile_bit_equal(weighted):
    grid, pts, rot, tr, pw = _random_cloud()
    key, planes, fills, nt = _frame_planes(grid, pts, rot, tr, pw, weighted)
    data, _ = tbin._prep_binned(key, planes, fills, nt, 128, True,
                                pack_idx=True)
    lane = tbin._planes_fwd(data[:, :2], data[:, 2] if weighted else None)
    jd = jnp.asarray(data.numpy())
    j_lane = jbin._planes_fwd(jd[:, :2], jd[:, 2] if weighted else None,
                              tbin.tile_shape_for(grid), 2)
    np.testing.assert_array_equal(lane.numpy().view(np.int32),
                                  np.asarray(j_lane).view(np.int32))


@pytest.mark.parametrize("grid", [(256, 256), (300, 200)])
def test_fold_bit_equal(grid):
    ts = tbin.tile_shape_for(grid)
    nt = tbin.n_tiles(grid)
    ext = np.random.default_rng(1).standard_normal(
        (2, nt, ts[0] + 1, ts[1] + 1)).astype(np.float32)
    out = tbin._fold(torch.from_numpy(ext), grid, ts, True)
    ref = jbin._fold(jnp.asarray(ext), grid, ts, True)
    assert out.shape == (2,) + grid
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # the B2 wrapper on a CPU tensor is the fold plus the epilogue
    ow = torch.tensor([2.0, 0.5])
    bg = torch.tensor([0.25, -1.0])
    folded = tbin.band_fold(torch.from_numpy(ext), grid, ts, ow, bg)
    np.testing.assert_array_equal(
        folded.numpy(), np.asarray(ref) * ow.numpy()[:, None, None]
        + bg.numpy()[:, None, None])


def test_fwd_splat_twin_matches_loop():
    """B1's twin against a per-row loop over the live slots."""
    grid, pts, rot, tr, pw = _random_cloud(n_points=200)
    key, planes, fills, nt = _frame_planes(grid, pts, rot, tr, pw, True)
    data, slot_tile = tbin._prep_binned(key, planes, fills, nt, 128, True,
                                        pack_idx=True)
    lane = tbin._planes_fwd(data[:, :2], data[:, 2])
    ext = tbin.fwd_splat(slot_tile, lane, nt, (128, 128), 128).numpy()
    ref = np.zeros_like(ext, dtype=np.float64)
    ln, st = lane.numpy().astype(np.float64), slot_tile.numpy()
    for b in range(ln.shape[0]):
        for row in range(st[b, -1] * 128):
            iy0, dly, w, dlx, ix0 = ln[b, :, row]
            for r, hy in ((int(iy0), 1 - dly), (int(iy0) + 1, dly)):
                for c, cx in ((int(ix0), 1 - dlx), (int(ix0) + 1, dlx)):
                    if 0 <= r < 128 and 0 <= c < 128:
                        ref[b, st[b, row // 128], r, c] += hy * w * cx
    assert _scaled_err(ext, ref) < 1e-6


RASTER_CASES = {
    # name: (grid, weighted, single pose, points spread past the grid)
    "128sq": ((128, 128), False, False, False),
    "128sq-weighted": ((128, 128), True, False, False),
    "256sq": ((256, 256), False, False, False),
    "256sq-weighted": ((256, 256), True, False, False),
    "300x200": ((300, 200), False, False, False),
    "300x200-weighted": ((300, 200), True, False, False),
    "256sq-single-pose-outside": ((256, 256), True, True, True),
}


@pytest.mark.parametrize("case", list(RASTER_CASES))
def test_raster_binned_matches_jax_and_oracle(case):
    grid, weighted, single, outside = RASTER_CASES[case]
    fx = fixtures(seed=4, n_points=400, batch_size=3, n_in=3, n_out=2)
    pts, rot, tr, bg, ow, pw = _f32(fx)
    if outside:
        pts = pts * 7.0     # most points land off the grid
    if not weighted:
        pw = np.ones_like(pw)
    if single:
        rot, tr, bg, ow = rot[:1], tr[:1], bg[:1], ow[:1]
    jargs = [jnp.asarray(a) for a in (pts, rot, tr, bg, ow, pw)]
    ref_jax = np.asarray(jbin.raster_fwd(grid, *jargs,
                                         pw_uniform=not weighted))
    ref_f64 = raster_numpy(grid, *(a.astype(np.float64)
                                   for a in (pts, rot, tr, bg, ow, pw)))
    if single:
        out = _raster(grid, pts, rot[0], tr[0], float(bg[0]),
                                  float(ow[0]), pw if weighted else None,
                                  backend="binned")
        assert out.shape == grid
        out = out[None]
    else:
        out = _raster(grid, pts, rot, tr, bg, ow,
                                  pw if weighted else None, backend="binned")
    assert out.dtype == torch.float32 and out.shape == ref_f64.shape
    assert _scaled_err(out.numpy(), ref_jax) < TOL
    assert _scaled_err(out.numpy(), ref_f64) < TOL
    assert _scaled_err(ref_jax, ref_f64) < TOL


@pytest.mark.parametrize("grid", [(5, 5), (1, 1), (3, 200), (130, 1)])
def test_raster_binned_edge_grids_match_oracle(grid):
    """A tiny single tile, a one-voxel grid, a one-row strip and a
    one-column multi-tile grid."""
    args = _f32(fixtures(seed=9, n_points=300, batch_size=2, n_in=3,
                         n_out=2))
    out = _raster(grid, *args, backend="binned")
    ref = raster_numpy(grid, *(a.astype(np.float64) for a in args))
    assert _scaled_err(out.numpy(), ref) < TOL


DISPATCH_GRIDS = [((128, 128), 100_000), ((1024, 1024), 100_000),
                  ((1024, 1024), 10_000), ((64, 64), 1000), ((256, 256), 10),
                  ((300, 200), None), ((10_000, 10_000), 5),
                  ((128, 128, 128), 100_000), ((1024, 1024, 1024), 100_000),
                  ((200,), 10)]


def test_host_rules_match():
    """Tile shapes, chunks and the support / profitability rules agree with
    the JAX package, so both pick the same backend."""
    for grid, p in DISPATCH_GRIDS:
        n = len(grid)
        assert tbin.supported(n, grid, p) == jbin.supported(n, grid, p)
        assert tbin.profitable(n, grid, p) == jbin.profitable(n, grid, p)
        if n in (2, 3):
            assert tbin.tile_shape_for(grid) == jbin.tile_shape_for(grid)
            assert tbin.n_tiles(grid) == jbin.n_tiles(grid)
            assert tbin._single_tile(grid) == jbin._single_tile(grid)
            assert tbin._default_chunk(grid, p) == jbin._default_chunk(grid,
                                                                       p)
    assert tbin._slot_frame_size(1000, 9, 128) == \
        jbin._slot_frame_size(1000, 9, 128)


# ---------------------------------------------------------------------------
# 3-D grids
# ---------------------------------------------------------------------------


def test_flat_rows_3d_bit_equal():
    """The four flat stencil rows, -9 where z or y leaves the window."""
    rng = np.random.default_rng(2)
    iz0 = rng.integers(-3, 9, 500).astype(np.int32)
    iy0 = rng.integers(-3, 17, 500).astype(np.int32)
    ts = tbin.tile_shape_for((128, 128, 128))
    rows = tbin._flat_rows_3d(torch.from_numpy(iz0), torch.from_numpy(iy0),
                              ts)
    j_rows, _ = jbin._flat_rows_3d(jnp.asarray(iz0), jnp.zeros(500),
                                   jnp.asarray(iy0), jnp.zeros(500), ts)
    assert len(rows) == 4
    for r, j in zip(rows, j_rows):
        assert r.dtype == torch.float32
        np.testing.assert_array_equal(r.numpy(), np.asarray(j))
    assert (rows[3].numpy() == -9).any() and (rows[0].numpy() >= 0).any()


@pytest.mark.parametrize("weighted", [False, True])
def test_lane_planes_3d_bit_equal(weighted):
    grid, pts, rot, tr, pw = _volume_cloud()
    key, planes, fills, nt = _frame_planes(grid, pts, rot, tr, pw, weighted)
    data, _ = tbin._prep_binned(key, planes, fills, nt, 128, True,
                                pack_idx=True)
    ts = tbin.tile_shape_for(grid)
    lane = tbin._planes_fwd(data[:, :3], data[:, 3] if weighted else None)
    lane_b = tbin._planes_bwd(data[:, :3], ts)
    jd = jnp.asarray(data.numpy())
    j_lane = jbin._planes_fwd(jd[:, :3], jd[:, 3] if weighted else None,
                              ts, 3)
    j_lane_b = jbin._planes_bwd(jd[:, :3], ts, 3)
    assert lane.shape[1] == (7 if weighted else 6) and lane_b.shape[1] == 8
    np.testing.assert_array_equal(lane.numpy().view(np.int32),
                                  np.asarray(j_lane).view(np.int32))
    np.testing.assert_array_equal(lane_b.numpy().view(np.int32),
                                  np.asarray(j_lane_b).view(np.int32))


@pytest.mark.parametrize("grid", [(8, 16, 200), (128, 128, 128)])
def test_fold_unfold_3d_bit_equal(grid):
    """The plain fold and unfold, which the 3-D forward and pullback run,
    against JAX's (the unfold through a transpose), and adjoint."""
    ts = tbin.tile_shape_for(grid)
    nt = tbin.n_tiles(grid)
    rng = np.random.default_rng(1)
    ext = rng.standard_normal((2, nt, 128, 128)).astype(np.float32)
    out = tbin._fold(torch.from_numpy(ext), grid, ts, True)
    assert out.shape == (2,) + grid
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jbin._fold(jnp.asarray(ext), grid, ts,
                                           True)))
    u = rng.standard_normal((2,) + grid).astype(np.float32)
    win = tbin._unfold(torch.from_numpy(u), grid, ts)
    ref = jbin._unfold(jnp.asarray(u), grid, ts, transposed=True)
    assert win.shape == (2, nt, 128, 128)
    np.testing.assert_array_equal(win.numpy(),
                                  np.asarray(jnp.swapaxes(ref, -1, -2)))
    x = torch.from_numpy(ext).double()
    np.testing.assert_allclose(
        np.vdot(u.astype(np.float64), tbin._fold(x, grid, ts, True).numpy()),
        np.vdot(win.double().numpy(), x.numpy()), rtol=1e-12)


def _edge_volume():
    """A 3-D cloud on (16, 16, 16) (six tiles) with points just below the
    grid's lower y edge in every z plane of a tile, so that frame rows
    with ``iy0 = -1`` and ``iz0 >= 1`` occur (a flat-row bound check
    would alias them into the z plane below), points off the grid, and
    filler rows."""
    rng = np.random.default_rng(3)
    pts = (rng.standard_normal((160, 3)) * 0.5).astype(np.float32)
    # u = (q + 1) * 8 - 1/2 in (-1, 0) on the y axis
    pts[:40, 1] = rng.uniform(-1.06, -1.0, 40)
    rot = np.stack([np.eye(3, dtype=np.float32),
                    np.eye(3, dtype=np.float32)[[0, 2, 1]]])
    tr = np.zeros((2, 3), np.float32)
    pw = rng.uniform(0.5, 2.0, 160).astype(np.float32)
    return (16, 16, 16), pts, rot, tr, pw


def _live_rows(slot_tile, chunk):
    """(b, row, tile) of every row of a live slot."""
    st = slot_tile.numpy()
    for b in range(st.shape[0]):
        for row in range(st[b, -1] * chunk):
            yield b, row, st[b, row // chunk]


@pytest.mark.parametrize("weighted", [False, True])
def test_fwd_splat_twin_3d_matches_loop(weighted):
    """B1's 3-D twin against a per-row loop that masks each axis."""
    grid, pts, rot, tr, pw = _edge_volume()
    key, planes, fills, nt = _frame_planes(grid, pts, rot, tr, pw, weighted)
    data, slot_tile = tbin._prep_binned(key, planes, fills, nt, 128, True,
                                        pack_idx=True)
    lane = tbin._planes_fwd(data[:, :3], data[:, 3] if weighted else None)
    ext = tbin.fwd_splat(slot_tile, lane, nt, (8, 16, 128), 128).numpy()
    ref = np.zeros(ext.shape, np.float64)
    ln = lane.numpy().astype(np.float64)
    aliasing = 0
    for b, row, tile in _live_rows(slot_tile, 128):
        iz0, dlz, iy0, dly = ln[b, :4, row]
        w = ln[b, 4, row] if weighted else 1.0
        dlx, ix0 = ln[b, -2:, row]
        aliasing += iy0 == -1 and iz0 >= 1
        for z, hz in ((int(iz0), 1 - dlz), (int(iz0) + 1, dlz)):
            for y, hy in ((int(iy0), 1 - dly), (int(iy0) + 1, dly)):
                for x, cx in ((int(ix0), 1 - dlx), (int(ix0) + 1, dlx)):
                    if 0 <= z < 8 and 0 <= y < 16 and 0 <= x < 128:
                        ref[b, tile, z * 16 + y, x] += hz * hy * w * cx
    assert aliasing > 0
    assert (ln[:, 0] == -3).any()                     # filler rows
    assert _scaled_err(ext, ref) < 1e-6


def test_bwd_gather_twin_3d_matches_loop():
    """B4's 3-D twin against a per-row loop over the decoded (z, y, x)
    stencil; rows of dead slots are zeros."""
    grid, pts, rot, tr, _ = _edge_volume()
    data, slot_tile, chunk = tbin._bwd_frame(
        grid, *(torch.from_numpy(a) for a in (pts, rot, tr)))
    ts = tbin.tile_shape_for(grid)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2,) + grid).astype(np.float32))
    win = tbin._unfold(g, grid, ts)
    buf = tbin.bwd_gather(slot_tile, tbin._planes_bwd(data[:, :3], ts), win,
                          chunk).numpy()
    assert buf.shape == (2, 4, data.shape[-1])
    w4 = win.double().numpy()
    dec = [[v.double().numpy() for v in tbin._decode_coord(data[:, i])]
           for i in range(3)]
    ref = np.zeros(buf.shape, np.float64)
    for b, row, tile in _live_rows(slot_tile, chunk):
        (iz0, dlz), (iy0, dly), (ix0, dlx) = [(int(r[b, row]), d[b, row])
                                              for r, d in dec]

        def at(z, y, x):
            ok = 0 <= z < 8 and 0 <= y < 16 and 0 <= x < 128
            return w4[b, tile, z * 16 + y, x] if ok else 0.0

        p = np.array([[[at(iz0 + sz, iy0 + sy, ix0 + sx) for sx in (0, 1)]
                       for sy in (0, 1)] for sz in (0, 1)])
        hz, hy, hx = ([1 - d, d] for d in (dlz, dly, dlx))
        ref[b, :, row] = (
            sum(hy[sy] * hx[sx] * (p[1, sy, sx] - p[0, sy, sx])
                for sy in (0, 1) for sx in (0, 1)),
            sum(hz[sz] * hx[sx] * (p[sz, 1, sx] - p[sz, 0, sx])
                for sz in (0, 1) for sx in (0, 1)),
            sum(hz[sz] * hy[sy] * (p[sz, sy, 1] - p[sz, sy, 0])
                for sz in (0, 1) for sy in (0, 1)),
            sum(hz[sz] * hy[sy] * hx[sx] * p[sz, sy, sx]
                for sz in (0, 1) for sy in (0, 1) for sx in (0, 1)))
    assert _scaled_err(buf, ref) < 1e-6
    st = slot_tile.numpy()
    for b in range(2):
        assert not buf[b, :, st[b, -1] * chunk:].any()


VOLUMES = [(8, 16, 128), (16, 16, 16), (9, 17, 130)]
VOLUME_IDS = ["x".join(map(str, g)) for g in VOLUMES]


def _volume_args(n_points=300):
    return _f32(fixtures(seed=6, n_points=n_points, batch_size=2, n_in=3,
                         n_out=3))


@pytest.mark.parametrize("grid", VOLUMES, ids=VOLUME_IDS)
@pytest.mark.parametrize("weighted", [False, True])
def test_raster_binned_3d_matches_jax_and_oracle(grid, weighted):
    """The 3-D forward through `raster` against the f64 oracle (1e-5) and
    the JAX binned backend (2e-5: its splat rounds through a two-term
    bf16 split, about 3e-6 from the oracle here)."""
    pts, rot, tr, bg, ow, pw = _volume_args()
    if not weighted:
        pw = np.ones_like(pw)
    jargs = [jnp.asarray(a) for a in (pts, rot, tr, bg, ow, pw)]
    ref_jax = np.asarray(jbin.raster_fwd(grid, *jargs,
                                         pw_uniform=not weighted))
    ref_f64 = raster_numpy(grid, *(a.astype(np.float64)
                                   for a in (pts, rot, tr, bg, ow, pw)))
    out = _raster(grid, pts, rot, tr, bg, ow,
                              pw if weighted else None, backend="binned")
    assert out.dtype == torch.float32 and out.shape == ref_f64.shape
    assert _scaled_err(out.numpy(), ref_f64) < TOL
    assert _scaled_err(out.numpy(), ref_jax) < 2e-5


@pytest.mark.parametrize("grid", VOLUMES, ids=VOLUME_IDS)
@pytest.mark.parametrize("form", ["weighted", "uniform", "scalar"])
def test_pullback_binned_3d_matches_jax_and_oracle(grid, form):
    """All six 3-D gradients of the public `raster_pullback` against the
    f64 oracle (1e-5) and the JAX binned pullback (2e-5): a per-point
    weight, a defaulted one (exact per-point d_pw) and a scalar 1.7 (the
    uniform path, summed d_pw)."""
    pts, rot, tr, bg, ow, pw = _volume_args()
    w = {"weighted": pw, "uniform": None, "scalar": 1.7}[form]
    pw_full = np.broadcast_to(np.float32(1.0 if w is None else w),
                              pw.shape) if form != "weighted" else pw
    g = np.random.default_rng(6).standard_normal((2,) + grid).astype(
        np.float32)
    res = _raster_pullback(g, pts, rot, tr, bg, ow, w,
                                       backend="binned")
    arrays = (pts, rot, tr, bg, ow, np.ascontiguousarray(pw_full), g)
    ref_j = jbin.raster_pullback(grid, *map(jnp.asarray, arrays),
                                 pw_uniform=form == "scalar")
    ref_np = raster_pullback_numpy(grid, *arrays)
    for name in ref_np:
        out, ref, ref_jn = (getattr(res, name).numpy(), ref_np[name],
                            np.asarray(getattr(ref_j, name)))
        if form == "scalar" and name == "point_weight":
            ref, ref_jn = ref.sum(), ref_jn.sum()
        assert out.shape == np.shape(ref), name
        assert _scaled_err(out, ref) < TOL, name
        assert _scaled_err(out, ref_jn) < 2e-5, name


def test_wrappers_run_the_twin_only_on_cpu():
    """A tensor on neither the CPU nor a CUDA device is refused, never
    copied to the CPU twin."""
    lane = torch.zeros((1, 4, 128), device="meta")
    st = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbin.fwd_splat(st, lane, 1, (8, 8), 128)
    ext = torch.zeros((1, 4, 128, 128), device="meta")
    ow = torch.ones((1,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbin.band_fold(ext, (200, 200), (127, 127), ow, ow)
    with pytest.raises(ValueError, match="CUDA"):
        tbin.band_unfold(torch.zeros((1, 200, 200), device="meta"),
                         (200, 200), (127, 127))
    with pytest.raises(ValueError, match="CUDA"):
        tbin.bwd_gather(st, lane, ext, 128)
    with pytest.raises(ValueError, match="CUDA"):
        tbin.fwd_splat(st, torch.zeros((1, 6, 128), device="meta"), 1,
                       (8, 16, 128), 128)
    with pytest.raises(ValueError, match="CUDA"):
        tbin.bwd_gather(st, torch.zeros((1, 8, 128), device="meta"), ext,
                        128)
    with pytest.raises(ValueError, match="CUDA"):
        tbin.bwd_gather(st, lane, ext, 128, terms=2, layout="transposed")
    with pytest.raises(ValueError, match="CUDA"):
        tbin.bwd_gather(st, lane, (ext.bfloat16(), ext.bfloat16()), 128,
                        terms=2, layout="presplit")
    with pytest.raises(ValueError, match="CUDA"):
        tbin.fwd_splat(st, lane, 1, (8, 8), 128, terms=1)
    with pytest.raises(ValueError, match="CUDA"):
        tbin.bwd_gather(st, lane, torch.zeros((1, 200, 200), device="meta"),
                        128, layout="grid")
    # the main path's instances, which read the frame, and its writers
    frame = torch.zeros((1, 3, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbin.fwd_splat_enc(st, frame, 1, (8, 8), 128)
    with pytest.raises(ValueError, match="CUDA"):
        tbin.bwd_gather_enc(st, frame[:, :2], (8, 8), ext, 128)
    with pytest.raises(ValueError, match="CUDA"):
        tbin.frame_gather(torch.zeros((1, 128), dtype=torch.int64,
                                      device="meta"), [frame[0]] * 2, None)
    with pytest.raises(ValueError, match="CUDA"):
        tbin.direct_frame((8, 8), (8, 8), *(
            torch.zeros(shape, device="meta")
            for shape in ((10, 3), (1, 2, 3), (1, 2))), None, 128)
    with pytest.raises(ValueError, match="CUDA"):
        tbin.slot_prep(torch.zeros((1, 128), dtype=torch.int32,
                                   device="meta"), 4, 128, True)
    with pytest.raises(ValueError, match="CUDA"):
        tbin.bin_scatter(*(torch.zeros(shape, dtype=torch.int32,
                                       device="meta")
                           for shape in ((1, 128), (1, 5), (1, 1, 5))),
                         4, 128, True, True)
    # the pullback's epilogue (B8)
    with pytest.raises(ValueError, match="CUDA"):
        tbin.pullback_epilogue((200, 200), frame, frame[:, -1], *(
            torch.zeros(shape, device="meta")
            for shape in ((10, 3), (1, 2, 3), (1,), (10,))))
    # the `xla` path's kernels X1-X3 (`core`), which count here too
    from dprast_torch.ops import core as tcore
    pts, rot, tr = (torch.zeros(shape, device="meta")
                    for shape in ((10, 3), (1, 2, 3), (1, 2)))
    w1, w10 = torch.ones((1,), device="meta"), torch.ones((10,),
                                                           device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tcore.xla_neighbours((8, 8), pts, rot, tr, w1, w10)
    with pytest.raises(ValueError, match="CUDA"):
        tcore.xla_scatter(w1, (8, 8), torch.zeros(40, dtype=torch.int32,
                                                  device="meta"),
                          torch.zeros(40, dtype=torch.int64, device="meta"),
                          torch.zeros(40, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tcore.xla_gather((8, 8), torch.zeros((1, 8, 8), device="meta"), (
            torch.zeros((1, 10, 2), dtype=torch.int32, device="meta"),
            torch.zeros((1, 10, 2), device="meta")), w1, w10)
    # every CUDA instance has a counter, and none counted here
    assert tbin.LAUNCHES == {
        "xla_neighbours": 0, "xla_scatter": 0, "xla_gather": 0,
        "coords": 0, "slot_prep": 0, "bin_scatter": 0, "epilogue_tile": 0,
        "epilogue_rows": 0, "epilogue_points": 0, "epilogue_poses": 0,
        "fwd_splat": 0, "band_fold": 0,
        "band_unfold": 0, "bwd_gather": 0,
        "fwd_splat_3d": 0, "bwd_gather_3d": 0, "fwd_splat_bf16": 0,
        "fwd_splat_3d_bf16": 0, "bwd_gather_bf16": 0,
        "bwd_gather_3d_bf16": 0, "bwd_gather_split": 0,
        "bwd_gather_split_t": 0, "bwd_gather_presplit": 0,
        "bwd_gather_grid": 0, "bwd_gather_grid_bf16": 0,
        "bwd_gather_grid_ldg": 0, "bwd_gather_grid_bf16_ldg": 0,
        "frame_gather": 0, "fwd_splat_enc": 0, "fwd_splat_3d_enc": 0,
        "fwd_splat_bf16_enc": 0, "fwd_splat_3d_bf16_enc": 0,
        "bwd_gather_enc": 0, "bwd_gather_3d_enc": 0,
        "bwd_gather_bf16_enc": 0, "bwd_gather_3d_bf16_enc": 0,
        "bwd_gather_grid_enc": 0, "bwd_gather_grid_bf16_enc": 0,
        "bwd_gather_grid_enc_ldg": 0, "bwd_gather_grid_bf16_enc_ldg": 0}


# ---------------------------------------------------------------------------
# the pullback
# ---------------------------------------------------------------------------


def test_planes_bwd_bit_equal():
    grid, pts, rot, tr, pw = _random_cloud()
    key, planes, fills, nt = _frame_planes(grid, pts, rot, tr, pw, False)
    data, _ = tbin._prep_binned(key, planes, fills, nt, 128, False,
                                pack_idx=True)
    lane_b = tbin._planes_bwd(data[:, :2], tbin.tile_shape_for(grid))
    j_lane = jbin._planes_bwd(jnp.asarray(data[:, :2].numpy()),
                              tbin.tile_shape_for(grid), 2)
    assert lane_b.shape == (3, 4, data.shape[-1])
    np.testing.assert_array_equal(lane_b.numpy().view(np.int32),
                                  np.asarray(j_lane).view(np.int32))


@pytest.mark.parametrize("grid", [(300, 200), (8, 192)])
def test_unfold_bit_equal_and_adjoint(grid):
    """B3's twin is JAX's `_unfold` in the natural orientation (JAX's
    kernel consumes it transposed), and the exact adjoint of the fold."""
    ts = tbin.tile_shape_for(grid)
    nt = tbin.n_tiles(grid)
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2,) + grid).astype(np.float32)
    win = tbin._unfold(torch.from_numpy(u), grid, ts)
    ref = jbin._unfold(jnp.asarray(u), grid, ts, transposed=True)
    assert win.shape == (2, nt, ts[0] + 1, ts[1] + 1)
    np.testing.assert_array_equal(win.numpy(),
                                  np.asarray(jnp.swapaxes(ref, -1, -2)))
    # the B3 wrapper on a CPU tensor is the twin
    assert torch.equal(tbin.band_unfold(torch.from_numpy(u), grid, ts), win)
    x = rng.standard_normal((2, nt, ts[0] + 1, ts[1] + 1))
    lhs = np.vdot(u.astype(np.float64),
                  tbin._fold(torch.from_numpy(x), grid, ts, True).numpy())
    rhs = np.vdot(win.double().numpy(), x)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize("weighted", [False, True])
def test_unsort_bit_equal_to_jax_sort(weighted):
    """The scatter by point id gives JAX's unsort (a sort by the id
    plane) bit for bit; fillers carry id p and are cut off."""
    grid, pts, rot, tr, pw = _random_cloud()
    key, planes, fills, nt = _frame_planes(grid, pts, rot, tr, pw, weighted)
    data, _ = tbin._prep_binned(key, planes, fills, nt, 128, True,
                                pack_idx=True)
    p = pts.shape[0]
    idx_rows = data[:, -1]
    rows = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 3, data.shape[-1])).astype(np.float32))
    out = tbin._unsort(rows, idx_rows, p)
    ops = jax.lax.sort((jnp.asarray(idx_rows.numpy()),)
                       + tuple(jnp.asarray(rows[:, i].numpy())
                               for i in range(3)),
                       dimension=1, num_keys=1, is_stable=False)
    ref = np.stack([np.asarray(o)[:, :p] for o in ops[1:]], axis=1)
    assert out.shape == (3, 3, p)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_bwd_gather_twin_matches_loop():
    """B4's twin against a per-row loop over the live slots, on a
    multi-tile frame and on a single tile that reads the grid itself."""
    for grid in ((300, 200), (100, 90)):
        _, pts, rot, tr, _ = _random_cloud(grid=grid, n_points=200)
        t_args = [torch.from_numpy(a) for a in (pts, rot, tr)]
        data, slot_tile, chunk = tbin._bwd_frame(grid, *t_args)
        lane_b = tbin._planes_bwd(data[:, :2], tbin.tile_shape_for(grid))
        g = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (3,) + grid).astype(np.float32))
        single = tbin._single_tile(grid)
        win = g if single else tbin._unfold(g, grid,
                                            tbin.tile_shape_for(grid))
        buf = tbin.bwd_gather(slot_tile, lane_b, win, chunk).numpy()
        w4 = (win[:, None] if single else win).double().numpy()
        ln, st = lane_b.double().numpy(), slot_tile.numpy()
        ref = np.zeros_like(buf, dtype=np.float64)
        for b in range(3):
            for row in range(st[b, -1] * chunk):
                iy0, dly, ix0, dlx = ln[b, :, row]
                w = w4[b, st[b, row // chunk]]

                def at(r, c):
                    ok = 0 <= r < w.shape[0] and 0 <= c < w.shape[1]
                    return w[r, c] if ok else 0.0

                p00, p01 = at(int(iy0), int(ix0)), at(int(iy0), int(ix0) + 1)
                p10 = at(int(iy0) + 1, int(ix0))
                p11 = at(int(iy0) + 1, int(ix0) + 1)
                a = (1 - dly) * p00 + dly * p10
                c = (1 - dly) * p01 + dly * p11
                ref[b, :, row] = ((p10 - p00) * (1 - dlx)
                                  + (p11 - p01) * dlx, c - a,
                                  a * (1 - dlx) + c * dlx)
        assert _scaled_err(buf, ref) < 1e-6
        for b in range(3):          # rows of dead slots are zeros
            assert not buf[b, :, st[b, -1] * chunk:].any()


PULLBACK_GRIDS = [(8, 8), (128, 128), (8, 192), (300, 200)]


@pytest.mark.parametrize("grid", PULLBACK_GRIDS,
                         ids=[f"{gy}x{gx}" for gy, gx in PULLBACK_GRIDS])
@pytest.mark.parametrize("weighted", [False, True])
def test_pullback_binned_matches_jax_and_oracle(grid, weighted):
    """All six binned gradients vs the JAX binned pullback (interpreter)
    and the f64 oracle; the uniform case takes the `pw_uniform` path in
    both, whose d_pw is sum-exact.  Against JAX the bound is the
    cross-backend 2e-5: JAX's kernel gathers through a two-term bf16
    split, the port's in fp32 (see tests/test_torch_grads.py)."""
    pts, rot, tr, bg, ow, pw = _f32(fixtures(seed=4, n_points=300,
                                             batch_size=3, n_in=3, n_out=2))
    if not weighted:
        pw = np.ones_like(pw)
    g = np.random.default_rng(6).standard_normal((3,) + grid).astype(
        np.float32)
    arrays = (pts, rot, tr, bg, ow, pw, g)
    res = tbin.raster_pullback(grid, *map(torch.from_numpy, arrays),
                               pw_uniform=not weighted)
    ref_j = jbin.raster_pullback(grid, *map(jnp.asarray, arrays),
                                 pw_uniform=not weighted)
    ref_np = raster_pullback_numpy(grid, *arrays)
    for name in ref_np:
        out = getattr(res, name).numpy()
        ref = ref_np[name]
        if name == "point_weight" and not weighted:
            out, ref = out.sum(), ref.sum()
        assert _scaled_err(out, ref) < TOL, name
        assert _scaled_err(getattr(res, name).numpy(),
                           getattr(ref_j, name)) < 2e-5, name


@pytest.mark.parametrize("weighted", [False, True])
def test_residual_pair_matches_standalone(weighted):
    """The pullback from the forward's frame (an empty tile keeps a slot
    there) against the standalone pullback's own frame."""
    grid, pts, rot, tr, pw = _random_cloud(n_points=500)
    bg = np.zeros(3, np.float32)
    ow = np.linspace(0.5, 2.0, 3).astype(np.float32)
    if not weighted:
        pw = np.ones_like(pw)
    args = tuple(map(torch.from_numpy, (pts, rot, tr, bg, ow, pw)))
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3,) + grid).astype(np.float32))
    out, res = tbin.raster_fwd_res(grid, *args, pw_uniform=not weighted)
    np.testing.assert_array_equal(
        out.numpy(), tbin.raster_fwd(grid, *args,
                                     pw_uniform=not weighted).numpy())
    fused = tbin.raster_pullback_res(grid, res, args, g,
                                     pw_uniform=not weighted)
    alone = tbin.raster_pullback(grid, *args, g, pw_uniform=not weighted)
    for name in fused._fields:
        np.testing.assert_allclose(getattr(fused, name).numpy(),
                                   getattr(alone, name).numpy(), rtol=1e-5,
                                   atol=1e-4, err_msg=name)


GRID_SOURCE_GRIDS = [(130, 140), (300, 200), (255, 129), (40, 56)]


@pytest.mark.parametrize("terms", [0, 1])
@pytest.mark.parametrize("grid", GRID_SOURCE_GRIDS,
                         ids=[f"{gy}x{gx}" for gy, gx in GRID_SOURCE_GRIDS])
def test_grid_source_is_unfold_then_natural(grid, terms):
    """B4's grid source reads the cotangent itself: its twin (and the
    wrapper on CPU tensors) gives the bits of `_unfold` followed by the
    natural twin, on multi-tile grids and on a single tile."""
    _, pts, rot, tr, _ = _random_cloud(grid=grid, n_points=400)
    data, slot_tile, chunk = tbin._bwd_frame(
        grid, *(torch.from_numpy(a) for a in (pts, rot, tr)))
    ts = tbin.tile_shape_for(grid)
    lane_b = tbin._planes_bwd(data[:, :2], ts)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (3,) + grid).astype(np.float32))
    ref = tbin._bwd_gather_plain(slot_tile, lane_b, tbin._unfold(g, grid, ts),
                                 chunk, terms=terms)
    assert ref.abs().sum() > 0
    twin = tbin._bwd_gather_plain(slot_tile, lane_b, g, chunk, terms=terms,
                                  layout="grid")
    assert torch.equal(twin, ref)
    assert torch.equal(tbin.bwd_gather(slot_tile, lane_b, g, chunk,
                                       terms=terms, layout="grid"), ref)
    if tbin._single_tile(grid):
        # the single tile's natural window is the cotangent too
        assert torch.equal(tbin._bwd_gather_plain(slot_tile, lane_b, g, chunk,
                                                  terms=terms), ref)


def test_grid_source_instances_and_staging():
    """Only 2-D has a grid source, at terms 0 and 1; the copy engines
    stage a window where their alignment rules hold."""
    assert tbin._b4_instance(2, 0, "grid") == "bwd_gather_grid"
    assert tbin._b4_instance(2, 1, "grid") == "bwd_gather_grid_bf16"
    for n_out, terms in ((3, 0), (2, 2)):
        with pytest.raises(ValueError, match="no instance"):
            tbin._b4_instance(n_out, terms, "grid")
    with pytest.raises(ValueError, match="no instance"):
        tbin._bwd_gather_plain(torch.zeros((1, 2), dtype=torch.int32),
                               torch.zeros((1, 8, 128)),
                               torch.zeros((1, 8, 16, 128)), 128,
                               layout="grid")
    assert tbin._b4_staging("grid", torch.zeros((2, 300, 200)),
                            128 * 128) == "tensor"
    assert tbin._b4_staging("grid", torch.zeros((2, 1023, 1021)),
                            128 * 128) == "loads"
    assert tbin._b4_staging("natural", torch.zeros((2, 6, 128, 128)),
                            128 * 128) == "bulk"
    assert tbin._b4_staging("transposed", torch.zeros((2, 100, 90)),
                            100 * 90) == "bulk"
    assert tbin._b4_staging("natural", torch.zeros((2, 5, 5)),
                            25) == "loads"
    assert tbin._b4_staging("natural", torch.zeros((2, 101, 90))[:, 1:],
                            100 * 90) == "loads"
    assert tbin._b4_staging("presplit", torch.zeros((2, 128, 128)),
                            128 * 128) == "loads"


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("terms", [0, 1])
@pytest.mark.parametrize("grid", [(300, 200), (130, 257)],
                         ids=["300x200", "130x257"])
def test_pullback_reads_the_cotangent_without_unfold(grid, terms, weighted):
    """On a multi-tile 2-D grid the pullback hands B4 the cotangent itself
    and never calls an unfold stage; its six gradients are the bits of the
    route through `_unfold` and the natural twin."""
    _, pts, rot, tr, pw = _random_cloud(grid=grid, n_points=500)
    if not weighted:
        pw = np.ones_like(pw)
    ow = np.linspace(0.5, 2.0, 3).astype(np.float32)
    t_pts, t_rot, t_tr, t_ow, t_pw = map(torch.from_numpy,
                                         (pts, rot, tr, ow, pw))
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3,) + grid).astype(np.float32))
    data, slot_tile, chunk = tbin._bwd_frame(grid, t_pts, t_rot, t_tr)
    frame = (grid, data[:, :2], data[:, 2], slot_tile, t_pts, t_rot, t_ow,
             t_pw, g)
    kw = dict(chunk=chunk, pw_uniform=not weighted, terms=terms)
    seen = []

    def gather(slot_tile, coord, ts, win, chunk, terms, layout):
        seen.append((layout, tuple(win.shape)))
        return tbin.bwd_gather_enc(slot_tile, coord, ts, win, chunk,
                                   terms=terms, layout=layout)

    def unfold(*args):
        seen.append(("unfold",))
        return tbin._unfold(*args)

    direct = tbin._pullback_from_frame(*frame, gather=gather, **kw)
    assert seen == [("grid", (3,) + grid)]
    seen.clear()
    old = tbin._pullback_from_frame(*frame, unfold=unfold, gather=gather,
                                    **kw)
    nt = tbin.n_tiles(grid)
    assert seen == [("unfold",), ("natural", (3, nt, 128, 128))]
    plain = tbin._pullback_from_frame(*frame, unfold=tbin._unfold,
                                      gather=tbin._bwd_gather_enc_plain, **kw)
    for name in direct._fields:
        assert torch.equal(getattr(direct, name), getattr(plain, name)), name
        assert torch.equal(getattr(old, name), getattr(plain, name)), name
    # the public pullback takes the same route
    res = tbin.raster_pullback(grid, t_pts, t_rot, t_tr, torch.zeros(3), t_ow,
                               t_pw, g, pw_uniform=not weighted, terms=terms)
    for name in direct._fields:
        assert torch.equal(getattr(res, name), getattr(direct, name)), name


# ---------------------------------------------------------------------------
# B1's thread-block cluster: the size rule, the partition of a tile's slots
# ---------------------------------------------------------------------------


# clusters of 1 .. 8 blocks of 1,024 threads and a 128 KB window (B1's
# fixed-point window) that an H100 (132 SMs, one such block each) holds at
# once, as `cudaOccupancyMaxActiveClusters` answers `_clusters_held` there
_H100_HELD = (132, 66, 39, 30, 22, 17, 15, 15)


@pytest.mark.parametrize("bsz,nt,want", [
    (64, 1, 2),       # 128^2, 64 poses: 66 clusters of 2 fit, 39 of 3
    (64, 81, 1),      # 1024^2, 64 poses: 5,184 tiles fill the card alone
    (1, 342, 1),      # 128^3, one pose: 342 slabs, 2 blocks an SM
    (4, 342, 1),      # 128^3, four poses
    (16, 9, 2),       # 256^2, 16 poses: 144 tiles, 2 blocks an SM
    (1, 1, 8),        # a single tile, a single pose
])
def test_cluster_size_rule(bsz, nt, want):
    """B1's cluster size is a pure function of (poses, tiles, SMs, the
    clusters of each size the card holds): at one tile the largest size
    whose clusters all run at once, at several tiles 2 blocks per SM
    spread over the (pose, tile) pairs."""
    assert tbin._cluster_size(bsz, nt, 132, _H100_HELD) == want
    for tiles in (1, 9):
        sizes = [tbin._cluster_size(n, tiles, 132, _H100_HELD)
                 for n in range(1, 500, 3)]
        assert all(1 <= c <= tbin._MAX_CLUSTER for c in sizes)
        assert sizes == sorted(sizes, reverse=True) and sizes[-1] == 1
    # one wave at a single tile: 39 clusters of 3 fit, 66 of 2; past the
    # 132 single blocks the card holds, one block per pose
    assert [tbin._cluster_size(n, 1, 132, _H100_HELD)
            for n in (15, 16, 22, 23, 39, 40, 66, 67, 133)] == \
        [8, 6, 5, 4, 3, 2, 2, 1, 1]
    # a size the card cannot hold is never picked; none at all gives 0
    few = (132, 66, 39, 0, 0, 0, 0, 0)
    assert tbin._cluster_size(16, 1, 132, few) == 3
    assert tbin._cluster_size(1, 100, 132, few) == 3
    assert tbin._cluster_size(1, 100, 132, (0, 66) + (0,) * 6) == 2
    assert tbin._cluster_size(64, 1, 132, (0,) * 8) == 0


def _live_range(table, t):
    """Mirror of the kernel's search: the live slots [first, end) of tile
    `t` in one pose's slot table (its last entry counts the live slots)."""
    n_slots = len(table) - 1
    live = table[:min(table[n_slots], n_slots)]
    return (int(np.searchsorted(live, t, side="left")),
            int(np.searchsorted(live, t + 1, side="left")))


def _rank_slots(first, end, n_ranks, rank):
    """Mirror of the kernel's partition: the slots of `rank`."""
    return range(first + rank, end, n_ranks)


def _stripe(n_units, n_active, rank):
    return rank * n_units // n_active, (rank + 1) * n_units // n_active


def _random_slot_table(rng, nt, n_slots):
    """A sorted slot table with empty tiles and dead slots, as
    `_prep_binned` lays it out (dead slots carry the last tile)."""
    n_live = int(rng.integers(0, n_slots + 1))
    tiles = np.sort(rng.choice(nt, size=n_live, replace=True))
    table = np.full(n_slots + 1, nt - 1, np.int32)
    table[:n_live] = tiles
    table[n_slots] = n_live
    return table


@pytest.mark.parametrize("seed", range(6))
def test_cluster_partition_covers_every_live_slot_once(seed):
    """Every live slot goes to exactly one (tile, rank), a dead slot to
    none, the ranks with slots are 0 .. n_active - 1, and their stripes
    tile the window exactly."""
    rng = np.random.default_rng(seed)
    nt, n_slots = int(rng.integers(1, 40)), int(rng.integers(1, 60))
    table = _random_slot_table(rng, nt, n_slots)
    if seed == 0:
        # a real frame's table: the standalone pullback's, whose empty
        # tiles own no slot
        grid, pts, rot, tr, pw = _sparse_cloud()
        key, planes, fills, nt = _frame_planes(grid, pts, rot, tr, pw, False)
        _, st = tbin._prep_binned(key, planes, fills, nt, 128, False,
                                  pack_idx=True)
        table = st[0].numpy()
        n_slots = len(table) - 1
    n_live = table[n_slots]
    for n_ranks in range(1, tbin._MAX_CLUSTER + 1):
        owner = np.zeros(n_slots, np.int64)
        for t in range(nt):
            first, end = _live_range(table, t)
            assert 0 <= first <= end <= n_live
            n_active = min(n_ranks, end - first)
            for rank in range(n_ranks):
                slots = _rank_slots(first, end, n_ranks, rank)
                assert (len(slots) > 0) == (rank < n_active)
                for s in slots:
                    assert table[s] == t
                    owner[s] += 1
            if n_active:
                bounds = [_stripe(4096, n_active, r) for r in range(n_active)]
                assert bounds[0][0] == 0 and bounds[-1][1] == 4096
                assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert (owner[:n_live] == 1).all() and (owner[n_live:] == 0).all()


def test_fwd_splat_reads_rows_in_fours(monkeypatch):
    """The kernel takes four rows per 128-bit load: a chunk that is no
    multiple of 4, or lane planes off a 16-byte boundary, are refused
    before anything is launched; so is a cluster size the kernel does not
    have."""
    monkeypatch.setattr(tbin, "_check_cuda", lambda *a: None)
    st = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="multiple of 4"):
        tbin.fwd_splat(st, torch.zeros((1, 4, 130), device="meta"), 1,
                       (8, 8), 130)
    off = torch.zeros(4 * 128 + 1, device="meta")[1:].reshape(1, 4, 128)
    assert off.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        tbin.fwd_splat(st, off, 1, (8, 8), 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tbin.bwd_gather(st, off, torch.zeros((1, 8, 8), device="meta"), 128)
    lane = torch.zeros((1, 4, 128), device="meta")
    with pytest.raises(ValueError, match="cluster 9"):
        tbin.fwd_splat(st, lane, 1, (8, 8), 128, cluster=9)
    with pytest.raises(ValueError, match="cluster 0"):
        tbin.fwd_splat(st, lane, 1, (8, 8), 128, cluster=0)
    assert tbin.LAUNCHES["fwd_splat"] == 0


def test_fwd_splat_twin_ignores_cluster_and_dead_rows():
    """On the CPU the wrapper is the twin whatever cluster it is asked
    for, and rows of dead slots add nothing even where they hold
    coordinates inside a window."""
    grid, pts, rot, tr, pw = _random_cloud()
    args = [torch.from_numpy(a) for a in (pts, rot, tr)]
    data, st, chunk = tbin._bwd_frame(grid, *args)
    lane = tbin._planes_fwd(data[:, :2], None).contiguous()
    nt, win = tbin.n_tiles(grid), (128, 128)
    n_slots = st.shape[1] - 1
    dead = torch.repeat_interleave(
        torch.arange(n_slots) >= st[:, n_slots:], chunk, dim=1)
    assert bool(dead.any())
    filled = torch.where(dead[:, None, :],
                         lane[:, :, :chunk].repeat(1, 1, n_slots), lane)
    ref = tbin._fwd_splat_plain(st, lane, nt, win, chunk)
    for cluster in (None, 1, 8):
        out = tbin.fwd_splat(st, filled.contiguous(), nt, win, chunk,
                             cluster=cluster)
        assert torch.equal(out, ref)
