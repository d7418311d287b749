"""dprast_torch's binned backend vs the JAX package on the same float32
numpy inputs, stage by stage (slot frame, lane planes, fold: bit-equal)
and as a whole (within 1e-5 scaled max-abs of the JAX backend, which runs
its Pallas kernels through the interpreter here, and of the f64 oracle).

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
from dprast.utils.testing import fixtures, raster_numpy  # noqa: E402
from dprast_torch.ops import splat_binned as tbin  # noqa: E402

torch.set_num_threads(2)

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
    fills = [0.0, 0.0]
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


FRAMES = {
    "packed": (_random_cloud, True, True),
    "payload": (_random_cloud, False, True),
    "payload-uniform": (_random_cloud, False, False),
    "sparse-packed": (_sparse_cloud, True, False),
    "sparse-payload": (_sparse_cloud, False, True),
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
    ext = tbin.fwd_splat(slot_tile, lane, nt, 128, 128, 128).numpy()
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
        out = dprast_torch.raster(grid, pts, rot[0], tr[0], float(bg[0]),
                                  float(ow[0]), pw if weighted else None,
                                  backend="binned")
        assert out.shape == grid
        out = out[None]
    else:
        out = dprast_torch.raster(grid, pts, rot, tr, bg, ow,
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
    out = dprast_torch.raster(grid, *args, backend="binned")
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


def test_3d_forward_not_ported_yet():
    fx = _f32(fixtures(seed=1, n_points=20, batch_size=2, n_in=3, n_out=3))
    assert tbin.supported(3, (16, 16, 16))
    with pytest.raises(NotImplementedError, match="A6"):
        dprast_torch.raster((16, 16, 16), *fx, backend="binned")


def test_wrappers_run_the_twin_only_on_cpu():
    """A tensor on neither the CPU nor a CUDA device is refused, never
    copied to the CPU twin."""
    lane = torch.zeros((1, 4, 128), device="meta")
    st = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbin.fwd_splat(st, lane, 1, 8, 8, 128)
    ext = torch.zeros((1, 4, 128, 128), device="meta")
    ow = torch.ones((1,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbin.band_fold(ext, (200, 200), (127, 127), ow, ow)
    assert tbin.LAUNCHES == {"fwd_splat": 0, "band_fold": 0}
