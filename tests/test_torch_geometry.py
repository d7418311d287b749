"""dprast_torch geometry and fixed-point encoding vs the JAX package, on
the same float32 numpy inputs: the compensated coordinates, reference
voxels, tile keys and encoded planes must be bit-equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dprast.ops import geometry as jgeo  # noqa: E402
from dprast.ops import splat_binned as jbin  # noqa: E402
from dprast_torch.ops import geometry as tgeo  # noqa: E402
from dprast_torch.ops import splat_binned as tbin  # noqa: E402

torch.set_num_threads(2)

GRIDS = [(128, 128), (1024, 1024), (300, 200)]


def _pose_inputs(grid, seed=0, n_points=600, batch=3, n_in=3):
    """Random poses plus points on exact voxel centres and cell
    boundaries of `grid` (identity-like rows keep u exact there)."""
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((n_points, n_in)) * 0.5).astype(np.float32)
    rot = rng.standard_normal((batch, 2, n_in)).astype(np.float32)
    tr = (rng.standard_normal((batch, 2)) * 0.1).astype(np.float32)
    # u = k exactly for q = (k + 0.5) * 2/n - 1 (centres) and k + 0.5
    # (boundaries); pose 0 maps (x0, x1) straight onto the grid axes
    special = []
    for k in (-1, 0, 1, 63, 126, 127, 128, 254, 299, 1023):
        for off in (0.0, 0.5):
            special.append([(k + off + 0.5) * 2.0 / grid[0] - 1.0,
                            (k + off + 0.5) * 2.0 / grid[1] - 1.0]
                           + [0.0] * (n_in - 2))
    pts = np.concatenate([pts, np.asarray(special, np.float32)])
    rot[0] = np.eye(2, n_in, dtype=np.float32)
    tr[0] = 0.0
    return pts, rot, tr


def _bits(x):
    return np.asarray(x).view(np.int32) if np.asarray(x).dtype == np.float32 \
        else np.asarray(x)


def _assert_bit_equal(t, j):
    t = t.numpy()
    j = np.asarray(j)
    assert t.dtype == j.dtype, (t.dtype, j.dtype)
    np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.mark.parametrize("grid", GRIDS)
def test_grid_coords_2f_bit_equal(grid):
    pts, rot, tr = _pose_inputs(grid)
    j_hi, j_lo = jgeo.grid_coords_2f(jnp.asarray(pts), jnp.asarray(rot),
                                     jnp.asarray(tr), grid)
    t_hi, t_lo = tgeo.grid_coords_2f(torch.from_numpy(pts),
                                     torch.from_numpy(rot),
                                     torch.from_numpy(tr), grid)
    _assert_bit_equal(t_hi, j_hi)
    _assert_bit_equal(t_lo, j_lo)
    j_r0, j_dl = jgeo.reference_voxel_and_deltas_2f(j_hi, j_lo)
    t_r0, t_dl = tgeo.reference_voxel_and_deltas_2f(t_hi, t_lo)
    _assert_bit_equal(t_r0, j_r0)
    _assert_bit_equal(t_dl, j_dl)


@pytest.mark.parametrize("grid", GRIDS)
def test_keys_and_encoded_planes_bit_equal(grid):
    pts, rot, tr = _pose_inputs(grid, seed=1)
    ts = jbin.tile_shape_for(grid)
    assert tbin.tile_shape_for(grid) == ts
    j_key, j_locs, j_nt = jbin._keys_and_local(
        grid, ts, jnp.asarray(pts), jnp.asarray(rot), jnp.asarray(tr))
    t_key, t_locs, t_nt = tbin._keys_and_local(
        grid, ts, torch.from_numpy(pts), torch.from_numpy(rot),
        torch.from_numpy(tr))
    assert t_nt == j_nt
    _assert_bit_equal(t_key, j_key)
    for t_pl, j_pl in zip(t_locs, j_locs, strict=True):
        _assert_bit_equal(t_pl, j_pl)
        j_r0, j_dl = jbin._decode_coord(j_pl)
        t_r0, t_dl = tbin._decode_coord(t_pl)
        _assert_bit_equal(t_r0, j_r0)
        _assert_bit_equal(t_dl, j_dl)


def test_exact_centres_and_boundaries_decode():
    """Voxel centres keep the reference's dl == 1 (encoded as a carry into
    the integer part); cell boundaries give dl == 0.5 exactly."""
    grid = (256, 256)
    ks = [0.0, 0.5, 1.0, 126.0, 127.0, 127.5, 128.0, 254.0, 255.0]
    xs = [(k + 0.5) / 128.0 - 1.0 for k in ks]
    pts = torch.tensor([[x, 0.0] for x in xs], dtype=torch.float32)
    rot = torch.eye(2)[None]
    tr = torch.zeros((1, 2))
    key, locs, _ = tbin._keys_and_local(grid, tbin.tile_shape_for(grid), pts,
                                        rot, tr)
    r0_loc, dl = tbin._decode_coord(locs[0][0])
    expect_dl = [1.0 if k == int(k) else 0.5 for k in ks]
    np.testing.assert_array_equal(dl.numpy(), np.float32(expect_dl))
    # global r0 = ceil(u) - 1 = tile * 127 + r_loc
    tile_y = key[0] // 3
    r0 = (tile_y * 127 + r0_loc).numpy()
    np.testing.assert_array_equal(r0, [int(np.ceil(k)) - 1 for k in ks])


def test_compensated_coords_match_f64():
    """grid_coords_2f keeps coordinates within 3e-7 of f64 at 1024 (plain
    f32 is ~3e-5 there)."""
    rng = np.random.default_rng(0)
    grid = (1024, 1024)
    pts = rng.standard_normal((500, 3)).astype(np.float32) * 0.5
    rot = rng.standard_normal((4, 2, 3)).astype(np.float32)
    tr = (rng.standard_normal((4, 2)) * 0.1).astype(np.float32)
    r0, dl = tgeo.pose_voxel_and_deltas(torch.from_numpy(pts),
                                        torch.from_numpy(rot),
                                        torch.from_numpy(tr), grid)
    q64 = np.einsum("boi,pi->bpo", rot.astype(np.float64),
                    pts.astype(np.float64)) + tr.astype(np.float64)[:, None]
    u64 = (q64 + 1) * np.asarray(grid, np.float64) / 2 - 0.5
    u2 = r0.numpy().astype(np.float64) + dl.numpy().astype(np.float64)
    np.testing.assert_allclose(u2, u64, atol=3e-7)
    assert np.all((dl.numpy() > 0) & (dl.numpy() <= 1))


def test_pose_voxel_and_deltas_f64_bypass():
    """f64 inputs skip the compensated pipeline and stay f64."""
    rng = np.random.default_rng(2)
    grid = (64, 48)
    pts = rng.standard_normal((50, 3)) * 0.5
    rot = rng.standard_normal((2, 2, 3))
    tr = rng.standard_normal((2, 2)) * 0.1
    t_r0, t_dl = tgeo.pose_voxel_and_deltas(
        torch.from_numpy(pts), torch.from_numpy(rot), torch.from_numpy(tr),
        grid)
    j_r0, j_dl = jgeo.pose_voxel_and_deltas(
        jnp.asarray(pts), jnp.asarray(rot), jnp.asarray(tr), grid)
    assert t_dl.dtype == torch.float64
    np.testing.assert_array_equal(t_r0.numpy(), np.asarray(j_r0))
    np.testing.assert_allclose(t_dl.numpy(), np.asarray(j_dl), rtol=0,
                               atol=1e-12)


def test_small_helpers_match():
    for n in (1, 2, 3):
        np.testing.assert_array_equal(tgeo.voxel_shifts(n),
                                      jgeo.voxel_shifts(n))
    np.testing.assert_array_equal(tgeo.flat_strides((4, 5, 6)), [30, 6, 1])
    dl = np.random.default_rng(0).uniform(0, 1, (10, 3))
    shifts = tgeo.voxel_shifts(3)
    w = tgeo.splat_weights(torch.from_numpy(dl), torch.from_numpy(shifts))
    np.testing.assert_allclose(
        w.numpy(), np.asarray(jgeo.splat_weights(jnp.asarray(dl),
                                                 jnp.asarray(shifts))),
        rtol=1e-15)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-12)
