"""The `xla` backend's path (X1 neighbour stage, X2 fixed-order scatter,
X3 in-place pullback gather; `csrc/xla_path.cu` on the card) on the CPU,
where each wrapper runs its plain version, against the JAX package on
the same float32 (and float64) numpy inputs:
- X1's plain version (`core._xla_neighbours_plain`) against
  `dprast.ops.core._neighbour_data` and the scatter's operand, ranks 1-4,
  float32 and float64, per-pose and scalar weights, points on and off the
  grid; its residuals, each point's voxel and deltas, expand
  (`core.expand_residuals`) to exactly `_neighbour_data`'s;
- X3's function with the contractions against `_pullback_impl` on JAX's
  residuals, and X3's plain version on X1's; the fused pair on the voxel
  and deltas keeps the CPU's bits of the pullback on the expanded ones;
- X2's plain version bit-equal to `index_add_` of the terms in input
  order (and to a numpy loop of adds in that order), also where one run
  holds every term;
- the whole path against `dprast.ops.core.raster_fwd_res` /
  `raster_pullback_res`, and against the f64 oracles `raster_numpy` /
  `raster_pullback_numpy` within 1e-5 scaled.

`chip_smoke.py` [xla path] holds the kernels to these plain versions bit
for bit on the card.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dprast.ops import core as jcore  # noqa: E402
from dprast.utils.testing import (  # noqa: E402
    fixtures, raster_numpy, raster_pullback_numpy)
from dprast_torch.ops import core as tcore  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5
FIELDS = ("points", "rotation", "translation", "background", "out_weight",
          "point_weight")
# (grid, n_in): ranks 1-4; the 3-D grid's cloud is wider than the grid's
# rank (3 -> 2) in one case
RANKS = {"1d": ((17,), 1), "2d": ((9, 12), 2), "3d-to-2d": ((10, 11), 3),
         "3d": ((6, 7, 5), 3), "4d": ((5, 4, 6, 3), 4)}
DTYPES = {"f32": np.float32, "f64": np.float64}


def _args(grid, n_in, dtype, weights, n_poses=3, n_points=400, seed=6):
    """Canonical inputs; the last pose is shifted so that part of the cloud
    lies off the grid, and the weights are per pose and point
    ("per-point") or broadcast scalars ("scalar")."""
    fx = fixtures(seed=seed, n_points=n_points, batch_size=n_poses,
                  n_in=n_in, n_out=len(grid))
    fx["translation"][-1] += 0.9
    args = [np.asarray(v, dtype) for v in fx.values()]
    if weights == "scalar":
        args[4] = np.full(n_poses, 1.5, dtype)
        args[5] = np.full(n_points, 0.75, dtype)
    return args


def _scaled_err(out, ref):
    out = np.asarray(out.detach().numpy() if isinstance(out, torch.Tensor)
                     else out, np.float64)
    ref = np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    return float(np.max(np.abs(out - ref)) / max(np.max(np.abs(ref)), 1.0))


CASES = [(r, d, w) for r in RANKS for d in DTYPES
         for w in ("per-point", "scalar")]
IDS = [f"{r}-{d}-{w}" for r, d, w in CASES]


@pytest.mark.parametrize("rank,dtype,weights", CASES, ids=IDS)
def test_x1_plain_matches_jax_neighbour_data(rank, dtype, weights):
    """Indices (out of grid -> total) and deltas as JAX computes them, the
    hat weights and terms within a rounding, and the sort keys: the pose's
    block plus the flat index, B * total out of grid."""
    grid, n_in = RANKS[rank]
    args = _args(grid, n_in, DTYPES[dtype], weights)
    keys, vals, res = tcore._xla_neighbours_plain(
        grid, *(torch.from_numpy(args[i]) for i in (0, 1, 2, 4, 5)))
    # the residuals are each point's voxel and deltas; their expansion is
    # `_neighbour_data`'s
    assert res[0].dtype == torch.int32 and res[0].shape == res[1].shape
    idx, ws, dl = tcore.expand_residuals(grid, res)
    j_idx, j_ws, j_dl, _ = jcore._neighbour_data(
        *(jnp.asarray(args[i]) for i in (0, 1, 2)), grid)
    total = math.prod(grid)
    bsz = args[1].shape[0]
    j_idx = np.asarray(j_idx)
    assert (j_idx == total).any() and (j_idx < total).any()
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    eps = np.finfo(DTYPES[dtype]).eps
    if dtype == "f32":
        # the compensated transform: the same operations in the same order
        np.testing.assert_array_equal(dl.numpy(), np.asarray(j_dl))
    else:
        # JAX's float64 transform sums its products in an order of its own
        np.testing.assert_allclose(dl.numpy(), np.asarray(j_dl), rtol=0,
                                   atol=64 * eps)
    np.testing.assert_allclose(ws.numpy(), np.asarray(j_ws), rtol=0,
                               atol=64 * eps)
    j_vals = (np.asarray(j_ws) * args[4][:, None, None]
              * args[5][None, :, None])
    np.testing.assert_allclose(vals.numpy(), j_vals, rtol=0,
                               atol=64 * eps * float(np.max(np.abs(j_vals))))
    want = np.where(j_idx < total,
                    j_idx + np.arange(bsz)[:, None, None] * total,
                    bsz * total)
    assert keys.dtype == torch.int32
    np.testing.assert_array_equal(keys.numpy(), want)


def test_x1_keys_widen_past_int32():
    """The keys are int64 where B * total reaches 2^31 (two poses of a
    1024^3 volume): `_key_dtype`, which X1 and the sort share."""
    assert tcore._key_dtype(1, 1024 ** 3) == torch.int32
    assert tcore._key_dtype(2, 1024 ** 3) == torch.int64
    assert tcore._key_dtype(1, 2 ** 31 - 1) == torch.int32
    assert tcore._key_dtype(1, 2 ** 31) == torch.int64
    assert tcore._key_dtype(2 ** 16, 2 ** 15) == torch.int64


def test_splat_weights_multiply_left_to_right():
    """`geometry.splat_weights` multiplies left to right, the order X1
    keeps, which gives the bits of `torch.prod` on the CPU."""
    from dprast_torch.ops import geometry
    dl = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (50, 7, 5)).astype(np.float32))
    for n in range(1, 6):
        shifts = geometry.shift_table(n, "cpu")
        sel = torch.where(shifts.to(torch.bool), dl[..., None, :n],
                          1 - dl[..., None, :n])
        assert torch.equal(geometry.splat_weights(dl[..., :n], shifts),
                           torch.prod(sel, dim=-1))


@pytest.mark.parametrize("rank,dtype,weights", CASES, ids=IDS)
def test_residuals_expand_to_neighbour_data(rank, dtype, weights):
    """The fused pair's residuals, each point's voxel (int32) and deltas,
    expand to exactly `_neighbour_data`'s ``(idx_flat, wsplat, dl)``: the
    indices (total out of grid), the weights and the deltas bit for bit;
    X3's plain version on them gives the bits of X3's function on the
    expanded ones."""
    grid, n_in = RANKS[rank]
    t = [torch.from_numpy(a) for a in _args(grid, n_in, DTYPES[dtype],
                                            weights)]
    _, _, res = tcore._xla_neighbours_plain(grid, t[0], t[1], t[2], t[4],
                                            t[5])
    r0, dl = res
    assert r0.dtype == torch.int32 and r0.shape == (t[1].shape[0],
                                                    t[0].shape[0], len(grid))
    assert dl.dtype == t[0].dtype and dl.shape == r0.shape
    want = tcore._neighbour_data(t[0], t[1], t[2], grid)[:3]
    got = tcore.expand_residuals(grid, res)
    assert (want[0] == math.prod(grid)).any() and (want[0] < math.prod(
        grid)).any()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (t[1].shape[0],) + grid).astype(DTYPES[dtype]))
    for a, b in zip(tcore._xla_gather_plain(grid, g, res, t[4], t[5]),
                    tcore._gather_expanded(grid, g, want, t[4], t[5])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rank,dtype,weights", CASES, ids=IDS)
def test_fused_pair_keeps_the_cpu_bits(rank, dtype, weights):
    """`raster_fwd_res` -> `raster_pullback_res` on the voxel-and-deltas
    residuals gives the CPU's bits of the pullback on `_neighbour_data`'s
    expanded residuals (the form the pair saved before), and of
    `raster_pullback` from the inputs."""
    grid, n_in = RANKS[rank]
    t = [torch.from_numpy(a) for a in _args(grid, n_in, DTYPES[dtype],
                                            weights)]
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (t[1].shape[0],) + grid).astype(DTYPES[dtype]))
    _, res = tcore.raster_fwd_res(grid, *t)
    fused = tcore.raster_pullback_res(grid, res, t, g)
    idx, ws, dl, _ = tcore._neighbour_data(t[0], t[1], t[2], grid)
    scaled, gw = tcore._gather_expanded(grid, g, (idx, ws, dl), t[4], t[5])
    before = tcore._contract(t[0], t[1], t[4], t[5], g, scaled, gw)
    alone = tcore.raster_pullback(grid, *t, g)
    for name in FIELDS:
        for other in (before, alone):
            assert torch.equal(getattr(fused, name), getattr(other, name)), \
                name


@pytest.mark.parametrize("rank,dtype,weights", CASES, ids=IDS)
def test_x3_plain_matches_jax_pullback_impl(rank, dtype, weights):
    """X3's function and the contractions on JAX's own residuals
    (`_gather_expanded`), and X3's plain version on X1's (the voxel and
    deltas), give `_pullback_impl`'s six gradients within 1e-6 scaled
    (float64 1e-12)."""
    grid, n_in = RANKS[rank]
    args = _args(grid, n_in, DTYPES[dtype], weights)
    g = np.random.default_rng(3).standard_normal(
        (args[1].shape[0],) + grid).astype(DTYPES[dtype])
    j_idx, j_ws, j_dl, _ = jcore._neighbour_data(
        *(jnp.asarray(args[i]) for i in (0, 1, 2)), grid)
    ref = jcore._pullback_impl(grid, *(jnp.asarray(args[i])
                                       for i in (0, 1, 4, 5)),
                               jnp.asarray(g), j_idx, j_ws, j_dl)
    t = [torch.from_numpy(a) for a in args]
    res = (torch.from_numpy(np.array(j_idx, np.int64)),
           torch.from_numpy(np.array(j_ws)), torch.from_numpy(np.array(j_dl)))
    _, _, compact = tcore._xla_neighbours_plain(grid, t[0], t[1], t[2],
                                                t[4], t[5])
    tol = 1e-6 if dtype == "f32" else 1e-12
    for scaled, gw in (
            tcore._gather_expanded(grid, torch.from_numpy(g), res, t[4],
                                   t[5]),
            tcore._xla_gather_plain(grid, torch.from_numpy(g), compact,
                                    t[4], t[5])):
        assert scaled.shape == res[2].shape and gw.shape == res[0].shape[:2]
        got = tcore._contract(t[0], t[1], t[4], t[5], torch.from_numpy(g),
                              scaled, gw)
        for name in FIELDS:
            assert _scaled_err(getattr(got, name),
                               np.asarray(getattr(ref, name))) < tol, name


def _sequential(out, keys, vals):
    """``out[keys[i]] += vals[i]`` one add at a time in the order of i, in
    the dtype of `out`, keys at or past ``out.size`` dropped."""
    out = out.copy()
    for k, v in zip(keys, vals):
        if k < out.size:
            out[k] = out.dtype.type(out[k] + v)
    return out


@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_x2_plain_adds_in_input_order(key_dtype, dtype):
    """On stably sorted keys, X2's plain version gives the bits of
    `index_add_` of the unsorted terms in input order onto the
    backgrounds, and of a loop of single adds in that order: many terms a
    voxel, out-of-grid keys."""
    rng = np.random.default_rng(4)
    grid, n_poses = (20,), 3
    keys = rng.integers(0, 61, 5000)                 # 60 = 3 x 20: off
    vals = rng.standard_normal(5000) * 10 ** rng.uniform(-3, 3, 5000)
    bg = rng.standard_normal(n_poses)
    t_keys = torch.from_numpy(keys).to(key_dtype)
    t_vals = torch.from_numpy(vals).to(dtype)
    t_bg = torch.from_numpy(bg).to(dtype)
    order, perm = torch.sort(t_keys, stable=True)
    got = tcore._xla_scatter_plain(t_bg, grid, order, perm, t_vals)
    assert got.shape == (n_poses,) + grid
    unsorted = tcore._xla_scatter_plain(t_bg, grid, t_keys, None, t_vals)
    assert torch.equal(got, unsorted)
    buf = torch.cat([t_bg.repeat_interleave(20), t_bg.new_zeros(1)])
    buf.index_add_(0, t_keys, t_vals)
    assert torch.equal(got.reshape(-1), buf[:-1])
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    seq = _sequential(np.repeat(bg, 20).astype(np_dtype), keys,
                      vals.astype(np_dtype))
    np.testing.assert_array_equal(got.reshape(-1).numpy(), seq)


def test_x2_plain_one_run_of_every_term():
    """Every term in one voxel: the run is added in input order."""
    rng = np.random.default_rng(5)
    vals = rng.standard_normal(20_000).astype(np.float32)
    keys = torch.full((20_000,), 7, dtype=torch.int32)
    order, perm = torch.sort(keys, stable=True)
    got = tcore.xla_scatter(torch.zeros(1), (16,), order, perm,
                            torch.from_numpy(vals))
    seq = _sequential(np.zeros(16, np.float32), keys.numpy(), vals)
    np.testing.assert_array_equal(got.reshape(-1).numpy(), seq)


def test_forward_keeps_the_cpu_bits():
    """The CPU's forward (X1's plain version, its terms unsorted into X2's)
    gives the bits of the scatter it replaces: `index_add_` of the terms
    in input order into (B, total + 1) blocks whose last entry absorbs the
    out-of-grid terms; and of X2's plain version on the stably sorted
    keys, the order the card's X2 adds in."""
    for rank in ("1d", "3d-to-2d", "4d"):
        grid, n_in = RANKS[rank]
        args = [torch.from_numpy(a) for a in _args(grid, n_in, np.float32,
                                                   "per-point")]
        got = tcore.raster_fwd(grid, *args)
        idx, ws, _, _ = tcore._neighbour_data(args[0], args[1], args[2],
                                              grid)
        b, total = args[1].shape[0], math.prod(grid)
        w = ws * args[4][:, None, None] * args[5][None, :, None]
        flat = args[3][:, None].expand(b, total + 1).contiguous()
        base = torch.arange(b)[:, None, None] * (total + 1)
        flat.view(-1).index_add_(0, (idx + base).reshape(-1), w.reshape(-1))
        want = flat[:, :total].reshape(got.shape)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        keys, vals, _ = tcore.xla_neighbours(grid, *args[:3], *args[4:],
                                             residuals=False)
        order, perm = torch.sort(keys.reshape(-1), stable=True)
        sorted_ = tcore._xla_scatter_plain(args[3], grid, order, perm,
                                           vals.reshape(-1))
        assert torch.equal(got.view(torch.int32), sorted_.view(torch.int32))


@pytest.mark.parametrize("rank,dtype,weights", CASES, ids=IDS)
def test_path_matches_jax_and_the_oracles(rank, dtype, weights):
    """The fused pair (`raster_fwd_res`, `raster_pullback_res`) and the
    standalone pullback against JAX's `raster_fwd_res` /
    `raster_pullback_res` (1e-6 scaled; float64 1e-12) and the f64
    oracles (1e-5 scaled)."""
    grid, n_in = RANKS[rank]
    args = _args(grid, n_in, DTYPES[dtype], weights)
    g = np.random.default_rng(8).standard_normal(
        (args[1].shape[0],) + grid).astype(DTYPES[dtype])
    t = [torch.from_numpy(a) for a in args]
    out, res = tcore.raster_fwd_res(grid, *t)
    fused = tcore.raster_pullback_res(grid, res, t, torch.from_numpy(g))
    alone = tcore.raster_pullback(grid, *t, torch.from_numpy(g))
    j = [jnp.asarray(a) for a in args]
    j_out, j_res = jcore.raster_fwd_res(grid, *j)
    j_pb = jcore.raster_pullback_res(grid, j_res, j, jnp.asarray(g))
    ref = raster_numpy(grid, *args)
    ref_pb = raster_pullback_numpy(grid, *args, g)
    tol = 1e-6 if dtype == "f32" else 1e-12
    assert out.dtype == t[0].dtype
    assert _scaled_err(out, np.asarray(j_out)) < tol
    assert _scaled_err(out, ref) < TOL
    for name in FIELDS:
        for pb in (fused, alone):
            assert _scaled_err(getattr(pb, name),
                               np.asarray(getattr(j_pb, name))) < tol, name
            assert _scaled_err(getattr(pb, name), ref_pb[name]) < TOL, name


def test_graph_form_runs_only_where_a_graph_is_recorded():
    """`raster_pullback` and `raster_pullback_res` run the plain torch
    form (counted in `GRAPH_FORM_CALLS`) exactly when grad mode is on and
    a tensor requires grad, and it gives the values of the kernels'
    form."""
    grid, n_in = RANKS["2d"]
    t = [torch.from_numpy(a) for a in _args(grid, n_in, np.float32,
                                            "per-point")]
    g = torch.randn((3,) + grid)
    _, res = tcore.raster_fwd_res(grid, *t)
    before = tcore.GRAPH_FORM_CALLS["xla_plain"]
    plain = tcore.raster_pullback(grid, *t, g)
    fused = tcore.raster_pullback_res(grid, res, t, g)
    assert tcore.GRAPH_FORM_CALLS["xla_plain"] == before
    leaves = [x.clone().requires_grad_() for x in t]
    graph = tcore.raster_pullback(grid, *leaves, g)
    graph_res = tcore.raster_pullback_res(grid, res, leaves, g)
    assert tcore.GRAPH_FORM_CALLS["xla_plain"] == before + 2
    with torch.no_grad():
        tcore.raster_pullback(grid, *leaves, g)
    assert tcore.GRAPH_FORM_CALLS["xla_plain"] == before + 2
    for a, b, c, d in zip(plain, fused, graph, graph_res):
        assert c.requires_grad or not c.grad_fn
        for x in (b, c.detach(), d.detach()):
            assert torch.equal(a, x)
