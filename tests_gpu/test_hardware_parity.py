"""Numerical parity on the CUDA card against the independent float64 numpy
oracle (the counterpart of `tests_tpu/test_hardware_parity.py`).

The CPU suite under `tests/` runs the kernels' plain versions; this suite
asserts that the ≤1e-5 parity contract holds for the kernels themselves
(`dprast_torch/csrc/`, built for the card at first use).  Each test is one
of the reference suite's, with its seeds, sizes and tolerances: 1e-5
against the f64 oracle, 2e-5 where two backends are compared, 1e-6 where
the sharded call is held to the unsharded one, and the fast mode's 2e-2
envelope for `binned_bf16`.  The inputs are drawn with numpy, as the
reference draws them, so both suites get the same bits.
"""

import functools

import numpy as np
import pytest
import torch

import dprast_torch
from dprast_torch.ops import splat_binned
from dprast_torch.parallel import make_mesh, raster_sharded
from dprast_torch.utils.testing import (fixtures, raster_numpy,
                                        raster_pullback_numpy)

pytestmark = pytest.mark.gpu

TOL = 1e-5
DEV = "cuda"


def _pose_args(seed, n_points, batch, n_in=3, n_out=2):
    fx = fixtures(seed=seed, n_points=n_points, batch_size=batch, n_in=n_in,
                  n_out=n_out)
    return tuple(np.asarray(v, np.float32) for v in fx.values())


def _card(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)).to(DEV) for a in arrays)


def _np(t):
    return t.detach().cpu().double().numpy()


def _close(out, ref, atol, what=""):
    """Scaled max-abs comparison: both sides over max(max|ref|, 1)."""
    ref = np.asarray(ref, np.float64)
    sc = max(float(np.max(np.abs(ref))), 1.0)
    np.testing.assert_allclose(np.asarray(out, np.float64) / sc, ref / sc,
                               atol=atol, err_msg=what)


def _check_hardware(fwd, bwd, grid, args, tol=TOL, seed=7):
    np64 = [a.astype(np.float64) for a in args]
    ref_f = raster_numpy(grid, *np64)
    _close(_np(fwd(*_card(*args))), ref_f, tol, "forward on hardware")

    g = np.random.default_rng(seed).standard_normal(ref_f.shape)
    ref_b = raster_pullback_numpy(grid, *np64, g)
    res = bwd(*_card(*args, g.astype(np.float32)))
    for name in res._fields:
        _close(_np(getattr(res, name)), ref_b[name], tol,
               f"grad {name} on hardware")


@pytest.mark.parametrize("grid", [(128, 128), (256, 256), (999, 777)])
def test_binned_parity_2d(grid):
    args = _pose_args(seed=3, n_points=1500, batch=4)
    _check_hardware(
        functools.partial(splat_binned.raster_fwd, grid),
        functools.partial(splat_binned.raster_pullback, grid), grid, args)


def test_binned_parity_3d():
    args = _pose_args(seed=5, n_points=800, batch=2, n_in=3, n_out=3)
    grid = (128, 128, 128)
    _check_hardware(
        functools.partial(splat_binned.raster_fwd, grid),
        functools.partial(splat_binned.raster_pullback, grid), grid, args)


def test_matmul_parity_flagship():
    grid = (128, 128)
    args = _pose_args(seed=4, n_points=2000, batch=4)

    def fwd(*a):
        return dprast_torch.raster(grid, *a, backend="matmul")

    def bwd(*a):
        return dprast_torch.raster_pullback(a[-1], *a[:-1], backend="matmul")

    _check_hardware(fwd, bwd, grid, args)


def test_1m_points_128cube_cross_backend():
    """BASELINE config 4 at its stated size: 10^6 points into 128^3 with
    full gradients.  The f64 loop oracle is out of reach at this size, so
    the binned kernels are held to the scatter oracle backend `xla` on the
    same card: the image and all six gradients, scale-normalised."""
    grid = (128, 128, 128)
    p = 1_000_000
    rng = np.random.default_rng(11)
    pts = (rng.standard_normal((p, 3)) * 0.4).astype(np.float32)
    rot = np.eye(3, dtype=np.float32)[None]
    tr = (rng.standard_normal((1, 3)) * 0.1).astype(np.float32)
    bg = np.zeros((1,), np.float32)
    ow = np.ones((1,), np.float32)
    pw = rng.uniform(0.5, 2.0, p).astype(np.float32)
    args = _card(pts, rot, tr, bg, ow, pw)

    out_b = splat_binned.raster_fwd(grid, *args)
    out_x = dprast_torch.raster(grid, *args, backend="xla")
    _close(_np(out_b), _np(out_x), 2e-5, "image at 1M points")

    g = _card(rng.standard_normal((1,) + grid).astype(np.float32))[0]
    res_b = splat_binned.raster_pullback(grid, *args, g)
    res_x = dprast_torch.raster_pullback(g, *args, backend="xla")
    for name in res_b._fields:
        _close(_np(getattr(res_b, name)), _np(getattr(res_x, name)), 2e-5,
               f"grad {name} at 1M points")


def test_shard_map_binned_compiled_single_chip():
    """`raster_sharded` on the 1 x 1 mesh runs the binned kernels and must
    equal the unsharded raster; its gradient is finite."""
    mesh = make_mesh()
    grid = (256, 256)
    args = _card(*_pose_args(seed=9, n_points=3000, batch=3))
    out_sh = raster_sharded(grid, *args, mesh=mesh, backend="binned")
    out_ref = dprast_torch.raster(grid, *args, backend="binned")
    np.testing.assert_allclose(_np(out_sh), _np(out_ref), atol=1e-6)

    pts = args[0].clone().requires_grad_()
    loss = (raster_sharded(grid, pts, *args[1:], mesh=mesh,
                           backend="binned") ** 2).sum()
    (gp,) = torch.autograd.grad(loss, pts)
    assert torch.isfinite(gp).all()


def test_shard_map_binned_3d_compiled_single_chip():
    """A 3-D binned grid through `raster_sharded`: the (7, 15, 127) tile
    layout, the flat (z, y) stencil rows and the plain fold and unfold,
    2 x 2 x 2 = 8 tiles."""
    mesh = make_mesh()
    grid = (8, 16, 200)
    args = _card(*_pose_args(seed=21, n_points=900, batch=2, n_in=3,
                             n_out=3))
    out_sh = raster_sharded(grid, *args, mesh=mesh, backend="binned")
    out_ref = dprast_torch.raster(grid, *args, backend="binned")
    np.testing.assert_allclose(_np(out_sh), _np(out_ref), atol=1e-6)

    pts = args[0].clone().requires_grad_()
    tr = args[2].clone().requires_grad_()
    loss = (raster_sharded(grid, pts, args[1], tr, *args[3:], mesh=mesh,
                           backend="binned") ** 2).sum()
    gp, gt = torch.autograd.grad(loss, (pts, tr))
    assert torch.isfinite(gp).all() and torch.isfinite(gt).all()


def test_shard_map_default_weight_fast_path():
    """A defaulted point weight through `raster_sharded` takes the uniform
    frame (no weight plane) and matches the unsharded default call; a
    scalar weight gets its summed gradient."""
    mesh = make_mesh()
    grid = (256, 256)
    pts, rot, tr, bg, ow, _ = _pose_args(seed=23, n_points=2000, batch=3)
    args = _card(pts, rot, tr, bg, ow)
    out_sh = raster_sharded(grid, *args, mesh=mesh, backend="binned")
    out_ref = dprast_torch.raster(grid, *args, backend="binned")
    np.testing.assert_allclose(_np(out_sh), _np(out_ref), atol=1e-6)

    pts_req = args[0].clone().requires_grad_()
    w = torch.ones((), device=DEV, requires_grad=True)
    loss = (raster_sharded(grid, pts_req, *args[1:], point_weight=w,
                           mesh=mesh, backend="binned") ** 2).sum()
    gp, gw = torch.autograd.grad(loss, (pts_req, w))
    assert torch.isfinite(gp).all()
    assert gw.shape == () and torch.isfinite(gw)


def test_scalar_weight_pullback_sum_exact():
    """`raster_pullback` with a scalar point weight takes the path whose
    weight gradients are per-pose sums; the summed d_pw and the per-pose
    d_ow must match the f64 oracle."""
    grid = (256, 256)
    pts, rot, tr, bg, ow, _ = _pose_args(seed=25, n_points=1500, batch=3)
    pw0 = 1.7
    pw_vec = np.full((1500,), pw0, np.float32)
    np64 = [a.astype(np.float64) for a in (pts, rot, tr, bg, ow, pw_vec)]
    ref_f = raster_numpy(grid, *np64)
    g = np.random.default_rng(27).standard_normal(ref_f.shape)
    ref_b = raster_pullback_numpy(grid, *np64, g)

    res = dprast_torch.raster_pullback(
        *_card(g.astype(np.float32), pts, rot, tr, bg, ow,
               np.float32(pw0)), backend="binned")
    assert res.point_weight.shape == ()
    ref_dpw = float(ref_b["point_weight"].sum())
    sc = max(abs(ref_dpw), 1.0)
    np.testing.assert_allclose(float(res.point_weight) / sc, ref_dpw / sc,
                               atol=TOL)
    _close(_np(res.out_weight), ref_b["out_weight"], TOL, "grad out_weight")
    for name in ("points", "rotation", "translation"):
        _close(_np(getattr(res, name)), ref_b[name], TOL,
               f"grad {name} (scalar-weight path)")


def test_binned_bf16_fast_mode_hardware():
    """The `binned_bf16` fast mode stays within its ~2e-3 envelope (held at
    2e-2) of the faithful backend, forward and through autograd."""
    grid = (256, 256)
    args = _card(*_pose_args(seed=29, n_points=2000, batch=3))
    ref = dprast_torch.raster(grid, *args, backend="binned")
    fast = dprast_torch.raster(grid, *args, backend="binned_bf16")
    _close(_np(fast), _np(ref), 2e-2, "binned_bf16 forward")

    g = _card(np.random.default_rng(31).standard_normal(
        tuple(ref.shape)).astype(np.float32))[0]

    def grads(backend):
        pts = args[0].clone().requires_grad_()
        tr = args[2].clone().requires_grad_()
        loss = (dprast_torch.raster(grid, pts, args[1], tr, *args[3:],
                                    backend=backend) * g).sum()
        return torch.autograd.grad(loss, (pts, tr))

    for a, b in zip(grads("binned_bf16"), grads("binned")):
        _close(_np(a), _np(b), 2e-2, "binned_bf16 gradient")


def test_grad_1024sq_end_to_end():
    """The gradient of a 1024^2 raster through the public API (`auto`)
    runs on the card and is finite."""
    grid = (1024, 1024)
    args = _card(*_pose_args(seed=6, n_points=5000, batch=2))
    pts = args[0].clone().requires_grad_()
    tr = args[2].clone().requires_grad_()
    loss = (dprast_torch.raster(grid, pts, args[1], tr, *args[3:])
            ** 2).sum()
    g_p, g_t = torch.autograd.grad(loss, (pts, tr))
    assert torch.isfinite(g_p).all() and torch.isfinite(g_t).all()


def test_uniform_weight_fast_path_hardware():
    """The uniform-weight path (defaulted point weight: no weight plane in
    the frame, the scalar applied after the fold) matches the f64 oracle
    and the explicit ones-array path, forward and through autograd."""
    grid = (256, 256)
    pts, rot, tr, bg, ow, _ = _pose_args(seed=13, n_points=1500, batch=3)
    pw1 = np.ones((1500,), np.float32)
    np64 = [a.astype(np.float64) for a in (pts, rot, tr, bg, ow, pw1)]
    ref_f = raster_numpy(grid, *np64)
    c_pts, c_rot, c_tr, c_bg, c_ow, c_pw1 = _card(pts, rot, tr, bg, ow, pw1)

    out_u = dprast_torch.raster(grid, c_pts, c_rot, c_tr, c_bg, c_ow,
                                backend="binned")
    _close(_np(out_u), ref_f, TOL, "uniform-weight forward")

    g = _card(np.random.default_rng(7).standard_normal(
        ref_f.shape).astype(np.float32))[0]

    def grads(point_weight):
        p = c_pts.clone().requires_grad_()
        t = c_tr.clone().requires_grad_()
        loss = (dprast_torch.raster(grid, p, c_rot, t, c_bg, c_ow,
                                    point_weight=point_weight,
                                    backend="binned") * g).sum()
        return torch.autograd.grad(loss, (p, t))

    for a, b in zip(grads(None), grads(c_pw1)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)


def test_flagship_step_repeats_bit_for_bit():
    """The flagship forward (128^2, 64 poses x 10^5 points, per-point
    weights) and its six gradients through `dprast_torch.raster` and
    autograd give the same bits on two runs: B1 sums each window exactly
    in fixed point, and nothing else on the path adds in an order that
    changes."""
    grid = (128, 128)
    args = _card(*_pose_args(seed=0, n_points=100_000, batch=64))
    g = _card(np.random.default_rng(2).standard_normal(
        (64,) + grid).astype(np.float32))[0]

    def step():
        leaves = [a.clone().requires_grad_() for a in args]
        out = dprast_torch.raster(grid, *leaves)
        return (out.detach(),
                *torch.autograd.grad((out * g).sum(), leaves))

    first, second = step(), step()
    assert len(first) == 7
    for name, a, b in zip(("image",) + tuple(dprast_torch.RasterGrads
                                             ._fields), first, second):
        assert torch.isfinite(a).all(), name
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


@pytest.mark.parametrize("pack_idx", [True, False],
                         ids=["packed", "unpacked"])
def test_1024sq_frame_is_the_sorts(pack_idx):
    """At 1024^2 x 64 poses x 10^5 points B10's counting scatter
    (`_slot_order` on the card) writes the frame keys bit for bit as
    `torch.sort` sorts B9's plain sort input (`_slot_prep_plain`): the
    packed keys, and the stable sort's permutation where the id rides
    apart; the slot table is the plain one and the frame the plain
    `_prep_binned`'s."""
    grid = (1024, 1024)
    pts, rot, tr, _, _, pw = _card(*_pose_args(seed=0, n_points=100_000,
                                               batch=64))
    ts = splat_binned.tile_shape_for(grid)
    chunk = splat_binned._default_chunk(grid, 100_000)
    key, locs, nt = splat_binned._keys_and_local(grid, ts, pts, rot, tr)
    perm, sorted_keys, slot_tile = splat_binned._slot_order(
        key, nt, chunk, True, pack_idx)
    keys2, want_st, _ = splat_binned._slot_prep_plain(key, nt, chunk, True,
                                                      pack_idx)
    values, want_perm = torch.sort(keys2, dim=1, stable=not pack_idx)
    if pack_idx:
        assert perm is None and torch.equal(sorted_keys, values)
    else:
        assert sorted_keys is None and torch.equal(perm, want_perm)
    assert torch.equal(slot_tile, want_st)
    data = splat_binned.frame_gather(
        perm if sorted_keys is None else sorted_keys, locs, pw)
    planes, fills = splat_binned._frame_planes(locs, pw)
    want, _ = splat_binned._prep_binned(key, planes, fills, nt, chunk, True,
                                        pack_idx=pack_idx)
    assert torch.equal(data.view(torch.int32), want.view(torch.int32))
