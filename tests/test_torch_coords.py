"""The coordinate stage of dprast_torch's binned backend (kernel B6 and its
plain twin) vs the JAX package on an edge set, and the port's own copy of
the numpy fixtures and float64 oracles vs the originals.

On the CPU `_keys_and_local` runs the twin; the smoke run on the card
holds the kernel to the twin on the same edge set, bit for bit.  All
comparisons of coordinates here are on int32 views, with no tolerance."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dprast.ops import splat_binned as jbin  # noqa: E402
from dprast.utils import testing as jtesting  # noqa: E402
from dprast_torch.ops import geometry as tgeo  # noqa: E402
from dprast_torch.ops import splat_binned as tbin  # noqa: E402
from dprast_torch.utils import testing as ttesting  # noqa: E402

torch.set_num_threads(2)

EDGE_CASES = [(grid, n_in) for grid in ttesting.COORDS_EDGE_GRIDS
              for n_in in (2, 3)]


def _edge(grid, n_in):
    fx = ttesting.coords_edge_set(grid, n_in=n_in)
    assert all(a.dtype == np.float32 for a in fx.values())
    return fx["points"], fx["rotation"], fx["translation"]


def _bits(t):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return t.view(np.int32) if t.dtype == np.float32 else t


def _twin(grid, pts, rot, tr):
    return tbin._keys_and_local(grid, tbin.tile_shape_for(grid),
                                torch.from_numpy(pts), torch.from_numpy(rot),
                                torch.from_numpy(tr))


@pytest.mark.parametrize("grid,n_in", EDGE_CASES)
def test_edge_set_bit_equal_to_jax(grid, n_in):
    """(b) `_keys_and_local` on the edge set gives the JAX package's keys
    and encoded planes bit for bit, sentinel keys included."""
    pts, rot, tr = _edge(grid, n_in)
    ts = jbin.tile_shape_for(grid)
    j_key, j_locs, j_nt = jbin._keys_and_local(
        grid, ts, jnp.asarray(pts), jnp.asarray(rot), jnp.asarray(tr))
    t_key, t_locs, t_nt = _twin(grid, pts, rot, tr)
    assert t_nt == j_nt
    assert t_key.dtype == torch.int32 and np.asarray(j_key).dtype == np.int32
    np.testing.assert_array_equal(t_key.numpy(), np.asarray(j_key))
    for t_pl, j_pl in zip(t_locs, j_locs, strict=True):
        np.testing.assert_array_equal(_bits(t_pl), _bits(j_pl))
    # on the CPU the wrapper is the twin, and nothing was launched
    p_key, p_locs, _ = tbin._keys_and_local_plain(
        grid, ts, torch.from_numpy(pts), torch.from_numpy(rot),
        torch.from_numpy(tr))
    assert torch.equal(t_key, p_key)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(t_locs, p_locs, strict=True))
    assert tbin.LAUNCHES["coords"] == 0


@pytest.mark.parametrize("grid,n_in", EDGE_CASES)
def test_edge_set_reaches_every_branch(grid, n_in):
    """(a) The edge set fires both branches of the fix-up step, holds
    points with ``dl == 1`` and ``dl == 1/2``, points inside and outside
    on both sides of every axis the cloud controls, and the sentinel
    key."""
    pts, rot, tr = _edge(grid, n_in)
    u_hi, u_lo = tgeo.grid_coords_2f(torch.from_numpy(pts),
                                     torch.from_numpy(rot),
                                     torch.from_numpy(tr), grid)
    dl_raw = (u_hi - (torch.ceil(u_hi) - 1)) + u_lo
    assert bool((dl_raw > 1.0).any()), "shift_up never fires"
    assert bool((dl_raw <= 0.0).any()), "shift_dn never fires"
    r0, dl = tgeo.reference_voxel_and_deltas_2f(u_hi, u_lo)
    # the invariant holds wherever coordinates are finer than a voxel (the
    # far shift's are 2 voxels apart: one fix-up step does not restore it)
    near = dl[:COORDS_POSE["far shift"]]
    assert bool(((near > 0) & (near <= 1)).all())
    ident = COORDS_POSE["identity"]
    for i in range(min(n_in, len(grid))):
        g = grid[i]
        r, d = r0[ident, :, i], dl[ident, :, i]
        assert bool((d == 1.0).any()) and bool((d == 0.5).any())
        # just out, half in, and just in, at both edges of the axis
        for value in (-2, -1, 0, g - 2, g - 1, g):
            assert bool((r == value).any()), (i, value)
    key, locs, nt = _twin(grid, pts, rot, tr)
    assert bool((key == nt).any()) and bool((key < nt).any())
    # the two far poses overlap nothing
    for name in ("large shift", "far shift"):
        assert bool((key[COORDS_POSE[name]] == nt).all())
        assert not any(bool(pl[COORDS_POSE[name]].view(torch.int32).any())
                       for pl in locs)


COORDS_POSE = {name: i for i, name in enumerate(ttesting.COORDS_EDGE_POSES)}


def _fma(a, b, c):
    """``a * b + c`` in float64, rounded to float32 once."""
    return (a.double() * b.double() + c.double()).float()


def _coords_2f_variant(pts, rot, tr, grid, *, fuse_scale=False,
                       fuse_split=False):
    """`geometry.grid_coords_2f` with one contraction an optimiser might
    make: ``lo * scale + e`` as one fused operation, or ``c - a`` of the
    Veltkamp split as ``fma(a, 4097, -a)``."""
    def split(a):
        c = a * 4097.0
        c_minus_a = _fma(a, torch.tensor(4097.0), -a) if fuse_split else c - a
        hi = c - c_minus_a
        return hi, a - hi

    def two_prod(a, b):
        p = a * b
        ah, al = split(a)
        bh, bl = split(b)
        return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl

    b, n_out, n_in = rot.shape
    hi = tr[:, None, :].expand(b, pts.shape[0], n_out)
    lo = torch.zeros_like(hi)
    for j in range(n_in):
        pr, pe = two_prod(rot[:, None, :, j], pts[None, :, None, j])
        hi, e = tgeo._two_sum(hi, pr)
        lo = lo + (pe + e)
    hi, e = tgeo._two_sum(hi, 1.0)
    lo = lo + e
    scale = torch.tensor(grid, dtype=torch.float32) / 2
    hi, e = two_prod(hi, scale)
    lo = _fma(lo, scale, e) if fuse_scale else lo * scale + e
    hi, e = tgeo._two_sum(hi, -0.5)
    lo = lo + e
    return tgeo._two_sum(hi, lo)


def _encode(grid, u_hi, u_lo):
    """(r0, dl) -> the stage's integer outputs, for counting differences."""
    r0, dl = tgeo.reference_voxel_and_deltas_2f(u_hi, u_lo)
    return torch.cat([r0, torch.round(dl * 2.0 ** 23).to(torch.int32)], -1)


@pytest.mark.parametrize("grid", [(1024, 1024), (300, 200)])
def test_edge_set_has_teeth(grid, capsys):
    """(c) A kernel that dropped the compensation term (the plain f32
    route) differs from the twin in an encoded bit on the edge set, so it
    cannot pass the card's bit-equality phase.  Two contractions of the
    twin are evaluated beside it and reported, not asserted: what they
    move tells a kernel's author which fused operations are harmless."""
    pts, rot, tr = (torch.from_numpy(a) for a in _edge(grid, 3))
    u_hi, u_lo = tgeo.grid_coords_2f(pts, rot, tr, grid)
    ref = _encode(grid, u_hi, u_lo)
    # pose 2, the generic rotation: every compensation term is live
    live = COORDS_POSE["rotation"]
    r0_p, dl_p = tgeo.reference_voxel_and_deltas(
        tgeo.transform_points(pts, rot, tr), grid)
    plain = torch.cat([r0_p, torch.round(dl_p * 2.0 ** 23).to(torch.int32)],
                      -1)
    n_plain = int((plain[live] != ref[live]).sum())
    assert n_plain >= 1
    # the identity and small-shift poses catch it too: an exact product
    # still leaves the sum, the scaling and the half to compensate
    assert int((plain[:2] != ref[:2]).sum()) >= 1
    report = [f"plain f32 route: {n_plain} of {ref[live].numel()} encoded "
              f"values differ on the rotation pose"]
    for name, kw in (("lo * scale + e fused", {"fuse_scale": True}),
                     ("c - a of the split fused", {"fuse_split": True})):
        v_hi, v_lo = _coords_2f_variant(pts, rot, tr, grid, **kw)
        moved_pair = int(((v_hi.view(torch.int32) != u_hi.view(torch.int32))
                          | (v_lo.view(torch.int32)
                             != u_lo.view(torch.int32))).sum())
        moved_enc = int((_encode(grid, v_hi, v_lo) != ref).sum())
        report.append(f"{name}: {moved_pair} (hi, lo) pairs and {moved_enc} "
                      f"encoded values of {ref.numel()} move")
    with capsys.disabled():
        print(f"\n[coords contractions] {grid}: " + "; ".join(report))
    # the unfused variant is the twin itself
    s_hi, s_lo = _coords_2f_variant(pts, rot, tr, grid)
    assert torch.equal(s_hi.view(torch.int32), u_hi.view(torch.int32))
    assert torch.equal(s_lo.view(torch.int32), u_lo.view(torch.int32))


THREAD_CASES = {"128x128": ((128, 128), 700, 3),
                "300x200": ((300, 200), 900, 2),
                "16x16x130": ((16, 16, 130), 300, 2)}


@pytest.mark.parametrize("case", list(THREAD_CASES))
@pytest.mark.parametrize("weighted", [False, True])
def test_coords_stage_threads_through(case, weighted):
    """(d) The forward, its residual frame, the fused pullback and the
    standalone pullback's frame with ``coords=_keys_and_local_plain`` are
    the default's on the CPU bit for bit, and nothing is launched."""
    grid, n_points, n_poses = THREAD_CASES[case]
    fx = ttesting.fixtures(seed=3, n_points=n_points, batch_size=n_poses,
                           n_in=3, n_out=len(grid))
    args = [torch.from_numpy(np.asarray(v, np.float32)) for v in fx.values()]
    if not weighted:
        args[5] = torch.ones(n_points)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (n_poses,) + grid).astype(np.float32))
    outs = []
    for kw in ({}, {"coords": tbin._keys_and_local_plain}):
        out, res = tbin._fwd_impl(grid, *args, pw_uniform=not weighted,
                                  with_residuals=True, **kw)
        grads = tbin.raster_pullback_res(grid, res, args, g,
                                         pw_uniform=not weighted)
        frame = tbin._bwd_frame(grid, *args[:3], **kw)
        outs.append((out, *res, *grads, *frame[:2]))
        assert frame[2] == tbin._default_chunk(grid, n_points)
    for a, b in zip(*outs, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert tbin.LAUNCHES["coords"] == 0


@pytest.mark.parametrize("stage", ["_keys_and_local",
                                   "_keys_and_local_plain"])
def test_coords_without_keys(stage):
    """``want_key=False`` is one contract for the wrapper and the twin: no
    key, the same planes, the same tile count."""
    grid = (300, 200)
    fx = ttesting.fixtures(seed=6, n_points=50, batch_size=2, n_in=3, n_out=2)
    args = [torch.from_numpy(np.asarray(fx[k], np.float32))
            for k in ("points", "rotation", "translation")]
    fn = getattr(tbin, stage)
    key, locs, nt = fn(grid, tbin.tile_shape_for(grid), *args)
    none, locs_nokey, nt_nokey = fn(grid, tbin.tile_shape_for(grid), *args,
                                    want_key=False)
    assert key is not None and none is None and nt_nokey == nt
    for a, b in zip(locs, locs_nokey, strict=True):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_coords_wrapper_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device raises:
    there is no fallback to the twin."""
    grid = (128, 128)
    meta = [torch.zeros(shape, device="meta")
            for shape in ((10, 3), (2, 2, 3), (2, 2))]
    with pytest.raises(ValueError, match="CUDA"):
        tbin._keys_and_local(grid, tbin.tile_shape_for(grid), *meta)


FIXTURES = [dict(seed=0, n_points=40, batch_size=3, n_in=3, n_out=2),
            dict(seed=5, n_points=30, batch_size=2, n_in=3, n_out=3),
            dict(seed=9, n_points=25, n_in=2, n_out=2)]
FIXTURE_GRIDS = [(12, 9), (5, 6, 7), (130, 3)]


@pytest.mark.parametrize("case", range(len(FIXTURES)))
def test_numpy_copies_match_the_originals(case):
    """(e) `dprast_torch.utils.testing` returns exactly what
    `dprast.utils.testing` returns: fixtures, forward oracle, pullback
    oracle (float64, no tolerance)."""
    kw, grid = FIXTURES[case], FIXTURE_GRIDS[case]
    t_fx, j_fx = ttesting.fixtures(**kw), jtesting.fixtures(**kw)
    assert list(t_fx) == list(j_fx)
    for name in t_fx:
        assert t_fx[name].dtype == np.float64
        np.testing.assert_array_equal(t_fx[name], j_fx[name])
    t_out = ttesting.raster_numpy(grid, **t_fx)
    np.testing.assert_array_equal(t_out, jtesting.raster_numpy(grid, **j_fx))
    g = np.random.default_rng(case).standard_normal(t_out.shape)
    t_g = ttesting.raster_pullback_numpy(grid, **t_fx, ds_dout=g)
    j_g = jtesting.raster_pullback_numpy(grid, **j_fx, ds_dout=g)
    assert list(t_g) == list(j_g)
    for name in t_g:
        np.testing.assert_array_equal(t_g[name], j_g[name])
    assert (ttesting.batch_size_coprime_to(8)
            == jtesting.batch_size_coprime_to(8))
    rng_t, rng_j = np.random.default_rng(case), np.random.default_rng(case)
    np.testing.assert_array_equal(ttesting.random_rotation(rng_t, 3),
                                  jtesting.random_rotation(rng_j, 3))
