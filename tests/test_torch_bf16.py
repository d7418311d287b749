"""dprast_torch's `binned_bf16` fast mode vs the JAX package's on the same
float32 numpy inputs: the forward, the B1 stage and the raw B4 rows at
``terms=1`` (and B4 at ``terms=2``) against the JAX kernels run through
the Pallas interpreter, the six gradients through autograd and
`raster_pullback` against JAX's and against the f64 oracle, and the
`binned` backend's bits, which the fast mode must leave as they were.

On the CPU the kernel wrappers run their plain twins; `chip_smoke.py`
holds the CUDA instances to the twins on the card.  Bounds (max-abs error
scaled by max(|reference|, 1)):
- the rounded products and window values are the JAX kernels' own, so
  the forward and B1 differ from JAX only in the order of fp32 sums:
  1e-5; the raw B4 rows: 1e-6;
- gradients against JAX's fast mode: the cross-backend 2e-5;
- gradients against the f64 oracle: the fast mode's envelope, 2e-2
  (`tests/test_grads.py::test_binned_bf16_fast_mode_close`).
"""

import functools
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import dprast  # noqa: E402
import dprast_torch  # noqa: E402
from dprast.ops import splat_binned as jbin  # noqa: E402
from dprast.utils.testing import (  # noqa: E402
    fixtures, raster_pullback_numpy)
from dprast_torch.ops import splat_binned as tbin  # noqa: E402

torch.set_num_threads(2)


def _raster(*args, **kw):
    """`dprast_torch.raster` on the CPU (the entry points default to the
    card)."""
    return dprast_torch.raster(*args, device="cpu", **kw)


def _raster_pullback(*args, **kw):
    """`dprast_torch.raster_pullback` on the CPU."""
    return dprast_torch.raster_pullback(*args, device="cpu", **kw)

FIELDS = ("points", "rotation", "translation", "background", "out_weight",
          "point_weight")
# a single tile, a multi-tile strip (tests/test_grads.py:177-214), and a
# small volume
GRIDS = [(8, 8), (8, 192), (8, 16, 200)]
IDS = ["x".join(map(str, g)) for g in GRIDS]


def _scaled_err(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(out, np.float64) - ref))
                 / max(float(np.max(np.abs(ref))), 1.0))


def _args(grid):
    """Six float32 arrays: 3 poses x 300 points in 2-D, 2 x 200 in 3-D."""
    n_out = len(grid)
    fx = fixtures(seed=7, n_points=300 if n_out == 2 else 200,
                  batch_size=3 if n_out == 2 else 2, n_in=3, n_out=n_out)
    return [np.asarray(v, np.float32) for v in fx.values()]


def _cot(grid, batch):
    return np.random.default_rng(4).standard_normal(
        (batch,) + grid).astype(np.float32)


@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
@pytest.mark.parametrize("weighted", [False, True])
def test_forward_matches_jax_fast_mode(grid, weighted):
    args = _args(grid)
    pw = args[5] if weighted else None
    out = _raster(grid, *args[:5], pw, backend="binned_bf16")
    ref = dprast.raster(grid, *map(jnp.asarray, args[:5]),
                        None if pw is None else jnp.asarray(pw),
                        backend="binned_bf16")
    assert out.dtype == torch.float32 and out.shape == ref.shape
    err = _scaled_err(out, ref)
    assert err < 1e-5, f"binned_bf16 forward vs JAX: {err:.3e}"
    # the rounding is really taken: the exact backend differs by ~bf16
    exact = _raster(grid, *args[:5], pw, backend="binned")
    assert 1e-5 < _scaled_err(out, exact) < 2e-2


def _jax_ext(grid, args, weighted, terms, monkeypatch):
    """JAX's B1 windows: `raster_fwd` through the interpreter, with the
    fold's input captured."""
    seen = []

    def fold(ext, *rest):
        seen.append(np.asarray(ext))
        return jbin_fold(ext, *rest)

    jbin_fold = jbin._fold
    monkeypatch.setattr(jbin, "_fold", fold)
    jbin.raster_fwd(grid, *map(jnp.asarray, args), pw_uniform=not weighted,
                    terms=terms)
    monkeypatch.setattr(jbin, "_fold", jbin_fold)
    (ext,) = seen
    return ext


@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
@pytest.mark.parametrize("weighted", [False, True])
def test_b1_twin_matches_jax_stage(grid, weighted, monkeypatch):
    """B1's twin at terms=1 against JAX's `_fwd_kernel` at terms=1 on the
    same frame (the frames are bit-equal, tests/test_torch_binned.py):
    within fp32 reordering; the exact twin is a bf16 step away."""
    args = _args(grid)
    if not weighted:
        args[5] = np.ones_like(args[5])
    pts, rot, tr, _, _, pw = map(torch.from_numpy, args)
    splat_args, _ = tbin._fwd_frame(grid, pts, rot, tr, pw, not weighted)
    ext1 = tbin._fwd_splat_plain(*splat_args, terms=1)
    ext0 = tbin._fwd_splat_plain(*splat_args)
    ref = _jax_ext(grid, args, weighted, 1, monkeypatch)
    assert ext1.shape == ref.shape
    err = _scaled_err(ext1, ref)
    assert err < 1e-5, f"B1 terms=1 vs JAX: {err:.3e}"
    assert _scaled_err(ext0, ref) > 10 * err
    # the wrapper on a CPU tensor is the twin
    assert torch.equal(tbin.fwd_splat(*splat_args, terms=1), ext1)


def _jax_gather_rows(grid, slot_tile, lane_b, g, chunk, terms):
    """The raw (B, n_out + 1, s_pad) rows of JAX's `_bwd_kernel_live` on
    the given frame, through the interpreter, with the window transposed
    as JAX's pullback feeds it."""
    ts = jbin.tile_shape_for(grid)
    n_out = len(grid)
    halo = not jbin._single_tile(grid)
    bsz, n_lane, s_pad = lane_b.shape
    g = jnp.asarray(g)
    if halo:
        g_in = jbin._unfold(g, grid, ts, transposed=True)
        g_spec = pl.BlockSpec((1, 1) + g_in.shape[2:],
                              lambda b, s, st: (b, st[b, s], 0, 0),
                              memory_space=pltpu.VMEM)
    else:
        g_in = jnp.swapaxes(g, 1, 2)
        g_spec = pl.BlockSpec((1, ts[1], ts[0]), lambda b, s, st: (b, 0, 0),
                              memory_space=pltpu.VMEM)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(bsz, s_pad // chunk),
        in_specs=[pl.BlockSpec((1, n_lane, chunk),
                               lambda b, s, st: (b, 0, s),
                               memory_space=pltpu.VMEM), g_spec],
        out_specs=pl.BlockSpec((1, n_out + 1, chunk),
                               lambda b, s, st: (b, 0, s),
                               memory_space=pltpu.VMEM))
    return np.asarray(pl.pallas_call(
        functools.partial(jbin._bwd_kernel, ts=ts, chunk=chunk, halo=halo,
                          n_out=n_out, skip_dead=False, terms=terms),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((bsz, n_out + 1, s_pad), jnp.float32),
        interpret=True)(jnp.asarray(slot_tile.numpy()),
                        jnp.asarray(lane_b.numpy()), g_in))


# terms=2 has only 2-D instances: the harness variants run it
B4_CASES = [(g, t) for g in GRIDS for t in (1, 2) if len(g) == 2 or t == 1]


@pytest.mark.parametrize("grid,terms", B4_CASES,
                         ids=[f"{'x'.join(map(str, g))}-terms{t}"
                              for g, t in B4_CASES])
def test_b4_twin_matches_jax_rows(grid, terms):
    """B4's twin at terms=1 / 2 against the raw rows of JAX's gather
    kernel at the same terms, on the standalone pullback's frame.  Not bit
    for bit: the interpreter's one-hot products and row sums round apart
    from the twin's direct reads (measured up to 2.4e-7 absolute at a
    scale of ~4, 7e-8 scaled)."""
    args = _args(grid)
    n_out = len(grid)
    pts, rot, tr = map(torch.from_numpy, args[:3])
    data, slot_tile, chunk = tbin._bwd_frame(grid, pts, rot, tr)
    ts = tbin.tile_shape_for(grid)
    lane_b = tbin._planes_bwd(data[:, :n_out], ts)
    g = _cot(grid, rot.shape[0])
    win = torch.from_numpy(g)
    if not tbin._single_tile(grid):
        win = tbin._unfold(win, grid, ts)
    rows = tbin._bwd_gather_plain(slot_tile, lane_b, win, chunk, terms=terms)
    ref = _jax_gather_rows(grid, slot_tile, lane_b, g, chunk, terms)
    assert rows.shape == ref.shape
    err = _scaled_err(rows, ref)
    assert err < 1e-6, f"B4 terms={terms} vs JAX rows: {err:.3e}"
    exact = tbin._bwd_gather_plain(slot_tile, lane_b, win, chunk)
    assert not torch.equal(rows, exact)
    # the wrapper on a CPU tensor is the twin
    assert torch.equal(tbin.bwd_gather(slot_tile, lane_b, win, chunk,
                                       terms=terms), rows)


def _loss_grads_jax(grid, arrays, g, scalar_pw):
    pw = jnp.float32(1.5) if scalar_pw else jnp.asarray(arrays[5])

    def loss(*a):
        return jnp.sum(dprast.raster(grid, *a, backend="binned_bf16")
                       * jnp.asarray(g))

    return jax.grad(loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, arrays[:5]), pw)


@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
@pytest.mark.parametrize("weighted", [False, True])
def test_gradients_match_jax_and_envelope(grid, weighted):
    """All six gradients, through autograd and through `raster_pullback`,
    against JAX's fast mode (2e-5) and the f64 oracle (2e-2); a scalar
    point weight takes the uniform path (summed d_pw)."""
    args = _args(grid)
    g = _cot(grid, args[1].shape[0])
    scalar = not weighted
    pw_full = np.full_like(args[5], 1.5) if scalar else args[5]
    ref_np = raster_pullback_numpy(grid, *args[:5], pw_full, g)
    if scalar:
        ref_np["point_weight"] = ref_np["point_weight"].sum()

    leaves = [torch.from_numpy(a).requires_grad_() for a in args[:5]]
    leaves.append(torch.tensor(1.5, requires_grad=True) if scalar
                  else torch.from_numpy(args[5]).requires_grad_())
    out = _raster(grid, *leaves, backend="binned_bf16")
    auto = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    pb = _raster_pullback(g, *args[:5], 1.5 if scalar
                                      else args[5], backend="binned_bf16")
    ref_auto = _loss_grads_jax(grid, args, g, scalar)
    ref_pb = dprast.raster_pullback(
        jnp.asarray(g), *map(jnp.asarray, args[:5]),
        jnp.float32(1.5) if scalar else jnp.asarray(args[5]),
        backend="binned_bf16")
    worst = {}
    for name, a, p, ja, jp in zip(FIELDS, auto, pb, ref_auto, ref_pb):
        assert a.shape == np.shape(ja) and p.shape == np.shape(jp), name
        e_jax = max(_scaled_err(a, ja), _scaled_err(p, jp))
        e_f64 = max(_scaled_err(a, ref_np[name]), _scaled_err(p, ref_np[name]))
        worst[name] = (e_jax, e_f64)
    msg = ", ".join(f"d_{k} {v[0]:.2e} / {v[1]:.2e}" for k, v in
                    worst.items())
    assert max(v[0] for v in worst.values()) < 2e-5, \
        f"vs JAX binned_bf16 / vs f64 oracle: {msg}"
    assert max(v[1] for v in worst.values()) < 2e-2, \
        f"vs JAX binned_bf16 / vs f64 oracle: {msg}"


@pytest.mark.parametrize("grid", [(8, 192), (8, 16, 200)], ids=IDS[1:])
@pytest.mark.parametrize("weighted", [False, True])
def test_autograd_pair_runs_fast_mode_both_ways(grid, weighted, monkeypatch):
    """Autograd's fused pair is the registry's terms=1 pair in both
    directions, bit for bit; on the uniform path the weight-gradient
    plane stays out of the unsort."""
    args = _args(grid)
    n_out = len(grid)
    t = list(map(torch.from_numpy, args))
    if not weighted:
        t[5] = torch.full_like(t[5], 1.5)
    g = torch.from_numpy(_cot(grid, t[1].shape[0]))
    unsorted = []
    real_unsort = tbin._unsort
    monkeypatch.setattr(tbin, "_unsort", lambda rows, *a: (
        unsorted.append(rows.shape[1]), real_unsort(rows, *a))[1])
    out_ref, res = tbin.raster_fwd_res(grid, *t, pw_uniform=not weighted,
                                       terms=1)
    ref = tbin.raster_pullback_res(grid, res, t, g, pw_uniform=not weighted,
                                   terms=1)
    exact = tbin.raster_pullback_res(grid, res, t, g,
                                     pw_uniform=not weighted)
    assert unsorted == [n_out if not weighted else n_out + 1] * 2
    leaves = [x.clone().requires_grad_() for x in t[:5]]
    leaves.append(torch.tensor(1.5, requires_grad=True) if not weighted
                  else t[5].clone().requires_grad_())
    out = _raster(grid, *leaves, backend="binned_bf16")
    assert torch.equal(out.detach(), out_ref)
    grads = torch.autograd.grad((out * g).sum(), leaves)
    for name, a, r, e in zip(FIELDS, grads, ref, exact):
        if name == "point_weight" and not weighted:
            r, e = r.sum(), e.sum()
        assert torch.equal(a, r), name
    assert not torch.equal(grads[0], exact.points)


def _digest(t):
    return hashlib.sha256(np.ascontiguousarray(t.numpy()).tobytes()) \
        .hexdigest()[:16]


# sha256 prefixes of the `binned` backend's bytes on the CPU from before
# the fast mode existed: B1's twin windows and `raster`'s image (uniform,
# weighted), and B4's twin rows on the standalone frame
PINNED = {
    (8, 192): ("0cddb7d70bc2c9af", "7c788987af9789c3", "51564bd6d4e0f24c",
               "3aec00e4691db324", "ee333fabedc1bfc2"),
    (100, 90): ("5417be38df79c384", "b1876c993212c9cd", "931a387388bdb449",
                "c49b7af6e5851ec2", "57483a633f6ca8ac"),
    (8, 16, 200): ("1a7b15da3c344a99", "787371c722be998a",
                   "f81f754ba29dfc64", "318532c070556bd0",
                   "85a1daf8b9fba75c"),
}


@pytest.mark.parametrize("grid", list(PINNED),
                         ids=["x".join(map(str, g)) for g in PINNED])
def test_binned_bits_unchanged(grid):
    """terms=0 (the `binned` backend, the twins' default) gives the bits
    it gave before `terms` existed."""
    n_out = len(grid)
    args = [torch.from_numpy(np.asarray(v, np.float32)) for v in fixtures(
        seed=13, n_points=300, batch_size=2, n_in=3, n_out=n_out).values()]
    pts, rot, tr, bg, ow, pw = args
    got = []
    for weighted in (False, True):
        splat_args, _ = tbin._fwd_frame(grid, pts, rot, tr, pw, not weighted)
        got.append(_digest(tbin._fwd_splat_plain(*splat_args, terms=0)))
        got.append(_digest(_raster(
            grid, pts, rot, tr, bg, ow, pw if weighted else None,
            backend="binned")))
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2,) + grid).astype(np.float32))
    data, st, chunk = tbin._bwd_frame(grid, pts, rot, tr)
    ts = tbin.tile_shape_for(grid)
    win = g if tbin._single_tile(grid) else tbin._unfold(g, grid, ts)
    got.append(_digest(tbin._bwd_gather_plain(
        st, tbin._planes_bwd(data[:, :n_out], ts), win, chunk, terms=0)))
    assert tuple(got) == PINNED[grid]


def test_fast_mode_registry_and_bounds():
    """`binned_bf16` is registered with its pair, supports what `binned`
    does, and the kernels refuse instances that do not exist."""
    from dprast_torch.ops import dispatch
    assert dispatch.resolve("binned_bf16", 3, (16, 16, 16), 100) == \
        "binned_bf16"
    with pytest.raises(ValueError, match="does not support"):
        dispatch.resolve("binned_bf16", 1, (64,), 100)
    lane = torch.zeros((1, 4, 128))
    st = torch.tensor([[0, 1]], dtype=torch.int32)
    with pytest.raises(ValueError, match="terms"):
        tbin.fwd_splat(st, lane, 1, (8, 8), 128, terms=2)
    with pytest.raises(ValueError, match="no instance"):
        tbin.bwd_gather(st, torch.zeros((1, 8, 128)),
                        torch.zeros((1, 1, 128, 128)), 128, terms=2)
    with pytest.raises(ValueError, match="no instance"):
        tbin.bwd_gather(st, lane, torch.zeros((1, 8, 8)), 128, terms=1,
                        layout="transposed")
    # the staged split is exact: hi + lo reproduces x to ~2^-17
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    two = tbin._split_terms(x, 2)
    one = tbin._split_terms(x, 1)
    assert torch.equal(tbin._split_terms(x, 0), x)
    assert float((two - x).abs().max() / x.abs().max()) < 2 ** -16
    assert float((one - x).abs().max() / x.abs().max()) > 2 ** -10
