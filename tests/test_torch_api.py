"""dprast_torch's public surface: golden tables, argument forms, the
reference's error wording, the empty-cloud short-circuit, the oracle
backend against the JAX oracle, and `auto` dispatch against the JAX
package's choices."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dprast  # noqa: E402
import dprast_torch  # noqa: E402
from dprast.ops import core as jcore  # noqa: E402
from dprast.ops import dispatch as jdispatch  # noqa: E402
from dprast.utils.testing import fixtures  # noqa: E402
from dprast_torch.ops import dispatch as tdispatch  # noqa: E402

from test_golden import CASES, CENTER, CROSS, EYE, GRID, NO_T  # noqa: E402

torch.set_num_threads(2)


def _raster(*args, **kw):
    """`dprast_torch.raster` on the CPU (the entry points default to the
    card)."""
    return dprast_torch.raster(*args, device="cpu", **kw)

BACKENDS = ["xla", "matmul", "binned"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_golden_tables(backend, case):
    pts, rot, t, bg, ow, pw, expected = CASES[case]
    out = _raster(GRID, pts, rot, t, bg, ow, pw, backend=backend)
    np.testing.assert_allclose(_np(out), np.asarray(expected, dtype=float),
                               atol=1e-12)


@pytest.mark.parametrize("backend", BACKENDS)
def test_golden_batched_background_and_drops(backend):
    sub = [c for c in CASES if c[0] == CROSS and c[5] is None]
    out = _raster(GRID, CROSS, [c[1] for c in sub],
                              [c[2] for c in sub], [c[3] for c in sub],
                              [c[4] for c in sub], backend=backend)
    assert out.shape == (len(sub),) + GRID
    for i, c in enumerate(sub):
        np.testing.assert_allclose(_np(out[i]), np.asarray(c[6], float),
                                   atol=1e-12)
    out = _raster(GRID, CENTER, EYE, NO_T, 0.5, 4.0,
                              backend=backend)
    expected = np.full(GRID, 0.5)
    expected[2, 2] += 4.0
    np.testing.assert_allclose(_np(out), expected, atol=1e-12)
    # out-of-grid points drop; a straddling stencil keeps its in-grid half
    out = _raster(GRID, [[5.0, 5.0], [-5.0, 0.0], [0.0, 0.0],
                                     [-1.0, 0.0]], EYE, NO_T,
                              backend=backend)
    expected = np.zeros(GRID)
    expected[2, 2] = 1.0
    expected[0, 2] = 0.5
    np.testing.assert_allclose(_np(out), expected, atol=1e-12)
    # orthographic projection: the dropped coordinate does not matter
    proj = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    for z in (-0.9, 0.0, 2.5):
        out = _raster(GRID, [[0.0, 0.4, z]], proj, NO_T, 0.0,
                                  4.0, backend=backend)
        expected = np.zeros(GRID)
        expected[2, 3] = 4.0
        np.testing.assert_allclose(_np(out), expected, atol=1e-12)


def _fx(**kw):
    return fixtures(seed=4, n_points=12, batch_size=5, n_in=3, n_out=2, **kw)


def test_arg_forms_defaults_and_scalars_agree():
    fx = _fx()
    b, p = fx["rotation"].shape[0], fx["points"].shape[0]
    ref = _raster((8, 8), **fx)
    as_lists = _raster((8, 8), *(v.tolist() for v in fx.values()))
    as_tensors = _raster(
        (8, 8), *(torch.from_numpy(v) for v in fx.values()))
    np.testing.assert_allclose(_np(as_lists), _np(ref))
    np.testing.assert_allclose(_np(as_tensors), _np(ref))
    explicit = _raster((8, 8), fx["points"], fx["rotation"],
                                   fx["translation"], np.zeros(b), np.ones(b),
                                   np.ones(p))
    defaulted = _raster((8, 8), fx["points"], fx["rotation"],
                                    fx["translation"])
    np.testing.assert_allclose(_np(defaulted), _np(explicit))
    vectors = _raster((8, 8), fx["points"], fx["rotation"],
                                  fx["translation"], np.full(b, 0.3),
                                  np.full(b, 2.0), np.full(p, 1.5))
    scalars = _raster((8, 8), fx["points"], fx["rotation"],
                                  fx["translation"], 0.3, 2.0, 1.5)
    np.testing.assert_allclose(_np(scalars), _np(vectors))
    single = _raster((8, 8), fx["points"], fx["rotation"][0],
                                 fx["translation"][0], fx["background"][0],
                                 fx["out_weight"][0], fx["point_weight"])
    assert single.shape == (8, 8)
    np.testing.assert_allclose(_np(single), _np(ref[0]))


def test_dtype_promotion():
    fx = _fx()
    f32 = {k: np.asarray(v, np.float32) for k, v in fx.items()}
    out = _raster((8, 8), f32["points"],
                              np.asarray(fx["rotation"], np.float64),
                              f32["translation"])
    assert out.dtype == torch.float64
    assert _raster((8, 8), f32["points"], f32["rotation"],
                               f32["translation"], 0.5,
                               2.0).dtype == torch.float32
    outi = _raster((8, 8), np.asarray(10 * fx["points"],
                                                  np.int32),
                               f32["rotation"], f32["translation"])
    assert outi.dtype == torch.float32
    assert _raster((8, 8), *f32.values(),
                               dtype=torch.float64).dtype == torch.float64


# the forms of a scalar argument: numpy scalars and 0-d arrays are
# strongly typed in both packages, a Python float weakly
NUMPY_SCALARS = {"np.float64": np.float64(0.5), "np.float32": np.float32(0.5),
                 "np.int64": np.int64(2), "np.bool_": np.bool_(True),
                 "0-d array": np.array(0.5), "float": 0.5}


@pytest.mark.parametrize("form", list(NUMPY_SCALARS))
@pytest.mark.parametrize("arg", ["background", "out_weight",
                                 "point_weight"])
def test_numpy_scalar_dtypes_match_jax(arg, form):
    """Under x64 a numpy scalar weight or background keeps its dtype in the
    promotion, as in JAX: `np.float64` makes the image float64 in both
    packages, `np.float32`, `np.int64`, `np.bool_` and a Python float keep
    the float32 arrays' float32; the values agree too (`xla` backend)."""
    fx = _fx()
    args = [np.asarray(fx[k], np.float32)
            for k in ("points", "rotation", "translation")]
    kw = {arg: NUMPY_SCALARS[form]}
    with jax.enable_x64(True):
        ref = dprast.raster((8, 8), *args, backend="xla", **kw)
    got = _raster((8, 8), *args, backend="xla", **kw)
    assert got.dtype == getattr(torch, str(ref.dtype)), (got.dtype,
                                                          ref.dtype)
    if form == "np.float64":
        assert got.dtype == torch.float64
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


DIM_ERRORS = [
    ("translation_ndim", "Dimension of translation"),
    ("rotation_rows", "Row dimension of rotation"),
    ("rotation_cols", "Column dimension of rotation"),
    ("batch_mismatch", "Batch size of rotation"),
    ("point_weight", "point_weight must be a scalar or a"),
    ("out_weight", "Batch size of rotation \\(got 5\\) and out_weight"),
]


@pytest.mark.parametrize("case", range(len(DIM_ERRORS)))
def test_dimension_errors(case):
    """Shape mismatches raise with the reference's wording."""
    what, match = DIM_ERRORS[case]
    fx = _fx()
    rot, tr = fx["rotation"], fx["translation"]
    kw = {}
    if what == "translation_ndim":
        tr = np.concatenate([tr, tr[:, :1]], axis=1)
    if what == "rotation_rows":
        rot = np.concatenate([rot, rot[:, :1, :]], axis=1)
    if what == "rotation_cols":
        rot = rot[:, :, :2]
    if what == "batch_mismatch":
        tr = tr[:-1]
    if what == "point_weight":
        kw["point_weight"] = np.ones(3)
    if what == "out_weight":
        kw["out_weight"] = np.ones(4)
    with pytest.raises(ValueError, match=match):
        _raster((8, 8), fx["points"], rot, tr, **kw)


def test_empty_cloud_and_backend_validation():
    out = _raster((8, 8), np.zeros((0, 2)), np.eye(2),
                              np.zeros(2), 0.7)
    assert out.shape == (8, 8)
    np.testing.assert_allclose(_np(out), 0.7)
    out = _raster((8, 8), np.zeros((0, 2)), np.stack([np.eye(2)]
                                                                  * 3),
                              np.zeros((3, 2)), np.array([0.1, 0.2, 0.3]),
                              backend="binned")
    np.testing.assert_allclose(_np(out)[:, 4, 4], [0.1, 0.2, 0.3])
    with pytest.raises(ValueError, match="backend"):
        _raster((8, 8), np.zeros((0, 3)), np.eye(3)[:2],
                            np.zeros(2), backend="bogus")
    # on a CUDA device `raster` resolves `auto` before its empty-cloud
    # branch: at 64^2 that is the binned backend; matmul, which the JAX
    # package picks there, serves the empty cloud by name
    assert tdispatch.resolve_pair("auto", 2, (64, 64), 0,
                                  accelerator=True) == ("binned", "binned")
    out = _raster((64, 64), np.zeros((0, 3), np.float32),
                  np.eye(3, dtype=np.float32)[:2], np.zeros(2, np.float32),
                  0.7, backend="matmul")
    np.testing.assert_allclose(_np(out), 0.7)


def test_requires_grad_and_devices_raise():
    """Inputs that require grad get gradients (through autograd, on every
    backend); inputs on two devices raise."""
    fx = _fx()
    for backend in BACKENDS:
        pts = torch.from_numpy(fx["points"]).requires_grad_()
        rot = torch.from_numpy(fx["rotation"]).requires_grad_()
        out = _raster((8, 8), pts, rot, fx["translation"],
                                  backend=backend)
        assert out.requires_grad
        d_pts, d_rot = torch.autograd.grad(out.sum(), (pts, rot))
        assert d_pts.shape == pts.shape and d_rot.shape == rot.shape
        assert bool(torch.isfinite(d_pts).all()) and d_pts.abs().sum() > 0
    # no tensor that requires grad, or no grad mode: a plain forward
    with torch.no_grad():
        assert not _raster((8, 8), pts, rot,
                                       fx["translation"]).requires_grad
    with pytest.raises(ValueError, match="one device"):
        _raster((8, 8), torch.from_numpy(fx["points"]),
                            torch.zeros((5, 2, 3), device="meta"),
                            fx["translation"])


def test_version_is_the_jax_package_s():
    import dprast
    assert dprast_torch.__version__ == dprast.__version__ == "0.2.0"
    assert "__version__" in dprast_torch.__all__


def test_surface():
    import dprast
    assert dprast_torch.available_backends() == (
        "xla", "matmul", "matmul_bf16", "binned", "binned_bf16")
    # the reference's five names, in its order
    assert dprast_torch.available_backends() == dprast.available_backends()
    assert dprast_torch.default_backend() == "auto"
    assert dprast_torch.RasterGrads._fields == (
        "points", "rotation", "translation", "background", "out_weight",
        "point_weight")
    for name in tdispatch.available_backends():
        assert callable(tdispatch.fwd_fn(name))
        assert callable(tdispatch.bwd_fn(name))
        # a fused autograd pair where the reference registers one
        pair, want = tdispatch.vjp_pair(name), jdispatch.vjp_pair(name)
        assert (pair is None) == (want is None)
        assert pair is None or len(pair) == 2


ORACLE_CASES = {
    # name: (grid, n_in, n_out)
    "1d": ((17,), 1, 1),
    "2d": ((9, 12), 2, 2),
    "3d": ((6, 7, 5), 3, 3),
    "3d-to-2d": ((10, 11), 3, 2),
}


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_xla_backend_matches_jax_oracle(case):
    grid, n_in, n_out = ORACLE_CASES[case]
    fx = fixtures(seed=6, n_points=40, batch_size=3, n_in=n_in, n_out=n_out)
    args = [np.asarray(v, np.float32) for v in fx.values()]
    out = _raster(grid, *args, backend="xla")
    ref = np.asarray(jcore.raster_fwd(grid, *(jnp.asarray(a) for a in args)))
    assert out.dtype == torch.float32
    err = np.max(np.abs(_np(out) - ref)) / max(np.max(np.abs(ref)), 1.0)
    assert err < 1e-6


# the `xla` backend's rows that `auto` sends there on the card, shrunk: a
# 1-D grid, a rank-4 grid, a dense 3-D cloud
SCATTER_CASES = {"1d": ((64,), 1, 2000), "4d": ((5, 4, 6, 3), 4, 2000),
                 "3d": ((6, 7, 5), 3, 2000)}


@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_xla_scatter_adds_in_a_fixed_order(case):
    """The `xla` forward on the CPU (X1's and X2's plain versions:
    `index_add_` in input order) repeats bit for bit on clouds that put
    many terms into each voxel, and `index_put_` with accumulate (under
    torch's deterministic mode, its sorted path), an independent witness,
    gives its image within fp32 rounding.  The card's X2 is held to the
    CPU's bits by `chip_smoke.py` `[xla path]`."""
    from dprast_torch.ops import core as tcore
    grid, n, p = SCATTER_CASES[case]
    fx = fixtures(seed=9, n_points=p, batch_size=3, n_in=n, n_out=n)
    args = [torch.from_numpy(np.asarray(v, np.float32)) for v in fx.values()]
    want = tcore.raster_fwd(grid, *args)
    assert torch.equal(want.view(torch.int32),
                       tcore.raster_fwd(grid, *args).view(torch.int32))
    scale = float(want.abs().max())
    assert scale > 10.0          # many terms a voxel
    idx, wsplat, _, _ = tcore._neighbour_data(args[0], args[1], args[2],
                                              grid)
    w = wsplat * args[4][:, None, None] * args[5][None, :, None]
    total = want[0].numel()
    base = torch.arange(3)[:, None, None] * (total + 1)
    flat = args[3][:, None].expand(3, total + 1).contiguous().view(-1)
    keep = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = flat.index_put_(((idx + base).reshape(-1),), w.reshape(-1),
                              accumulate=True)
    finally:
        torch.use_deterministic_algorithms(keep)
    got = got.view(3, total + 1)[:, :total].reshape(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=8 * np.finfo(np.float32).eps * scale)


DISPATCH_TABLE = [
    (2, (128, 128), 100_000), (2, (1024, 1024), 100_000),
    (2, (1024, 1024), 1000), (2, (64, 64), 100_000),
    (2, (256, 256), 100_000), (2, (300, 200), 100_000),
    (2, (999, 777), 1500), (3, (128, 128, 128), 100_000),
    (3, (16, 16, 16), 1000), (3, (1024, 1024, 1024), 100_000),
    (1, (4096,), 100),
]

# The rows where the port, on CUDA tensors, leaves the JAX package's
# choice: the JAX package picks `matmul` there from readings on its own
# chip; on the H100 `matmul` is the fastest fused step in no row that
# `chip_smoke.py` [matmul] times (`dispatch.resolve`'s docstring), so
# the port picks what its rule gives without it.
PORT_PICKS = {
    # the 64^2 x 64 x 10^5 row (and its 1-pose, 4-pose, 10^3-point kin)
    (2, (64, 64), 100_000): "binned",
    # the 64^2 row again, and the 256^2 x 64 x 10^5 reading before it
    (2, (256, 256), 100_000): "binned",
    # the 64^2 row: a multi-tile grid of under 256^2 voxels
    (2, (300, 200), 100_000): "binned",
    # the 32^3 x 4 x 10^5 row
    (3, (16, 16, 16), 1000): "binned",
    # the (4096,) x 4 x 10^4 row: `binned` has no 1-D form, `xla` wins
    (1, (4096,), 100): "xla",
}


@pytest.mark.parametrize("row", range(len(DISPATCH_TABLE)))
def test_auto_dispatch_matches_jax(row, monkeypatch):
    """With the accelerator flag set, `auto` picks what the JAX package
    picks on a TPU on every row, 3-D `binned` included, but where the JAX
    package picks `matmul`: there the port picks `binned` (2-D, 3-D) or
    `xla` (1-D), as the H100's readings say."""
    n_out, grid, p = DISPATCH_TABLE[row]
    monkeypatch.setattr(jdispatch, "_on_tpu", lambda: True)
    with jax.enable_x64(False):
        want = jdispatch.resolve_pair("auto", n_out, grid, p)
    assert want[0] == want[1]
    got = tdispatch.resolve_pair("auto", n_out, grid, p, accelerator=True)
    if DISPATCH_TABLE[row] in PORT_PICKS:
        assert want == ("matmul", "matmul")
        name = PORT_PICKS[DISPATCH_TABLE[row]]
        assert got == (name, name)
    else:
        assert got == want
    # `auto` picks `matmul` nowhere on the card
    assert "matmul" not in got
    # auto never picks a fast mode, in either package
    assert "binned_bf16" not in want and "matmul_bf16" not in want
    assert "binned_bf16" not in got and "matmul_bf16" not in got
    # off the accelerator, and for f64 inputs, auto is the oracle
    assert tdispatch.resolve_pair("auto", n_out, grid, p) == ("xla", "xla")
    assert tdispatch.resolve_pair("auto", n_out, grid, p, accelerator=True,
                                  f64=True) == ("xla", "xla")
    # the matmul backends stay selectable by name wherever they apply
    for name in ("matmul", "matmul_bf16"):
        if n_out <= 3:
            assert tdispatch.resolve_pair(name, n_out, grid, p,
                                          accelerator=True) == (name, name)


def _default_device_args():
    fx = {k: np.asarray(v, np.float32) for k, v in _fx().items()}
    g = np.random.default_rng(3).standard_normal((5, 8, 8)).astype(
        np.float32)
    return fx, g


@pytest.mark.parametrize("entry", ["raster", "raster_pullback"])
def test_default_device_is_the_card(entry, monkeypatch):
    """With no tensor among the inputs and no `device`, the entry points
    run on the CUDA device; where there is none they raise and name
    ``device="cpu"``, and never carry on on the CPU."""
    fx, g = _default_device_args()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    first = (8, 8) if entry == "raster" else g
    with pytest.raises(RuntimeError, match=r'device="cpu"'):
        getattr(dprast_torch, entry)(first, *fx.values())
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(dprast_torch, entry)(first, *(v.tolist()
                                              for v in fx.values()))


@pytest.mark.parametrize("entry", ["raster", "raster_pullback"])
def test_cpu_tensors_and_device_cpu_ask_for_the_cpu(entry, monkeypatch):
    """A CPU tensor among the inputs, or ``device="cpu"``, is the caller
    asking for the CPU: both compute the same there, card or no card."""
    fx, g = _default_device_args()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = getattr(dprast_torch, entry)
    first = (8, 8) if entry == "raster" else g
    by_arg = fn(first, *fx.values(), device="cpu")
    tensors = [torch.from_numpy(v) for v in fx.values()]
    by_tensor = fn(first, *tensors)
    one_tensor = fn(first, tensors[0], *list(fx.values())[1:])
    both = fn(first, *tensors, device="cpu")
    if entry == "raster":
        by_arg, by_tensor, one_tensor, both = ((x,) for x in (
            by_arg, by_tensor, one_tensor, both))
    for a, b, c, d in zip(by_arg, by_tensor, one_tensor, both):
        assert a.device.type == "cpu" and a.abs().sum() > 0
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
    with pytest.raises(ValueError, match="one device"):
        fn(first, *tensors, device="meta")
