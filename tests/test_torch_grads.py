"""dprast_torch's gradients vs the JAX package on the same float32 numpy
inputs: `splat_weight_grads`, the oracle backend's pullback, finite
differences in float64, autograd through `raster` against `jax.grad`
through `dprast.raster`, the fused autograd pair against the standalone
pullback, and `raster_pullback`'s argument rules against
`dprast.raster_pullback`.

Tolerances are the parity contract (max-abs error scaled by
max(|reference|, 1), 1e-5) unless a line says otherwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dprast  # noqa: E402
import dprast_torch  # noqa: E402
from dprast.ops import core as jcore  # noqa: E402
from dprast.ops import geometry as jgeo  # noqa: E402
from dprast.utils.testing import fixtures, raster_pullback_numpy  # noqa: E402
from dprast_torch.ops import core as tcore  # noqa: E402
from dprast_torch.ops import geometry as tgeo  # noqa: E402
from dprast_torch.ops import splat_binned as tbin  # noqa: E402

torch.set_num_threads(2)


def _raster(*args, **kw):
    """`dprast_torch.raster` on the CPU (the entry points default to the
    card)."""
    return dprast_torch.raster(*args, device="cpu", **kw)


def _raster_pullback(*args, **kw):
    """`dprast_torch.raster_pullback` on the CPU."""
    return dprast_torch.raster_pullback(*args, device="cpu", **kw)

TOL = 1e-5
FIELDS = ("points", "rotation", "translation", "background", "out_weight",
          "point_weight")


def _scaled_err(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    return float(np.max(np.abs(np.asarray(out, np.float64) - ref))
                 / max(float(np.max(np.abs(ref))), 1.0))


def _f32(fx):
    return [np.asarray(v, np.float32) for v in fx.values()]


def _cot(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n_out", [1, 2, 3])
def test_splat_weight_grads_match_jax(n_out):
    dl = np.random.default_rng(n_out).uniform(0, 1, (4, 9, n_out)).astype(
        np.float32)
    dl[0, 0] = 1.0          # a point on a voxel centre
    dl[0, 1] = 0.0          # the masked product keeps dl -> 0 exact
    shifts = tgeo.voxel_shifts(n_out)
    out = tgeo.splat_weight_grads(torch.from_numpy(dl),
                                  torch.from_numpy(shifts))
    ref = jgeo.splat_weight_grads(jnp.asarray(dl), jnp.asarray(shifts))
    assert out.shape == (4, 9, 2 ** n_out, n_out)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


ORACLE_CASES = {
    # name: (grid, n_in, n_out)
    "1d": ((17,), 1, 1),
    "2d": ((9, 12), 2, 2),
    "3d": ((6, 7, 5), 3, 3),
    "3d-to-2d": ((10, 11), 3, 2),
}


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_xla_pullback_matches_jax_and_oracle(case):
    grid, n_in, n_out = ORACLE_CASES[case]
    args = _f32(fixtures(seed=6, n_points=40, batch_size=3, n_in=n_in,
                         n_out=n_out))
    g = _cot((3,) + grid)
    res = tcore.raster_pullback(grid, *map(torch.from_numpy, args),
                                torch.from_numpy(g))
    ref_j = jcore.raster_pullback(grid, *map(jnp.asarray, args),
                                  jnp.asarray(g))
    ref_np = raster_pullback_numpy(grid, *(a.astype(np.float64)
                                           for a in args), g)
    for name in FIELDS:
        out = getattr(res, name)
        assert out.dtype == torch.float32
        assert tuple(out.shape) == np.shape(ref_np[name]), name
        assert _scaled_err(out, getattr(ref_j, name)) < 1e-6, name
        assert _scaled_err(out, ref_np[name]) < TOL, name


def _f64_inputs(n_in, n_out, batch=5):
    fx = fixtures(seed=1, n_points=16, batch_size=batch, n_in=n_in,
                  n_out=n_out)
    return tuple(torch.from_numpy(v).requires_grad_() for v in fx.values())


@pytest.mark.parametrize("n_in,n_out", [(2, 2), (3, 2), (3, 3)])
def test_gradcheck_xla_batched(n_in, n_out):
    """Finite differences in float64 on the oracle backend, all six
    inputs (first order only: the forward is piecewise multilinear)."""
    grid = (8,) * n_out
    inputs = _f64_inputs(n_in, n_out)

    def f(*a):
        return _raster(grid, *a, backend="xla")

    assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-6,
                                    rtol=1e-6)


def test_gradcheck_xla_single_pose():
    pts, rot, tr = _f64_inputs(3, 2, batch=1)[:3]

    def f(points, rotation, translation):
        return _raster((8, 8), points, rotation[0],
                                   translation[0], backend="xla")

    assert torch.autograd.gradcheck(f, (pts, rot, tr), eps=1e-6, atol=1e-6,
                                    rtol=1e-6)


AUTOGRAD_CASES = {
    # name: (backend, grid, n_in, weighted)
    "xla-8sq": ("xla", (8, 8), 3, True),
    "xla-2d-uniform": ("xla", (9, 12), 2, False),
    "binned-8sq": ("binned", (8, 8), 3, True),
    "binned-8sq-uniform": ("binned", (8, 8), 3, False),
    "binned-8x192": ("binned", (8, 192), 3, True),
    "binned-300x200-uniform": ("binned", (300, 200), 3, False),
    "binned-3d-8x16x128": ("binned", (8, 16, 128), 3, True),
    "binned-3d-9x17x130-uniform": ("binned", (9, 17, 130), 3, False),
}


@pytest.mark.parametrize("case", list(AUTOGRAD_CASES))
def test_autograd_matches_jax_grad(case):
    """`torch.autograd.grad` through `dprast_torch.raster` against
    `jax.grad` through `dprast.raster` (the JAX binned backend through
    the Pallas interpreter) and against the f64 oracle, all six inputs; a
    uniform case passes a scalar point weight, whose gradient is the sum.

    Against the JAX binned backend the bound is the cross-backend 2e-5:
    its kernel gathers the cotangent through a two-term bf16 split (about
    2^-17 relative per value), and at this input its d_translation is
    itself 1.35e-5 from the f64 oracle, while the port's fp32 gather
    stays within 1e-5 of the oracle."""
    backend, grid, n_in, weighted = AUTOGRAD_CASES[case]
    pts, rot, tr, bg, ow, pw = _f32(fixtures(seed=12, n_points=60,
                                             batch_size=3, n_in=n_in,
                                             n_out=len(grid)))
    w = pw if weighted else np.float32(1.7)
    arrays = (pts, rot, tr, bg, ow, w)
    g = _cot((3,) + grid)

    def loss(*a):
        return jnp.sum(dprast.raster(grid, *a, backend=backend)
                       * jnp.asarray(g))

    ref = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in arrays))
    ref_np = raster_pullback_numpy(
        grid, *arrays[:5], np.broadcast_to(w, pw.shape), g)
    if not weighted:
        ref_np["point_weight"] = ref_np["point_weight"].sum()
    inputs = [torch.tensor(a).requires_grad_() for a in arrays]
    out = _raster(grid, *inputs, backend=backend)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), inputs)
    tol_jax = TOL if backend == "xla" else 2e-5
    for name, a, r, x in zip(FIELDS, grads, ref, inputs):
        assert a.shape == x.shape and a.dtype == torch.float32, name
        assert _scaled_err(a, r) < tol_jax, name
        assert _scaled_err(a, ref_np[name]) < TOL, name


@pytest.mark.parametrize("grid", [(8, 8), (300, 200), (8, 16, 128)])
def test_binned_autograd_matches_xla(grid):
    """The binned VJP against the oracle's through the port alone, on a
    loss that is not linear in the image (at (8, 16, 128) the counterpart
    of the JAX package's 3-D binned-vs-xla gradient check)."""
    args = _f32(fixtures(seed=7, n_points=80, batch_size=2, n_in=3,
                         n_out=len(grid)))

    def grads(backend):
        inputs = [torch.from_numpy(a).requires_grad_() for a in args]
        out = _raster(grid, *inputs, backend=backend)
        return torch.autograd.grad((out ** 2).sum(), inputs)

    for name, a, r in zip(FIELDS, grads("binned"), grads("xla")):
        assert _scaled_err(a, r.numpy()) < TOL, name


def test_grad_matches_analytic_pullback():
    """autograd through `raster` equals the public `raster_pullback` on
    the same cotangent (both on the oracle in float64)."""
    fx = fixtures(seed=1, n_points=16, batch_size=5, n_in=3, n_out=2)
    inputs = [torch.from_numpy(v).requires_grad_() for v in fx.values()]
    out = _raster((8, 8), *inputs)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        out.shape))
    grads = torch.autograd.grad((out * g).sum(), inputs)
    pb = _raster_pullback(g, *fx.values())
    assert isinstance(pb, dprast_torch.RasterGrads)
    for name, a in zip(FIELDS, grads):
        np.testing.assert_allclose(a.numpy(), getattr(pb, name).numpy(),
                                   rtol=1e-9, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("backend", ["binned", "xla"])
@pytest.mark.parametrize("weighted", [False, True])
def test_fused_pair_matches_standalone_pullback(backend, weighted):
    """autograd rides the fused residual pair; it must agree with the
    standalone pullback.  The point count is not a chunk multiple and
    some points fall off the grid."""
    rng = np.random.default_rng(5)
    pts = (rng.standard_normal((500, 3)) * 0.6).astype(np.float32)
    rot = np.stack([np.eye(3, dtype=np.float32)[:2]] * 3)
    tr = (rng.standard_normal((3, 2)) * 0.1).astype(np.float32)
    pw = rng.uniform(0.5, 2.0, 500).astype(np.float32)
    g = torch.from_numpy(_cot((3, 256, 256), seed=6))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in ((pts, tr, pw) if weighted else (pts, tr))]
    out = _raster((256, 256), leaves[0], rot, leaves[1],
                              point_weight=leaves[2] if weighted else None,
                              backend=backend)
    grads = torch.autograd.grad((out * g).sum(), leaves)
    res = _raster_pullback(g, pts, rot, tr,
                                       point_weight=pw if weighted else None,
                                       backend=backend)
    assert all(bool(torch.isfinite(a).all()) for a in grads)
    np.testing.assert_allclose(grads[0].numpy(), res.points.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(grads[1].numpy(), res.translation.numpy(),
                               atol=1e-5)
    if weighted:
        np.testing.assert_allclose(grads[2].numpy(),
                                   res.point_weight.numpy(), atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_fused_pair_matches_standalone_pullback_3d(weighted):
    """The 3-D binned pullback from the forward's frame (an empty tile
    keeps a slot there) against the standalone pullback's own frame, all
    six gradients; the point count is not a chunk multiple and some
    points fall off the grid."""
    grid = (16, 16, 40)
    rng = np.random.default_rng(8)
    pts = (rng.standard_normal((333, 3)) * 0.6).astype(np.float32)
    rot = np.stack([np.eye(3, dtype=np.float32)] * 2)
    tr = (rng.standard_normal((2, 3)) * 0.1).astype(np.float32)
    bg = np.float32([0.1, -0.2])
    ow = np.float32([0.5, 2.0])
    pw = rng.uniform(0.5, 2.0, 333).astype(np.float32) if weighted else 1.7
    g = _cot((2,) + grid, seed=9)
    inputs = [torch.tensor(a).requires_grad_()
              for a in (pts, rot, tr, bg, ow, pw)]
    out = _raster(grid, *inputs, backend="binned")
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), inputs)
    res = _raster_pullback(g, pts, rot, tr, bg, ow, pw,
                                       backend="binned")
    for name, a in zip(FIELDS, grads):
        assert bool(torch.isfinite(a).all()), name
        np.testing.assert_allclose(a.numpy(), getattr(res, name).numpy(),
                                   rtol=1e-5, atol=1e-4, err_msg=name)


def _both_pullbacks(g, *args, **kw):
    ours = _raster_pullback(g, *args, **kw)
    # Python scalars stay Python scalars: weakly typed in both packages
    ref = dprast.raster_pullback(
        g, *(a if a is None or isinstance(a, float) else jnp.asarray(a)
             for a in args), **kw)
    return ours, ref


def _assert_same(ours, ref):
    for name in FIELDS:
        a, r = getattr(ours, name), np.asarray(getattr(ref, name))
        assert tuple(a.shape) == r.shape, (name, tuple(a.shape), r.shape)
        assert _scaled_err(a, r) < TOL, name


PULLBACK_FORMS = {
    # name: (batched, background, out_weight, point_weight)
    "batched-defaults": (True, None, None, None),
    "batched-scalars": (True, 0.3, 2.0, 1.5),
    "batched-vectors": (True, "vec", "vec", "vec"),
    "single-defaults": (False, None, None, None),
    "single-scalars": (False, 0.3, 2.0, 1.5),
    "single-vector-weight": (False, 0.1, 0.5, "vec"),
}


@pytest.mark.parametrize("form", list(PULLBACK_FORMS))
def test_raster_pullback_argument_forms_match_jax(form):
    """Summed gradients for broadcast scalars, per-pose ones for vectors,
    the single-pose squeeze, and the exact per-point d_pw of a defaulted
    weight, as `dprast.raster_pullback` gives them."""
    batched, bg, ow, pw = PULLBACK_FORMS[form]
    pts, rot, tr, bg_v, ow_v, pw_v = _f32(fixtures(seed=4, n_points=30,
                                                   batch_size=3, n_in=3,
                                                   n_out=2))
    bg = bg_v if bg == "vec" else bg
    ow = ow_v if ow == "vec" else ow
    pw = pw_v if pw == "vec" else pw
    if not batched:
        rot, tr = rot[0], tr[0]
    g = _cot(((3,) if batched else ()) + (8, 8))
    ours, ref = _both_pullbacks(g, pts, rot, tr, bg, ow, pw)
    _assert_same(ours, ref)


def test_raster_pullback_empty_cloud_and_errors():
    rot = np.stack([np.eye(2, dtype=np.float32)] * 3)
    g = _cot((3, 8, 8))
    ours, ref = _both_pullbacks(g, np.zeros((0, 2), np.float32), rot,
                                np.zeros((3, 2), np.float32),
                                np.zeros(3, np.float32))
    _assert_same(ours, ref)
    assert ours.point_weight.shape == (0,)
    np.testing.assert_allclose(ours.background.numpy(),
                               g.reshape(3, -1).sum(-1), rtol=1e-6)
    with pytest.raises(ValueError, match="ds_dout shape"):
        _raster_pullback(g[:2], np.zeros((4, 2)), rot,
                                     np.zeros((3, 2)))
    with pytest.raises(ValueError, match="Dimension of translation"):
        _raster_pullback(g, np.zeros((4, 2)), rot,
                                     np.zeros((3, 3)))


def test_binned_raster_pullback_scalar_weight_sum_exact():
    """A scalar point weight takes the binned backend's unsort-free
    weight path: the summed d_pw and per-pose d_ow match the f64
    oracle."""
    grid = (256, 256)
    pts, rot, tr, bg, ow, _ = _f32(fixtures(seed=25, n_points=300,
                                            batch_size=3, n_in=3, n_out=2))
    g = _cot((3,) + grid, seed=27)
    res = _raster_pullback(g, pts, rot, tr, bg, ow, 1.7,
                                       backend="binned")
    ref = raster_pullback_numpy(grid, pts, rot, tr, bg, ow,
                                np.full(300, 1.7), g)
    assert res.point_weight.shape == ()
    assert _scaled_err(res.point_weight, ref["point_weight"].sum()) < TOL
    for name in FIELDS[:5]:
        assert _scaled_err(getattr(res, name), ref[name]) < TOL, name


def test_binned_3d_scalar_weight_sum_exact():
    """The summed d_pw of a scalar point weight through autograd on a 3-D
    grid, where the JAX binned backend leaves its contract: at this input
    its value (two-term bf16 gathers, summed over every point of every
    pose) is 3.0e-5 from the f64 oracle.  The port's fp32 gathers hold all
    six gradients to the oracle at 1e-5."""
    grid = (16, 16, 16)
    pts, rot, tr, bg, ow, pw = _f32(fixtures(seed=12, n_points=60,
                                             batch_size=3, n_in=3, n_out=3))
    g = _cot((3,) + grid)
    ref = raster_pullback_numpy(grid, pts, rot, tr, bg, ow,
                                np.full(pw.shape, 1.7), g)
    ref["point_weight"] = ref["point_weight"].sum()
    inputs = [torch.tensor(a).requires_grad_()
              for a in (pts, rot, tr, bg, ow, np.float32(1.7))]
    out = _raster(grid, *inputs, backend="binned")
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), inputs)
    assert grads[5].shape == ()
    for name, a in zip(FIELDS, grads):
        assert _scaled_err(a, ref[name]) < TOL, name


@pytest.mark.parametrize("backend", ["binned", "binned_bf16"])
def test_double_backward_raises_on_kernel_backends(backend):
    """The kernels record no graph: a gradient taken with
    ``create_graph=True`` raises instead of coming back cut from it.  A
    plain first derivative is untouched."""
    fx = fixtures(seed=4, n_points=60, batch_size=2, n_in=3, n_out=2)
    pts = torch.from_numpy(np.asarray(fx["points"], np.float32)
                           ).requires_grad_()
    rot, tr = (torch.from_numpy(np.asarray(fx[k], np.float32))
               for k in ("rotation", "translation"))
    out = dprast_torch.raster((16, 16), pts, rot, tr, backend=backend)
    (first,) = torch.autograd.grad((out ** 2).sum(), pts, retain_graph=True)
    assert bool(torch.isfinite(first).all()) and not first.requires_grad
    with pytest.raises(RuntimeError, match="differentiated once"):
        torch.autograd.grad((out ** 2).sum(), pts, create_graph=True)


def test_double_backward_works_on_xla():
    """The oracle backend's pullback is plain torch: its gradient can be
    differentiated again, and agrees with finite differences of the first
    derivative."""
    fx = fixtures(seed=4, n_points=12, batch_size=2, n_in=2, n_out=2)
    pts = torch.from_numpy(np.asarray(fx["points"], np.float64))
    rot, tr = (torch.from_numpy(np.asarray(fx[k], np.float64))
               for k in ("rotation", "translation"))
    w = torch.linspace(0.5, 2.0, 12, dtype=torch.float64).requires_grad_()

    def first(weights):
        x = pts.clone().requires_grad_()
        out = dprast_torch.raster((8, 8), x, rot, tr, None, None, weights,
                                  backend="xla")
        (g,) = torch.autograd.grad((out ** 2).sum(), x, create_graph=True)
        return g

    g = first(w)
    assert g.requires_grad
    (second,) = torch.autograd.grad(g.sum(), w)
    assert second.shape == w.shape and float(second.abs().sum()) > 0
    eps = 1e-6
    for i in (0, 5, 11):
        step = torch.zeros_like(w)
        step[i] = eps
        fd = (first(w + step).sum() - first(w - step).sum()) / (2 * eps)
        np.testing.assert_allclose(float(second[i]), float(fd), rtol=1e-5,
                                   atol=1e-8)
