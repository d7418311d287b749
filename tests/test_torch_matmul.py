"""dprast_torch's matmul backends (`dprast_torch.ops.splat_matmul`) against
the JAX package's (`dprast.ops.splat_matmul`) and the float64 numpy oracles
on the same float32 numpy inputs, made from a seed.

Tolerances (max-abs error scaled by max(|reference|, 1)): 2e-5 against the
JAX backend (both sum exact products in fp32, in another order), 1e-5
against the f64 oracles (the parity contract), 2e-2 for the one-plane
`matmul_bf16` fast mode, 1e-10 for float64 inputs against JAX under x64.
Every case is small (<= 3 poses, <= 200 points): JAX's matmul on the CPU is
slow.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dprast_torch  # noqa: E402
from dprast.ops import splat_matmul as jmm  # noqa: E402
from dprast.utils.testing import (fixtures, raster_numpy,  # noqa: E402
                                  raster_pullback_numpy)
from dprast_torch.ops import dispatch as tdispatch  # noqa: E402
from dprast_torch.ops import splat_matmul as tmm  # noqa: E402

torch.set_num_threads(2)

TOL_JAX = 2e-5
TOL_ORACLE = 1e-5
TOL_BF16 = 2e-2
FIELDS = ("points", "rotation", "translation", "background", "out_weight",
          "point_weight")
CASES = {
    # name: (grid, n_in, n_out, points)
    "1d": ((17,), 1, 1, 45),
    "2d": ((9, 12), 2, 2, 45),
    "3d": ((6, 7, 5), 3, 3, 45),
    "3d-to-2d": ((10, 11), 3, 2, 200),
}


def _raster(*args, **kw):
    """`dprast_torch.raster` on the CPU (the entry points default to the
    card)."""
    return dprast_torch.raster(*args, device="cpu", **kw)


def _raster_pullback(*args, **kw):
    """`dprast_torch.raster_pullback` on the CPU."""
    return dprast_torch.raster_pullback(*args, device="cpu", **kw)


def _scaled_err(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    return float(np.max(np.abs(np.asarray(out, np.float64) - ref))
                 / max(float(np.max(np.abs(ref))), 1.0))


def _inputs(case, dtype=np.float32):
    grid, n_in, n_out, n_points = CASES[case]
    fx = fixtures(seed=6, n_points=n_points, batch_size=3, n_in=n_in,
                  n_out=n_out)
    args = [np.asarray(v, dtype) for v in fx.values()]
    g = np.random.default_rng(2).standard_normal((3,) + grid).astype(dtype)
    return grid, args, g


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax_and_oracle(case):
    grid, args, _ = _inputs(case)
    out = tmm.raster_fwd(grid, *map(torch.from_numpy, args))
    with jax.enable_x64(False):
        ref = np.asarray(jmm.raster_fwd(grid, *map(jnp.asarray, args)))
    assert out.dtype == torch.float32 and tuple(out.shape) == (3,) + grid
    assert _scaled_err(out, ref) < TOL_JAX
    assert _scaled_err(out, raster_numpy(grid, *args)) < TOL_ORACLE
    # through the public entry point, by name
    by_name = _raster(grid, *args, backend="matmul")
    assert torch.equal(by_name, out)


@pytest.mark.parametrize("case", list(CASES))
def test_pullback_matches_jax_and_oracle(case):
    grid, args, g = _inputs(case)
    res = tmm.raster_pullback(grid, *map(torch.from_numpy, args),
                              torch.from_numpy(g))
    with jax.enable_x64(False):
        ref_j = jmm.raster_pullback(grid, *map(jnp.asarray, args),
                                    jnp.asarray(g))
    ref_np = raster_pullback_numpy(grid, *args, g)
    for name in FIELDS:
        out = getattr(res, name)
        assert out.dtype == torch.float32, name
        assert tuple(out.shape) == np.shape(ref_np[name]), name
        assert _scaled_err(out, np.asarray(getattr(ref_j, name))) < TOL_JAX, \
            name
        assert _scaled_err(out, ref_np[name]) < TOL_ORACLE, name
    by_name = _raster_pullback(g, *args, backend="matmul")
    for name in FIELDS:
        assert torch.equal(getattr(by_name, name), getattr(res, name)), name


@pytest.mark.parametrize("case", list(CASES))
def test_matmul_bf16_within_its_envelope(case):
    """One bf16 plane per value operand: ~2e-3 of the oracles, held at
    2e-2, and equal to the JAX fast mode up to the order of the sums."""
    grid, args, g = _inputs(case)
    out = _raster(grid, *args, backend="matmul_bf16")
    assert _scaled_err(out, raster_numpy(grid, *args)) < TOL_BF16
    with jax.enable_x64(False):
        ref = jmm.raster_fwd(grid, *map(jnp.asarray, args), terms=1)
        ref_g = jmm.raster_pullback(grid, *map(jnp.asarray, args),
                                    jnp.asarray(g), terms=1)
    assert _scaled_err(out, np.asarray(ref)) < TOL_JAX
    res = _raster_pullback(g, *args, backend="matmul_bf16")
    ref_np = raster_pullback_numpy(grid, *args, g)
    for name in FIELDS:
        assert _scaled_err(getattr(res, name), ref_np[name]) < TOL_BF16, name
        assert _scaled_err(getattr(res, name),
                           np.asarray(getattr(ref_g, name))) < TOL_JAX, name
    # the fast mode is a different result, not the exact one
    exact = _raster(grid, *args, backend="matmul")
    assert not torch.equal(out, exact)


@pytest.mark.parametrize("case", list(CASES))
def test_float64_inputs_stay_float64(case):
    """f64 inputs skip the bf16 planes: one f64 product per branch."""
    grid, args, g = _inputs(case, np.float64)
    out = _raster(grid, *args, backend="matmul")
    res = _raster_pullback(g, *args, backend="matmul")
    with jax.enable_x64(True):
        ref = jmm.raster_fwd(grid, *map(jnp.asarray, args))
        ref_g = jmm.raster_pullback(grid, *map(jnp.asarray, args),
                                    jnp.asarray(g))
        assert ref.dtype == jnp.float64
    assert out.dtype == torch.float64
    assert _scaled_err(out, np.asarray(ref)) < 1e-10
    assert _scaled_err(out, raster_numpy(grid, *args)) < 1e-10
    for name in FIELDS:
        assert getattr(res, name).dtype == torch.float64, name
        assert _scaled_err(getattr(res, name),
                           np.asarray(getattr(ref_g, name))) < 1e-10, name


@pytest.mark.parametrize("case", ["2d", "3d", "3d-to-2d"])
def test_several_chunks_and_a_ragged_point_count(case):
    """45 and 200 points are no multiple of the forced chunk of 16 (45
    none of 8 either): several chunks run, the last one padded and masked."""
    grid, args, g = _inputs(case)
    p = args[0].shape[0]
    t_args = list(map(torch.from_numpy, args))
    assert p % 16 and tmm._chunked(t_args[0], t_args[5], 16)[3] == -(-p // 16)
    out = tmm.raster_fwd(grid, *t_args, chunk=16)
    res = tmm.raster_pullback(grid, *t_args, torch.from_numpy(g), chunk=16)
    whole = tmm.raster_fwd(grid, *t_args)
    res_whole = tmm.raster_pullback(grid, *t_args, torch.from_numpy(g))
    with jax.enable_x64(False):
        ref = jmm.raster_fwd(grid, *map(jnp.asarray, args), chunk=16)
        ref_g = jmm.raster_pullback(grid, *map(jnp.asarray, args),
                                    jnp.asarray(g), chunk=16)
    assert _scaled_err(out, np.asarray(ref)) < TOL_JAX
    assert _scaled_err(out, whole.numpy()) < 1e-6
    for name in FIELDS:
        got = getattr(res, name)
        assert got.shape == getattr(res_whole, name).shape, name
        assert _scaled_err(got, np.asarray(getattr(ref_g, name))) < TOL_JAX, \
            name
        assert _scaled_err(got, getattr(res_whole, name).numpy()) < 1e-6, name


def _bits(x):
    """bf16 values as their 16 bits."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_split_planes_are_jax_s_bit_for_bit(terms):
    rng = np.random.default_rng(terms)
    x = (rng.standard_normal((3, 40, 7)) * np.exp(rng.uniform(
        -8, 8, (3, 40, 7)))).astype(np.float32)
    x[0, 0, :3] = (0.0, 1.0, -2.5)
    planes = tmm._split_planes(torch.from_numpy(x), terms)
    with jax.enable_x64(False):
        ref = jmm._split_planes(jnp.asarray(x), terms)
    assert len(planes) == len(ref) == terms
    for got, want in zip(planes, ref):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), _bits(want))
    total = sum(p.double() for p in planes).numpy()
    # each plane takes 8 bits of the remainder: 3 planes give back fp32
    rel = np.abs(total - x) / np.maximum(np.abs(x), 1e-30)
    assert rel.max() <= 2.0 ** (-8 * terms)
    if terms == 3:
        assert rel.max() <= 2.0 ** -24


PICK_CHUNK_TABLE = [
    (100_000, 64, (64, 64)), (100_000, 64, (128, 128)),
    (100_000, 64, (256, 256)), (100_000, 4, (32, 32, 32)),
    (10_000, 4, (4096,)), (45, 3, (9, 12)), (7, 1, (5, 5)), (0, 2, (8, 8)),
    (1_000_000, 1, (16, 16, 16)), (1001, 512, (300, 200)),
]


@pytest.mark.parametrize("row", range(len(PICK_CHUNK_TABLE)))
def test_pick_chunk_is_jax_s(row):
    n_points, batch, grid = PICK_CHUNK_TABLE[row]
    chunk = tmm._pick_chunk(n_points, batch, grid)
    assert chunk == jmm._pick_chunk(n_points, batch, grid)
    assert chunk >= 8 and chunk % 8 == 0


def test_constants_and_support_are_jax_s():
    assert (tmm.FWD_TERMS, tmm.BWD_TERMS) == (jmm.FWD_TERMS,
                                              jmm.BWD_TERMS) == (2, 3)
    for n_out in range(0, 6):
        assert tmm.supported(n_out) == jmm.supported(n_out)
    with pytest.raises(ValueError, match="does not support"):
        _raster((4, 4, 4, 4), np.zeros((3, 4), np.float32),
                np.eye(4, dtype=np.float32), np.zeros(4, np.float32),
                backend="matmul")


@pytest.mark.parametrize("n_out", [1, 2, 3])
def test_axis_pair_matches_jax(n_out):
    rng = np.random.default_rng(n_out)
    r0 = rng.integers(-2, 9, (2, 11)).astype(np.int32)
    dl = rng.uniform(0, 1, (2, 11)).astype(np.float32)
    a, da = tmm._axis_pair(torch.from_numpy(r0), torch.from_numpy(dl), 8,
                           torch.float32)
    with jax.enable_x64(False):
        ref_a, ref_da = jmm._axis_pair(jnp.asarray(r0), jnp.asarray(dl), 8,
                                       jnp.float32)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref_a))
    np.testing.assert_array_equal(da.numpy(), np.asarray(ref_da))


@pytest.mark.parametrize("backend", ["matmul", "matmul_bf16"])
def test_autograd_runs_the_unfused_pullback(backend):
    """The matmul backends register no fused pair: `ad._Raster` saves the
    six inputs and its backward is `raster_pullback` on them."""
    assert tdispatch.vjp_pair(backend) is None
    grid, args, g = _inputs("3d-to-2d")
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = dprast_torch.raster(grid, *leaves, backend=backend)
    assert out.requires_grad
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    res = _raster_pullback(g, *args, backend=backend)
    for name, got in zip(FIELDS, grads):
        assert torch.equal(got, getattr(res, name)), name
    # a scalar point weight: the summed gradient
    leaves[5] = torch.tensor(1.5, requires_grad=True)
    out = dprast_torch.raster(grid, *leaves, backend=backend)
    (d_pw,) = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                  leaves[5])
    ref = _raster_pullback(g, *args[:5], 1.5, backend=backend)
    assert d_pw.shape == () and _scaled_err(d_pw, ref.point_weight) < 1e-6


@pytest.mark.parametrize("backend", ["matmul", "matmul_bf16"])
def test_double_backward_raises(backend):
    """The pullback rounds its operands to bf16 planes, so a second
    derivative through it would be a bf16 one: asking for it raises."""
    grid, args, _ = _inputs("2d")
    pts = torch.from_numpy(args[0]).requires_grad_()
    out = dprast_torch.raster(grid, pts, *map(torch.from_numpy, args[1:3]),
                              backend=backend)
    (first,) = torch.autograd.grad((out ** 2).sum(), pts, retain_graph=True)
    assert bool(torch.isfinite(first).all()) and not first.requires_grad
    with pytest.raises(RuntimeError, match="differentiated once"):
        torch.autograd.grad((out ** 2).sum(), pts, create_graph=True)


def test_empty_cloud():
    """P == 0: the background image, and zero gradients but d_background,
    through the entry points and through the backend itself."""
    grid = (8, 8)
    rot = np.stack([np.eye(2, 3, dtype=np.float32)] * 2)
    tr = np.zeros((2, 2), np.float32)
    bg = np.array([0.25, -1.0], np.float32)
    g = np.random.default_rng(0).standard_normal((2,) + grid).astype(
        np.float32)
    empty = np.zeros((0, 3), np.float32)
    out = _raster(grid, empty, rot, tr, bg, backend="matmul")
    np.testing.assert_array_equal(out.numpy()[:, 3, 3], bg)
    res = _raster_pullback(g, empty, rot, tr, bg, backend="matmul")
    canon = [torch.from_numpy(a) for a in (
        empty, rot, tr, bg, np.ones(2, np.float32), np.zeros(0, np.float32))]
    direct = tmm.raster_pullback(grid, *canon, torch.from_numpy(g))
    np.testing.assert_array_equal(
        tmm.raster_fwd(grid, *canon).numpy(), out.numpy())
    for got in (res, direct):
        assert got.points.shape == (0, 3) and got.point_weight.shape == (0,)
        assert not got.rotation.any() and not got.translation.any()
        assert not got.out_weight.any()
        np.testing.assert_allclose(got.background.numpy(),
                                   g.reshape(2, -1).sum(-1), rtol=1e-6)


def test_bf16_product_on_the_cpu_and_the_reduction_flag():
    """On CPU tensors the bf16 product widens to fp32 (exact products, fp32
    sums).  The context that guards the CUDA product turns the
    reduced-precision reduction off and restores what it found."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(
        np.float32)).bfloat16()
    onehot = torch.zeros((2, 64, 7), dtype=torch.bfloat16)
    onehot[:, torch.arange(64), torch.arange(64) % 7] = 1.0
    out = tmm._bf16_bmm(a, onehot)
    assert out.dtype == torch.float32
    ref = torch.bmm(a.double(), onehot.double())
    assert _scaled_err(out, ref.numpy()) < 1e-6
    mm = torch.backends.cuda.matmul
    for before in (True, False):
        mm.allow_bf16_reduced_precision_reduction = before
        try:
            with tmm._full_precision_bf16_sums():
                assert mm.allow_bf16_reduced_precision_reduction is False
            assert mm.allow_bf16_reduced_precision_reduction is before
            with pytest.raises(KeyError):
                with tmm._full_precision_bf16_sums():
                    raise KeyError("inside")
            assert mm.allow_bf16_reduced_precision_reduction is before
        finally:
            mm.allow_bf16_reduced_precision_reduction = True


def test_port_imports_no_jax():
    """The module and the examples' package import torch, never jax or the
    JAX package."""
    import pathlib
    import re
    root = pathlib.Path(dprast_torch.__file__).resolve().parent
    pat = re.compile(r"^\s*(import|from)\s+(jax|dprast)(\.|\s|$)", re.M)
    files = list(root.rglob("*.py")) + [
        root.parent / "chip_smoke.py",
        root.parent / "examples" / "fit_langevin_torch.py",
        root.parent / "examples" / "tomography_torch.py"]
    for path in files:
        assert not pat.search(path.read_text()), path
