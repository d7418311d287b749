"""The autograd pullbacks compute only the gradients autograd asks for.

`ad._Raster.backward` hands `ctx.needs_input_grad` to the pullback as its
`asked` mask; each pullback skips the work of an unasked gradient that
has work of its own (every contraction of the `xla` path, the
background's sum of the cotangent on `binned` and `matmul`, whose other
five gradients come out of one kernel or one chunk loop together) and
counts the skip in `core.UNASKED_SKIPS`.  What is asked keeps its bits:
each asked gradient equals the full pullback's (`raster_pullback`, which
returns all six), and on `xla` a second derivative through the
graph-recording form equals the full form's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dprast_torch  # noqa: E402
from dprast_torch.ops import core, dispatch  # noqa: E402
from dprast_torch.utils.testing import fixtures  # noqa: E402

torch.set_num_threads(2)

NAMES = core.PullbackResult._fields

# (backend, grid): the xla path, binned on several tiles, on one tile and
# in 3-D, and matmul, which has no fused pair (autograd's backward runs
# its standalone pullback)
BACKENDS = {
    "xla": ("xla", (12, 14, 16)),
    "binned-multi-tile": ("binned", (300, 200)),
    "binned-one-tile": ("binned", (64, 64)),
    "binned-3d": ("binned", (20, 24, 140)),
    "matmul": ("matmul", (40, 56)),
}
ASKED = {
    "points": ("points",),
    "fit": ("points", "rotation", "translation"),
    "background": ("background",),
    "weights": ("out_weight", "point_weight"),
    "all": NAMES,
}
# the gradients whose own work each backend can skip
SEPARABLE = {"xla": NAMES, "binned": ("background",),
             "matmul": ("background",)}

CASES = [pytest.param(b, a, id=f"{b}-{a}") for b in BACKENDS for a in ASKED]


def _inputs(grid, n_poses=2, n_points=300):
    """The six canonical inputs (per-pose and per-point weights), float32
    CPU tensors, and a cotangent of the output."""
    fx = fixtures(seed=5, n_points=n_points, batch_size=n_poses, n_in=3,
                  n_out=len(grid))
    args = tuple(torch.from_numpy(np.asarray(fx[k], np.float32))
                 for k in NAMES)
    g = np.random.default_rng(11).standard_normal((n_poses,) + grid)
    return args, torch.from_numpy(g.astype(np.float32))


def _asked_step(backend, grid, asked, create_graph=False):
    """A forward through autograd with the inputs of `asked` requiring
    grad, and `torch.autograd.grad` of ``sum(out * g)`` -> (leaves,
    cotangent, {name: gradient}, the skips it counted)."""
    args, g = _inputs(grid)
    leaves = [a.clone().requires_grad_(n in asked) for a, n in
              zip(args, NAMES)]
    before = dict(core.UNASKED_SKIPS)
    out = dprast_torch.raster(grid, *leaves, backend=backend)
    grads = torch.autograd.grad(
        (out * g).sum(), [x for x, n in zip(leaves, NAMES) if n in asked],
        create_graph=create_graph)
    skips = {n: core.UNASKED_SKIPS[n] - before[n] for n in NAMES}
    return leaves, g, dict(zip(asked, grads)), skips


@pytest.mark.parametrize("backend,asked", CASES)
def test_asked_gradients_are_the_full_pullbacks(backend, asked):
    name, grid = BACKENDS[backend]
    args, g = _inputs(grid)
    full = dprast_torch.raster_pullback(g, *args, backend=name)
    _, _, grads, _ = _asked_step(name, grid, ASKED[asked])
    assert list(grads) == list(ASKED[asked])
    for n, grad in grads.items():
        assert torch.equal(grad, getattr(full, n)), n


@pytest.mark.parametrize("backend,asked", CASES)
def test_unasked_skips_count_the_separable_gradients(backend, asked):
    name, grid = BACKENDS[backend]
    _, _, _, skips = _asked_step(name, grid, ASKED[asked])
    want = {n: int(n in SEPARABLE[name] and n not in ASKED[asked])
            for n in NAMES}
    assert skips == want


@pytest.mark.parametrize("backend,asked", CASES)
def test_standalone_pullback_honours_asked(backend, asked):
    """The registered pullback called with a mask (as autograd's backward
    calls it where there is no fused pair): each asked entry has the
    full call's bits, each skipped one is None, the rest are computed."""
    name, grid = BACKENDS[backend]
    args, g = _inputs(grid)
    bwd = dispatch.bwd_fn(name)
    full = bwd(grid, *args, g)
    mask = tuple(n in ASKED[asked] for n in NAMES)
    before = dict(core.UNASKED_SKIPS)
    got = bwd(grid, *args, g, asked=mask)
    for n, wanted in zip(NAMES, mask):
        skipped = not wanted and n in SEPARABLE[name]
        assert core.UNASKED_SKIPS[n] - before[n] == int(skipped), n
        if skipped:
            assert getattr(got, n) is None, n
        else:
            assert torch.equal(getattr(got, n), getattr(full, n)), n


@pytest.mark.parametrize("asked", list(ASKED))
def test_second_derivative_of_asked_gradients(asked):
    """On `xla` a backward under create_graph=True runs the graph form
    for the asked gradients alone; each, and the second derivative of a
    weighted sum of them, has the bits of the full graph form
    (`core._pullback_graph` of all six) on the same leaves."""
    name, grid = BACKENDS["xla"]
    leaves, g, grads, _ = _asked_step(name, grid, ASKED[asked],
                                      create_graph=True)
    pts, rot, tr, _, ow, pw = leaves
    ref = core._pullback_graph(grid, pts, rot, tr, ow, pw, g)
    rng = np.random.default_rng(2)
    scalar = ref_scalar = None
    for n, grad in grads.items():
        want = getattr(ref, n)
        assert torch.equal(grad.detach(), want.detach()), n
        assert grad.requires_grad == want.requires_grad, n
        if grad.requires_grad:
            w = torch.from_numpy(rng.standard_normal(grad.shape)
                                 .astype(np.float32))
            term, ref_term = (grad * w).sum(), (want * w).sum()
            scalar = term if scalar is None else scalar + term
            ref_scalar = ref_term if ref_scalar is None else \
                ref_scalar + ref_term
    if scalar is None:
        # the background's gradient is a sum of the cotangent alone
        assert asked == "background"
        return
    wrt = [x for x in leaves if x.requires_grad]
    second = torch.autograd.grad(scalar, wrt, allow_unused=True)
    ref_second = torch.autograd.grad(ref_scalar, wrt, allow_unused=True)
    for a, b in zip(second, ref_second):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
