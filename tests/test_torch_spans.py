"""The port's stage spans (`dprast_torch.utils.profiling.annotate`).

Under a CPU `torch.profiler` capture a forward and an autograd backward
record the spans PERF.md §3 lists: ``dprast.normalise``, the outermost
``dprast.raster[<fwd>/<bwd>]`` with dispatch's resolved pair in its name,
and inside it the forward's stages; ``dprast.pullback[<bwd>]`` with the
pullback's stages inside it: those of the gradients asked for, so a
``dprast.grad.<input>`` span opens only where its input's gradient is.
On the CPU each kernel wrapper runs its plain twin, and the span fires
there too.  With no profiler running the
helper opens no range at all (a spy on the range it would open), and a
span changes no bit of what the call returns.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dprast_torch  # noqa: E402
from dprast_torch.utils import profiling  # noqa: E402
from dprast_torch.utils.testing import fixtures  # noqa: E402

torch.set_num_threads(2)

OUTERMOST = ("dprast.raster[", "dprast.pullback[")
BINNED_FWD = ["dprast.b6.coords", "dprast.b9.slot_prep", "dprast.sort",
              "dprast.frame_gather", "dprast.b1.splat", "dprast.b2.fold"]
BINNED_BWD = ["dprast.b4.gather", "dprast.b8.epilogue"]
# the xla path's forward on the CPU: X2's plain version takes the terms
# unsorted (the CPU's index_add_ keeps their order), so no sort runs here
XLA_FWD = ["dprast.x1.neighbours", "dprast.x2.scatter"]
XLA_BWD = ["dprast.x3.gather"]
# the spans of the gradients with work of their own: the points, rotation
# and translation terms of the xla path (one span), then one span each
CONTRACT = ["dprast.contract"]
GRAD_SPANS = ["dprast.grad.background", "dprast.grad.out_weight",
              "dprast.grad.point_weight"]

# the inputs a step asks gradients of: a fit's points and translations,
# or the three per-pose and per-point values alone
FIT = ("points", "translation")
WEIGHTS = ("background", "out_weight", "point_weight")

# (backend asked, grid, the resolved pair, forward stages, backward stages,
# the inputs whose gradients the step asks for)
PATHS = {
    "binned-multi-tile": ("binned", (300, 200), "binned/binned", BINNED_FWD,
                          BINNED_BWD, FIT),
    "binned-3d": ("binned", (20, 24, 140), "binned/binned", BINNED_FWD,
                  ["dprast.unfold"] + BINNED_BWD, FIT),
    "binned-one-tile": ("binned", (64, 64), "binned/binned",
                        ["dprast.b6.coords", "dprast.b1.splat",
                         "dprast.scale"], BINNED_BWD, FIT),
    "xla": ("xla", (40, 56), "xla/xla", XLA_FWD, XLA_BWD + CONTRACT, FIT),
    "auto-cpu": ("auto", (300, 200), "xla/xla", XLA_FWD, XLA_BWD + CONTRACT,
                 FIT),
    # B8 writes the weights' gradients with the others: only the
    # background's sum has a span of its own on the binned path
    "binned-multi-tile-weights": ("binned", (300, 200), "binned/binned",
                                  BINNED_FWD, BINNED_BWD + GRAD_SPANS[:1],
                                  WEIGHTS),
    "xla-weights": ("xla", (40, 56), "xla/xla", XLA_FWD,
                    XLA_BWD + GRAD_SPANS, WEIGHTS),
}


def _inputs(grid, n_poses=2, n_points=400,
            keys=("points", "rotation", "translation")):
    fx = fixtures(seed=3, n_points=n_points, batch_size=n_poses, n_in=3,
                  n_out=len(grid))
    return tuple(torch.from_numpy(np.asarray(fx[k], np.float32))
                 for k in keys)


def _step(backend, grid, asked=FIT):
    """A forward and an autograd backward of the inputs `asked` -> (out,
    grads).  A step that asks for none of the weights leaves them at
    their defaults."""
    keys = ("points", "rotation", "translation")
    if any(k in WEIGHTS for k in asked):
        keys += WEIGHTS
    args = dict(zip(keys, _inputs(grid, keys=keys)))
    for k in asked:
        args[k].requires_grad_()
    out = dprast_torch.raster(grid, *args.values(), backend=backend)
    grads = torch.autograd.grad((out * out).sum(),
                                tuple(args[k] for k in asked))
    return out.detach(), grads


def _spans(fn, tmp_path):
    """fn() under a CPU capture -> the program's spans, each (name, tid,
    start, end), in the order they started."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], e["tid"], float(e["ts"]),
              float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in events if e.get("ph") == "X"
             and e.get("name", "").startswith("dprast.")]
    return sorted(spans, key=lambda s: s[2])


def _inside(span, outer):
    return span[1] == outer[1] and outer[2] <= span[2] \
        and span[3] <= outer[3]


@pytest.mark.parametrize("path", list(PATHS))
def test_stage_spans_nest_in_their_call(path, tmp_path):
    backend, grid, pair, fwd, bwd, asked = PATHS[path]
    spans = _spans(lambda: _step(backend, grid, asked), tmp_path)
    names = [s[0] for s in spans]
    raster = [s for s in spans if s[0].startswith("dprast.raster[")]
    pullback = [s for s in spans if s[0].startswith("dprast.pullback[")]
    # one call: one forward span naming the pair dispatch resolved, one
    # backward span naming its backward
    assert [s[0] for s in raster] == [f"dprast.raster[{pair}]"]
    assert [s[0] for s in pullback] == \
        [f"dprast.pullback[{pair.split('/')[1]}]"]
    assert names.count("dprast.normalise") == 1
    normalise = spans[names.index("dprast.normalise")]
    assert normalise[3] <= raster[0][2]
    # each stage ran once, in its order, inside its outermost span
    for stages, outer in ((fwd, raster[0]), (bwd, pullback[0])):
        inner = [s for s in spans if _inside(s, outer) and s is not outer]
        assert [s[0] for s in inner] == stages
    # nothing of the program runs outside the three
    for s in spans:
        assert s in (normalise, raster[0], pullback[0]) or \
            _inside(s, raster[0]) or _inside(s, pullback[0]), s


@pytest.mark.parametrize("backend", ["binned", "xla"])
def test_raster_pullback_spans(backend, tmp_path):
    grid = (300, 200)
    pts, rot, tr = _inputs(grid)
    g = torch.ones((2,) + grid)
    spans = _spans(lambda: dprast_torch.raster_pullback(
        g, pts, rot, tr, backend=backend), tmp_path)
    names = [s[0] for s in spans]
    assert names[0] == "dprast.normalise"
    assert names[1] == f"dprast.pullback[{backend}]"
    assert all(_inside(s, spans[1]) for s in spans[2:])
    # all six gradients: every span of the pullback
    stages = {"binned": ["dprast.b6.coords", "dprast.b9.slot_prep",
                         "dprast.sort", "dprast.frame_gather"] + BINNED_BWD
              + GRAD_SPANS[:1],
              "xla": ["dprast.x1.neighbours"] + XLA_BWD + CONTRACT
              + GRAD_SPANS}[backend]
    assert names[2:] == stages


class _Spy:
    """Stands in for the range the helper opens; counts its openings."""

    opened = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _Spy.opened.append(self.name)

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("backend", ["binned", "xla"])
def test_no_range_without_a_profiler(backend, monkeypatch, tmp_path):
    """With no profiler running the helper opens no range (it checks the
    profiler's state and enters nothing); under one it opens one a span,
    so the spy sees what the helper does."""
    grid = (300, 200)
    monkeypatch.setattr(profiling, "_Range", _Spy)
    monkeypatch.setattr(_Spy, "opened", [])
    calls = []
    real = torch.profiler.record_function.__init__

    def record_function_spy(self, *a, **kw):
        calls.append(a)
        real(self, *a, **kw)

    monkeypatch.setattr(torch.profiler.record_function, "__init__",
                        record_function_spy)
    _step(backend, grid)
    assert _Spy.opened == [] and calls == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _step(backend, grid)
    assert "dprast.normalise" in _Spy.opened
    assert any(n.startswith("dprast.pullback[") for n in _Spy.opened)
    assert calls == []


@pytest.mark.parametrize("backend", ["binned", "xla"])
def test_spans_change_no_bit(backend):
    grid = (300, 200)
    plain = _step(backend, grid)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = _step(backend, grid)
    assert torch.equal(plain[0], traced[0])
    for a, b in zip(plain[1], traced[1]):
        assert torch.equal(a, b)


def test_annotate_as_block_and_decorator(tmp_path):
    @profiling.annotate("dprast.test.decorated")
    def twice(x, *, k=2):
        """Doubles."""
        return x * k

    assert twice.__name__ == "twice" and twice.__doc__ == "Doubles."

    def run():
        with profiling.annotate("dprast.test.block"):
            twice(torch.ones(3), k=3)

    spans = _spans(run, tmp_path)
    assert [s[0] for s in spans] == ["dprast.test.block",
                                     "dprast.test.decorated"]
    assert _inside(spans[1], spans[0])
    # an exception leaves the span closed and propagates
    with pytest.raises(ZeroDivisionError):
        with profiling.annotate("dprast.test.raises"):
            1 / 0
