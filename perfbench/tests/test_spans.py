"""The readers of the program's spans (`perfbench/spans.py`,
`metrics/sort_us.fit.py`, `metrics/unasked_grad_us.fit.py`) on synthetic
traces, in the style of `test_harness.py::test_trace_reduction`: a
device operation belongs to a span when its launch lies inside the span
on the span's own thread, so the pullback's spans on autograd's thread
count."""

from types import SimpleNamespace

import pytest

from perfbench import spans, trace
from perfbench.spec import Spec

from .conftest import REPO

GRADS = ["points", "rotation", "translation"]


def _events(host, launches):
    """`host`: (tid, name, ts, dur); `launches`: (tid, launch ts, kernel
    name, kernel start, kernel dur) -> Chrome trace events inside a window
    on thread 1 from 0 to 10,000 µs."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
           "tid": 1, "ts": 0.0, "dur": 10_000.0}]
    for tid, name, ts, dur in host:
        ev.append({"ph": "X", "cat": "cpu_op", "name": name, "tid": tid,
                   "ts": float(ts), "dur": float(dur)})
    for corr, (tid, at, name, start, dur) in enumerate(launches, 1):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                   "tid": tid, "ts": float(at), "dur": 1.0,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "tid": 99,
                   "ts": float(start), "dur": float(dur),
                   "args": {"correlation": corr}})
    return ev


# two fit steps: the forward on the main thread (1), its pullback on
# autograd's (2); each step's sort takes 300 µs, its background sum 50
STEP_SPANS = [
    (1, "dprast.normalise", 50, 40),
    (1, "dprast.raster[binned/binned]", 100, 400),
    (1, "dprast.sort", 150, 100),
    (1, "perfbench.loss", 600, 100),
    (2, "dprast.pullback[binned]", 700, 200),
    (2, "dprast.b4.gather", 710, 50),
    (2, "dprast.grad.background", 800, 50),
]
STEP_LAUNCHES = [
    (1, 60, "fill_kernel", 990, 2),
    (1, 120, "coords_kernel", 1000, 40),
    (1, 160, "DeviceRadixSortOnesweepKernel", 1100, 250),
    (1, 170, "sort_postprocess_kernel", 1400, 50),
    (1, 300, "band_fold_kernel", 1500, 100),
    (1, 650, "vectorized_elementwise_kernel", 1700, 80),
    (2, 720, "bwd_gather_kernel", 1800, 60),
    (2, 810, "reduce_kernel", 1900, 50),
    # on the main thread at a time inside the pullback's spans: not theirs
    (1, 820, "vectorized_elementwise_kernel", 2000, 30),
]


def _two_steps(spans_of=STEP_SPANS, launches_of=STEP_LAUNCHES):
    host, launches = [], []
    for k, shift in enumerate((0, 3000)):
        host += [(tid, name, ts + shift, dur)
                 for tid, name, ts, dur in spans_of]
        launches += [(tid, at + shift, name, start + shift, dur)
                     for tid, at, name, start, dur in launches_of]
    return trace.Trace(_events(host, launches))


def _ctx(t, grads=GRADS, kind="fit"):
    return SimpleNamespace(attributed=t, kind=kind, batches=[0, 1],
                           traffic={"grads": list(grads)})


def _read(name, ctx):
    return Spec(REPO).reader(name).read(ctx)


def test_readers_by_span_and_thread():
    ctx = _ctx(_two_steps())
    # a step's sort: the onesweep 250 and the post-processing 50
    assert _read("sort_us.fit", ctx) == pytest.approx(300.0)
    # the background's sum, launched on autograd's thread; the main
    # thread's launch at the same time is not the span's
    assert _read("unasked_grad_us.fit", ctx) == pytest.approx(50.0)
    # asked for, the background's gradient is no waste
    asked = _ctx(ctx.attributed, GRADS + ["background"])
    assert _read("unasked_grad_us.fit", asked) == 0.0
    # the kernel-name sum of the same capture agrees
    names = ("RadixSort", "sort_postprocess")
    assert ctx.attributed.device_s(names) * 1e6 / 2 == pytest.approx(300.0)


def test_none_without_device_operations():
    t = _two_steps(launches_of=[])
    for name in ("sort_us.fit", "unasked_grad_us.fit"):
        assert _read(name, _ctx(t)) is None
        assert _read(name, _ctx(None)) is None
        # a project run's capture is no fit's
        assert _read(name, _ctx(_two_steps(), kind="project")) is None


def test_zero_where_no_unasked_span_ran():
    """The program's spans ran and launched work, but no gradient of an
    unasked input had any: 0.0, not None, so that the change that stops
    computing them reads as a drop."""
    kept = [s for s in STEP_SPANS if not s[1].startswith("dprast.grad.")]
    ctx = _ctx(_two_steps(spans_of=kept))
    assert _read("unasked_grad_us.fit", ctx) == 0.0
    assert _read("sort_us.fit", ctx) == pytest.approx(300.0)


def test_none_where_the_program_has_no_spans():
    """A checkout from before the spans: the benchmark's own range and
    autograd's node, device operations, no program span -> left out."""
    host = [(1, "perfbench.raster", 100, 400), (1, "aten::sort", 150, 100),
            (2, "_RasterOnceBackward", 700, 200)]
    ctx = _ctx(_two_steps(spans_of=host))
    assert ctx.attributed.launches() == 18
    for name in ("sort_us.fit", "unasked_grad_us.fit"):
        assert _read(name, ctx) is None


def test_stage_table():
    t = _two_steps()
    table = spans.stage_table(t, 2)
    by_span = table["by_span"]
    assert by_span["dprast.sort"] == pytest.approx(300.0)
    assert by_span["dprast.grad.background"] == pytest.approx(50.0)
    assert by_span["dprast.b4.gather"] == pytest.approx(60.0)
    assert table["kernels_by_span"]["dprast.sort"] == {
        "DeviceRadixSortOnesweepKernel": pytest.approx(250.0),
        "sort_postprocess_kernel": pytest.approx(50.0)}
    # the fill of a scalar, before the call's outermost span
    assert by_span["dprast.normalise"] == pytest.approx(2.0)
    # coords and the fold ran in the raster span, outside any stage span
    assert by_span["dprast.raster[binned/binned]"] == pytest.approx(140.0)
    assert table["in_program_spans_us"] == pytest.approx(550.0)
    assert table["coverage"] == pytest.approx(410.0 / 550.0)
    assert table["outside_stage_spans"] == {
        "band_fold_kernel": pytest.approx(100.0),
        "coords_kernel": pytest.approx(40.0)}
    # the loss's kernel and the main thread's launch during the pullback
    assert table["outside_program_spans"] == {
        "perfbench.loss": pytest.approx(80.0), "host": pytest.approx(30.0)}
    assert table["wall_us"] == pytest.approx(5000.0)
    # a gap goes to the span that launched the operation ending it: in the
    # raster span, the gaps before coords (8 µs) and the fold (50)
    assert table["idle_gaps"]["dprast.raster[binned/binned]"] == \
        pytest.approx(58.0)
    assert table["idle_gaps"]["dprast.sort"] == pytest.approx(110.0)
