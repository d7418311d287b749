"""The flagship's cell (`proj128_fit`, one 128^2 tile) and the metrics
`program_host_pct.fit` and `step_workspace_gb`: the first reader on
synthetic traces, in the style of `test_spans.py` (the program's spans on
the caller's thread and on autograd's, nested, read on one clock within
the benchmark's own ranges around a step's calls); a traced run of the
tiny one-tile fit cell (`t2_fit`, 48x40) through `run_cell` on the CPU
rehearsal and on the card; every cell's per-layer metrics by the
benchmark's rule; and, on the card, the cell's control and faults at its
own size."""

from types import SimpleNamespace

import pytest

import dprast_torch
from perfbench import run, trace
from perfbench.calibrate import reading
from perfbench.spec import Spec

from .conftest import REPO
from .test_spans import _events

SEED = 2 ** 31 + 4243
CELL = "proj128_fit"
METRIC = "program_host_pct.fit"
WORKSPACE = "step_workspace_gb"


def _reader():
    return Spec(REPO).reader(METRIC)


def _ctx(host, launches, kind="fit"):
    return SimpleNamespace(attributed=trace.Trace(_events(host, launches)),
                           kind=kind, batches=[0, 1])


# a step: the benchmark's ranges around raster (90-610) and autograd.grad
# (700-1100) on the caller's thread (1), autograd's thread (2) running the
# pullback while the caller waits; stage spans nested in the outermost
STEP = [
    (1, "perfbench.raster", 90, 520),
    (1, "dprast.normalise", 100, 40),
    (1, "dprast.raster[binned/binned]", 150, 300),
    (1, "dprast.b6.coords", 160, 50),
    (1, "dprast.b1.splat", 220, 60),
    (1, "aten::sub", 620, 40),
    (1, "perfbench.grad", 700, 400),
    (2, "MeanBackward0", 720, 30),
    (2, "_RasterOnceBackward", 800, 260),
    (2, "dprast.pullback[binned]", 810, 200),
    (2, "dprast.b4.gather", 820, 50),
    (2, "dprast.b8.epilogue", 900, 80),
    (2, "dprast.grad.background", 990, 15),
]
LAUNCHES = [(1, 170, "coords_kernel", 1200, 40),
            (2, 830, "bwd_gather_kernel", 1300, 60)]


def test_share_of_two_steps():
    host, launches = [], []
    for shift in (0, 3000):
        host += [(tid, n, ts + shift, dur) for tid, n, ts, dur in STEP]
        launches += [(tid, at + shift, n, s + shift, d)
                     for tid, at, n, s, d in LAUNCHES]
    # a step's host time: 520 + 400; the program's: normalise 40, raster
    # 300, the pullback 200 (its stage spans inside add nothing)
    assert _reader().read(_ctx(host, launches)) == \
        pytest.approx(100 * 540 / 920)


def test_share_on_one_clock_within_the_step():
    """The threads' spans are one union on the host's clock, and a span
    outside the step's ranges adds nothing: the share cannot pass 100."""
    host = [(1, "perfbench.raster", 100, 300),
            (1, "dprast.raster[binned/binned]", 100, 300),
            (1, "perfbench.grad", 500, 200),
            (2, "dprast.pullback[binned]", 450, 200),
            (2, "dprast.b8.epilogue", 460, 400),
            # on the caller's thread at the same time as the pullback
            (1, "dprast.normalise", 550, 100)]
    # the program's union 100-400 and 450-860, clipped to 100-400 and
    # 500-700: all of the step
    assert _reader().read(_ctx(host, LAUNCHES)) == pytest.approx(100.0)
    host[-2] = (2, "dprast.b8.epilogue", 460, 140)
    # the pullback's union 450-650 gives the grad range 150 of its 200
    assert _reader().read(_ctx(host, LAUNCHES)) == \
        pytest.approx(100 * 450 / 500)


def test_left_out_without_spans_device_or_step():
    read = _reader().read
    no_program = [h for h in STEP if not h[1].startswith("dprast.")]
    assert read(_ctx(no_program, LAUNCHES)) is None
    assert read(_ctx(STEP, [])) is None
    assert read(_ctx(STEP, LAUNCHES, kind="project")) is None
    assert read(SimpleNamespace(attributed=None, kind="fit",
                                batches=[0])) is None
    no_step = [h for h in STEP if not h[1].startswith("perfbench.")]
    assert read(_ctx(no_step, LAUNCHES)) is None


def test_onetile_cell_traced_on_the_cpu(root, monkeypatch):
    """The tiny fit cell is one tile (48x40): `binned` runs the single-tile
    path's plain versions through the benchmark's loop.  Its attributing
    capture holds the one-tile stages and none of the multi-tile ones,
    and the share reads from it; the run's line leaves the metric out,
    since a CPU run traces no device."""
    captures = []
    capture = trace.capture

    def keeping(fn, device, host=True):
        captures.append(capture(fn, device, host=host))
        return captures[-1]

    monkeypatch.setattr(trace, "capture", keeping)
    result = run.run_cell(root, "t2_fit", SEED, 0.2, trace=True,
                          device="cpu", raster=dprast_torch.raster,
                          backend="binned", log=lambda *a: None)
    assert result["correct"] is True, result["checks"]
    assert not {METRIC, WORKSPACE} & set(result["metrics"])
    t = captures[-1]
    names = {h[3] for h in t.host}
    assert {"dprast.raster[binned/binned]", "dprast.pullback[binned]",
            "dprast.b6.coords", "dprast.b1.splat", "dprast.scale",
            "dprast.b4.gather", "dprast.b8.epilogue"} <= names
    assert not names & {"dprast.b9.slot_prep", "dprast.sort",
                        "dprast.frame_gather", "dprast.b2.fold"}
    assert 0.0 < _reader().share(t) <= 100.0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["t2_fit", "t3_project"])
def test_traced_metrics_on_the_card(root, workload):
    result = run.run_cell(root, workload, SEED, 0.2, trace=True,
                          device="cuda", raster=dprast_torch.raster,
                          log=lambda *a: None)
    assert result["correct"] is True, result["checks"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    peak = result["device"]["memory_peak_bytes"] / 1e9
    assert 0.0 < metrics[WORKSPACE] <= peak
    if workload.endswith("_fit"):
        assert 0.0 < metrics[METRIC] <= 100.0


def per_layer_of(spec, workload):
    """A cell's per-layer metrics: those that list it, and those that list
    no cell and move an end-to-end metric the cell reports."""
    end_to_end = {m["name"] for m in spec.metrics(workload, False)}
    return {m["name"] for m in spec.bench["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in end_to_end)}


def test_every_cell_reports_a_per_layer_metric():
    spec = Spec(REPO)
    for cell in spec.bench["workloads"]:
        assert per_layer_of(spec, cell["name"]), cell["name"]
    assert per_layer_of(spec, CELL) == {WORKSPACE}
    for workload in ("proj1024_fit", "vol1024_fit"):
        assert {METRIC, WORKSPACE} <= per_layer_of(spec, workload)


def test_cell_entries():
    """A configuration, a cell file and entries: the flagship's one tile,
    nothing cut; the cell reports set-up and another end-to-end metric,
    and the harness reads `program_host_pct.fit` in every fit cell."""
    spec = Spec(REPO)
    cell = spec.workload(CELL)
    config = spec.config(cell["config"])
    assert (cell["traffic"], cell["chips"]) == ("fit", 1)
    assert config["grid"] == [128, 128] and config["reduced"] == []
    assert (config["n_points"], config["poses_per_call"],
            config["pool_poses"]) == (100_000, 64, 1024)
    end_to_end = {m["name"] for m in spec.metrics(CELL, per_layer=False)}
    assert "setup_s" in end_to_end and len(end_to_end) >= 2
    for workload in ("proj1024_fit", "vol1024_fit", CELL):
        assert METRIC in {m["name"]
                          for m in spec.metrics(workload, per_layer=True)}
    assert set(spec.cell_file(CELL)["limits"]) == {
        "out_err", "loss_gap", "grad_gap", "grad_err", "change_gap"}


@pytest.mark.gpu
def test_control_fails_at_the_cells_size():
    spec = Spec(REPO).cell_file(CELL)
    for seed in (1, 2, 3):
        ok, numbers, _ = reading(REPO, CELL, "program", seed, 0.5)
        assert ok, numbers
        for mode in [spec["control"]] + spec.get("faults", []):
            ok, numbers, _ = reading(REPO, CELL, mode, seed, 0.5)
            assert not ok, (mode, numbers)
