"""The density fit's cell (`proj1024_fit_pw`: the 1024^2 row with per-point
weights that require grad) and the metric `epilogue_us.fit`: the cell's
files against the ones it copies, the cell itself shrunk as `tiny_root`
shrinks the others and run on the CPU rehearsal, traced and untraced,
through the binned path's plain versions on several tiles, with a wrong
weights' gradient planted around the program; the reader on synthetic
captures, in the style of `test_spans.py`."""

import json
from types import SimpleNamespace

import pytest

import dprast_torch
from perfbench import run, trace
from perfbench.spec import Spec

from .conftest import REPO, tiny_root
from .test_spans import _events

SEED = 2 ** 31 + 4244
CELL = "proj1024_fit_pw"
TINY = "t2_fit_pw"
METRIC = "epilogue_us.fit"
# the cell's numbers: `kinds/fit.py`'s and the weights' own
# (`kinds/fit_density.py`)
NUMBERS = {"out_err", "loss_gap", "grad_gap", "grad_err", "change_gap",
           "pw_err"}
TINY_LIMITS = {"out_err": 1e-5, "loss_gap": 1e-5, "grad_gap": 1e-4,
               "grad_err": 1e-4, "change_gap": 1e-4, "pw_err": 1e-4}


def _json(path):
    return json.loads((REPO / path).read_text())


def test_cell_files():
    """The configuration is the 1024^2 row's with drawn point weights,
    the traffic `fit`'s with the weights' gradient asked, and the cell
    reads the fit metrics the issue's lists give it."""
    spec = Spec(REPO)
    cell = spec.workload(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("proj_1024sq_1e5_pw", "fit_density", 1)
    base = _json("perfbench/configs/proj_1024sq_1e5.json")
    config = spec.config(cell["config"])
    changed = {k for k in base if base[k] != config[k]}
    assert changed == {"name", "source", "weights", "assumed"}
    assert config["reduced"] == [] and config["reference"] == "raster"
    assert config["weights"] == {"background": None, "out_weight": None,
                                 "point_weight": {"uniform": [0.5, 2.0]}}
    fit = _json("perfbench/traffic/fit.json")
    traffic = spec.traffic("fit_density")
    assert {k for k in fit if fit[k] != traffic[k]} == \
        {"loop", "about", "grads"}
    assert traffic["loop"] == "fit_density"
    assert traffic["grads"] == fit["grads"] + ["point_weight"]
    assert set(spec.cell_file(CELL)["limits"]) == NUMBERS
    per_layer = {m["name"] for m in spec.metrics(CELL, per_layer=True)}
    assert {METRIC, "binned_pullback_roofline", "sort_us.fit",
            "launches_per_step.fit", "unasked_grad_us.fit",
            "step_workspace_gb", "program_host_pct.fit"} <= per_layer
    assert METRIC in {m["name"]
                      for m in spec.metrics("proj1024_fit", per_layer=True)}


def _pw_root(tmp_path):
    """`tiny_root` with the cell shrunk from the repository's own files:
    300x200 (3 x 2 tiles, so the frame is gathered after the sort and B8
    runs E1 / E2's plain form), 400 points, 4 poses a step."""
    root = tiny_root(tmp_path)
    extra = root / "extra"
    config = _json("perfbench/configs/proj_1024sq_1e5_pw.json")
    config.update(name="tiny2d_pw", grid=[300, 200], n_points=400,
                  poses_per_call=4, pool_poses=8)
    (extra / "configs/tiny2d_pw.json").write_text(json.dumps(config))
    # `fit_tiny`'s step size, under a name that only `extra/` holds
    # (`Spec.find` searches `perfbench/` first)
    traffic = _json("perfbench/traffic/fit_density.json")
    traffic["lr"] = json.loads(
        (extra / "traffic/fit_tiny.json").read_text())["lr"]
    (extra / "traffic/fit_density_tiny.json").write_text(json.dumps(traffic))
    (extra / f"cells/{TINY}.json").write_text(json.dumps(
        {"limits": TINY_LIMITS}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(
        {"name": "tiny2d_pw", "source": "test", "reduced": [], "why": "test",
         "file": "extra/configs/tiny2d_pw.json"})
    bench["workloads"].append({"name": TINY, "config": "tiny2d_pw",
                               "traffic": "fit_density_tiny", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_on_the_cpu(tmp_path, monkeypatch, traced):
    root = _pw_root(tmp_path)
    captures = []
    capture = trace.capture

    def keeping(fn, device, host=True):
        captures.append(capture(fn, device, host=host))
        return captures[-1]

    monkeypatch.setattr(trace, "capture", keeping)
    detail = {}
    result = run.run_cell(root, TINY, SEED, 0.2, trace=traced,
                          device="cpu", raster=dprast_torch.raster,
                          backend="binned", log=lambda *a: None,
                          detail=detail)
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == NUMBERS
    # the weights' gradient is compared, and neither side's is zero
    assert set(detail) == {"points", "rotation", "translation",
                           "point_weight"}
    applied, ref_norm, _ = detail["point_weight"]
    assert applied > 0 and ref_norm > 0
    if not traced:
        assert captures == []
        # the cell's end-to-end metrics; peak memory on the card only
        want = {m["name"] for m in Spec(root).metrics(TINY, False)}
        assert set(result["metrics"]) == want - {"peak_mem_gb"}
        return
    # a CPU run traces no device: the device's metrics are left out
    assert set(result["metrics"]) <= {"host_ms_per_step.fit"}
    names = {h[3] for h in captures[-1].host}
    assert {"dprast.raster[binned/binned]", "dprast.pullback[binned]",
            "dprast.sort", "dprast.frame_gather", "dprast.b1.splat",
            "dprast.b2.fold", "dprast.b4.gather",
            "dprast.b8.epilogue"} <= names
    ctx = SimpleNamespace(attributed=captures[-1], kind="fit",
                          batches=[0, 1])
    assert Spec(root).reader(METRIC).read(ctx) is None


def _scaled_pw_grad(scale):
    """The program with the weights' gradient scaled by `scale` and all
    else as it is: the weights keep their values in the forward."""
    def raster(grid, points, rot, tr, point_weight=None, **kwargs):
        pw = point_weight * scale + (point_weight * (1 - scale)).detach()
        return dprast_torch.raster(grid, points, rot, tr,
                                   point_weight=pw, **kwargs)
    return raster


@pytest.mark.parametrize("scale", [0.5, 0.0], ids=["halved", "zero"])
def test_wrong_weights_gradient_fails(tmp_path, scale):
    """A halved or zero `d_point_weight` under a right forward fails
    `pw_err` by its own norm; the forward's, the loss's and the points'
    numbers read as a sound run's."""
    root = _pw_root(tmp_path)
    result = run.run_cell(root, TINY, SEED, 0.2, device="cpu",
                          raster=_scaled_pw_grad(scale), backend="binned",
                          log=lambda *a: None, setup_only=True)
    checks = result["checks"]
    assert result["correct"] is False
    assert checks["pw_err"]["value"] == pytest.approx(1 - scale, abs=1e-3)
    for name in ("out_err", "loss_gap", "change_gap"):
        assert checks[name]["value"] <= TINY_LIMITS[name], checks


# a step: the forward on the caller's thread (1), the pullback on
# autograd's (2) with B4 and then B8's two kernels
STEP = [
    (1, "dprast.raster[binned/binned]", 100, 400),
    (1, "dprast.b1.splat", 150, 100),
    (2, "dprast.pullback[binned]", 700, 300),
    (2, "dprast.b4.gather", 710, 50),
    (2, "dprast.b8.epilogue", 800, 100),
]
LAUNCHES = [
    (1, 160, "fwd_splat_kernel", 1000, 250),
    (2, 720, "bwd_gather_kernel", 1300, 150),
    (2, 810, "epilogue_rows_kernel", 1500, 220),
    (2, 830, "epilogue_points_kernel", 1750, 40),
    # on the caller's thread while B8's span is open: not the span's
    (1, 820, "vectorized_elementwise_kernel", 1800, 30),
]


def _ctx(host, launches, kind="fit"):
    shifted_host, shifted = [], []
    for shift in (0, 3000):
        shifted_host += [(tid, n, ts + shift, dur) for tid, n, ts, dur in host]
        shifted += [(tid, at + shift, n, s + shift, d)
                    for tid, at, n, s, d in launches]
    return SimpleNamespace(
        attributed=trace.Trace(_events(shifted_host, shifted)), kind=kind,
        batches=[0, 1])


def _read(ctx):
    return Spec(REPO).reader(METRIC).read(ctx)


def test_epilogue_reads_its_span_alone():
    # a step's E1 220 and E2 40, launched inside the span on its thread
    assert _read(_ctx(STEP, LAUNCHES)) == pytest.approx(260.0)


def test_epilogue_left_out_without_spans_device_or_fit():
    no_program = [(1, "perfbench.raster", 100, 400),
                  (2, "_RasterOnceBackward", 700, 300)]
    assert _read(_ctx(no_program, LAUNCHES)) is None
    assert _read(_ctx(STEP, [])) is None
    assert _read(_ctx(STEP, LAUNCHES, kind="project")) is None
    assert _read(SimpleNamespace(attributed=None, kind="fit",
                                 batches=[0])) is None
    # the program's spans ran, but no epilogue span: nothing launched there
    no_b8 = [s for s in STEP if s[1] != "dprast.b8.epilogue"]
    assert _read(_ctx(no_b8, LAUNCHES)) == 0.0
