"""The harness on the CPU rehearsal: inputs by seed, the reference on hand-
worked cases, the least-work count, the trace's reduction, the result's
keys, a cell found by its files alone, and no JAX anywhere."""

import ast
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dprast_torch
from perfbench import inputs, trace, work
from perfbench.references import raster as ref
from perfbench.run import run_cell
from perfbench.spec import Spec

from .conftest import REPO

SEED = 2 ** 31 + 4242   # past 32 signed bits, as the driver's are
# the checkout's program, imported here from the repository itself
PROGRAM = dprast_torch.raster


# -- inputs -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["fit", "project"])
def test_inputs_repeat_by_seed(root, kind):
    spec = Spec(root)
    config = spec.config("tiny2d")
    traffic = spec.traffic("fit_tiny" if kind == "fit" else "project")
    a = inputs.make(config, traffic, SEED, "cpu")
    b = inputs.make(config, traffic, SEED, "cpu")
    c = inputs.make(config, traffic, SEED + 1, "cpu")
    for x, y, z in zip(a[:4], b[:4], c[:4]):
        assert torch.equal(x, y)
        assert not torch.equal(x, z)
    assert a.sample == b.sample
    ta = inputs.targets(config, a, spec.reference(config))
    tb = inputs.targets(config, b, spec.reference(config))
    assert torch.equal(ta, tb)
    # every seed draws the same sizes
    assert [t.shape for t in a[:4]] == [t.shape for t in c[:4]]


def test_pool_interleaves_angles(root):
    spec = Spec(root)
    config = spec.config("tiny2d")
    data = inputs.make(config, spec.traffic("project"), SEED, "cpu")
    calls, per_call = data.rotation.shape[:2]
    assert (calls, per_call) == (2, 4)
    # pose j * calls + b of the pool is the j-th pose of call b; rotations
    # about one axis: row 0 is (cos a, 0, -sin a), row 1 is (0, 1, 0)
    ang = torch.atan2(-data.rotation[..., 0, 2], data.rotation[..., 0, 0])
    step = 2 * math.pi / 8
    flat = ang.transpose(0, 1).reshape(-1)
    diffs = torch.remainder(flat[1:] - flat[:-1], 2 * math.pi)
    assert torch.allclose(diffs, torch.full_like(diffs, step), atol=1e-5)
    assert torch.equal(data.rotation[..., 1, :],
                       torch.tensor([0.0, 1.0, 0.0]).expand(2, 4, 3))


# -- the reference ----------------------------------------------------------

def test_reference_one_point_by_hand():
    # a 4 x 4 grid: u = (q + 1) * 2 - 1/2; q = (0.1, -0.3) -> u = (1.7, 0.9)
    # -> corners (1, 0), (2, 0), (1, 1), (2, 1) with weights
    # (0.3 * 0.1, 0.7 * 0.1, 0.3 * 0.9, 0.7 * 0.9) (axis 0 first)
    pts = torch.tensor([[0.1, -0.3, 5.0]], dtype=torch.float64)
    rot = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0]]], dtype=torch.float64)
    tr = torch.zeros((1, 2), dtype=torch.float64)
    out = torch.zeros((1, 4, 4), dtype=torch.float64)
    ref.render((4, 4), pts, rot, tr, out)
    want = torch.zeros((4, 4), dtype=torch.float64)
    want[1, 0], want[2, 0], want[1, 1], want[2, 1] = 0.03, 0.07, 0.27, 0.63
    assert torch.allclose(out[0], want, atol=1e-12)
    assert ref.forward_error((4, 4), want[None].float(), pts, rot, tr) < 1e-7
    wrong = want.clone()
    wrong[3, 3] = 0.5
    assert ref.forward_error((4, 4), wrong[None], pts, rot, tr) == \
        pytest.approx(0.5)
    # the loss against a zero target and its gradient by hand: the mean
    # over 16 voxels of out^2; d/du0 of out = (-w1, w1) on the two rows
    target = torch.zeros((1, 4, 4), dtype=torch.float64)
    step = ref.fit_step((4, 4), pts, rot, tr, target)
    assert step.loss == pytest.approx(float((want ** 2).sum() / 16))
    g = 2 * want / 16
    du0 = (g[2, 0] - g[1, 0]) * 0.1 + (g[2, 1] - g[1, 1]) * 0.9
    du1 = (g[1, 1] - g[1, 0]) * 0.3 + (g[2, 1] - g[2, 0]) * 0.7
    assert step.d_translation[0].tolist() == pytest.approx(
        [2 * du0.item(), 2 * du1.item()])
    assert step.d_points[0].tolist() == pytest.approx(
        [2 * du0.item(), 2 * du1.item(), 0.0])
    assert step.d_rotation[0].reshape(-1).tolist() == pytest.approx(
        [2 * du.item() * x for du in (du0, du1) for x in (0.1, -0.3, 5.0)])


def test_reference_drops_voxels_outside():
    pts = torch.tensor([[0.99, 0.0], [-3.0, 0.0]], dtype=torch.float64)
    rot = torch.eye(2, dtype=torch.float64)[None]
    tr = torch.zeros((1, 2), dtype=torch.float64)
    out = torch.zeros((1, 8, 8), dtype=torch.float64)
    ref.render((8, 8), pts, rot, tr, out)
    # u0 = 7.46: only the corners at 7 lie in the grid; the second point
    # lies far outside
    assert out.sum().item() == pytest.approx(1 - 0.46)
    assert out[0, 7].sum().item() == pytest.approx(0.54)


@pytest.mark.parametrize("bg, ow, per_point", [(0.0, 1.0, False),
                                                (0.3, 1.7, True)])
def test_reference_against_oracle(bg, ow, per_point):
    from dprast_torch.utils import testing as oracle

    fx = oracle.fixtures(seed=3, n_points=60, batch_size=3, n_in=3, n_out=3)
    grid = (9, 11, 7)
    args = [torch.tensor(fx[k]) for k in ("points", "rotation",
                                           "translation")]
    pw = torch.linspace(0.5, 2.0, 60, dtype=torch.float64) if per_point \
        else torch.ones(60, dtype=torch.float64)
    weights = ref.Weights(bg, ow, pw if per_point else 1.0)
    out = torch.zeros((3,) + grid, dtype=torch.float64)
    ref.render(grid, *args, out, weights=weights)
    want = oracle.raster_numpy(grid, fx["points"], fx["rotation"],
                               fx["translation"], [bg] * 3, [ow] * 3,
                               pw.numpy())
    assert abs(out.numpy() - want).max() < 1e-12
    assert ref.forward_error(grid, torch.tensor(want), *args,
                             weights=weights) < 1e-12
    # the fit step's gradients against the oracle's pullback of the
    # loss's cotangent, 2 (out - target) / n
    target = torch.rand((3,) + grid, generator=torch.Generator()
                        .manual_seed(5), dtype=torch.float64)
    step = ref.fit_step(grid, *args, target, weights=weights)
    assert step.loss == pytest.approx(
        float(((torch.tensor(want) - target) ** 2).mean()), rel=1e-12)
    cot = 2 * (want - target.numpy()) / target.numel()
    back = oracle.raster_pullback_numpy(
        grid, fx["points"], fx["rotation"], fx["translation"], [bg] * 3,
        [ow] * 3, pw.numpy(), cot)
    for mine, name in ((step.d_points, "points"),
                       (step.d_rotation, "rotation"),
                       (step.d_translation, "translation"),
                       (step.d_point_weight, "point_weight")):
        assert torch.allclose(mine, torch.as_tensor(back[name]),
                              rtol=1e-10, atol=1e-13), name


# -- least work -------------------------------------------------------------

def test_forward_least_work_by_hand():
    flops, nbytes = work.forward((1024, 1024), 100_000, 3, 64)
    # points 1.2 MB, poses 64 * 2 * 4 floats, images 64 * 1024^2 floats
    assert nbytes == 4 * (300_000 + 64 * 2 * 4 + 64 * 1024 ** 2)
    assert flops == 64 * 100_000 * (12 + 4 + 8)
    assert work.least_s(flops, nbytes) == pytest.approx(nbytes / 3.35e12)


@pytest.mark.parametrize("col, sectors", [(2, 2), (7, 4), (9, 2), (15, 2)])
def test_cotangent_sectors_by_hand(col, sectors):
    # one point between columns col and col + 1 and rows 3 and 4 of a 16 x
    # 16 float32 image: two rows, and one or two 8-float sectors a row
    # (column 16 lies outside the grid)
    pts = torch.tensor([[(col + 1.0) / 8 - 1, 4.0 / 8 - 1, 0.0]],
                       dtype=torch.float64)
    rot = torch.tensor([[[0.0, 1, 0], [1.0, 0, 0]]], dtype=torch.float64)
    tr = torch.zeros((1, 2), dtype=torch.float64)
    assert work.cotangent_sectors((16, 16), pts, rot, tr, ref) == sectors


def test_pullback_least_work():
    whole = 64 * 1024 ** 2 * 4
    _, few = work.pullback((1024, 1024), 10, 3, 64,
                           ["points", "rotation", "translation"], 100)
    _, bg = work.pullback((1024, 1024), 10, 3, 64,
                          ["points", "background"], 100)
    _, many = work.pullback((1024, 1024), 10, 3, 64, ["points"], 10 ** 9)
    assert few == 100 * 32 + 4 * (30 + 64 * 8 + 30 + 64 * 6 + 64 * 2)
    assert bg > whole and many > whole
    assert many < whole + 10 ** 5


def test_shares_never_pass_100():
    """A share is least time over measured time; the least counts each
    byte once, so a device that moves exactly those bytes at the peak
    reads 100% and no count reads above what the call must move."""
    grid, n, b = (64, 64), 2000, 8
    gen = torch.Generator().manual_seed(1)
    pts = torch.randn((n, 3), generator=gen, dtype=torch.float64) * 0.4
    rot = torch.eye(3, dtype=torch.float64)[:2].expand(b, 2, 3)
    tr = torch.zeros((b, 2), dtype=torch.float64)
    sectors = work.cotangent_sectors(grid, pts, rot, tr, ref)
    flops, nbytes = work.pullback(grid, n, 3, b, ["points"], sectors)
    naive = b * 64 * 64 * 4 + 4 * (n * 3 * 2 + b * 2 * 4)
    assert nbytes <= naive
    assert sectors * 8 <= b * 64 * 64
    ctx = _ctx_with_device_time(work.least_s(flops, nbytes), grid, n, b,
                                pts, rot, tr)
    assert work.pullback_roofline_pct(ctx, ("bwd",)) == pytest.approx(100)


def _ctx_with_device_time(seconds, grid, n, b, pts, rot, tr):
    from types import SimpleNamespace

    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
         "tid": 1, "ts": 0.0, "dur": 1e6},
        {"ph": "X", "cat": "cpu_op", "name": "bwd", "tid": 1, "ts": 10.0,
         "dur": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 20.0, "dur": 5.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k", "tid": 9, "ts": 30.0,
         "dur": seconds * 1e6, "args": {"correlation": 7}}]
    loop = SimpleNamespace(rot=[rot.float()], tr=[tr.float()],
                           asked=["points"])
    return SimpleNamespace(
        attributed=trace.Trace(events), kind="fit", loop=loop,
        reference=ref,
        config={"grid": list(grid), "n_points": n, "n_in": 3,
                "poses_per_call": b},
        trace_points=pts.float(), batches=[0])


# -- the trace --------------------------------------------------------------

def test_trace_reduction():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
           "tid": 1, "ts": 100.0, "dur": 1000.0},
          {"ph": "X", "cat": "user_annotation", "name": "perfbench.raster",
           "tid": 1, "ts": 110.0, "dur": 50.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "tid": 1,
           "ts": 300.0, "dur": 50.0}]
    # launches at 120 (in the raster range), 130 (in it), 310 (in sort)
    # and one at 2000, after the window
    for corr, at, start, dur, name in ((1, 120, 150, 90, "DeviceRadixSortX"),
                                       (2, 130, 200, 100, "b1"),
                                       (3, 310, 600, 50, "sort_postprocess"),
                                       (4, 2000, 2100, 10, "late")):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                   "tid": 1, "ts": at, "dur": 2.0,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "tid": 7,
                   "ts": start, "dur": dur, "args": {"correlation": corr}})
    t = trace.Trace(ev)
    assert t.launches() == 3
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s() == pytest.approx(200e-6)          # 150-300, 600-650
    assert t.device_s() == pytest.approx(240e-6)
    assert t.device_s(("RadixSort", "sort_postprocess")) == \
        pytest.approx(140e-6)
    assert t.device_s_in(t.ranges(("perfbench.raster",))) == \
        pytest.approx(190e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["window end"] == pytest.approx(450e-6)  # 650-1100
    assert gaps["aten::sort"] == pytest.approx(300e-6)  # 300-600
    assert gaps["perfbench.raster"] == pytest.approx(50e-6)  # 100-150
    assert t.by_name(1) == [["b1", pytest.approx(100e-6)]]


def test_device_capture_window():
    """Without the host's ranges the window runs from the first launch of
    a device operation to the end of the last one."""
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaGetDevice",
           "tid": 1, "ts": 5.0, "dur": 1.0, "args": {"correlation": 9}}]
    for corr, at, start, dur in ((1, 10, 40, 20), (2, 50, 70, 30)):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                   "tid": 1, "ts": at, "dur": 2.0,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "tid": 7,
                   "ts": start, "dur": dur, "args": {"correlation": corr}})
    t = trace.Trace(ev)
    assert (t.t0, t.t1) == (10.0, 100.0)
    assert t.busy_s() == pytest.approx(50e-6)
    assert dict(t.idle_gaps()) == {"before k1": pytest.approx(30e-6),
                                   "before k2": pytest.approx(10e-6)}


# -- runs -------------------------------------------------------------------

@pytest.mark.parametrize("workload", ["t2_fit", "t3_fit", "t2_project",
                                      "t3_project"])
def test_cell_runs_and_its_last_line(root, workload):
    result = run_cell(root, workload, SEED, 0.2, device="cpu",
                      raster=PROGRAM, log=lambda *a: None)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    kind = workload.split("_")[1]
    want = {"fit": {"fit_step_ms", "fit_step_p95_ms", "setup_s"},
            "project": {"project_ms", "setup_s"}}[kind]
    assert set(result["metrics"]) == want   # peak memory: on the card only
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"} and metric["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for check in result["checks"].values():
        assert check["value"] <= check["limit"]
    json.dumps(result)


@pytest.mark.parametrize("workload", ["t2_fit", "t3_project"])
def test_traced_run(root, workload):
    result = run_cell(root, workload, SEED, 0.2, trace=True, device="cpu",
                      raster=PROGRAM, log=lambda *a: None)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert result["correct"] is True
    assert result["attempted"] == 64
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0
    # a CPU run traces no device: the device's metrics are left out
    assert set(result["metrics"]) <= {"host_ms_per_step.fit"}


def _add(root, entry, group="workloads", config=None):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench[group].append(entry)
    if config:
        bench["configs"].append(
            {"name": config, "source": "test", "reduced": [], "why": "test",
             "file": f"extra/configs/{config}.json"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_cell_defined_only_by_files(root):
    """A density fit (per-point weights that require grad, a background):
    a new configuration, traffic mix, cell and metric are files and
    entries, and no file is edited."""
    extra = root / "extra"
    config = json.loads((extra / "configs/tiny3d.json").read_text())
    config.update(name="tiny3d_pw", weights={
        "background": 0.25, "out_weight": 1.5,
        "point_weight": {"uniform": [0.5, 2.0]}})
    (extra / "configs/tiny3d_pw.json").write_text(json.dumps(config))
    traffic = json.loads((extra / "traffic/fit_tiny.json").read_text())
    traffic["grads"] = ["points", "point_weight"]
    (extra / "traffic/fit_pw.json").write_text(json.dumps(traffic))
    (extra / "cells/t3_fit_pw.json").write_text(json.dumps(
        {"limits": {"out_err": 1e-5, "loss_gap": 1e-5, "grad_err": 1e-4}}))
    (extra / "metrics/steps_run.py").write_text(
        "def read(ctx):\n    return float(ctx.window['count'])\n")
    _add(root, {"name": "t3_fit_pw", "config": "tiny3d_pw",
                "traffic": "fit_pw", "chips": 1, "why": "test"},
         config="tiny3d_pw")
    _add(root, {"name": "steps_run", "unit": "count", "better": "higher",
                "bound": 0.01, "source": "host_clock",
                "workloads": ["t3_fit_pw"]}, group="end_to_end")
    detail = {}
    result = run_cell(root, "t3_fit_pw", SEED, 0.2, device="cpu",
                      raster=PROGRAM, log=lambda *a: None, detail=detail)
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["steps_run"]["value"] == result["attempted"]
    assert list(result["checks"]) == ["out_err", "loss_gap", "grad_gap",
                                      "grad_err", "change_gap"]
    assert result["checks"]["grad_gap"]["limit"] is None
    # the weights' gradient is compared, and is no zero
    assert set(detail) == {"points", "point_weight"}
    assert detail["point_weight"][1] > 0
    # the weights reach the program: the reference without them disagrees
    config["weights"] = {}
    (extra / "configs/tiny3d_pw.json").write_text(json.dumps(config))
    traffic["grads"] = ["points"]
    (extra / "traffic/fit_pw.json").write_text(json.dumps(traffic))
    plain = run_cell(root, "t3_fit_pw", SEED, 0.2, device="cpu",
                     raster=PROGRAM, log=lambda *a: None)
    assert plain["correct"] is True
    assert plain["checks"]["loss_gap"]["value"] < 1e-5


def test_loop_kind_defined_only_by_files(root):
    """A new kind of loop is its own file under `kinds/`, found by the
    name its traffic gives."""
    extra = root / "extra"
    (extra / "kinds").mkdir()
    (extra / "kinds/pairs.py").write_text(
        "from perfbench.loops import Loop as _Base\n"
        "class Loop(_Base):\n"
        "    kind = 'pairs'\n"
        "    def step(self, i, b):\n"
        "        self.out = (b, self.raster(self.grid, self.inputs.points,\n"
        "                    self.rot[b], self.tr[b]))\n"
        "    def setup(self):\n"
        "        self.run(2)\n"
        "def numbers(loop, reference, detail=None):\n"
        "    b, out = loop.out\n"
        "    return {'out_err': reference.forward_error(\n"
        "        loop.grid, out, loop.inputs.points, loop.rot[b],\n"
        "        loop.tr[b])}\n")
    (extra / "traffic/pairs.json").write_text(json.dumps({"loop": "pairs"}))
    (extra / "cells/t2_pairs.json").write_text(json.dumps(
        {"limits": {"out_err": 1e-5}}))
    _add(root, {"name": "t2_pairs", "config": "tiny2d", "traffic": "pairs",
                "chips": 1, "why": "test"})
    result = run_cell(root, "t2_pairs", SEED, 0.1, device="cpu",
                      raster=PROGRAM, log=lambda *a: None)
    assert result["correct"] is True and result["attempted"] > 0
    assert list(result["checks"]) == ["out_err"]


def test_command_without_a_card_prints_nothing(root):
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", "t2_fit",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode == 3 and proc.stdout == ""


def test_command_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's paths."""
    import shutil

    bare = tmp_path / "bare"
    shutil.copytree(REPO / "perfbench", bare / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", bare)
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "proj1024_fit", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=bare, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


# -- no JAX -----------------------------------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in (REPO / "perfbench").rglob("*.py"):
        found = set(_imports(path)) & {"jax", "jaxlib", "flax", "dprast"}
        assert not found, (path, found)
    for path in (REPO / "perfbench/references").rglob("*.py"):
        assert "dprast_torch" not in set(_imports(path)), path


def test_processes_hold_no_jax(root):
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from perfbench.run import run_cell, forbidden_modules\n"
        "run_cell('.', 't2_fit', 5, 0.1, device='cpu', log=print)\n"
        "run_cell('.', 't3_project', 5, 0.1, trace=True, device='cpu',"
        " log=print)\n"
        "print('FOUND', forbidden_modules())\n"
        "import dprast_torch, perfbench.run\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print('TOP', sorted(top & {'jax', 'jaxlib', 'flax', 'dprast'}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FOUND []" in proc.stdout and "TOP []" in proc.stdout
    code = ("import sys, importlib.util\n"
            "s = importlib.util.spec_from_file_location('r', "
            "'perfbench/references/raster.py')\n"
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m)\n"
            "top = {k.split('.')[0] for k in sys.modules}\n"
            "print(sorted(top & {'jax', 'dprast', 'dprast_torch', "
            "'perfbench'}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.strip() == "[]", proc.stderr[-2000:]


def test_forbidden_names_compared_whole():
    from perfbench import run

    before = dict(sys.modules)
    try:
        sys.modules["dprast_torch_like"] = sys.modules["json"]
        assert "dprast" not in run.forbidden_modules()
        sys.modules["dprast.api"] = sys.modules["json"]
        assert "dprast" in run.forbidden_modules()
    finally:
        for name in set(sys.modules) - set(before):
            del sys.modules[name]
