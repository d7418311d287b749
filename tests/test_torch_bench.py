"""The port's benchmark entry points on the CPU: `bench_torch.py` against
`bench.py`, `dprast_torch.benchmarks.run` against `benchmarks/run.py`
(its table, its inputs, its backends, its records, `--multihost` on two
Gloo processes), and `tests_gpu/`, the on-card suite, which collects here
and skips every test.  The numbers these scripts print on the card are
`chip_smoke.py`'s [bench] and [run] business."""

import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import types
import xml.etree.ElementTree as ET

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
import bench_torch  # noqa: E402
from benchmarks import run as jrun  # noqa: E402
from dprast.ops import dispatch as jdispatch  # noqa: E402
from dprast_torch.benchmarks import run as trun  # noqa: E402
from dprast_torch.ops import dispatch as tdispatch  # noqa: E402

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the reference's detail keys (`bench.py`) and record keys
# (`benchmarks/run.py` with --grad)
BENCH_DETAIL = ("backend", "platform", "t_fwd_ms", "t_bwd_ms", "t_fwd_ms_pm",
                "t_bwd_ms_pm", "n_points", "batch", "grid")
RUN_KEYS = ("config", "backend", "t_fwd_ms", "t_fwd_ms_pm", "t_bwd_ms",
            "t_bwd_ms_pm", "t_grad_ms", "t_grad_ms_pm", "splats_per_s")


def _bits(a):
    a = np.asarray(a)
    assert a.dtype == np.float32
    return a.view(np.uint32)


def test_bench_inputs_bit_equal_to_bench_py(monkeypatch, capsys):
    """What `bench.py` hands the binned forward and pullback, captured by
    recorders in place of `dispatch.fwd_fn` / `bwd_fn`, is what
    `bench_torch.flagship_inputs` draws, bit for bit."""
    seen = {}

    def recorder(kind):
        def fn(backend):
            def call(grid, *args, **kw):
                seen[kind] = (backend, grid, args, kw)
                if kind == "fwd":
                    return jnp.zeros((1,), jnp.float32)
                zero = jnp.zeros((1,), jnp.float32)
                return types.SimpleNamespace(translation=zero, points=zero,
                                             rotation=zero)
            return call
        return fn

    def one_call(step, *extra, **kw):
        step(jnp.float32(0.0), *extra)
        return 1.0, 0.0

    monkeypatch.setattr(jdispatch, "fwd_fn", recorder("fwd"))
    monkeypatch.setattr(jdispatch, "bwd_fn", recorder("bwd"))
    monkeypatch.setattr("benchmarks.timing.per_iter_stats", one_call)
    bench.main()
    assert json.loads(capsys.readouterr().out)["metric"] == bench_torch.METRIC

    args, g = bench_torch.flagship_inputs()
    for kind, want in (("fwd", args), ("bwd", args + (g,))):
        _, grid, got, kw = seen[kind]
        assert grid == (128, 128) and kw == {"pw_uniform": True}
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_bench_torch_on_the_cpu(capsys):
    """`bench_torch --device cpu` prints one JSON line with `bench.py`'s
    keys and the port's."""
    bench_torch.main(["--device", "cpu", "--points", "500", "--poses", "2",
                      "--grid", "32,32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "points_splats_per_s_fwd_bwd_3d_to_2d_128sq"
    assert rec["unit"] == "splats/s" and rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 1.58e8)
    detail = rec["detail"]
    assert set(BENCH_DETAIL) <= set(detail)
    assert {"t_step_ms", "t_grad_ms", "name", "power_limit"} <= set(detail)
    assert detail["platform"] == "cpu" and detail["backend"] == "binned"
    assert (detail["n_points"], detail["batch"], detail["grid"]) == (
        500, 2, [32, 32])


def test_bench_torch_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        bench_torch.main([])
    with pytest.raises(SystemExit, match="--device cpu"):
        trun.main(["--configs", "128sq_1e5"])


def test_configs_are_the_reference_table():
    assert trun.CONFIGS == jrun.CONFIGS
    assert len(trun.CONFIGS) == 12


@pytest.mark.parametrize("shape", [(2000, 64, (128, 128), 3),
                                   (2000, 64, (64, 64), 2),
                                   (5000, 1, (16, 16, 16), 3)])
def test_args_for_matches_the_reference(shape):
    """The deterministic inputs (rotations, background, output weights)
    are the reference's bits; the random ones (drawn with numpy, not
    `jax.random`) have its shapes, dtypes and distributions."""
    n_points, batch, grid, n_in = shape
    with jax.enable_x64(False):
        ref = [np.asarray(a) for a in jrun._args_for(*shape)]
    got = trun._args_for(*shape)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    for i in (1, 3, 4):           # rotation, background, out_weight
        np.testing.assert_array_equal(_bits(got[i]), _bits(ref[i]))
    pts, _, tr, _, _, pw = got
    assert abs(pts.std() / 0.4 - 1) < 0.05 and abs(pts.mean()) < 0.02
    assert abs(tr.std() / 0.1 - 1) < 0.5
    assert pw.min() >= 0.5 and pw.max() < 2.0
    assert abs(pw.mean() - 1.25) < 0.05


DISPATCH_ROWS = {cfg[0]: cfg for cfg in trun.CONFIGS}


@pytest.mark.parametrize("name", list(DISPATCH_ROWS))
def test_rows_name_the_backend_auto_picks(name, monkeypatch):
    """Each row runs on what the port's `auto` picks on the card (the fast
    mode on `_bf16` rows): JAX's choice on a TPU, but where that is
    `matmul`, which the port picks nowhere on the card
    (`tests/test_torch_api.py::test_auto_dispatch_matches_jax`)."""
    _, n_points, _, grid, *_ = DISPATCH_ROWS[name]
    got = trun.backends(name, n_points, grid)
    if name.endswith("_bf16"):
        assert got == ("binned_bf16", "binned_bf16")
        return
    assert got == tdispatch.resolve_pair("auto", len(grid), grid, n_points,
                                         accelerator=True)
    monkeypatch.setattr(jdispatch, "_on_tpu", lambda: True)
    with jax.enable_x64(False):
        want = jdispatch.resolve_pair("auto", len(grid), grid, n_points)
    if want == ("matmul", "matmul"):
        want = ("binned", "binned")
    assert got == want
    if name == "1024cube_1e5":
        assert got == ("xla", "xla")


@pytest.mark.parametrize("row", [
    ("128sq_1e5", 400, 2, (32, 32), 3, 153.0, 9.0),
    ("128sq_1e5_pw", 400, 2, (32, 32), 3, None, None, True),
    ("128sq_1e5_bf16", 400, 2, (300, 200), 3, None, None),
    ("128cube_1e5", 300, 1, (8, 16, 200), 3, None, None)])
def test_run_config_on_the_cpu(row, capsys):
    """A row at a small size carries the reference's keys (with --grad),
    the port's, and no error; it prints itself as one JSON line."""
    rec = trun.run_config(*row, with_grad=True, device="cpu")
    assert set(RUN_KEYS) <= set(rec)
    assert not [k for k in rec if k.endswith("error")]
    assert rec["inputs"] == "numpy" and rec["platform"] == "cpu"
    assert rec["backend"] == ("binned_bf16" if row[0].endswith("_bf16")
                              else "binned")
    assert ("vs_a100" in rec) == (row[5] is not None)
    assert json.loads(capsys.readouterr().out) == rec


def test_large_cotangent_is_an_outer_product(monkeypatch):
    """Above 2^27 voxels the cotangent is a plane times ones times 0.1."""
    monkeypatch.setattr(trun, "_DENSE_COTANGENT", 0)
    g = trun._cotangent(2, (4, 5, 6), "cpu")
    plane = np.random.default_rng(7).standard_normal((2, 4, 5)).astype(
        np.float32)
    assert g.shape == (2, 4, 5, 6)
    np.testing.assert_array_equal(
        g.numpy(), np.repeat(plane[..., None], 6, -1) * np.float32(0.1))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _multihost(n_procs, baseline=None):
    """`run --multihost` in `n_procs` Gloo processes on the CPU at the
    JAX test's size -> the lines the processes print."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "dprast_torch.benchmarks.run",
           "--multihost", "--device", "cpu",
           "--coordinator", f"localhost:{_free_port()}",
           "--num-processes", str(n_procs), "--mh-grid", "16,16",
           "--mh-points", "501", "--mh-poses", "6"]
    if baseline is not None:
        cmd += ["--baseline", repr(baseline)]
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(n_procs)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    return [ln for out in outs for ln in out.splitlines()
            if ln.startswith("{")]


def test_multihost_two_gloo_processes():
    """A one-process row, then two processes: exactly one record, whose
    efficiency is its splats/s per process over the one-process row's."""
    (base,) = _multihost(1)
    base = json.loads(base)
    assert base["n_processes"] == 1 and base["mesh"] == {"poses": 1,
                                                         "points": 1}
    lines = _multihost(2, baseline=base["splats_per_s_per_chip"])
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["n_processes"] == 2 and rec["cards"] == 0
    assert rec["mesh"] == {"poses": 1, "points": 2}
    assert (rec["n_points"], rec["batch"], rec["grid"]) == (501, 6, [16, 16])
    assert rec["splats_per_s_per_chip"] > 0
    assert rec["efficiency_vs_1chip"] == pytest.approx(
        rec["splats_per_s_per_chip"] / base["splats_per_s_per_chip"])


def test_tests_gpu_collects_and_skips_here(tmp_path):
    """`tests_gpu/` collects the reference suite's 13 cases and skips
    every one of them without a card."""
    xml = tmp_path / "tests_gpu.xml"
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests_gpu", "-q",
         "-p", "no:cacheprovider", f"--junitxml={xml}"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    suite = ET.parse(xml).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    assert int(suite.get("tests")) >= 13
    assert int(suite.get("skipped")) == int(suite.get("tests"))


def test_entry_points_import_no_jax():
    """The benchmark entry points and the on-card suite run where there is
    no JAX: they import neither `jax` nor the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|dprast)(\.|\s|$)", re.M)
    files = [ROOT / "bench_torch.py", ROOT / "dprast_torch" / "benchmarks" /
             "run.py"] + sorted((ROOT / "tests_gpu").glob("*.py"))
    assert len(files) >= 4
    for path in files:
        assert not pat.search(path.read_text()), path
