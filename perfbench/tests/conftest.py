"""Tests of the benchmark's harness.  They run on the CPU at tiny sizes
(the CPU rehearsal: `run_cell(..., device="cpu")`, which the command line
never takes); those marked `gpu` need the card and skip without one.

    python -m pytest perfbench/tests -q
"""

import json
import os
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs on a CUDA card; skipped where there is none")


@pytest.fixture(autouse=True)
def _card(request):
    # decided per test, not while collecting
    if request.node.get_closest_marker("gpu") and \
            not torch.cuda.is_available():
        pytest.skip("no CUDA device present")


def tiny_root(tmp_path: Path, lr=1e-4) -> Path:
    """A checkout of its own: the benchmark and the program linked in, a
    BENCHMARK.json whose cells, configurations, traffic and limits are all
    defined in files under a second path, `extra/`."""
    root = tmp_path / "root"
    extra = root / "extra"
    for sub in ("configs", "cells", "traffic", "metrics"):
        (extra / sub).mkdir(parents=True)
    os.symlink(REPO / "perfbench", root / "perfbench")
    os.symlink(REPO / "dprast_torch", root / "dprast_torch")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["paths"] = ["perfbench", "extra"]
    bench["configs"] = [
        {"name": name, "source": "test", "reduced": [], "why": "test",
         "file": f"extra/configs/{name}.json"}
        for name in ("tiny2d", "tiny3d")]
    names = {"proj1024": "t2", "vol1024": "t3"}
    bench["workloads"] = [
        {"name": f"{short}_{kind}", "config": cfg,
         "traffic": "fit_tiny" if kind == "fit" else kind, "chips": 1,
         "why": "test"}
        for short, cfg in (("t2", "tiny2d"), ("t3", "tiny3d"))
        for kind in ("fit", "project")]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = [
                names[w.split("_")[0]] + "_" + w.split("_", 1)[1]
                for w in metric["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    proj = json.loads((REPO / "perfbench/configs/proj_1024sq_1e5.json")
                      .read_text())
    proj.update(name="tiny2d", grid=[48, 40], n_points=400,
                poses_per_call=4, pool_poses=8)
    vol = json.loads((REPO / "perfbench/configs/vol_1024cube_1e5.json")
                     .read_text())
    vol.update(name="tiny3d", grid=[20, 24, 16], n_points=300)
    (extra / "configs/tiny2d.json").write_text(json.dumps(proj))
    (extra / "configs/tiny3d.json").write_text(json.dumps(vol))
    fit = json.loads((REPO / "perfbench/traffic/fit.json").read_text())
    fit["lr"] = lr
    (extra / "traffic/fit_tiny.json").write_text(json.dumps(fit))
    for short in ("t2", "t3"):
        (extra / f"cells/{short}_fit.json").write_text(json.dumps(
            {"limits": {"out_err": 1e-5, "loss_gap": 1e-5, "grad_gap": 1e-4,
                        "grad_err": 1e-4, "change_gap": 1e-4}}))
        (extra / f"cells/{short}_project.json").write_text(json.dumps(
            {"limits": {"out_err": 1e-5}}))
    return root


@pytest.fixture
def root(tmp_path):
    return tiny_root(tmp_path)
