"""B8 (the pullback's epilogue) in other forms of its source, on one CUDA
card: where E1's time goes, and the depths the kernels were built with.

Each form is a copy of this checkout's `dprast_torch/` and `chip_smoke.py`
under ``build/exp_b8_forms/<form>/`` with `csrc/epilogue.cu` edited:

- ``kernel``: the source as it is;
- ``no_store``: E1 stores nothing into the point-order copy: what it
  costs without the unsort's stores;
- ``frame_store``: E1 stores each row at its own frame position (modulo
  P) in place of its point's: the same stores, coalesced;
- ``no_sums``: E1 makes no partial sums (nor the gathers of the cloud
  they need): the unsort alone;
- ``ring3``: the single tile's ring of asynchronous copies three poses
  deep in place of two (`kStages`);
- ``ahead4``: E2 on several tiles issues four poses' loads before their
  arithmetic in place of two (`kAhead`).

The first three edits compute something else and serve only to split the
time.  With ``--parent DIR`` (an older checkout unpacked by `git archive`
into a directory that `.gitignore` lists) its epilogue is timed beside
them.  Every form builds its own library and runs in a process of its
own, in the order of `FORMS` and back (a, b, .., b, a); each prints, at the
main path's three shapes (128^2 and 1024^2 x 64 poses x 10^5 points, 128^3
x 1 x 10^6: the flagship cloud and BASELINE config 4) with uniform and
per-point weights, on the arguments the main path hands the epilogue
(`chip_smoke.b8_args`), the device microseconds of each of the epilogue's
kernels that ran (`torch.profiler`), the epilogue's busy microseconds and
launches, and the first 12 hex digits of the sha256 of its outputs, so
that the forms that compute the same bits show it.

Usage, from the root of the repository:

    python3 -m dprast_torch.benchmarks.exp_b8_forms [--parent build/parent]
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "exp_b8_forms"

_STORE = "    if (!real[m]) continue;\n    if (width == 2) {"
_PASSES = ("  for (int k0 = 0; k0 < n_in; k0 += KA) {\n"
           "    float xg[R][KA];")
# form -> the (old, new) edits of csrc/epilogue.cu
FORMS = {
    "kernel": [],
    "no_store": [(_STORE, "    if (real[m] || !real[m]) continue;\n"
                          "    if (width == 2) {")],
    "frame_store": [(f"reinterpret_cast<{t}*>(copy)[pose + id[m]]",
                     f"reinterpret_cast<{t}*>(copy)"
                     f"[pose + (base + m * kThreads) % n_points]")
                    for t in ("float2", "float4")],
    "no_sums": [(_PASSES, _PASSES.replace("k0 < n_in", "k0 < 0"))],
    "ring3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "ahead4": [("constexpr int kAhead = 2;", "constexpr int kAhead = 4;")],
}
# the epilogue's kernels, by the names of either checkout's launches
KERNELS = ("epilogue_tile_kernel", "epilogue_poses_kernel",
           "epilogue_rows_kernel", "epilogue_points_kernel")

WORKER = r'''
import hashlib, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from dprast_torch.ops import splat_binned as sb
from dprast_torch.utils import profiling
dev = torch.device("cuda", 0)
out = {}
for grid, n_poses, n_points in cs.B8_CASES:
    for weighted in (False, True):
        args, kw = cs.b8_args(sb, grid, n_poses, n_points, dev,
                              weighted=weighted, terms=0)
        fn = lambda: sb.pullback_epilogue(*args, **kw)
        res = fn()
        torch.cuda.synchronize()
        digest = hashlib.sha256(b"".join(
            r.cpu().numpy().tobytes() for r in res)).hexdigest()[:12]
        us = {k: round(profiling.kernel_device_us(fn, k, calls=5), 2)
              for k in KERNELS}
        busy, launches = profiling.device_busy(fn)
        out[f"{'x'.join(map(str, grid))} "
            f"{'weighted' if weighted else 'uniform'}"] = {
            "us": {k.replace("_kernel", ""): v for k, v in us.items() if v},
            "busy": round(busy, 2), "launches": launches, "sha": digest}
print(json.dumps(out))
'''.replace("KERNELS", repr(KERNELS))


def make_form(name: str, edits) -> Path:
    """A copy of the package and `chip_smoke.py` with `edits` applied."""
    d = OUT / name
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    shutil.copytree(ROOT / "dprast_torch", d / "dprast_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", d)
    cu = d / "dprast_torch" / "csrc" / "epilogue.cu"
    text = cu.read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"form {name}: {old!r} is not in epilogue.cu")
        text = text.replace(old, new)
    cu.write_text(text)
    return d


def run(checkout: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", WORKER], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: worker failed\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="an older checkout whose epilogue is timed "
                             "beside")
    args = parser.parse_args(argv)
    from dprast_torch.utils import profiling
    print(profiling.card(0))
    dirs = {name: make_form(name, edits) for name, edits in FORMS.items()}
    if args.parent is not None:
        dirs["parent"] = args.parent.resolve()
    readings = {name: [] for name in dirs}
    for name in list(dirs) + list(dirs)[::-1]:
        readings[name].append(run(dirs[name]))
        print(name, json.dumps(readings[name][-1]), flush=True)
    for case in readings["kernel"][0]:
        print(f"{case}: device us per form and kernel, in turns; busy us in "
              f"launches")
        for name, runs in readings.items():
            r = [run_[case] for run_ in runs]
            print(f"  {name}: " + "; ".join(
                f"{k} " + " / ".join(f"{x['us'][k]:.2f}" for x in r)
                for k in r[0]["us"]) + "; busy " + " / ".join(
                f"{x['busy']:.2f} in {x['launches']:.0f}" for x in r)
                + f" ({r[0]['sha']})")


if __name__ == "__main__":
    main()
