"""B1 (the forward splat) in other forms of its source, on one CUDA card:
where its time goes, and what a form would gain.

Each form is a copy of this checkout's `dprast_torch/` and `chip_smoke.py`
under ``build/exp_b1_forms/<form>/`` with `csrc/fwd_splat.cu` edited:

- ``kernel``: the source as it is;
- ``rows2``, ``rows1``: two or one frame rows per thread and step in
  place of four (`kRows`);
- ``no_atomics``: the window is zeroed and stored, nothing is added (the
  rows are not even read): what the kernel costs without its sums;
- ``no_store``: the sums are made and never stored: what the kernel
  costs without its output;
- ``no_search``: each tile's slots taken as an even share of the live
  ones, without the search of the slot table;
- ``no_zero``: the window is not zeroed.

The last four compute something else and serve only to split the time.
With ``--parent DIR`` (an older checkout unpacked by `git archive` into a
directory that `.gitignore` lists) its B1 is timed beside them.  Every form
builds its own library and runs in a process of its own, in the order of
`FORMS` and back (a, b, .., b, a); each prints, at the main path's three
shapes (128^2 and 1024^2 x 64 poses x 10^5 points, 128^3 x 1 x 10^6, the
flagship cloud and BASELINE config 4, uniform weights), the device
microseconds of one launch of `fwd_splat_enc` at the cluster size its rule
picks (`torch.profiler`) and the first 12 hex digits of the sha256 of its
output, so that the forms that compute the same bits show it.

Usage, from the root of the repository:

    python3 -m dprast_torch.benchmarks.exp_b1_forms [--parent build/parent]
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "exp_b1_forms"

_ADD = """          add_fixed(lo, hi, tg.idx[i],
                    __float2ll_rn(__fmul_rn(tg.v[i], scale)));"""
_STORE = ("  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {\n"
          "    if constexpr (kVec) {")
_ROWS = "constexpr int kRows = 4;"
_SEARCH = ("const int r = warp_lower_bound(st, n_slots, t + warp, "
           "st[n_slots]);")
_ZERO = ("    zero_units<uint4>(win, 0, 2 * n_units);\n  else\n"
         "    zero_units<unsigned>(win, 0, 2 * n_units);")
# form -> the (old, new) edits of csrc/fwd_splat.cu
FORMS = {
    "kernel": [],
    "rows2": [(_ROWS, "constexpr int kRows = 2;")],
    "rows1": [(_ROWS, "constexpr int kRows = 1;")],
    "no_atomics": [(_ADD, "          (void)scale;")],
    "no_store": [(_STORE, "  return;\n" + _STORE)],
    "no_search": [(_SEARCH, "const int r = min((t + warp) * (st[n_slots] "
                            "/ nt), st[n_slots]);")],
    "no_zero": [(_ZERO, "    ;\n  else\n    ;")],
}

WORKER = r'''
import hashlib, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from dprast_torch.ops import splat_binned as sb
from dprast_torch.utils import profiling
dev = torch.device("cuda", 0)
pts, rot, tr = (torch.from_numpy(a).to(dev) for a in cs.flagship_inputs()[:3])
vol = [torch.from_numpy(a).to(dev)
       for a in cs.volume_inputs(1, 1_000_000)[:3]]
out = {}
for grid, (p, r, t) in (((128, 128), (pts, rot, tr)),
                        ((1024, 1024), (pts, rot, tr)),
                        ((128, 128, 128), vol)):
    data, st, nt, chunk = sb._fwd_prep(grid, p, r, t, None, True)
    fn = lambda: sb.fwd_splat_enc(st, data, nt, sb._window(grid), chunk)
    ext = fn()
    torch.cuda.synchronize()
    us = profiling.kernel_device_us(fn, "fwd_splat_kernel", calls=5)
    digest = hashlib.sha256(ext.cpu().numpy().tobytes()).hexdigest()[:12]
    out["x".join(map(str, grid))] = [round(us, 2), digest]
print(json.dumps(out))
'''


def make_form(name: str, edits) -> Path:
    """A copy of the package and `chip_smoke.py` with `edits` applied."""
    d = OUT / name
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    shutil.copytree(ROOT / "dprast_torch", d / "dprast_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", d)
    cu = d / "dprast_torch" / "csrc" / "fwd_splat.cu"
    text = cu.read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"form {name}: {old!r} is not in fwd_splat.cu")
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
                        help="an older checkout whose B1 is timed beside")
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
    for shape in readings["kernel"][0]:
        print(f"{shape}: device us per form, in turns: " + "; ".join(
            f"{name} " + " / ".join(f"{r[shape][0]:.2f}" for r in runs)
            + f" ({runs[0][shape][1]})" for name, runs in readings.items()))


if __name__ == "__main__":
    main()
