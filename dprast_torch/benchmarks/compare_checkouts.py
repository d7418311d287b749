"""Kernel and step times of two checkouts of this repository on one CUDA
card, taken in turns inside one call.

Times of one configuration differ between calls (another card, another
host), so two versions of a kernel are only comparable when both run in
the same call.  This script starts a worker process in each checkout, in
the order before, after, after, before; each worker builds that
checkout's kernels and times, at the flagship cloud (64 poses x 10^5
points, uniform weights) on 128^2 and 1024^2:

- the coordinate stage (`_keys_and_local`: kernel B6 where the checkout
  has it, ~170 eager launches where not): its median milliseconds and
  what it keeps the card busy with;
- B1, B2, B3 and B4 (natural windows) alone: the median milliseconds of
  the wrapper by CUDA events and the kernel's own device microseconds from
  `torch.profiler` (B1 also at 128^3, one pose x 10^6 points);
- B4 on the cotangent itself (the grid source), where the checkout has it;
- B1 and B4 are reached as the checkout's own path reaches them: on the
  frame's encoded planes where it has `fwd_splat_enc` / `bwd_gather_enc`,
  else on the lane planes (which that path made before each launch);
- the pullback from the forward's frame, the forward and the fused
  forward + pullback step, and what the step keeps the card busy with
  (`torch.profiler`: the microseconds in kernels and copies, and their
  number); the forward and the step also at 128^3, one pose x 10^6 points.

It prints one line per quantity with the readings of the four runs and
the means of each checkout.  Usage, from the root of the newer checkout,
with the older one unpacked by `git archive` into a directory that
`.gitignore` lists:

    python3 -m dprast_torch.benchmarks.compare_checkouts build/parent .

A worker uses only what both checkouts have: the wrappers of
`dprast_torch.ops.splat_binned` and the helpers of `chip_smoke.py`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

WORKER = r'''
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from dprast_torch.ops import splat_binned as sb

dev = torch.device("cuda", 0)
pts, rot, tr = (torch.from_numpy(a).to(dev) for a in cs.flagship_inputs()[:3])
canon = (pts, rot, tr, torch.zeros(cs.N_POSES, device=dev),
         torch.ones(cs.N_POSES, device=dev),
         torch.ones(cs.N_POINTS, device=dev))
out = {}


def both(key, fn, kernel):
    out[key + " ms"] = cs.time_ms(fn)
    out[key + " device us"] = cs.kernel_device_us(fn, kernel)


# B1 and B4 as the checkout's path runs them: on the frame itself where
# it has the encoded instances, else on lane planes
ENC = hasattr(sb, "fwd_splat_enc")


def b1_call(args, data):
    """B1 on the forward's frame (`_fwd_frame` -> args, data)."""
    if ENC:
        st, _, nt, win, chunk = args
        return lambda: sb.fwd_splat_enc(st, data, nt, win, chunk)
    return lambda: sb.fwd_splat(*args)


def b4_call(st, data, ts, win, chunk, **kw):
    """B4 on the frame `data` and the window source `win`."""
    n_out = len(ts)
    if ENC:
        coord = data[:, :n_out]
        return lambda: sb.bwd_gather_enc(st, coord, ts, win, chunk, **kw)
    lane_b = sb._planes_bwd(data[:, :n_out], ts).contiguous()
    return lambda: sb.bwd_gather(st, lane_b, win, chunk, **kw)


for grid in cs.GRIDS:
    tag = "x".join(map(str, grid))
    ts = sb.tile_shape_for(grid)
    args, data = sb._fwd_frame(grid, pts, rot, tr, canon[5], True)
    st, chunk = args[0], args[-1]
    g = torch.randn((cs.N_POSES,) + grid, device=dev)
    out[f"keys {tag} ms"] = cs.time_ms(
        lambda: sb._keys_and_local(grid, ts, pts, rot, tr))
    (out[f"keys {tag} device-busy us"],
     out[f"keys {tag} kernels and copies"]) = cs.device_busy(
        lambda: sb._keys_and_local(grid, ts, pts, rot, tr))
    both(f"B1 {tag}", b1_call(args, data), "fwd_splat_kernel")
    win = g
    if not sb._single_tile(grid):
        ext = b1_call(args, data)()
        ow, bg = canon[4], canon[3]
        both(f"B2 {tag}", lambda: sb.band_fold(ext, grid, ts, ow, bg),
             "band_fold_kernel")
        both(f"B3 {tag}", lambda: sb.band_unfold(g, grid, ts),
             "band_unfold_kernel")
        win = sb.band_unfold(g, grid, ts)
        if "grid" in sb._LAYOUTS:
            both(f"B4 grid source {tag}",
                 b4_call(st, data, ts, g, chunk, layout="grid"),
                 "bwd_gather_kernel")
    both(f"B4 natural {tag}", b4_call(st, data, ts, win, chunk),
         "bwd_gather_kernel")
    res = sb.raster_fwd_res(grid, *canon, pw_uniform=True)[1]
    out[f"pullback from the forward's frame {tag} ms"] = cs.time_ms(
        lambda: sb.raster_pullback_res(grid, res, canon, g, pw_uniform=True))
    out[f"forward {tag} ms"] = cs.time_ms(
        lambda: sb.raster_fwd(grid, *canon, pw_uniform=True))
    def step():
        return sb.raster_pullback_res(
            grid, sb.raster_fwd_res(grid, *canon, pw_uniform=True)[1], canon,
            g, pw_uniform=True)

    out[f"fused step {tag} ms"] = cs.time_ms(step)
    (out[f"fused step {tag} device-busy us"],
     out[f"fused step {tag} kernels and copies"]) = cs.device_busy(step)
# B1 in 3-D: 128^3, one pose x 10^6 points, uniform weights
vol = [torch.from_numpy(a).to(dev) for a in cs.volume_inputs(1, 1_000_000)]
args, data = sb._fwd_frame(cs.VOLUME, *vol[:3], vol[5], True)
tag = "x".join(map(str, cs.VOLUME))
both(f"B1 {tag}", b1_call(args, data), "fwd_splat_kernel")
canon = (*vol[:3], torch.zeros(1, device=dev), torch.ones(1, device=dev),
         torch.ones(1_000_000, device=dev))
g = torch.randn((1,) + cs.VOLUME, device=dev)
ts = sb.tile_shape_for(cs.VOLUME)
out[f"keys {tag} ms"] = cs.time_ms(
    lambda: sb._keys_and_local(cs.VOLUME, ts, *vol[:3]))
out[f"forward {tag} ms"] = cs.time_ms(
    lambda: sb.raster_fwd(cs.VOLUME, *canon, pw_uniform=True))


def step_3d():
    return sb.raster_pullback_res(
        cs.VOLUME, sb.raster_fwd_res(cs.VOLUME, *canon, pw_uniform=True)[1],
        canon, g, pw_uniform=True)


out[f"fused step {tag} ms"] = cs.time_ms(step_3d)
(out[f"fused step {tag} device-busy us"],
 out[f"fused step {tag} kernels and copies"]) = cs.device_busy(step_3d)
print("RESULT " + json.dumps(out))
'''


def run_worker(checkout: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", WORKER], cwd=checkout,
                          capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"worker failed in {checkout}:\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main(argv=None):
    import torch

    from dprast_torch.utils import profiling
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before", type=Path, help="the older checkout")
    ap.add_argument("after", type=Path, help="the newer checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_checkouts: torch.cuda.is_available() is "
                         "False")
    card = profiling.card()
    order = (args.before, args.after, args.after, args.before)
    runs = [run_worker(path.resolve()) for path in order]
    print(f"{card} | runs in the order before, after, after, before",
          flush=True)
    keys = list(dict.fromkeys(k for run in runs for k in run))
    for key in keys:
        got = [run.get(key) for run in runs]
        means = []
        for pair in ((got[0], got[3]), (got[1], got[2])):
            have = [v for v in pair if v is not None]
            means.append(sum(have) / len(have) if have else None)
        cells = ", ".join("-" if v is None else f"{v:.4f}" for v in got)
        mean = " -> ".join("-" if v is None else f"{v:.4f}" for v in means)
        print(f"{card} | {key}: {cells}; mean before -> after {mean}",
              flush=True)


if __name__ == "__main__":
    main()
