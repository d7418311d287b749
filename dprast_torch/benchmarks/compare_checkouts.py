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
  number); the forward and the step also at 128^3, one pose x 10^6 points;
- the two entry points a user calls with default weights: the training
  step through autograd (`dprast_torch.raster`, then `torch.autograd.grad`
  of ``sum(out * g)`` with respect to the points and the translation) and
  the API's `raster_pullback`, at all three shapes, with what the
  autograd step keeps the card busy with;
- where the checkout has the pullback's epilogue as a stage (B8,
  `pullback_epilogue`), the "bwd epilogue" alone on the rows B4 gave the
  fused pair, beside its torch form (`_epilogue_plain`), with uniform
  weights and again ("weighted") with per-point weights, and the fused
  step with the torch form in its place (``epilogue=_epilogue_plain``),
  each with what it keeps the card busy with, at all three shapes;
- what the fused step keeps the card busy with, by kernel
  (`profile_binned.step_by_kernel`, its inputs): each kernel's device
  microseconds and launches per step, at all three shapes (a kernel's
  name without its argument list, which a new parameter changes);
- the `xla` backend at ``1024cube_1e5`` (1024^3, one pose, 10^5 points,
  `benchmarks.run`'s inputs, per-point weights) and at ``512cube_1e6``
  (512^3, one pose, 10^6 points): the forward, the fused step and the
  autograd step of all six inputs, each with what it keeps the card busy
  with and its peak device memory; each of the path's kernels alone (X1,
  X2's fill and run kernel, X3: device microseconds a launch) and in the
  fused step; X3's wrapper on the host at 1024^3; and X2 on a run of 1.2
  x 10^6 terms.  ``--xla-only`` times
  these rows alone.

It prints one line per quantity with the readings of the four runs and
the means of each checkout.  Usage, from the root of the newer checkout,
with the older one unpacked by `git archive` into a directory that
`.gitignore` lists:

    python3 -m dprast_torch.benchmarks.compare_checkouts build/parent .
    python3 -m dprast_torch.benchmarks.compare_checkouts --xla-only \
        build/parent .

A worker uses only what both checkouts have: the public entry points, the
wrappers of `dprast_torch.ops.splat_binned` and the helpers of
`chip_smoke.py`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# a worker is HEAD_WORKER (imports and helpers), BINNED_WORKER (the binned
# path's stages at the three shapes; left out by --xla-only) and XLA_WORKER
# (the xla rows, and the result line)
HEAD_WORKER = r'''
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
import dprast_torch
from dprast_torch.benchmarks import profile_binned as pb
from dprast_torch.benchmarks.run import _args_for, _cotangent
from dprast_torch.ops import core, splat_binned as sb

dev = torch.device("cuda", 0)
pts, rot, tr = (torch.from_numpy(a).to(dev) for a in cs.flagship_inputs()[:3])
canon = (pts, rot, tr, torch.zeros(cs.N_POSES, device=dev),
         torch.ones(cs.N_POSES, device=dev),
         torch.ones(cs.N_POINTS, device=dev))
out = {}


def both(key, fn, kernel):
    out[key + " ms"] = cs.time_ms(fn)
    out[key + " device us"] = cs.kernel_device_us(fn, kernel)


def entry_points(tag, grid, pts, rot, tr, g):
    """The autograd step and the API's pullback, default weights."""
    pts_req = pts.clone().requires_grad_()
    tr_req = tr.clone().requires_grad_()

    def grad_step():
        loss = (dprast_torch.raster(grid, pts_req, rot, tr_req) * g).sum()
        return torch.autograd.grad(loss, (pts_req, tr_req))

    out[f"autograd step {tag} ms"] = cs.time_ms(grad_step)
    (out[f"autograd step {tag} device-busy us"],
     out[f"autograd step {tag} kernels and copies"]) = cs.device_busy(
        grad_step)
    out[f"raster_pullback (API) {tag} ms"] = cs.time_ms(
        lambda: dprast_torch.raster_pullback(g, pts, rot, tr))


def short(name):
    """A kernel's name without the argument list at its end."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i]
    return name


def by_kernel(tag, grid, points, batch):
    """The fused step's device time by kernel (`step_by_kernel`)."""
    res = pb.step_by_kernel(grid, points, batch)
    for name, us, count in res["rows"]:
        key = f"fused step {tag} by kernel, {short(name)[:120]}"
        out[key + " us"] = out.get(key + " us", 0.0) + us
        out[key + " launches"] = out.get(key + " launches", 0.0) + count
    out[f"fused step {tag} by kernel, busy us"] = res["busy_us"]
    out[f"fused step {tag} by kernel, launches"] = res["launches"]


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


# the pullback's epilogue as a stage of its own (B8), where the checkout
# has it: the kernels and their torch form on the rows B4 gives the fused
# pair, and the fused step with either
EPILOGUE = hasattr(sb, "pullback_epilogue")


def epilogue_stage(tag, grid, canon, g):
    chunk = sb._default_chunk(grid, canon[0].shape[0])
    gen = torch.Generator(device=dev).manual_seed(5)
    weights = torch.rand(canon[0].shape[0], generator=gen, device=dev) + 0.5
    for form, uniform in (("", True), (" weighted", False)):
        inputs = canon if uniform else (*canon[:5], weights)
        res = sb.raster_fwd_res(grid, *inputs, pw_uniform=uniform)[1]
        coord, idx_rows, st = sb._residual_planes(res, uniform)
        caught = []

        def catch(*a, **kw):
            caught.append((a, kw))
            return sb.pullback_epilogue(*a, **kw)

        sb._pullback_from_frame(grid, coord, idx_rows, st, inputs[0],
                                inputs[1], inputs[4], inputs[5], g,
                                chunk=chunk, pw_uniform=uniform,
                                epilogue=catch)
        a, kw = caught[0]
        for name, fn in (("bwd epilogue" + form, sb.pullback_epilogue),
                         ("bwd epilogue (torch form)" + form,
                          sb._epilogue_plain)):
            out[f"{name} {tag} ms"] = cs.time_ms(lambda: fn(*a, **kw))
            (out[f"{name} {tag} device-busy us"],
             out[f"{name} {tag} kernels and copies"]) = cs.device_busy(
                lambda: fn(*a, **kw))

    def step_torch_form():
        res = sb.raster_fwd_res(grid, *canon, pw_uniform=True)[1]
        coord, idx_rows, st = sb._residual_planes(res, True)
        return sb._pullback_from_frame(
            grid, coord, idx_rows, st, canon[0], canon[1], canon[4],
            canon[5], g, chunk=chunk, pw_uniform=True,
            epilogue=sb._epilogue_plain)

    key = f"fused step with the torch-form epilogue {tag}"
    out[key + " ms"] = cs.time_ms(step_torch_form)
    out[key + " device-busy us"], out[key + " kernels and copies"] = \
        cs.device_busy(step_torch_form)


'''

BINNED_WORKER = r'''
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
    if EPILOGUE:
        epilogue_stage(tag, grid, canon, g)
    entry_points(tag, grid, pts, rot, tr, g)
    by_kernel(tag, grid, cs.N_POINTS, cs.N_POSES)
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
if EPILOGUE:
    epilogue_stage(tag, cs.VOLUME, canon, g)
entry_points(tag, cs.VOLUME, *vol[:3], g)
by_kernel(tag, cs.VOLUME, 1_000_000, 1)
'''

XLA_WORKER = r'''
import re
import time
from dprast_torch.benchmarks.exp_xla_scatter import by_kernel
# the xla backend at its timed rows: the forward, the fused step and the
# autograd step of all six inputs (per-point weights), with what each
# keeps the card busy with and its peak device memory
for name, big, n_points in (("1024cube_1e5", (1024, 1024, 1024), 100_000),
                            ("512cube_1e6", (512, 512, 512), 1_000_000)):
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in _args_for(n_points, 1, big, 3))
    g = _cotangent(1, big, dev)
    leaves = [x.clone().requires_grad_() for x in args]

    def xla_step():
        _, res = core.raster_fwd_res(big, *args)
        return core.raster_pullback_res(big, res, args, g)

    def xla_autograd():
        img = dprast_torch.raster(big, *leaves, backend="xla")
        return torch.autograd.grad((img * g).sum(), leaves)

    for what, fn in (("forward", lambda: core.raster_fwd(big, *args)),
                     ("fused step", xla_step),
                     ("autograd step", xla_autograd)):
        key = f"xla {what} {name}"
        out[key + " ms"] = cs.time_ms(fn)
        out[key + " device-busy us"], out[key + " kernels and copies"] = \
            cs.device_busy(fn)
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        out[key + " peak GB"] = torch.cuda.max_memory_allocated() / 1e9
    # each kernel alone, on the checkout's own keys, terms and residuals:
    # its device microseconds a launch
    pts, rot, tr, bg, ow, pw = args
    keys, vals, res = core.xla_neighbours(big, pts, rot, tr, ow, pw)
    order, perm = torch.sort(keys.reshape(-1), stable=True)
    vals = vals.reshape(-1)
    for kname, fn in (
            ("xla_neighbours_kernel",
             lambda: core.xla_neighbours(big, pts, rot, tr, ow, pw)),
            ("xla_fill_kernel",
             lambda: core.xla_scatter(bg, big, order, perm, vals)),
            ("xla_scatter_kernel",
             lambda: core.xla_scatter(bg, big, order, perm, vals)),
            ("xla_gather_kernel",
             lambda: core.xla_gather(big, g, res, ow, pw))):
        out[f"xla {kname} {name} device us"] = cs.launch_us(fn, kname)
    if name == "1024cube_1e5":
        # X3's wrapper on the host (its kernel is shorter: the host sets
        # the pace), the mean of 1,000 calls
        for _ in range(50):
            core.xla_gather(big, g, res, ow, pw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            core.xla_gather(big, g, res, ow, pw)
        out[f"xla xla_gather wrapper {name} host us"] = (
            time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    # what the fused step keeps the card busy with, kernel by kernel
    for kname, us, n in by_kernel(xla_step):
        found = re.search(r"xla_\w+?_kernel", kname)
        if found:
            key = f"xla fused step {name} {found.group()} device us"
            out[key] = out.get(key, 0.0) + us
    del args, g, leaves, keys, vals, res, order, perm
    torch.cuda.empty_cache()
# X2 on its longest run: a (64,) grid and 1.2 x 10^6 points in one
# voxel's span, two runs of 1.2 x 10^6 terms
gen = torch.Generator(device=dev).manual_seed(3)
lpts = 0.1 + 1e-4 * torch.rand((1_200_000, 1), generator=gen, device=dev)
lpw = 0.5 + torch.rand(1_200_000, generator=gen, device=dev)
lkeys, lvals, _ = core.xla_neighbours(
    (64,), lpts, torch.ones((1, 1, 1), device=dev),
    torch.zeros((1, 1), device=dev), torch.ones(1, device=dev), lpw,
    residuals=False)
lorder, lperm = torch.sort(lkeys.reshape(-1), stable=True)
lbg = torch.zeros(1, device=dev)
out["xla long run xla_scatter_kernel device us"] = cs.launch_us(
    lambda: core.xla_scatter(lbg, (64,), lorder, lperm, lvals.reshape(-1)),
    "xla_scatter_kernel", calls=3)
print("RESULT " + json.dumps(out))
'''



# the whole comparison's worker
WORKER = HEAD_WORKER + BINNED_WORKER + XLA_WORKER


def run_worker(checkout: Path, xla_only: bool = False) -> dict:
    worker = HEAD_WORKER + XLA_WORKER if xla_only else WORKER
    proc = subprocess.run([sys.executable, "-c", worker], cwd=checkout,
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
    ap.add_argument("--xla-only", action="store_true",
                    help="time the xla backend's rows alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_checkouts: torch.cuda.is_available() is "
                         "False")
    card = profiling.card()
    order = (args.before, args.after, args.after, args.before)
    runs = [run_worker(path.resolve(), args.xla_only) for path in order]
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
