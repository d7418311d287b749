"""The readings that a cell's limits are set from: the program's numbers
over many seeds (the lower readings), the control's and the planted
faults' (the upper readings), all in one process, at the cell's own
sizes.  The benchmark's own runs never run this.

    python3 -m perfbench.calibrate --workload proj1024_fit \\
        --runs program:1-12 binned_bf16:101-103 half_batch:201-203 \\
        [--seconds 1] [--out chiprun_out/calibrate.jsonl]

Modes: `program` (the sound run); `binned_bf16` (the program's own
bfloat16 fast mode in place of the cell's backend); `tf32` (the program
with TF32 matrix products switched on); `reference_bf16` (the reference,
computed in bfloat16, put in the program's place); and the planted faults
`unchanged`, `half_batch` and `altered` (`perfbench/kinds/`).  A fit's
readings run no window; a projector's run a short one of `--seconds`.
Prints one JSON line a run and a summary line: each number's smallest and
largest reading by mode.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import sys
from pathlib import Path

import torch

FAULTS = ("unchanged", "half_batch", "altered")


class _ReferenceRaster(torch.autograd.Function):
    """The reference's forward and pullback as one autograd function."""

    @staticmethod
    def forward(ctx, points, rot, tr, point_weight, grid, dtype, reference,
                weights):
        out = torch.empty((rot.shape[0],) + grid, dtype=torch.float32,
                          device=points.device)
        if point_weight is not None:
            weights = weights._replace(point_weight=point_weight.detach())
        reference.render(grid, points.detach(), rot.detach(), tr.detach(),
                         out, dtype=dtype, weights=weights)
        ctx.save_for_backward(points, rot, tr)
        ctx.grid, ctx.dtype, ctx.reference = grid, dtype, reference
        ctx.weights, ctx.has_pw = weights, point_weight is not None
        return out

    @staticmethod
    def backward(ctx, g):
        points, rot, tr = ctx.saved_tensors
        grid, dtype, ref = ctx.grid, ctx.dtype, ctx.reference
        ow, pw = ref.factors(ctx.weights, rot.shape[0], points.shape[0],
                              dtype, points.device)
        d_points = torch.zeros(points.shape, dtype=dtype,
                               device=points.device)
        d_pw = torch.zeros(points.shape[0], dtype=dtype,
                           device=points.device)
        d_rot = torch.zeros(rot.shape, dtype=dtype, device=points.device)
        d_tr = torch.zeros(tr.shape, dtype=dtype, device=points.device)
        flat_g = g.reshape(g.shape[0], -1)
        for b0, b1 in ref.pose_blocks(rot.shape[0], points.shape[0],
                                      len(grid)):
            t = ref.terms(grid, points, rot[b0:b1], tr[b0:b1], dtype)
            g_terms = torch.where(
                t.ok, flat_g[b0:b1].reshape(-1)[t.flat.clamp(min=0)]
                .to(dtype), 0)
            dp, dr, dt, dw = ref.pullback(grid, points, rot[b0:b1], t,
                                          g_terms, ow[b0:b1], pw, dtype)
            d_points += dp
            d_pw += dw
            d_rot[b0:b1] = dr
            d_tr[b0:b1] = dt
        return (d_points.float(), d_rot.float(), d_tr.float(),
                d_pw.float() if ctx.has_pw else None, None, None, None, None)


def reference_raster(reference, dtype):
    """A `raster` that runs the reference in `dtype`."""
    def raster(grid, points, rot, tr, backend=None, background=None,
               out_weight=None, point_weight=None):
        given = {k: v for k, v in (("background", background),
                                   ("out_weight", out_weight))
                 if v is not None}
        pw = None
        if isinstance(point_weight, torch.Tensor):
            pw = point_weight
        elif point_weight is not None:
            given["point_weight"] = point_weight
        return _ReferenceRaster.apply(points, rot, tr, pw, tuple(grid),
                                      dtype, reference,
                                      reference.Weights(**given))
    return raster


@contextlib.contextmanager
def _tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def reading(root, workload, mode, seed, seconds, device="cuda",
            program=None):
    """One run of `workload` in `mode` -> (correct, {number: value},
    the first step's readings leaf by leaf).  `program` is the program's
    `raster` where it is imported already."""
    from perfbench.run import run_cell
    from perfbench.spec import Spec

    spec = Spec(root)
    cell = spec.workload(workload)
    traffic = spec.traffic(cell["traffic"])
    kwargs = {"setup_only": traffic["loop"] == "fit", "raster": program}
    guard = contextlib.nullcontext()
    if mode == "binned_bf16":
        kwargs["backend"] = "binned_bf16"
    elif mode == "tf32":
        guard = _tf32()
    elif mode == "reference_bf16":
        config = spec.config(cell["config"])
        kwargs["raster"] = reference_raster(spec.reference(config),
                                            torch.bfloat16)
    elif mode in FAULTS:
        kwargs["fault"] = mode
    elif mode != "program":
        raise ValueError(f"unknown mode {mode!r}")
    detail = {}
    with guard:
        result = run_cell(root, workload, seed, seconds, device=device,
                          log=lambda *a: None, detail=detail, **kwargs)
    return (result["correct"],
            {k: v["value"] for k, v in result["checks"].items()}, detail)


def _seeds(text):
    seeds = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        seeds += list(range(int(lo), int(hi or lo) + 1))
    return seeds


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--runs", nargs="+", required=True,
                        help="mode:seeds, seeds as 1-12 or 1,5,9")
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    root = Path.cwd().resolve()
    summary = {}
    out = open(args.out, "a") if args.out else None
    for run in args.runs:
        mode, _, seeds = run.partition(":")
        for seed in _seeds(seeds):
            correct, numbers, detail = reading(root, args.workload, mode,
                                               seed, args.seconds)
            line = {"workload": args.workload, "mode": mode, "seed": seed,
                    "correct": correct, "numbers": numbers,
                    "detail": detail}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            for name, value in numbers.items():
                lo, hi = summary.setdefault(mode, {}).get(
                    name, (math.inf, -math.inf))
                summary[mode][name] = (min(lo, value), max(hi, value))
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "summary": summary}))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
