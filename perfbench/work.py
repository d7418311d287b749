"""The least work of a call, counted from the cell's shapes and inputs
alone, never from how the program lays out its data, and the least time
the card could take for it against the published peaks (`peaks.json`).

Forward: the inputs read once (points, rotations, translations, and the
per-point weights where there are any) and the B output images or volumes
written once.  Pullback: the points and the poses read once and the asked
gradients written once; of the float32 cotangent, the smaller of the
whole of it and the 32-byte sectors that the points' 2^N in-grid corners
touch, worked out from the inputs by the reference's own coordinates
(the whole of it only where a gradient that needs all of it, background
or out_weight, is asked).  Operations: per (pose, point) the transform,
the corners' weights and, in the pullback, the derivatives and the
contractions; they bound no cell here (bytes do), but the least time
takes the larger of the two.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

F32 = 4
SECTOR = 32
PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def least_s(flops: float, nbytes: float, peaks=PEAKS) -> float:
    return max(flops / peaks["fp32_flops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])


def forward(grid, n_points, n_in, poses, per_point_weight=False):
    """(flops, bytes) of one forward call."""
    n_out = len(grid)
    nbytes = F32 * (n_points * n_in + poses * n_out * (n_in + 1)
                    + (n_points if per_point_weight else 0)
                    + poses * math.prod(grid))
    flops = poses * n_points * (2 * n_in * n_out + 2 * n_out
                                + 2 ** n_out * n_out)
    return flops, nbytes


def cotangent_sectors(grid, points, rot, tr, reference) -> int:
    """The 32-byte sectors of a float32 (B, *grid) cotangent that the
    in-grid corners of the points under the poses `rot`, `tr` touch."""
    per_sector = SECTOR // F32
    found = []
    for b0, b1 in reference.pose_blocks(rot.shape[0], points.shape[0],
                                        len(grid)):
        t = reference.terms(grid, points, rot[b0:b1], tr[b0:b1])
        flat = t.flat[t.ok] + b0 * math.prod(grid)
        found.append(torch.unique(torch.div(flat, per_sector,
                                            rounding_mode="floor")))
        del t, flat
    return int(torch.unique(torch.cat(found)).numel()) if found else 0


def pullback(grid, n_points, n_in, poses, asked, sectors,
             per_point_weight=False):
    """(flops, bytes) of one pullback that returns the gradients `asked`
    (names of `raster`'s six inputs), given the cotangent's touched
    sectors."""
    n_out = len(grid)
    whole = poses * math.prod(grid) * F32
    needs_all = "background" in asked or "out_weight" in asked
    cot = whole if needs_all else min(whole, sectors * SECTOR)
    written = {"points": n_points * n_in, "rotation": poses * n_out * n_in,
               "translation": poses * n_out, "background": poses,
               "out_weight": poses, "point_weight": n_points}
    nbytes = cot + F32 * (n_points * n_in + poses * n_out * (n_in + 1)
                          + (n_points if per_point_weight else 0)
                          + sum(written[a] for a in asked))
    flops = poses * n_points * (2 * n_in * n_out + 2 ** n_out * 2 * n_out
                                + 4 * n_in * n_out)
    return flops, nbytes


def _per_point(config) -> bool:
    """Whether the configuration gives one weight a point."""
    return isinstance(config.get("weights", {}).get("point_weight"), dict)


def fwd_roofline_pct(ctx, ranges=("perfbench.raster",)):
    """The forward's least time over the device time of the kernels
    launched inside the benchmark's `raster` ranges of the attributing
    capture of a project window, in percent; None where it holds no such
    time."""
    if ctx.attributed is None or ctx.kind != "project":
        return None
    device_s = ctx.attributed.device_s_in(ctx.attributed.ranges(ranges))
    if device_s <= 0:
        return None
    c = ctx.config
    least = least_s(*forward(c["grid"], c["n_points"], c["n_in"],
                             c["poses_per_call"], _per_point(c)))
    return 100.0 * least * len(ctx.batches) / device_s


def pullback_roofline_pct(ctx, ranges):
    """The pullback's least time over the device time of the kernels
    launched inside autograd's backward of the program's raster function
    (`ranges`, its names in the trace) in the attributing capture of a fit
    window, in percent; None where it holds no such time."""
    if ctx.attributed is None or ctx.kind != "fit":
        return None
    device_s = ctx.attributed.device_s_in(ctx.attributed.ranges(ranges))
    if device_s <= 0:
        return None
    c, loop = ctx.config, ctx.loop
    sectors = {b: cotangent_sectors(c["grid"], ctx.trace_points,
                                    loop.rot[b].detach(),
                                    loop.tr[b].detach(), ctx.reference)
               for b in set(ctx.batches)}
    least = sum(least_s(*pullback(c["grid"], c["n_points"], c["n_in"],
                                  c["poses_per_call"], loop.asked,
                                  sectors[b], _per_point(c)))
                for b in ctx.batches)
    return 100.0 * least / device_s
