"""A cell's inputs, made on the device from the seed.

The points are the upstream rows' cloud, N(0, sigma^2) in each input axis
(`dprast_torch/benchmarks/run.py`, 0.4); the poses of the pool are
rotations about one axis (the (first, last) input plane, as there) at
`pool_poses` angles evenly spread over the turn from an offset drawn from
the seed, each with a translation N(0, 0.1^2); a call takes the poses
b, b + calls, b + 2 calls, ... of the pool (interleaved subsets, as an
ordered-subsets reconstruction takes them).  A fit starts from the truth
cloud moved by N(0, init_jitter^2) and fits targets that the reference
renders from the truth.  Every seed draws the same sizes.

The configuration's `weights` give `raster`'s background, out_weight and
point_weight: null for the program's default (not passed), a number, or,
for point_weight, {"uniform": [lo, hi]}: one weight a point drawn from the
seed after everything else.
"""

from __future__ import annotations

import math
import random
from typing import NamedTuple

import torch


class Inputs(NamedTuple):
    truth: torch.Tensor      # (P, n_in) float32
    points: torch.Tensor     # (P, n_in) float32, the cloud a call sees first
    rotation: torch.Tensor   # (calls, B, n_out, n_in) float32
    translation: torch.Tensor  # (calls, B, n_out) float32
    sample: int              # the window call whose output is compared
    point_weight: torch.Tensor | None  # (P,) float32 where drawn

# a project window compares the output of a call drawn from its first
# SAMPLE_CALLS calls, and of its last call
SAMPLE_CALLS = 16


def make(config: dict, traffic: dict, seed: int, device) -> Inputs:
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n_points, n_in = config["n_points"], config["n_in"]
    grid = config["grid"]
    n_out = len(grid)
    pool, per_call = config["pool_poses"], config["poses_per_call"]
    calls = pool // per_call
    f32 = torch.float32
    truth = torch.randn((n_points, n_in), generator=gen, device=device,
                        dtype=f32) * config["points_sigma"]
    jitter = traffic.get("init_jitter", 0.0)
    points = truth + jitter * torch.randn(
        (n_points, n_in), generator=gen, device=device, dtype=f32) \
        if jitter else truth.clone()
    step = 2 * math.pi / pool
    offset = torch.rand((), generator=gen, device=device,
                        dtype=torch.float64) * step
    angles = offset + step * torch.arange(pool, device=device,
                                          dtype=torch.float64)
    c, s = torch.cos(angles), torch.sin(angles)
    rot = torch.eye(n_in, device=device, dtype=torch.float64).repeat(
        pool, 1, 1)
    rot[:, 0, 0], rot[:, 0, -1] = c, -s
    rot[:, -1, 0], rot[:, -1, -1] = s, c
    rot = rot[:, :n_out].to(f32)
    tr = torch.randn((pool, n_out), generator=gen, device=device,
                     dtype=f32) * config["translation_sigma"]
    # pose j * calls + b is the j-th pose of call b
    rot = rot.reshape(per_call, calls, n_out, n_in).transpose(0, 1)
    tr = tr.reshape(per_call, calls, n_out).transpose(0, 1)
    sample = random.Random(int(seed)).randrange(SAMPLE_CALLS)
    pw = config.get("weights", {}).get("point_weight")
    if isinstance(pw, dict):
        lo, hi = pw["uniform"]
        pw = lo + (hi - lo) * torch.rand((n_points,), generator=gen,
                                         device=device, dtype=f32)
    else:
        pw = None
    return Inputs(truth, points, rot.contiguous(), tr.contiguous(), sample,
                  pw)


def weights(config: dict, inputs: Inputs) -> dict:
    """The weights `raster` is given: name -> a number or a tensor, the
    program's defaults left out."""
    given = {k: v for k, v in config.get("weights", {}).items()
             if v is not None}
    if inputs.point_weight is not None:
        given["point_weight"] = inputs.point_weight
    return given


def targets(config: dict, inputs: Inputs, reference) -> torch.Tensor:
    """The fit's targets (calls, B, *grid) float32: the reference's render
    of the truth cloud under every pose of the pool."""
    grid = tuple(config["grid"])
    calls, per_call = inputs.rotation.shape[:2]
    out = torch.empty((calls, per_call) + grid, dtype=torch.float32,
                      device=inputs.truth.device)
    ref_weights = reference.Weights(**weights(config, inputs))
    for b in range(calls):
        reference.render(grid, inputs.truth, inputs.rotation[b],
                         inputs.translation[b], out[b], weights=ref_weights)
    return out
