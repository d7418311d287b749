"""Flagship benchmark of the PyTorch port: fwd+bwd points·splats/s on one
CUDA card.

The counterpart of `bench.py`, with the same configuration (BASELINE
config 3: 10^5 points, 64 poses, 3D->2D orthographic projection onto a
128² grid, default point weights) and the same inputs: they are drawn in
`bench.py`'s order from ``np.random.default_rng(0)`` and rounded to
float32 as `jnp.asarray(..., float32)` rounds them, so both packages get
the same bits.  The forward (`dispatch.fwd_fn`) and the standalone
pullback (`dispatch.bwd_fn`, ``pw_uniform=True``) of the backends that
``resolve_pair("auto", ...)`` names for the card are timed apart with CUDA
events (`profiling.time_fn`: the median of 15 calls after 3 warm-ups, and
half the spread); the baseline is the same A100 row, 10^5·64·4 splats /
(153 ms fwd + 9 ms bwd) ≈ 1.58e8 points·splats/s.

Beside `bench.py`'s fields, ``detail`` carries the card's name and power
limit, the fused pair (`raster_fwd_res` + `raster_pullback_res`, what
autograd runs), the training step through autograd
(`dprast_torch.raster`, then `torch.autograd.grad` of ``sum(out *
ds_dout)`` with respect to the points and the translation), and the
microseconds the fused step keeps the card busy with and its kernel and
copy count (`profiling.device_busy`).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"detail"}.  Usage:

    python3 bench_torch.py                      # the flagship, on the card
    python3 bench_torch.py --device cpu --points 500 --poses 2 --grid 32,32

Without a card it exits non-zero unless ``--device cpu`` asks for the CPU
(a rehearsal of the same code; its times are the CPU's).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

METRIC = "points_splats_per_s_fwd_bwd_3d_to_2d_128sq"
BASELINE = 1.58e8  # A100, the reference README's row (153 ms fwd + 9 ms bwd)


def flagship_inputs(n_points=100_000, batch=64, grid=(128, 128)):
    """`bench.py`'s inputs as float32 numpy arrays, drawn in its order:
    ``(points, rotation, translation, background, out_weight,
    point_weight), ds_dout``."""
    rng = np.random.default_rng(0)
    points = (rng.standard_normal((n_points, 3)) * 0.4).astype(np.float32)
    angles = rng.uniform(0, 2 * np.pi, batch)
    c, s = np.cos(angles), np.sin(angles)
    rot = np.zeros((batch, 2, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 2] = c, -s
    rot[:, 1, 1] = 1.0
    translation = (rng.standard_normal((batch, 2)) * 0.1).astype(np.float32)
    background = np.zeros((batch,), np.float32)
    out_weight = np.ones((batch,), np.float32)
    point_weight = np.ones((n_points,), np.float32)
    ds_dout = rng.standard_normal((batch,) + tuple(grid)).astype(np.float32)
    return (points, rot, translation, background, out_weight,
            point_weight), ds_dout


def run(n_points=100_000, batch=64, grid=(128, 128), device="cuda"):
    """Time the flagship on `device` -> the record `main` prints."""
    import dprast_torch
    from dprast_torch.ops import dispatch
    from dprast_torch.utils import profiling

    device = torch.device(device)
    grid = tuple(grid)
    args, g = flagship_inputs(n_points, batch, grid)
    args = tuple(torch.from_numpy(a).to(device) for a in args)
    g = torch.from_numpy(g).to(device)
    backend_f, backend_b = dispatch.resolve_pair(
        "auto", len(grid), grid, n_points, accelerator=True)
    fwd = dispatch.fwd_fn(backend_f)
    bwd = dispatch.bwd_fn(backend_b)
    t_fwd, s_fwd = profiling.time_fn(
        lambda: fwd(grid, *args, pw_uniform=True), device)
    t_bwd, s_bwd = profiling.time_fn(
        lambda: bwd(grid, *args, g, pw_uniform=True), device)

    detail = {}
    pair = dispatch.vjp_pair(backend_f) if backend_f == backend_b else None
    if pair is not None:
        def step():
            _, res = pair[0](grid, *args, pw_uniform=True)
            return pair[1](grid, res, args, g, pw_uniform=True)

        detail["t_step_ms"], detail["t_step_ms_pm"] = profiling.time_fn(
            step, device)
        if device.type == "cuda":
            busy_us, launches = profiling.device_busy(step)
            detail["busy_ms"], detail["launches"] = busy_us / 1e3, launches
    pts_req = args[0].clone().requires_grad_()
    tr_req = args[2].clone().requires_grad_()

    def grad_step():
        loss = (dprast_torch.raster(grid, pts_req, args[1], tr_req) * g).sum()
        return torch.autograd.grad(loss, (pts_req, tr_req))

    detail["t_grad_ms"], detail["t_grad_ms_pm"] = profiling.time_fn(
        grad_step, device)

    splats = n_points * batch * 2 ** len(grid)
    value = splats / ((t_fwd + t_bwd) * 1e-3)
    name, limit = profiling.card_fields(device)
    return {
        "metric": METRIC,
        "value": value,
        "unit": "splats/s",
        "vs_baseline": value / BASELINE,
        "detail": {
            "backend": (backend_f if backend_f == backend_b
                        else f"{backend_f}+{backend_b}"),
            "platform": device.type,
            "t_fwd_ms": t_fwd,
            "t_bwd_ms": t_bwd,
            "t_fwd_ms_pm": s_fwd,
            "t_bwd_ms_pm": s_bwd,
            "n_points": n_points, "batch": batch, "grid": list(grid),
            "name": name, "power_limit": limit,
            **detail,
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu' for a rehearsal")
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--poses", type=int, default=64)
    ap.add_argument("--grid", default="128,128",
                    help="the 2-D grid, e.g. 128,128")
    args = ap.parse_args(argv)
    grid = tuple(int(x) for x in args.grid.split(","))
    if len(grid) != 2:
        ap.error("--grid takes two sizes: the flagship projects 3-D points "
                 "onto a 2-D grid")
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        sys.exit("bench_torch: torch.cuda.is_available() is False; pass "
                 "--device cpu for the CPU")
    print(json.dumps(run(args.points, args.poses, grid, args.device)),
          flush=True)


if __name__ == "__main__":
    main()
