"""Stage-by-stage timing of the binned backend on one CUDA card (PyTorch
port of `benchmarks/profile_binned.py`).

Every stage runs alone on inputs built in advance and is timed with CUDA
events (`dprast_torch.utils.profiling.time_fn`): the events time what was
launched, so the JAX script's chained fit and its forcing of every sort
chunk have no counterpart here.  "fwd kernel" and "bwd kernel" launch B1
(`fwd_splat`) and B4 (`bwd_gather`) alone on the lane planes of the
forward's frame, the counterparts of the JAX script's `fwd_kernel` and
`bwd_kernel`; "fwd kernel enc" and "bwd kernel enc" launch the instances
the backend runs, which read the frame's encoded planes and decode each
row themselves (`fwd_splat_enc`, `bwd_gather_enc`).  The lane planes are
made by no stage of the backend on the card: "fwd planes (twin)" and
"bwd planes (twin)" time `_planes_fwd` / `_planes_bwd`, the first step of
the kernels' plain versions.  "prep fwd" and "prep bwd" build the frames
as the backend does (B6 writes a single tile's frame; the frame gather
writes a multi-tile frame after the sort).  "keys only" is the
coordinate stage as the backend runs it (kernel B6, `csrc/coords.cu`) and
"keys only (eager)" its plain twin, ~170 elementwise launches.  The fold
is what the backend runs: B2 on a multi-tile 2-D grid, the plain `_fold`
in 3-D.  The unfold is B3 in 2-D and the plain `_unfold` in 3-D, and the
two "bwd kernel" stages read the windows it wrote; on a multi-tile 2-D
grid the backend itself skips the unfold and B4 cuts its windows out of
the cotangent, which is the "bwd kernel grid" stage (the frame's
instance).  A single tile has no unfold.  "bwd epilogue" is the
pullback's epilogue on B4's rows (kernel B8, `pullback_epilogue`: the
unsort by the point-id plane and the gradients' products and sums, two
launches of `csrc/epilogue.cu`: `epilogue_tile` and `epilogue_poses` on a
single tile, `epilogue_rows` and `epilogue_points` on several, counted
together), "bwd epilogue (torch form)" its eager
form `_epilogue_plain`; both also run on a single tile, which keeps the
point order.

The inputs are the JAX script's: a 0.4-sigma Gaussian cloud, identity
rotations, translations at 0.1 sigma, point weights uniform in (0.5, 2),
and a standard normal cotangent, made from a seed with numpy.

Usage, from the root of the repository:

    python3 -m dprast_torch.benchmarks.profile_binned --grid 1024,1024
    python3 -m dprast_torch.benchmarks.profile_binned --grid 128,128,128 \\
        --points 1000000 --batch 1

``--by-kernel`` lists instead what one fused step (`raster_fwd_res`, then
`raster_pullback_res` on its frame, uniform weights) keeps the card busy
with: `torch.profiler`'s device microseconds and launches per step by
kernel name, the ``--top`` longest, under the step's median milliseconds.

``--device cpu`` runs the same stages through the kernels' plain twins;
the default ``cuda`` raises where there is no card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dprast_torch.ops import splat_binned as sb
from dprast_torch.utils import profiling

STAGES = ("prep fwd", "prep bwd", "keys only", "keys only (eager)",
          "fwd planes (twin)", "fwd kernel", "fwd kernel enc", "fold",
          "unfold", "bwd planes (twin)", "bwd kernel", "bwd kernel enc",
          "bwd kernel grid", "bwd epilogue", "bwd epilogue (torch form)")


def cloud(grid, points, batch, device, seed=0):
    """The JAX script's inputs on `device` -> (points (P, 3), rotation
    (B, n_out, 3), translation (B, n_out), point_weight (P,), cotangent
    (B, *grid)), all float32."""
    n_out = len(grid)
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((points, 3)) * 0.4
    tr = rng.standard_normal((batch, n_out)) * 0.1
    pw = rng.uniform(0.5, 2.0, points)
    g = rng.standard_normal((batch,) + tuple(grid))
    rot = np.broadcast_to(np.eye(3)[:n_out], (batch, n_out, 3))
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 .to(device) for a in (pts, rot, tr, pw, g))


def run(grid, points, batch, chunk=0, device="cuda", *, iters=15,
        warmup=3, seed=0):
    """Build every stage's inputs, then time each stage alone.  `chunk` 0
    takes the backend's own.  -> dict with ``ms`` and ``spread`` per
    stage (`time_fn`), the frame's sizes, and the standalone kernels'
    arguments and outputs: ``fwd_splat_args`` / ``ext`` (B1 on lanes),
    ``fwd_splat_enc_args`` (B1 on the frame, which gives ``ext`` on the
    CPU and within B1's reordering on the card), ``bwd_gather_args`` /
    ``buf`` (B4 on lanes) and ``bwd_gather_enc_args`` (B4 on the frame,
    ``buf`` bit for bit), ``frame`` (data, slot_tile) and ``inputs``."""
    device = torch.device(device)
    grid = tuple(grid)
    n_out = len(grid)
    pts, rot, tr, pw, g = cloud(grid, points, batch, device, seed)
    ts = sb.tile_shape_for(grid)
    halo = not sb._single_tile(grid)
    default = sb._default_chunk(grid, points)
    if chunk and chunk != default:
        # the frame's slot geometry follows the backend's chunk rule
        raise ValueError(f"chunk {chunk}: the binned backend runs chunk "
                         f"{default} at grid {grid}, {points} points")

    # the forward's frame (per-point weights), as `_fwd_impl` builds it
    splat_args, data = sb._fwd_frame(grid, pts, rot, tr, pw, False)
    slot_tile, lane, nt, win, chunk = splat_args
    ext = sb.fwd_splat(*splat_args)
    ow = torch.ones(batch, device=device)
    bg = torch.zeros(batch, device=device)

    def fold(e):
        if n_out == 2 and halo:
            return sb.band_fold(e, grid, ts, ow, bg)
        return sb._fold(e, grid, ts, halo)

    def unfold(x):
        return (sb.band_unfold if n_out == 2 else sb._unfold)(x, grid, ts)

    g_win = unfold(g) if halo else g
    coord, idx_rows = data[:, :n_out], data[:, -1]
    lane_b = sb._planes_bwd(coord, ts).contiguous()
    gather_args = (slot_tile, lane_b, g_win, chunk)
    buf = sb.bwd_gather(*gather_args)
    splat_enc_args = (slot_tile, data, nt, win, chunk)
    gather_enc_args = (slot_tile, coord, ts, g_win, chunk)
    epilogue_args = (grid, buf, idx_rows, pts, rot, ow, pw)

    stages = {
        "prep fwd": lambda: sb._fwd_prep(grid, pts, rot, tr, pw, False),
        "prep bwd": lambda: sb._bwd_frame(grid, pts, rot, tr),
        "keys only": lambda: sb._keys_and_local(grid, ts, pts, rot, tr),
        "keys only (eager)": lambda: sb._keys_and_local_plain(grid, ts, pts,
                                                              rot, tr),
        "fwd planes (twin)": lambda: sb._planes_fwd(coord, data[:, n_out])
        .contiguous(),
        "fwd kernel": lambda: sb.fwd_splat(*splat_args),
        "fwd kernel enc": lambda: sb.fwd_splat_enc(*splat_enc_args),
        "fold": lambda: fold(ext),
        "unfold": lambda: unfold(g),
        "bwd planes (twin)": lambda: sb._planes_bwd(coord, ts).contiguous(),
        "bwd kernel": lambda: sb.bwd_gather(*gather_args),
        "bwd kernel enc": lambda: sb.bwd_gather_enc(*gather_enc_args),
        "bwd kernel grid": lambda: sb.bwd_gather_enc(slot_tile, coord, ts, g,
                                                     chunk, layout="grid"),
        "bwd epilogue": lambda: sb.pullback_epilogue(*epilogue_args),
        "bwd epilogue (torch form)": lambda: sb._epilogue_plain(
            *epilogue_args),
    }
    if not halo:
        # one tile: the window is the cotangent
        del stages["unfold"]
    if n_out == 3 or not halo:
        # only a multi-tile 2-D grid has the grid-source instance of B4
        del stages["bwd kernel grid"]
    ms, spread = {}, {}
    for name, fn in stages.items():
        ms[name], spread[name] = profiling.time_fn(fn, device, iters, warmup)
    return {"grid": grid, "points": points, "batch": batch, "chunk": chunk,
            "nt": nt, "s_pad": data.shape[-1], "device": str(device),
            "fold": "B2 band_fold" if n_out == 2 and halo else "plain _fold",
            "unfold": ("B3 band_unfold" if n_out == 2 else "plain _unfold")
            if halo else None,
            "ms": ms, "spread": spread, "fwd_splat_args": splat_args,
            "fwd_splat_enc_args": splat_enc_args, "ext": ext,
            "bwd_gather_args": gather_args,
            "bwd_gather_enc_args": gather_enc_args, "buf": buf,
            "frame": (data, slot_tile), "inputs": (pts, rot, tr, pw, g)}


def report(res) -> list[str]:
    """One line per stage: median ms and half-spread."""
    lines = [f"grid={res['grid']} ts={sb.tile_shape_for(res['grid'])} "
             f"nt={res['nt']} chunk={res['chunk']} s_pad={res['s_pad']} "
             f"batch={res['batch']} points={res['points']} "
             f"device={res['device']}"]
    for name, ms in res["ms"].items():
        route = f" ({res[name]})" if name in ("fold", "unfold") else ""
        lines.append(f"{name + route:<28s} {ms:10.4f} ms "
                     f"(+- {res['spread'][name]:.4f})")
    return lines


def step_by_kernel(grid, points, batch, device="cuda", *, calls=5, iters=15,
                   warmup=3, seed=0):
    """Trace `calls` fused steps at `grid` -> dict: ``rows`` [(name, us per
    step, launches per step)] by falling time, ``busy_us`` and
    ``launches`` per step, ``step_ms`` (median).  On the CPU the rows are
    the host's operators by their own time."""
    device = torch.device(device)
    grid = tuple(grid)
    pts, rot, tr, _, g = cloud(grid, points, batch, device, seed)
    canon = (pts, rot, tr, torch.zeros(batch, device=device),
             torch.ones(batch, device=device),
             torch.ones(points, device=device))

    def step():
        _, res = sb.raster_fwd_res(grid, *canon, pw_uniform=True)
        return sb.raster_pullback_res(grid, res, canon, g, pw_uniform=True)

    rows = profiling.by_kernel(step, calls, device) or []
    step_ms, _ = profiling.time_fn(step, device, iters, warmup)
    return {"grid": grid, "points": points, "batch": batch,
            "device": str(device), "rows": rows,
            "busy_us": sum(row[1] for row in rows),
            "launches": sum(row[2] for row in rows), "step_ms": step_ms}


def report_by_kernel(res, top=15) -> list[str]:
    """A headline and one line per kernel, the `top` longest."""
    lines = [f"grid={res['grid']} batch={res['batch']} "
             f"points={res['points']} device={res['device']}: fused step "
             f"{res['step_ms']:.4f} ms, busy {res['busy_us']:.1f} us in "
             f"{res['launches']:.0f} launches per step"]
    for name, us, count in res["rows"][:top]:
        lines.append(f"{us:10.1f} us  x{count:6.1f}  {name[:100]}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", default="1024,1024")
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--by-kernel", action="store_true",
                    help="list a fused step's device time by kernel name")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    grid = tuple(int(x) for x in args.grid.split(","))
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("profile_binned: --device cuda and "
                             "torch.cuda.is_available() is False")
        print(profiling.card(), flush=True)
    else:
        print("device cpu: the kernels' plain twins, timed on the host",
              flush=True)
    if args.by_kernel:
        res = step_by_kernel(grid, args.points, args.batch, args.device)
        print("\n".join(report_by_kernel(res, args.top)), flush=True)
        return
    res = run(grid, args.points, args.batch, args.chunk, args.device)
    print("\n".join(report(res)), flush=True)


if __name__ == "__main__":
    main()
