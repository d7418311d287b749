"""Benchmark suite over the reference's headline table, on one CUDA card
(the counterpart of `benchmarks/run.py`).

`CONFIGS` is the JAX suite's table: the same twelve rows, sizes, A100
milliseconds and weighted / `_bf16` variants.  Each row times, with CUDA
events (`profiling.time_fn`: median of 15 calls after 3 warm-ups, and half
the spread), the forward (`dispatch.fwd_fn`) and the standalone pullback
(`dispatch.bwd_fn`) of the backend that ``resolve_pair("auto", ...,
accelerator=True)`` names (``binned_bf16`` on the `_bf16` rows), the fused
pair (`raster_fwd_res` + `raster_pullback_res`) and, with ``--grad``, the
training step through autograd (`dprast_torch.raster`, then
`torch.autograd.grad` of ``sum(out * g)`` with respect to the translation,
as the reference's ``gstep`` differentiates).  It adds the card's name and
power limit, what the fused pair keeps the card busy with
(`profiling.device_busy`) and the peak device memory of the row.

The inputs are the reference's in kind, not in bits: the rotations about
one axis and the background and output weights are built as it builds
them (bit-equal), but points N(0, 0.4²), translations N(0, 0.1²) and point
weights U(0.5, 2) are drawn with numpy (``default_rng(0)``), since the
card's machine has no `jax.random`; every row says so (``"inputs":
"numpy"``).  The cotangent is ``default_rng(7)``'s up to 2^27 voxels; above
that (1024³), a (B, *grid[:-1]) numpy plane times ones times 0.1, made on
the card, as the reference makes it on its device.

``--multihost`` runs the weak-scaling step of BASELINE config 5 over
`dprast_torch.parallel.multihost`: the same command in every process (or
``--coordinator host:port --num-processes N --process-id i``), the mesh of
`pod_mesh()`, identical data on every rank, and a step of `raster_sharded`
+ `torch.autograd.grad` with respect to (points, translation); process 0
prints one record.  Processes that share one card talk over Gloo through
host memory: such a record shows that the step works and is no scaling
number (its ``"cards"`` says how many cards there were).

Usage, from the root of the repository:

    python3 -m dprast_torch.benchmarks.run [--configs 128sq_1e5,...] [--grad]
        [--out BENCHMARKS_h100.jsonl] [--device cpu]
    torchrun --nproc-per-node=2 -m dprast_torch.benchmarks.run --multihost
"""

from __future__ import annotations

import argparse
import datetime
import json
import sys

import numpy as np
import torch

# (name, n_points, batch, grid, n_in, A100 fwd ms, A100 bwd ms[, weighted]):
# the reference's table (its `benchmarks/run.py`).  The headline rows time
# the default-weight call, as the A100 rows did; the `_pw` rows a random
# per-point weight; `_bf16` selects the fast mode.
CONFIGS = [
    ("64sq_2d_1e4", 10_000, 64, (64, 64), 2, None, None),
    ("128sq_1e4", 10_000, 64, (128, 128), 3, 15.0, 1.0),
    ("1024sq_1e4", 10_000, 64, (1024, 1024), 3, 16.0, 2.0),
    ("128sq_1e5", 100_000, 64, (128, 128), 3, 153.0, 9.0),
    ("1024sq_1e5", 100_000, 64, (1024, 1024), 3, 154.0, 10.0),
    ("128sq_1e5_pw", 100_000, 64, (128, 128), 3, None, None, True),
    ("1024sq_1e5_pw", 100_000, 64, (1024, 1024), 3, None, None, True),
    ("128sq_1e5_bf16", 100_000, 64, (128, 128), 3, None, None),
    ("1024sq_1e5_bf16", 100_000, 64, (1024, 1024), 3, None, None),
    ("128cube_1e5", 100_000, 1, (128, 128, 128), 3, None, None),
    ("128cube_1e6", 1_000_000, 1, (128, 128, 128), 3, None, None),
    ("1024cube_1e5", 100_000, 1, (1024, 1024, 1024), 3, 24.0, 17.0),
]

# above this many voxels the cotangent is an outer product made on the card
_DENSE_COTANGENT = 2 ** 27


def _args_for(n_points, batch, grid, n_in):
    """The row's six inputs as float32 numpy arrays ``(points, rotation,
    translation, background, out_weight, point_weight)``."""
    rng = np.random.default_rng(0)
    pts = (rng.standard_normal((n_points, n_in)) * 0.4).astype(np.float32)
    n_out = len(grid)
    rot = np.zeros((batch, n_out, n_in), np.float32)
    angles = np.linspace(0, 2 * np.pi, batch, endpoint=False)
    for i, a in enumerate(angles):
        c, s = np.cos(a), np.sin(a)
        r = np.eye(n_in, dtype=np.float32)
        r[0, 0], r[0, -1], r[-1, 0], r[-1, -1] = c, -s, s, c
        rot[i] = r[:n_out]
    tr = (rng.standard_normal((batch, n_out)) * 0.1).astype(np.float32)
    bg = np.zeros((batch,), np.float32)
    ow = np.ones((batch,), np.float32)
    pw = rng.uniform(0.5, 2.0, n_points).astype(np.float32)
    return pts, rot, tr, bg, ow, pw


def _cotangent(batch, grid, device):
    """The row's cotangent (B, *grid) on `device`."""
    rng = np.random.default_rng(7)
    if batch * int(np.prod(grid)) <= _DENSE_COTANGENT:
        return torch.from_numpy(rng.standard_normal(
            (batch,) + tuple(grid)).astype(np.float32)).to(device)
    plane = torch.from_numpy(rng.standard_normal(
        (batch,) + tuple(grid[:-1])).astype(np.float32)).to(device)
    return plane[..., None] * torch.ones(grid[-1], device=device) * 0.1


def backends(name, n_points, grid):
    """The (forward, backward) backends of a row: the fast mode on the
    `_bf16` rows, else what `auto` picks on the card."""
    from dprast_torch.ops import dispatch

    if name.endswith("_bf16"):
        return "binned_bf16", "binned_bf16"
    return dispatch.resolve_pair("auto", len(grid), tuple(grid), n_points,
                                 accelerator=True)


def _timed(rec, key, fn, device):
    """Time `fn` into ``rec["t_<key>_ms"]`` and its half-spread into
    ``rec["t_<key>_ms_pm"]``; an error is reported in
    ``rec["<key>_error"]`` so that the other timings of the row stand ->
    the median ms or None."""
    from dprast_torch.utils import profiling

    try:
        rec[f"t_{key}_ms"], rec[f"t_{key}_ms_pm"] = profiling.time_fn(
            fn, device)
    except Exception as exc:  # noqa: BLE001 -- reported in the row
        rec[f"{key}_error"] = f"{type(exc).__name__}: {exc}"[:200]
        return None
    return rec[f"t_{key}_ms"]


def run_config(name, n_points, batch, grid, n_in, ref_fwd, ref_bwd,
               weighted=False, with_grad=False, device="cuda"):
    """Time one row of `CONFIGS` on `device` -> its record (also printed
    as one JSON line)."""
    import dprast_torch
    from dprast_torch.ops import dispatch
    from dprast_torch.utils import profiling

    device = torch.device(device)
    grid = tuple(grid)
    backend_f, backend_b = backends(name, n_points, grid)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    pts, rot, tr, bg, ow, pw = (torch.from_numpy(a).to(device)
                                for a in _args_for(n_points, batch, grid,
                                                   n_in))
    if not weighted:
        pw = torch.ones(n_points, device=device)
    g = _cotangent(batch, grid, device)
    args = (pts, rot, tr, bg, ow, pw)
    uniform = not weighted
    card, limit = profiling.card_fields(device)
    rec = {"config": name,
           "backend": (backend_f if backend_f == backend_b
                       else f"{backend_f}+{backend_b}"),
           "n_points": n_points, "batch": batch, "grid": list(grid),
           "weighted": weighted, "inputs": "numpy",
           "platform": device.type, "card": card, "power_limit": limit}
    fwd, bwd = dispatch.fwd_fn(backend_f), dispatch.bwd_fn(backend_b)
    t_fwd = _timed(rec, "fwd", lambda: fwd(grid, *args, pw_uniform=uniform),
                   device)
    t_bwd = _timed(rec, "bwd",
                   lambda: bwd(grid, *args, g, pw_uniform=uniform), device)

    pair = dispatch.vjp_pair(backend_f) if backend_f == backend_b else None
    if pair is not None:
        def step():
            _, res = pair[0](grid, *args, pw_uniform=uniform)
            return pair[1](grid, res, args, g, pw_uniform=uniform)

        if _timed(rec, "step", step, device) is not None and \
                device.type == "cuda":
            busy_us, rec["launches"] = profiling.device_busy(step)
            rec["busy_ms"] = busy_us / 1e3
    if with_grad:
        api_backend = "binned_bf16" if name.endswith("_bf16") else "auto"
        tr_req = tr.clone().requires_grad_()

        def gstep():
            out = dprast_torch.raster(grid, pts, rot, tr_req, bg, ow,
                                      pw if weighted else None,
                                      backend=api_backend)
            return torch.autograd.grad((out * g).sum(), tr_req)

        _timed(rec, "grad", gstep, device)
    if t_fwd is not None and t_bwd is not None:
        splats = n_points * batch * 2 ** len(grid)
        rec["splats_per_s"] = splats / ((t_fwd + t_bwd) * 1e-3)
        if ref_fwd is not None:
            rec["vs_a100"] = (ref_fwd + ref_bwd) / (t_fwd + t_bwd)
    if device.type == "cuda":
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    print(json.dumps(rec), flush=True)
    return rec


def run_multihost(args):
    """The weak-scaling step over the pod mesh (BASELINE config 5): poses
    grow with the "poses" axis and points with the "points" axis, so the
    work per process is constant, and ``efficiency_vs_1chip`` is the
    splats/s per process against ``--baseline`` (a one-process row).
    Process 0 prints the record and appends it to ``--out``."""
    import torch.distributed as dist

    from dprast_torch.parallel import multihost, raster_sharded
    from dprast_torch.parallel.sharded import POINTS_AXIS, POSES_AXIS
    from dprast_torch.utils import profiling

    init_method = (f"tcp://{args.coordinator}" if args.coordinator
                   else None)
    multihost.initialize(init_method, args.num_processes, args.process_id)
    try:
        device = torch.device(args.device)
        mesh = multihost.pod_mesh()
        n_proc = dist.get_world_size() if dist.is_initialized() else 1
        grid = tuple(int(x) for x in args.mh_grid.split(","))
        b = args.mh_poses or 64 * mesh.shape[POSES_AXIS]
        p = args.mh_points or 100_000 * mesh.shape[POINTS_AXIS]

        rng = np.random.default_rng(0)          # identical data everywhere
        pts = (rng.standard_normal((p, 3)) * 0.4).astype(np.float32)
        angles = np.linspace(0, 2 * np.pi, b, endpoint=False)
        rot = np.zeros((b, len(grid), 3), np.float32)
        rot[:, 0, 0] = np.cos(angles)
        rot[:, 0, 2] = -np.sin(angles)
        rot[:, 1, 1] = 1.0
        if len(grid) == 3:
            # the full rotation: without the third row every point lands
            # on one z plane
            rot[:, 2, 0] = np.sin(angles)
            rot[:, 2, 2] = np.cos(angles)
        tr = (rng.standard_normal((b, len(grid))) * 0.1).astype(np.float32)
        g = rng.standard_normal((b,) + grid).astype(np.float32)
        pts, rot, tr, g = (torch.from_numpy(a).to(device)
                           for a in (pts, rot, tr, g))
        pts_req = pts.clone().requires_grad_()
        tr_req = tr.clone().requires_grad_()

        def step():
            out = raster_sharded(grid, pts_req, rot, tr_req, mesh=mesh)
            return torch.autograd.grad((out * g).sum(), (pts_req, tr_req))

        t, t_pm = profiling.time_fn(step, device)
        per_chip = p * b * 2 ** len(grid) / (t * 1e-3) / n_proc
        card, limit = profiling.card_fields(device)
        rec = {"multihost": True, "n_processes": n_proc,
               "cards": (torch.cuda.device_count() if device.type == "cuda"
                         else 0),
               "mesh": dict(mesh.shape), "grid": list(grid), "n_points": p,
               "batch": b, "platform": device.type, "card": card,
               "power_limit": limit, "t_step_ms": t, "t_step_ms_pm": t_pm,
               "splats_per_s_per_chip": per_chip}
        if args.baseline:
            rec["efficiency_vs_1chip"] = per_chip / args.baseline
        if mesh.rank == 0:
            print(json.dumps(rec), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        return rec
    finally:
        multihost.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default=None,
                    help="comma-separated subset of config names")
    ap.add_argument("--grad", action="store_true",
                    help="also time the training step through autograd")
    ap.add_argument("--out", default=None,
                    help="also append the rows to this JSON-lines file")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu' for a rehearsal")
    ap.add_argument("--multihost", action="store_true",
                    help="the weak-scaling step over the pod mesh (see "
                    "run_multihost)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (default: the launcher's "
                    "environment)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--mh-grid", default="128,128")
    ap.add_argument("--mh-points", type=int, default=None,
                    help="total points (default 1e5 per points shard)")
    ap.add_argument("--mh-poses", type=int, default=None,
                    help="total poses (default 64 per poses shard)")
    ap.add_argument("--baseline", type=float, default=None,
                    help="one-process splats/s for the efficiency ratio")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        sys.exit("dprast_torch.benchmarks.run: torch.cuda.is_available() is "
                 "False; pass --device cpu for the CPU")
    if args.multihost:
        run_multihost(args)
        return
    want = set(args.configs.split(",")) if args.configs else None
    unknown = (want or set()) - {cfg[0] for cfg in CONFIGS}
    if unknown:
        ap.error(f"unknown configs {sorted(unknown)}")
    rows = []
    for cfg in CONFIGS:
        if want and cfg[0] not in want:
            continue
        try:
            rows.append(run_config(*cfg, with_grad=args.grad,
                                   device=args.device))
        except Exception as exc:  # noqa: BLE001 -- the next rows still run
            rows.append({"config": cfg[0], "backend": "-",
                         "error": f"{type(exc).__name__}: {exc}"[:200]})
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        date = datetime.date.today().isoformat()
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(dict(r, date=date)) + "\n")
    print(f"\n{'config':<16} {'backend':<12} {'fwd ms':>9} {'bwd ms':>9} "
          f"{'grad ms':>9} {'splats/s':>12} {'vs A100':>8}")
    for r in rows:
        cells = [f"{r[k]:.4f}" if k in r else "-"
                 for k in ("t_fwd_ms", "t_bwd_ms", "t_grad_ms")]
        sps = r.get("splats_per_s")
        vs = r.get("vs_a100")
        print(f"{r['config']:<16} {r['backend']:<12} {cells[0]:>9} "
              f"{cells[1]:>9} {cells[2]:>9} "
              f"{f'{sps:.3e}' if sps else '-':>12} "
              f"{f'{vs:.2f}' if vs else '-':>8}")


if __name__ == "__main__":
    main()
