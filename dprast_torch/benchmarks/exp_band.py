"""The window-orientation experiment of the backward gather (PyTorch port
of `benchmarks/exp_band.py`), on a multi-tile 2-D grid (default 1024^2,
64 poses, 10^5 points).

Fusing the band unfold (B3) into the gather (B4) means B4 cuts its
windows from the cotangent in their natural (rows, cols) orientation.
On the TPU that turned the gather's contraction from NN on transposed
windows into TN on natural ones, and the experiment priced the switch;
it also tried windows split into a bf16 pair (hi, lo) before the kernel.
Here the three are B4 instances at the JAX kernels' two-part bf16 split
(``terms=2``):

- NN: transposed windows (cols_e, rows_e), ``bwd_gather_split_t``, fed
  ``.transpose(-1, -2).contiguous()`` of B3's natural output;
- TN: natural windows (rows_e, cols_e) from B3, ``bwd_gather_split``;
- presplit: the transposed windows split by plain torch into ``hi =
  bf16(w)``, ``lo = bf16(w - hi)``, ``bwd_gather_presplit``.

All three stage the same fp32 values, so the script's own checks are that
NN and TN, and presplit and NN, agree bit for bit; then it times the
three with CUDA events.

Usage, from the root of the repository:

    python3 -m dprast_torch.benchmarks.exp_band [--grid 1024,1024]

``--device cpu`` runs the plain twins; the default ``cuda`` raises where
there is no card.
"""

from __future__ import annotations

import argparse

import torch

from dprast_torch.benchmarks.profile_binned import cloud
from dprast_torch.ops import splat_binned as sb
from dprast_torch.utils import profiling


def split2(x):
    """The two-part bf16 split (hi, lo) of an fp32 tensor."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def run(device="cuda", grid=(1024, 1024), points=100_000, batch=64, *,
        iters=15, warmup=3, seed=0):
    """-> dict: the ``rows`` of each variant ("NN", "TN", "presplit"),
    the two bit-exactness relations, ``ms`` of each variant, and the
    natural-window arguments of B4 (``gather_args``) with the transposed
    windows ``g_t`` and their split ``g_split``."""
    device = torch.device(device)
    grid = tuple(grid)
    if len(grid) != 2 or sb._single_tile(grid):
        raise ValueError(f"exp_band: {grid} is not a multi-tile 2-D grid")
    pts, rot, tr, _, g = cloud(grid, points, batch, device, seed)
    ts = sb.tile_shape_for(grid)
    data, slot_tile, chunk = sb._bwd_frame(grid, pts, rot, tr)
    lane_b = sb._planes_bwd(data[:, :2], ts).contiguous()
    g_n = sb.band_unfold(g, grid, ts)
    g_t = g_n.transpose(-1, -2).contiguous()
    g_split = split2(g_t)
    terms = sb._SPLIT_TERMS
    variants = {
        "NN": lambda: sb.bwd_gather(slot_tile, lane_b, g_t, chunk,
                                    terms=terms, layout="transposed"),
        "TN": lambda: sb.bwd_gather(slot_tile, lane_b, g_n, chunk,
                                    terms=terms),
        "presplit": lambda: sb.bwd_gather(slot_tile, lane_b, g_split, chunk,
                                          terms=terms, layout="presplit"),
    }
    rows = {name: fn() for name, fn in variants.items()}
    res = {"grid": grid, "points": points, "batch": batch,
           "device": str(device), "rows": rows,
           "nn_tn_bit_exact": torch.equal(rows["NN"], rows["TN"]),
           "presplit_bit_exact": torch.equal(rows["presplit"], rows["NN"]),
           "gather_args": (slot_tile, lane_b, g_n, chunk), "g_t": g_t,
           "g_split": g_split}
    res["ms"] = {name: profiling.time_fn(fn, device, iters, warmup)[0]
                 for name, fn in variants.items()}
    return res


def report(res) -> list[str]:
    ms = res["ms"]
    return [f"grid={res['grid']} batch={res['batch']} "
            f"points={res['points']} device={res['device']}",
            f"NN vs TN bit-exact: {res['nn_tn_bit_exact']}",
            f"kernel NN (transposed windows)  {ms['NN']:8.4f} ms",
            f"kernel TN (natural windows)     {ms['TN']:8.4f} ms",
            f"presplit bit-exact: {res['presplit_bit_exact']}",
            f"kernel NN presplit bf16         {ms['presplit']:8.4f} ms"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", default="1024,1024")
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("exp_band: --device cuda and "
                             "torch.cuda.is_available() is False")
        print(profiling.card(), flush=True)
    grid = tuple(int(x) for x in args.grid.split(","))
    print("\n".join(report(run(args.device, grid, args.points,
                               args.batch))), flush=True)


if __name__ == "__main__":
    main()
