"""The x-selection experiment of the backward gather (PyTorch port of
`benchmarks/exp_xsel.py`), at the single-tile flagship size: 128^2, 64
poses, 10^5 points, where the kernel is the whole backward.

On the TPU the experiment compared two ways of picking the x neighbours
out of the gathered rows: products with the materialised ``bx``/``dbx``
planes (the "base", then shipped) against masked row sums (the
"candidate", `_kernel_absums`, which reads the transposed cotangent).
On Hopper B4 reads the two x neighbours straight from shared memory, so
both forms are the same two reads, and the only difference left is the
orientation of the cotangent operand.  So here

- "base" is B4 at the JAX kernels' two-part bf16 split (``terms=2``) on
  the natural cotangent (B, gy, gx): the instance ``bwd_gather_split``;
- "candidate" is the same split on the transposed cotangent
  ``g.transpose(-1, -2)`` (B, gx, gy): ``bwd_gather_split_t``, the
  counterpart of `_kernel_absums`.

It prints the largest difference between the two (they stage the same
values and read the same entries, so it should be 0) and the scale, then
times both with CUDA events.

Usage, from the root of the repository:

    python3 -m dprast_torch.benchmarks.exp_xsel

``--device cpu`` runs the plain twins; the default ``cuda`` raises where
there is no card.
"""

from __future__ import annotations

import argparse

import torch

from dprast_torch.benchmarks.profile_binned import cloud
from dprast_torch.ops import splat_binned as sb
from dprast_torch.utils import profiling


def run(device="cuda", grid=(128, 128), points=100_000, batch=64, *,
        iters=15, warmup=3, seed=0):
    """-> dict: ``base`` and ``candidate`` rows, their ``max_abs_diff``
    and ``scale``, ``ms`` of each, and the natural-window arguments of B4
    (``gather_args``) with the transposed cotangent ``g_t``."""
    device = torch.device(device)
    grid = tuple(grid)
    if not sb._single_tile(grid):
        raise ValueError(f"exp_xsel: {grid} is not a single tile")
    pts, rot, tr, _, g = cloud(grid, points, batch, device, seed)
    data, slot_tile, chunk = sb._bwd_frame(grid, pts, rot, tr)
    lane_b = sb._planes_bwd(data[:, :2], sb.tile_shape_for(grid)) \
        .contiguous()
    g_t = g.transpose(-1, -2).contiguous()
    terms = sb._SPLIT_TERMS

    def base():
        return sb.bwd_gather(slot_tile, lane_b, g, chunk, terms=terms)

    def candidate():
        return sb.bwd_gather(slot_tile, lane_b, g_t, chunk, terms=terms,
                             layout="transposed")

    rows_b, rows_c = base(), candidate()
    res = {"grid": grid, "points": points, "batch": batch,
           "device": str(device), "base": rows_b, "candidate": rows_c,
           "max_abs_diff": float((rows_b - rows_c).abs().max()),
           "scale": float(rows_b.abs().max()),
           "gather_args": (slot_tile, lane_b, g, chunk), "g_t": g_t}
    res["ms"] = {name: profiling.time_fn(fn, device, iters, warmup)[0]
                 for name, fn in (("base", base), ("candidate", candidate))}
    return res


def report(res) -> list[str]:
    return [f"grid={res['grid']} batch={res['batch']} "
            f"points={res['points']} device={res['device']}",
            f"max abs diff {res['max_abs_diff']:.3e} "
            f"(scale {res['scale']:.3e})",
            f"kernel natural cotangent (base)       "
            f"{res['ms']['base']:8.4f} ms",
            f"kernel transposed cotangent (cand.)   "
            f"{res['ms']['candidate']:8.4f} ms"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("exp_xsel: --device cuda and "
                             "torch.cuda.is_available() is False")
        print(profiling.card(), flush=True)
    print("\n".join(report(run(args.device))), flush=True)


if __name__ == "__main__":
    main()
