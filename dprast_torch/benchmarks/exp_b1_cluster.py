"""B1 (the forward splat) at every size of its thread-block cluster, on
one CUDA card.

The blocks that share one (pose, tile) form a cluster of 1 to 8; the
wrapper picks the size from the shapes and the card's occupancy alone
(`splat_binned._cluster_size`: at a single tile the largest size of
which the card holds every pose's cluster at once, at several tiles enough
blocks to give every SM `_B1_BLOCKS_PER_SM`).  This script is where that rule is held to
the card.  At the main path's shapes -- 128^2 and 1024^2 with 64 poses x
10^5 points, 128^3 with one pose x 10^6 points and with 4 poses x 10^5 --
and at other pose and tile counts (`MORE_CASES`) it runs the kernel at
each size in turns (1 .. 8, 8 .. 1) and prints per size: the device
microseconds of a launch (`profiling.launch_us`); the median milliseconds of
wrapper + kernel (CUDA events); the scaled error against the plain twin,
which must stay within 1e-5; the slots of the busiest block; how many such
clusters the card holds at once.  The size the rule picks is marked, and
each shape ends with how far the rule's size is from the best one read.

Usage, from the root of the repository (the inputs are `chip_smoke.py`'s):

    python3 -m dprast_torch.benchmarks.exp_b1_cluster
"""

from __future__ import annotations

import argparse

import torch

from dprast_torch.ops import splat_binned as sb
from dprast_torch.utils import profiling

# (grid, poses, points per pose) beyond the main path's: pose counts on
# both sides of what the card holds in one wave of clusters, a few tiles
# per pose, and two poses of a volume
MORE_CASES = (((128, 128), 16, 100_000), ((128, 128), 32, 100_000),
              ((128, 128), 100, 100_000), ((128, 128), 128, 100_000),
              ((128, 128), 256, 100_000), ((256, 256), 4, 100_000),
              ((256, 256), 16, 100_000), ((256, 256), 64, 100_000),
              ((512, 512), 64, 100_000), ((128, 128, 128), 2, 1_000_000))


def cases(cs, dev):
    """(label, poses, `fwd_splat` arguments) of the main path's shapes and
    of `MORE_CASES`, uniform weights."""
    out = []
    pts, rot, tr, pw = (torch.from_numpy(a).to(dev)
                        for a in cs.flagship_inputs())
    for grid in cs.GRIDS:
        args, _ = sb._fwd_frame(grid, pts, rot, tr, pw, True)
        out.append((f"{grid} x {cs.N_POSES} x {cs.N_POINTS}", cs.N_POSES,
                    args))
    volumes = list(cs.VOLUME_CASES.values())
    for grid, n_poses, n_points in MORE_CASES:
        if len(grid) == 3:
            volumes.append((n_poses, n_points))
            continue
        more = [torch.from_numpy(a).to(dev)
                for a in cs.flagship_inputs(0, n_points, n_poses)]
        args, _ = sb._fwd_frame(grid, *more, True)
        out.append((f"{grid} x {n_poses} x {n_points}", n_poses, args))
    for n_poses, n_points in volumes:
        vol = [torch.from_numpy(a).to(dev)
               for a in cs.volume_inputs(n_poses, n_points)]
        args, _ = sb._fwd_frame(cs.VOLUME, *vol[:3], vol[5], True)
        out.append((f"{cs.VOLUME} x {n_poses} x {n_points}", n_poses, args))
    return out


def run(cs, dev):
    """-> (lines of the report, worst scaled error against the twin)."""
    card = profiling.card()
    lines = []
    worst = 0.0
    for label, n_poses, args in cases(cs, dev):
        nt = args[2]
        ext_p = sb._fwd_splat_plain(*args)
        busiest = int(cs.slots_per_tile(args[0], nt).max())
        picked = sb._b1_cluster(dev, n_poses, nt, args[3])
        held = sb._clusters_held(dev, args[3])
        sizes = tuple(range(1, sb._MAX_CLUSTER + 1))
        us = {c: [] for c in sizes}
        ms = {c: [] for c in sizes}
        err = {}
        for c in sizes + sizes[::-1]:
            def fn():
                return sb.fwd_splat(*args, cluster=c)
            err[c] = cs.scaled_err(fn(), ext_p)
            worst = max(worst, err[c])
            us[c].append(profiling.launch_us(fn, "fwd_splat_kernel"))
            ms[c].append(cs.time_ms(fn))
        bound_ms, _ = cs.b1_bound(*args)
        lines.append(f"{card} | {label}: {nt} tiles, busiest tile {busiest} "
                     f"slots, bound {bound_ms * 1e3:.1f} us")
        for c in sizes:
            lines.append(
                f"{card} |   cluster {c}: device {cs.us_text(us[c][0])}, "
                f"{cs.us_text(us[c][1])}; wrapper + kernel ms {ms[c][0]:.4f}, "
                f"{ms[c][1]:.4f}; busiest block {-(-busiest // c)} slots; "
                f"err vs twin {err[c]:.3e}; the card holds {held[c - 1]} "
                f"such clusters" + ("  <- the rule's" if c == picked else ""))
        mean = {c: sum(us[c]) / 2 for c in sizes if None not in us[c]}
        if picked not in mean:
            continue
        best = min(mean, key=mean.get)
        lines.append(f"{card} |   the rule's {picked}: {mean[picked]:.2f} us, "
                     f"the best read {best}: {mean[best]:.2f} us, "
                     f"{mean[picked] / mean[best] - 1:+.1%}")
    return lines, worst


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_b1_cluster: torch.cuda.is_available() is "
                         "False")
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    lines, worst = run(cs, dev)
    for line in lines:
        print(line, flush=True)
    if worst > 1e-5:
        raise SystemExit(f"exp_b1_cluster: B1 is {worst:.3e} (scaled) off "
                         f"its twin, more than 1e-5")


if __name__ == "__main__":
    main()
