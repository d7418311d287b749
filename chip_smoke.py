"""Smoke run of dprast_torch on one CUDA card.

Builds the port's CUDA kernels from `dprast_torch/csrc/`, holds each
against its plain torch twin on the card at the shapes of the main path
(B1 also at every size of its thread-block cluster, on odd grids and on a
frame with empty tiles and dead slots; B6, the coordinate stage, bit for
bit against its twin on the card and on the CPU, also on an edge set of
voxel centres, cell boundaries, grid edges and extreme poses), and drives
the two 2-D main paths at the flagship size (3D->2D orthographic, 64
poses, 10^5 points, 128x128) and at 1024x1024:

- the forward `raster` through `auto` (kernels B6, B1, and B2 at 1024^2),
  checked against the port's scatter oracle on the card;
- the training step, `torch.autograd.grad` through `raster` (B6 + B1 +
  B4, and B2 at 1024^2, where B4 cuts its windows out of the cotangent
  itself and B3 does not run), checked against the same autograd through
  the oracle on the card, and a few SGD steps of a point-cloud fit.

The [3d] phase drives the 3-D path, 10^6 points into 128^3 with one
pose (the forward and the training step through `auto`, on the 3-D
branches of B1 and B4), and a pose batch, 4 rotations x 10^5 points, the
same way.

The main path's B1 and B4 read the frame's encoded planes and decode each
row themselves (their `_enc` instances), and kernels write the frame: B6
on a single tile, the frame gather after the sort on several.  The
[B7 frame] phase holds both writers to the plain `_prep_direct` /
`_prep_binned` bit for bit, each `_enc` instance to the same kernel on
lane planes and to its plain version (B4 bit for bit, B1 within its
reordering of fp32 sums), times them, and fails if a fused step makes
lane planes on the card.  Before the frame gather, B9 (`slot_prep`, two
kernels) writes the per-tile counts, the slot table and each stretch's
first place of each tile, and B10 (`bin_scatter`) the sorted frame keys
straight to their places, in place of `torch.sort`; the [B9 slot prep]
phase holds B9 to the eager chain it replaces (`_slot_prep_plain`,
`_bases_plain`) and B10 to `torch.sort` of that chain's sort input bit
for bit, packed and unpacked, B10 also to itself on a second run, and
times each against what it replaces in turns (`python3 chip_smoke.py
--slot-prep` runs the build, this phase, [B7 frame], [repeat],
[deterministic] and [no sync] alone).

At small sizes the forward and `raster_pullback` are checked against the
float64 numpy oracles, in 2-D and 3-D.  Then it times the kernels
against their twins, and the forward and the training step against the
same work run through the twins; B4's grid source against the route it
replaced (B3, then B4 on the windows B3 wrote) in turns; and, once each,
the `F.fold` / `F.unfold` routes that compute what B2 / B3 compute.

The [bf16] phase drives the `binned_bf16` fast mode (its B1 and B4
instances, `terms=1`, are held in [B7 frame]): the forward and the
training step at 128^2, 1024^2 and 128^3 against the `xla` backend
within the fast mode's 2e-2 envelope, timed beside `binned`.  The
[profile] phase runs the stage profiler (`dprast_torch.benchmarks.
profile_binned`, B1 and B4 launched alone) at 1024^2 and 128^3, and the
[exp] phase the two gather experiments (`exp_xsel` at 128^2, `exp_band`
at 1024^2), whose B4 instances read the window through the two-part
bf16 split in three layouts; each instance is held to its twin.

The [matmul] phase drives the small grids, which the JAX package sends to
its `matmul` backend (one-hot matrix products, `torch.bmm` on bf16
planes with an fp32 result) and this package, on the card, does not:
the forward and the training step at 64^2 x 64 poses x 10^5 points, at
32^3 x 4 x 10^5 and at (4096,) x 4 x 10^4 on `matmul` by name and through
`auto` against the `xla` backend, small cases against the f64 oracles, an
empty cloud, and `matmul`'s times beside `xla` and `binned` in turns, one
row per regime (few poses, a tiny grid, a small cloud, 3-D, 1-D): the rows
`auto`'s rule is derived from.  The [examples] phase runs
`examples/fit_langevin_torch.py` and `examples/tomography_torch.py` for a
few steps and checks that their losses fall.

The [sharded] phase drives the distribution layer
(`dprast_torch.parallel`): `raster_sharded` and autograd through it on the
1 x 1 mesh in this process at 128^2 and 1024^2, and on a 2 x 2 mesh of
four worker processes that share the one card and talk over Gloo; every
rank checks its launches, its shard, its image and gradients against the
`xla` backend, and that all ranks hold the same bits.

The [poses] and [poses rows] phases run what CUDA's 65,535 blocks on a
launch grid's y and z once kept from the card (`csrc/poses.cuh` carries a
pose's high part on a second coordinate): 64^2 x 65,536 and 70,000 poses,
(127, 130) and (7, 15, 130) x 70,000 poses of 10^3 points, and (70,000,
64) x 4 x 10^5 (B2 past 65,535 rows), through `auto`: the forward and the
fused step twice, bit-equal, within 2e-5 of the `xla` backend, every
kernel instance launched at 70,000 poses (B1 and B4 bit-equal to their
lane instances and B4 to its plain version), and the peak device memory.

The [xla path] phase drives the `xla` backend's kernels
(`csrc/xla_path.cu`: X1 the neighbour stage, X2 the fixed-order scatter
after a stable sort, X3 the pullback's gather): each bit-equal to its
plain version (X2 to the CPU's `index_add_`) at the rows `auto` sends to
`xla`, the launches of its entry points, a timed run of 1.2 x 10^6 terms,
X2 on runs that end at and across warps and blocks and on a (4096,) x
10^6 cloud, the f64 oracles at small sizes, the second derivatives (C8)
against a float64 run on the CPU, and its times at 1024^3 x 10^5 and
512^3 x 10^6 (X2's fill and run kernel apart, with the sectors of their
random accesses); `python3 chip_smoke.py --xla-path` runs the build and
this phase alone.

Then [no sync] runs every entry point (the forward, the fused pair,
`raster_pullback`, the autograd step; `raster_sharded` on the 1 x 1 mesh)
at 128^2, 1024^2, 128^3 and 64^2 x 70,000 poses under
``torch.cuda.set_sync_debug_mode("error")``, so that a call that makes the
host wait for the card fails the run (`python3 chip_smoke.py --no-sync`
runs the build and this phase alone, then once more under a recording
profiler, where every stage span opens its range); [repeat] runs the
`binned` forward and step at those shapes, and the `xla` rows `auto`
takes on the card, twice to the same bits; [deterministic] every entry
point under ``torch.use_deterministic_algorithms(True)``; [bench] runs
`bench_torch.py`; [run] two rows of `dprast_torch.benchmarks.run` (128^2
and 1024^3, with the autograd step); [tests_gpu] the on-card parity suite
`tests_gpu/`, every test of which must pass.

Run from the root of the repository:

    python3 chip_smoke.py

The last line of its output is one JSON object, ``{"ok": true, "device":
{...}}``; the line before it lists the kernels with their launch counts
on the training path, errors, times and bounds (the least time the card
could take: bytes moved once over its memory rate, or operations over its
fp32 rate).  It exits non-zero when no CUDA device is present or any
check fails.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from dprast_torch.utils.profiling import by_kernel, device_busy, launch_us

ROOT = Path(__file__).resolve().parent

FLAGSHIP = (128, 128)
MULTI_TILE = (1024, 1024)
GRIDS = (FLAGSHIP, MULTI_TILE)
N_POINTS = 100_000
N_POSES = 64
# the small configurations checked against the f64 oracles: the flagship
# grid, two multi-tile grids, and edge shapes (a tiny window, a one-row
# strip, a one-column multi-tile grid)
SMALL_GRIDS = ((128, 128), (256, 256), (999, 777), (5, 5), (3, 200),
               (130, 1))
GRAD_NAMES = ("points", "rotation", "translation", "background",
              "out_weight", "point_weight")
# the grids, poses and points at which B2 and B4's grid source are held to
# their twins beside the main path's: multi-tile grids whose edges cut a
# tile, one whose rows are no multiple of 16 bytes (no TMA box there, the
# kernel stages with plain loads), and for B4 the single tile
ODD_GRIDS = (((300, 200), 3, 5000), ((130, 1000), 3, 5000),
             ((1023, 1021), 3, 20000))

# the card's peak rates for a kernel's bound: device memory bytes/s and
# fp32 operations/s outside the tensor cores (NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# B8's two kernels, which every binned and binned_bf16 pullback launches
# once each: on a single tile E2 on B4's rows and the final sums, on
# several E1 (the unsort and each pose's partials) and E2 on its
# point-order copy with the final sums
EPILOGUE_TILE = ("epilogue_tile", "epilogue_poses")
EPILOGUE_TILES = ("epilogue_rows", "epilogue_points")

# the 3-D path: BASELINE config 4 (10^6 points into 128^3, one pose), and
# a pose batch at a tenth of the points
VOLUME = (128, 128, 128)
VOLUME_CASES = {"1 pose x 1e6": (1, 1_000_000),
                "4 poses x 1e5": (4, 100_000)}
# the point counts of the 3-D path's timings (one pose)
VOLUME_TIMED = (1_000_000, 100_000)
# the 3-D configurations checked against the f64 oracles (grid, seed,
# points; two poses each): tests_tpu/test_hardware_parity.py's two, and a
# grid that is no multiple of the tiles
SMALL_VOLUMES = (((128, 128, 128), 5, 800), ((8, 16, 200), 21, 900),
                 ((9, 17, 130), 5, 800))


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def scaled_err(out, ref):
    """max |out - ref| / max(max |ref|, 1), in float64."""
    out = torch.as_tensor(out).double()
    ref = torch.as_tensor(ref).double().to(out.device)
    return float((out - ref).abs().max() / max(float(ref.abs().max()), 1.0))


def bound(n_bytes, n_ops):
    """The least milliseconds the card could take to move `n_bytes` (each
    input read once, each output written once) or to do `n_ops` fp32
    operations, whichever is larger -> (ms, "bytes" | "operations")."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def live_rows(slot_tile, chunk):
    """Frame rows in live slots, which B1 and B4 read."""
    return int(slot_tile[:, -1].sum()) * chunk


def b1_bound(slot_tile, lane, nt, win, chunk):
    """B1 on these arguments: the live rows' lane planes and the slot
    table read, the windows written; 14 (2-D) or 34 (3-D) operations a
    row (the hat weights, their products, the adds)."""
    rows = live_rows(slot_tile, chunk)
    bsz, n_lane, _ = lane.shape
    n_bytes = (rows * n_lane + slot_tile.numel()
               + bsz * nt * int(np.prod(win))) * 4
    return bound(n_bytes, rows * (14 if len(win) == 2 else 34))


def b4_bound(slot_tile, lane_b, win, chunk):
    """B4 on these arguments: the live rows' lane planes, the slot table
    and the window source (windows, a presplit pair, or the cotangent)
    read once, every output row written; 18 (2-D) or 45 (3-D) operations
    a row."""
    n_out = 2 if lane_b.shape[1] == 4 else 3
    return _b4_bound(slot_tile, lane_b.shape[1], n_out, lane_b.shape[2], win,
                     chunk, 18 if n_out == 2 else 45)


# operations a row spends decoding one encoded coordinate in the kernel
# (two shifts, a subtract, a compare, two selects, a conversion and a
# multiply)
DECODE_OPS = 8


def b1_enc_bound(slot_tile, data, nt, win, chunk):
    """B1 on the frame (`fwd_splat_enc`): as `b1_bound`, with the live
    rows' encoded planes and weight (every plane but the id) read in place
    of lane planes, and the decode of each axis counted."""
    n_out = len(win)
    rows = live_rows(slot_tile, chunk)
    n_bytes = (rows * (data.shape[1] - 1) + slot_tile.numel()
               + data.shape[0] * nt * int(np.prod(win))) * 4
    return bound(n_bytes, rows * ((14 if n_out == 2 else 34)
                                  + DECODE_OPS * n_out))


def b4_enc_bound(slot_tile, coord, win, chunk):
    """B4 on the frame (`bwd_gather_enc`): as `b4_bound`, with the live
    rows' n_out encoded planes read in place of lane planes, and the
    decode of each axis (and in 3-D the four flat rows, 3 operations each)
    counted."""
    n_out = coord.shape[1]
    ops = (18 + 2 * DECODE_OPS if n_out == 2
           else 45 + 3 * DECODE_OPS + 4 * 3)
    return _b4_bound(slot_tile, n_out, n_out, coord.shape[2], win, chunk,
                     ops)


def _b4_bound(slot_tile, n_read, n_out, s_pad, win, chunk, ops_per_row):
    rows = live_rows(slot_tile, chunk)
    bsz = slot_tile.shape[0]
    wins = win if isinstance(win, tuple) else (win,)
    n_bytes = ((rows * n_read + bsz * (n_out + 1) * s_pad
                + slot_tile.numel()) * 4
               + sum(w.numel() * w.element_size() for w in wins))
    return bound(n_bytes, rows * ops_per_row)


def frame_gather_bound(data, n_out, n_points, index):
    """The frame gather writing `data` (B, n_planes, s_pad): the sort's
    index of every frame row (`index`: 4 bytes a row where it is the packed
    int32 keys, 8 where the int64 permutation), each point's n_out encoded
    values and (where the frame has a weight plane) its weight read once,
    the frame written once; no arithmetic."""
    bsz, n_planes, s_pad = data.shape
    weighted = n_planes == n_out + 2
    n_bytes = (bsz * s_pad * index.element_size()
               + (n_out * bsz + weighted) * n_points * 4 + data.numel() * 4)
    return bound(n_bytes, 0)


def direct_frame_bound(pts, rot, tr, data, slot_tile):
    """B6 writing a single tile's frame (`direct_frame`): the cloud and the
    poses read once, the padded frame and its slot table written once;
    B6's operations per (pose, point), as in `coords_bound`."""
    pairs = rot.shape[0] * pts.shape[0]
    n_out, n_in = rot.shape[1:]
    n_bytes = (pts.numel() + rot.numel() + tr.numel() + data.numel()
               + slot_tile.numel()) * 4
    return bound(n_bytes, 2 * pairs * coords_ops(n_in, n_out))


def coords_ops(n_in, n_out):
    """B6's rounded fp32 and integer operations per (pose, point), counted
    from `csrc/coords.cu`: 4 per input axis (the point's split); per
    output axis 17 per input axis (TwoProd 9, TwoSum 6, the lo term 2) and
    63 (the + 1, * scale, - 1/2 and renormalising steps 35; voxel, delta
    and fix-up 10; the cast 1; range tests, tile index, key and encoding
    17).  The splits of the rotation entries and of the scales are done
    once per block and not counted."""
    return n_out * (17 * n_in + 63) + 4 * n_in


def coords_bound(pts, rot, tr, want_key=True):
    """B6 on these inputs: the cloud and the poses read once, one int32
    key (where asked for) and one plane per output axis written per
    (pose, point).  No operation of the compensated pipeline may fuse, so
    each takes the instruction slot of a fused multiply-add, which the
    card's fp32 rate counts as two."""
    pairs = rot.shape[0] * pts.shape[0]
    n_out, n_in = rot.shape[1:]
    n_bytes = (pts.numel() + rot.numel() + tr.numel()
               + pairs * (n_out + bool(want_key))) * 4
    return bound(n_bytes, 2 * pairs * coords_ops(n_in, n_out))


def copy_bound(src, dst, ops_per_out=0):
    """B2 / B3: `src` read once, `dst` written once."""
    return bound((src.numel() + dst.numel()) * 4, dst.numel() * ops_per_out)


def fold_library(ext, grid, ts, ow, bg):
    """What B2 computes through `F.fold` (kernel 128, stride 127): a
    permute of the windows to columns, the fold onto the padded grid, the
    slice and the epilogue -- more than one call."""
    gy, gx = grid
    n0, n1 = -(-gy // ts[0]), -(-gx // ts[1])
    cols = ext.reshape(ext.shape[0], n0 * n1, -1).transpose(1, 2)
    out = torch.nn.functional.fold(
        cols, (n0 * ts[0] + 1, n1 * ts[1] + 1), kernel_size=ts[0] + 1,
        stride=ts[0])
    return out[:, 0, :gy, :gx] * ow[:, None, None] + bg[:, None, None]


def unfold_library(g, grid, ts):
    """What B3 computes through `F.unfold`: the padding, the unfold, and
    the permute of its columns to windows -- more than one call."""
    gy, gx = grid
    n0, n1 = -(-gy // ts[0]), -(-gx // ts[1])
    padded = torch.nn.functional.pad(
        g, (0, n1 * ts[1] + 1 - gx, 0, n0 * ts[0] + 1 - gy))[:, None]
    cols = torch.nn.functional.unfold(padded, kernel_size=ts[0] + 1,
                                      stride=ts[0])
    return cols.transpose(1, 2).reshape(g.shape[0], n0 * n1, ts[0] + 1,
                                        ts[1] + 1)


def flagship_inputs(seed=0, n_points=N_POINTS, n_poses=N_POSES):
    """The flagship benchmark's inputs: a Gaussian cloud and rotations
    about the y axis projected onto (x, y)."""
    rng = np.random.default_rng(seed)
    points = (rng.standard_normal((n_points, 3)) * 0.4).astype(np.float32)
    angles = rng.uniform(0, 2 * np.pi, n_poses)
    c, s = np.cos(angles), np.sin(angles)
    rot = np.zeros((n_poses, 2, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 2] = c, -s
    rot[:, 1, 1] = 1.0
    translation = (rng.standard_normal((n_poses, 2)) * 0.1).astype(np.float32)
    point_weight = rng.uniform(0.5, 2.0, n_points).astype(np.float32)
    return points, rot, translation, point_weight


def time_ms(fn, reps=15, warmup=3):
    """Median milliseconds of `fn` on the card, by CUDA events."""
    from dprast_torch.utils import profiling
    return profiling.time_fn(fn, "cuda", reps, warmup)[0]


def sass_atomics(so, nvcc, kernel="fwd_splat_kernel"):
    """What the atomics of the library's kernels named `kernel` compiled
    to: per template instance, its distinct ATOMS (shared), ATOM and RED
    (global) instructions with their counts, from `cuobjdump -sass` ->
    lines, or one line that says why there are none."""
    import re
    import subprocess
    tool = Path(nvcc).with_name("cuobjdump")
    try:
        sass = subprocess.run([str(tool), "-sass", str(so)],
                              capture_output=True, text=True,
                              check=True).stdout
    except (OSError, subprocess.CalledProcessError) as exc:
        return [f"SASS not read: {exc}"]
    found, name = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            inst = re.search(kernel + r"ILi(\d+)ELi(\d+)E(?:Lb(\d)E)?",
                             fn.group(1))
            name = (f"{kernel}<{inst.group(1)}, {inst.group(2)}"
                    f"{', enc' if inst.group(3) == '1' else ''}>"
                    if inst else None)
            continue
        op = re.search(r"\s((?:ATOMS|ATOM|RED)[.\w]*)\s", line)
        if name and op:
            ops = found.setdefault(name, {})
            ops[op.group(1)] = ops.get(op.group(1), 0) + 1
    return [f"SASS {name}: " + ", ".join(f"{k} x{v}" for k, v in ops.items())
            for name, ops in found.items()] or [
        f"SASS: no atomics found in kernels named {kernel}"]


def reset_launches(sb):
    for name in sb.LAUNCHES:
        sb.LAUNCHES[name] = 0


def ran(launched):
    """The kernels of a launch count that ran at all."""
    return {name: count for name, count in launched.items() if count}


def binned_ran(launched):
    """`ran` without the `xla` path's kernels, which every comparison
    with the `xla` backend launches."""
    from dprast_torch.ops import core
    return {name: count for name, count in ran(launched).items()
            if name not in core.XLA_KERNELS}


def xla_ran(launched):
    """Each of the `xla` path's kernels X1-X3 ran."""
    from dprast_torch.ops import core
    return all(launched.get(name, 0) >= 1 for name in core.XLA_KERNELS)


def train_inputs(pts, rot, tr, pw, weighted):
    """The six `raster` inputs as leaves that require grad: per-pose
    background and out_weight, and a per-point or a scalar point weight
    (the uniform path)."""
    dev = pts.device
    rng = np.random.default_rng(4)
    bg = torch.from_numpy((rng.standard_normal(N_POSES) * 0.1).astype(
        np.float32)).to(dev)
    ow = torch.from_numpy(rng.uniform(0.5, 2.0, N_POSES).astype(
        np.float32)).to(dev)
    w = pw if weighted else torch.tensor(1.5, device=dev)
    return [t.clone().requires_grad_() for t in (pts, rot, tr, bg, ow, w)]


def train_grads(dprast_torch, grid, inputs, g, backend="auto"):
    out = dprast_torch.raster(grid, *inputs, backend=backend)
    return torch.autograd.grad((out * g).sum(), inputs)


def phase_train(dprast_torch, sb, pts, rot, tr, pw, cots, totals):
    """[train]: autograd through `auto` vs the oracle backend on the card,
    each run between a reset and a read of the launch counts."""
    want = {FLAGSHIP: ("coords", "fwd_splat_enc", "bwd_gather_enc",
                       *EPILOGUE_TILE),
            MULTI_TILE: ("coords", "slot_prep", "bin_scatter",
                         "frame_gather", "fwd_splat_enc", "band_fold",
                         "bwd_gather_grid_enc", *EPILOGUE_TILES)}
    for grid in GRIDS:
        for weighted in (False, True):
            inputs = train_inputs(pts, rot, tr, pw, weighted)
            reset_launches(sb)
            grads = train_grads(dprast_torch, grid, inputs, cots[grid])
            torch.cuda.synchronize()
            launched = dict(sb.LAUNCHES)
            for name in launched:
                totals[name] += launched[name]
            for name, count in launched.items():
                # one launch of each kernel of the path and no other: B1
                # and B4 read the frame; at 1024^2 B9, the sort and the
                # frame gather make it, B4 reads the cotangent and B3 does
                # not run; B8's kernels finish the gradients
                check(count == (name in want[grid]),
                      f"{name} ran {count} times in the training step at "
                      f"{grid}")
            ref = train_grads(dprast_torch, grid, inputs, cots[grid],
                              backend="xla")
            errs = {}
            for name, a, r, x in zip(GRAD_NAMES, grads, ref, inputs):
                check(a.shape == x.shape and bool(torch.isfinite(a).all()),
                      f"finite d_{name} of shape {tuple(x.shape)} at {grid}")
                errs[name] = scaled_err(a, r)
            label = "weighted" if weighted else "uniform"
            print(f"[train] auto {grid} {label}: launches {ran(launched)}; "
                  f"scaled max-abs err vs the xla backend (tol 2e-5): "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
            check(max(errs.values()) <= 2e-5, f"training grads at {grid}")


def phase_small(dprast_torch, oracle, dev, tag, cases, backend="binned",
                tol=1e-5, pullback=True):
    """[small] / [3d small]: the forward and (with `pullback`)
    `raster_pullback` on the `backend` vs the f64 oracles within `tol`;
    `cases` are (grid, seed, points, poses) of the fixtures."""
    rng = np.random.default_rng(7)
    for grid, seed, n_points, n_poses in cases:
        fx = oracle.fixtures(seed=seed, n_points=n_points,
                             batch_size=n_poses, n_in=3, n_out=len(grid))
        small = [np.asarray(v, np.float32) for v in fx.values()]
        ones = np.ones(n_points, np.float32)
        on_dev = [torch.from_numpy(a).to(dev) for a in small]
        for weighted in (False, True):
            args = on_dev if weighted else on_dev[:5]
            ref = oracle.raster_numpy(grid, *small[:5],
                                      small[5] if weighted else ones)
            out = dprast_torch.raster(grid, *args, backend=backend)
            err = scaled_err(out, ref)
            print(f"{tag} {backend} {grid} x {n_poses} poses x {n_points} "
                  f"points {'weighted' if weighted else 'uniform'}: forward "
                  f"scaled max-abs err vs f64 oracle {err:.3e} (tol {tol:g})")
            check(err <= tol, f"{backend} forward vs f64 oracle at {grid}")
        if not pullback:
            continue
        g = rng.standard_normal((n_poses,) + grid)
        g_dev = torch.from_numpy(g.astype(np.float32)).to(dev)
        # a per-point weight, the defaulted one (exact per-point d_pw) and
        # a scalar one (summed d_pw, the uniform unsort-free path)
        for label, pw, pw_ref in (("weighted", on_dev[5], small[5]),
                                  ("uniform", None, ones),
                                  ("scalar 1.7", 1.7,
                                   np.full(n_points, 1.7, np.float32))):
            ref = oracle.raster_pullback_numpy(grid, *small[:5], pw_ref, g)
            if label.startswith("scalar"):
                ref["point_weight"] = ref["point_weight"].sum()
            res = dprast_torch.raster_pullback(g_dev, *on_dev[:5], pw,
                                               backend=backend)
            errs = {k: scaled_err(getattr(res, k), ref[k])
                    for k in GRAD_NAMES}
            worst = max(errs, key=errs.get)
            print(f"{tag} {backend} raster_pullback {grid} {label}: scaled "
                  f"max-abs err vs f64 oracle {errs[worst]:.3e} (d_{worst}; "
                  f"tol {tol:g})")
            check(errs[worst] <= tol,
                  f"{backend} pullback vs f64 oracle at {grid} ({label})")


def slots_per_tile(slot_tile, nt):
    """The live slots of each (pose, tile) of a slot table -> (B, nt)."""
    bsz, n_slots = slot_tile.shape[0], slot_tile.shape[1] - 1
    dev = slot_tile.device
    live = torch.arange(n_slots, device=dev) < slot_tile[:, n_slots:]
    flat = (slot_tile[:, :n_slots].long()
            + torch.arange(bsz, device=dev)[:, None] * nt)
    return torch.bincount(flat[live], minlength=bsz * nt).reshape(bsz, nt)


def sparse_frame(sb, grid, pts, rot, tr):
    """A frame that has tiles without a slot and dead slots (the
    standalone pullback's, which gives an empty tile none), as arguments of
    B1.  The rows of its dead slots are overwritten with those of the first
    slot, which lie inside a window: B1 must add nothing for them."""
    ts = sb.tile_shape_for(grid)
    data, st, chunk = sb._bwd_frame(grid, pts, rot, tr)
    n_out = len(grid)
    lane = sb._planes_fwd(data[:, :n_out], None).contiguous()
    n_slots = st.shape[1] - 1
    dead = torch.repeat_interleave(
        torch.arange(n_slots, device=st.device) >= st[:, n_slots:], chunk,
        dim=1)
    lane = torch.where(dead[:, None, :], lane[:, :, :chunk].repeat(
        1, 1, n_slots), lane).contiguous()
    nt = sb.n_tiles(grid)
    per_tile = slots_per_tile(st, nt)
    check(bool((per_tile == 0).any()) and bool(dead.any()),
          f"the sparse frame at {grid} has an empty tile and dead slots")
    return st, lane, nt, tuple(t + 1 for t in ts), chunk


def b1_clusters(sb, tag, args, *, encoded=False, terms=0):
    """B1 on the frame `args` (lane planes, or with `encoded` the frame
    itself, the main path's instance) at every cluster size, two launches
    each: every launch bit-equal to the first, so to every other run and
    cluster size, and to `_fwd_splat_fixed_plain`, the kernel's function
    (a NaN matches any NaN); the finite entries within `B1_TWIN_TOL` of
    the fp32 twin, and every NaN and infinity where the twin has it ->
    the error against the fp32 twin."""
    kernel, fixed, plain = (
        (sb.fwd_splat_enc, sb._fwd_splat_enc_fixed_plain,
         sb._fwd_splat_enc_plain) if encoded else
        (sb.fwd_splat, sb._fwd_splat_fixed_plain, sb._fwd_splat_plain))
    name = sb._b1_instance(len(args[3]), terms) + ("_enc" if encoded else "")
    first = None
    for c in range(1, sb._MAX_CLUSTER + 1):
        for _ in range(2):
            ext = kernel(*args, terms=terms, cluster=c)
            first = ext if first is None else first
            check(same_values(ext, first),
                  f"[B1 clusters] {tag} {name}: cluster size {c} gives the "
                  f"bits of the first run")
    ext_f = fixed(*args, terms=terms)
    ext_p = plain(*args, terms=terms)
    torch.cuda.synchronize()
    fin = torch.isfinite(ext_p)
    err = scaled_err(first[fin], ext_p[fin])
    n_bad = int((~fin).sum())
    print(f"[B1 clusters] {tag} {name}: ext {tuple(first.shape)}, two runs "
          f"at each cluster size 1-{sb._MAX_CLUSTER} bit-equal to each other "
          f"and to _fwd_splat_fixed_plain; scaled max-abs err vs the fp32 "
          f"twin {err:.3e} (tol {B1_TWIN_TOL:g}); {n_bad} non-finite "
          f"entries where the twin has them")
    check(same_values(first, ext_f),
          f"[B1 clusters] {tag} {name} bit-equal to _fwd_splat_fixed_plain")
    check(same_values(torch.where(fin, 0.0, first),
                      torch.where(fin, 0.0, ext_p)),
          f"[B1 clusters] {tag} {name}: NaN and infinities where the fp32 "
          f"twin has them")
    check(err <= B1_TWIN_TOL, f"[B1 clusters] {tag} {name} vs the fp32 twin")
    return err


def same_values(a, b):
    """Two float32 tensors hold the same bits, any NaN matching any NaN
    (tensors of another type: the same values)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        torch.where(na, 0.0, a).view(torch.int32),
        torch.where(nb, 0.0, b).view(torch.int32))


def same_bits(a, b):
    """Two tensors of 32-bit elements hold the same bits."""
    return torch.equal(a.view(torch.int32).cpu(), b.view(torch.int32).cpu())


def bits_apart(a, b):
    """Largest absolute difference of two tensors of 32-bit elements, read
    as int32 -> int; 0 where they hold the same bits."""
    a, b = (x.view(torch.int32).cpu().long() for x in (a, b))
    return int((a - b).abs().max()) if a.numel() else 0


def coords_three_ways(sb, dev, tag, grid, host):
    """B6 at `grid` on `host` = (points, rotation, translation) as float32
    numpy arrays: the kernel on the card, its twin on the card and its
    twin on the CPU must give the same keys and encoded planes bit for
    bit, the kernel must count one launch, and the sentinel key must stand
    exactly where the twin puts it.  -> the largest difference of the int32
    views of keys and planes, kernel against either twin (0 if it got
    here)."""
    ts = sb.tile_shape_for(grid)
    on_dev = [torch.from_numpy(a).to(dev) for a in host]
    before = sb.LAUNCHES["coords"]
    key_k, locs_k, nt = sb._keys_and_local(grid, ts, *on_dev)
    check(sb.LAUNCHES["coords"] == before + 1, f"{tag}: B6 counted a launch")
    twins = {"the twin on the card": sb._keys_and_local_plain(
        grid, ts, *on_dev), "the twin on the CPU": sb._keys_and_local_plain(
        grid, ts, *(torch.from_numpy(a) for a in host))}
    check(sb.LAUNCHES["coords"] == before + 1, f"{tag}: a twin launches "
                                               f"nothing")
    torch.cuda.synchronize()
    apart = 0
    for where, (key_t, locs_t, nt_t) in twins.items():
        apart = max(apart, bits_apart(key_k, key_t), *(
            bits_apart(a, b) for a, b in zip(locs_k, locs_t, strict=True)))
        check(nt_t == nt and same_bits(key_k, key_t),
              f"{tag}: tile keys bit-equal to {where}")
        check(torch.equal((key_k == nt).cpu(), (key_t == nt).cpu()),
              f"{tag}: the sentinel key stands where {where} puts it")
        for i, (a, b) in enumerate(zip(locs_k, locs_t, strict=True)):
            check(same_bits(a, b),
                  f"{tag}: encoded plane {i} bit-equal to {where}")
    n_out, n_in = host[1].shape[1:]
    print(f"[B6 coords] {tag}: {grid}, {n_in} -> {n_out}, {host[1].shape[0]} "
          f"poses x {host[0].shape[0]} points, {nt} tiles: keys and encoded "
          f"planes of the kernel, the twin on the card and the twin on the "
          f"CPU bit-equal (largest difference of the int32 views {apart}); "
          f"{int((key_k == nt).sum())} sentinel keys")
    return float(apart)


def phase_coords(sb, dev, testing, main_host):
    """[B6 coords]: the coordinate kernel against its twin, three ways
    (`coords_three_ways`), no tolerance: at the main shapes (128^2 and
    1024^2 x 64 x 10^5, 128^3 x 1 x 10^6), a 2 -> 2 cloud, the odd grids,
    the edge set of `dprast_torch.utils.testing.coords_edge_set` on six
    grids from 2 and 3 input axes, and from 1 and 4 input axes (the
    instance that reads the count at run time); without keys, the planes
    are the same and no key comes back.  -> the difference read at each
    main shape, by grid."""
    apart = {grid: coords_three_ways(sb, dev, "main", grid, main_host)
             for grid in GRIDS}
    apart[VOLUME] = coords_three_ways(
        sb, dev, "main", VOLUME,
        volume_inputs(*VOLUME_CASES["1 pose x 1e6"])[:3])
    coords_three_ways(sb, dev, "pose batch", VOLUME,
                      volume_inputs(*VOLUME_CASES["4 poses x 1e5"])[:3])
    pts, rot, tr = flagship_inputs(3, 20_000, 8)[:3]
    flat = (np.ascontiguousarray(pts[:, :2]),
            np.ascontiguousarray(rot[:, :, :2]), tr)
    coords_three_ways(sb, dev, "flat cloud", (300, 200), flat)
    for grid, n_poses, n_points in ((g, 4, 1500) for g in SMALL_GRIDS):
        coords_three_ways(sb, dev, "small", grid,
                          flagship_inputs(3, n_points, n_poses)[:3])
    for grid, n_poses, n_points in ODD_GRIDS:
        coords_three_ways(sb, dev, "odd", grid,
                          flagship_inputs(3, n_points, n_poses)[:3])
    for grid in testing.COORDS_EDGE_GRIDS:
        for n_in in (2, 3):
            fx = testing.coords_edge_set(grid, n_in=n_in)
            coords_three_ways(sb, dev, "edge set", grid, tuple(fx.values()))
    for n_in in (1, 4):
        fx = testing.coords_edge_set((300, 200), n_in=n_in)
        coords_three_ways(sb, dev, "edge set", (300, 200),
                          tuple(fx.values()))
    on_dev = [torch.from_numpy(a).to(dev) for a in main_host]
    ts = sb.tile_shape_for(FLAGSHIP)
    _, locs, _ = sb._keys_and_local(FLAGSHIP, ts, *on_dev)
    key, locs_nokey, _ = sb._keys_and_local(FLAGSHIP, ts, *on_dev,
                                            want_key=False)
    check(key is None and all(same_bits(a, b) for a, b in
                              zip(locs, locs_nokey, strict=True)),
          "[B6 coords] without keys the planes are the same")
    print(f"[B6 coords] {FLAGSHIP} without keys: the same planes, no key "
          f"written")
    return apart


def coords_in_turns(sb, smi, tag, grid, on_dev, phase="[times]"):
    """[times] / [3d times]: the coordinate stage at `grid`, kernel
    against twin in turns (kernel, twin, twin, kernel) -> (kernel ms, twin
    ms, the kernel's device us, the twin's device-busy us, the twin's
    launches), ms the median by CUDA events and the mean of the two
    turns."""
    ts = sb.tile_shape_for(grid)
    fns = {"kernel": lambda: sb._keys_and_local(grid, ts, *on_dev),
           "twin": lambda: sb._keys_and_local_plain(grid, ts, *on_dev)}
    runs = {name: [] for name in fns}
    for name in ("kernel", "twin", "twin", "kernel"):
        runs[name].append(time_ms(fns[name]))
    dev_us = launch_us(fns["kernel"], "coords_kernel")
    twin_us, twin_launches = device_busy(fns["twin"])
    k_ms, t_ms = (sum(runs[name]) / 2 for name in ("kernel", "twin"))
    bound_ms, by = coords_bound(*on_dev)
    print(f"{phase} {smi} | {tag} keys (B6), kernel against twin in turns, "
          f"median ms: kernel "
          + " / ".join(f"{v:.4f}" for v in runs["kernel"]) + ", twin "
          + " / ".join(f"{v:.4f}" for v in runs["twin"])
          + f"; kernel device {us_text(dev_us)}, "
            f"{of_bound(bound_ms, dev_us)} of its "
            f"{bound_ms * 1e3:.1f} us bound (by {by}); the twin keeps the "
            f"card busy {twin_us:.1f} us in {twin_launches:.0f} launches")
    return k_ms, t_ms, dev_us, twin_us, twin_launches


def b1_weights(pw, kind):
    """The point weights of a [B1 clusters] frame: `pw` itself
    ("positive"), its signs flipped at random ("signed"), or with one NaN
    and one infinite weight ("NaN and inf")."""
    if kind == "signed":
        signs = np.random.default_rng(5).choice([-1.0, 1.0], pw.shape[0])
        return pw * torch.from_numpy(signs.astype(np.float32)).to(pw.device)
    if kind == "NaN and inf":
        out = pw.clone()
        out[0], out[1] = float("nan"), float("inf")
        return out
    return pw


def phase_b1(sb, dev, pts, rot, tr, pw, oracle, dprast_torch):
    """[B1 clusters]: the forward splat, every instance at every cluster
    size (`b1_clusters`): the lane and the frame's (`_enc`) instances at
    the main shapes (128^2 and 1024^2 x 64 x 10^5, 128^3 x 1 x 10^6), terms
    0 and 1, uniform, positive, signed weights and weights with a NaN and
    an infinity; the lane instance at `ODD_GRIDS`, at the single tile with
    a point count that is no multiple of the chunk, at a 5x5 window and on
    a frame with an empty tile and dead slots.  Then the forward of small
    clouds against the f64 oracle.  -> {(grid, weighted): (args, ext,
    data)} at the 2-D main shapes; the main path's instance on the frame
    is held to the lane instance in [B7 frame]."""
    frames = {}
    host = volume_inputs(1, 1_000_000)
    vol = [torch.from_numpy(a).to(dev) for a in host]
    for grid, (p_, r_, t_, w_) in ((FLAGSHIP, (pts, rot, tr, pw)),
                                   (MULTI_TILE, (pts, rot, tr, pw)),
                                   (VOLUME, (vol[0], vol[1], vol[2],
                                             vol[5]))):
        kinds = ["uniform", "positive", "signed"]
        if grid != MULTI_TILE:
            kinds.append("NaN and inf")
        for kind in kinds:
            weighted = kind != "uniform"
            args, data = sb._fwd_frame(grid, p_, r_, t_, b1_weights(w_, kind),
                                       not weighted)
            if grid in GRIDS and kind in ("uniform", "positive"):
                frames[grid, weighted] = (args, sb.fwd_splat(*args), data)
            enc = (args[0], data) + args[2:]
            tag = f"{grid} x {r_.shape[0]} x {p_.shape[0]} {kind}"
            for terms in (0, 1):
                b1_clusters(sb, tag, args, terms=terms)
                b1_clusters(sb, tag, enc, encoded=True, terms=terms)
    cases = [(grid, n_poses, n_points, "weighted")
             for grid, n_poses, n_points in ODD_GRIDS]
    cases.append((FLAGSHIP, 3, 4321, "weighted"))
    cases.append(((5, 5), 3, 700, "uniform"))
    for grid, n_poses, n_points, label in cases:
        p_, r_, t_, w_ = (torch.from_numpy(a).to(dev) for a in
                          flagship_inputs(3, n_points, n_poses))
        args, _ = sb._fwd_frame(grid, p_, r_, t_, w_, label == "uniform")
        b1_clusters(sb, f"{grid} x {n_poses} x {n_points} {label}", args)
    p_, r_, t_ = (torch.from_numpy(a).to(dev) for a in
                  flagship_inputs(3, 3000, 3)[:3])
    b1_clusters(sb, "(1023, 1021) x 3 x 3000, empty tiles and dead slots",
                sparse_frame(sb, (1023, 1021), p_ * 0.3, r_, t_))
    phase_small(dprast_torch, oracle, dev, "[B1 clusters]",
                [((256, 256), 3, 1500, 4), ((8, 16, 200), 21, 900, 2)],
                pullback=False)
    return frames


def phase_b2(sb, dev, ext_mt, ow, bg):
    """[B2]: the band fold bit-equal to its twin on the 1024^2 windows of
    B1 and on random windows at `ODD_GRIDS` -> worst scaled error."""
    cases = [(MULTI_TILE, ext_mt, ow, bg)]
    gen = torch.Generator(device=dev).manual_seed(1)
    for grid, n_poses, _ in ODD_GRIDS:
        cases.append((grid, torch.randn(
            (n_poses, sb.n_tiles(grid), sb.TILE, sb.TILE), device=dev,
            generator=gen), ow[:n_poses].contiguous(),
            bg[:n_poses].contiguous()))
    worst = 0.0
    for grid, ext, ow_g, bg_g in cases:
        ts = sb.tile_shape_for(grid)
        out_k = sb.band_fold(ext, grid, ts, ow_g, bg_g)
        out_p = sb._band_fold_plain(ext, grid, ts, ow_g, bg_g)
        torch.cuda.synchronize()
        err = scaled_err(out_k, out_p)
        worst = max(worst, err)
        same = torch.equal(out_k, out_p)
        print(f"[B2 band_fold] {grid}: out {tuple(out_k.shape)}, scaled "
              f"max-abs err vs twin {err:.3e}, bit-equal {same}")
        check(same, f"B2 bit-equal to its twin at {grid}")
    return worst


def phase_b4_grid(sb, dev, b4_cases):
    """[B4 grid]: B4's grid source (the cotangent itself) at terms 0 and 1,
    bit-equal to its twin and to B3 followed by the natural instance, on
    the frames `b4_cases` of the main path ((grid, label, st, lane_b, g,
    chunk)) and on standalone frames at `ODD_GRIDS`.  The main path's grid
    source reads the frame (`bwd_gather_grid_enc`): [B7 frame] holds it to
    this lane instance."""
    cases = list(b4_cases)
    for grid, n_poses, n_points in ODD_GRIDS:
        pts, rot, tr = (torch.from_numpy(a).to(dev) for a in flagship_inputs(
            3, n_points, n_poses)[:3])
        data, st, chunk = sb._bwd_frame(grid, pts, rot, tr)
        lane_b = sb._planes_bwd(data[:, :2],
                                sb.tile_shape_for(grid)).contiguous()
        g = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (n_poses,) + grid).astype(np.float32)).to(dev)
        cases.append((grid, "standalone frame", st, lane_b, g, chunk))
    for grid, label, st, lane_b, g, chunk in cases:
        ts = sb.tile_shape_for(grid)
        win = g if sb._single_tile(grid) else sb.band_unfold(g, grid, ts)
        for terms in (0, 1):
            before = dict(sb.LAUNCHES)
            buf_k = sb.bwd_gather(st, lane_b, g, chunk, terms=terms,
                                  layout="grid")
            (counter,) = (k for k, v in sb.LAUNCHES.items()
                          if v != before[k])
            buf_p = sb._bwd_gather_plain(st, lane_b, g, chunk, terms=terms,
                                         layout="grid")
            buf_n = sb.bwd_gather(st, lane_b, win, chunk, terms=terms)
            torch.cuda.synchronize()
            same = torch.equal(buf_k, buf_p)
            same_n = torch.equal(buf_k, buf_n)
            print(f"[B4 grid] {grid} x {g.shape[0]} {label} terms={terms} "
                  f"({counter}): rows {tuple(buf_k.shape)}, bit-equal to "
                  f"twin {same}, to B3 + the natural instance {same_n}")
            check(same, f"B4 grid bit-equal to its twin at {grid} "
                        f"(terms={terms}, {label})")
            check(same_n, f"B4 grid bit-equal to B3 + natural B4 at {grid} "
                          f"(terms={terms}, {label})")


# [B7 frame]: (grid, poses, points) at which the frame writers and the
# `_enc` instances of B1 and B4 are held to the plain writers, to the lane
# instances and to the plain versions: the main path's three shapes, and a
# grid whose rows are no multiple of 16 bytes, where B4's grid source
# stages with plain loads (the `_ldg` counters)
B7_CASES = ((FLAGSHIP, N_POSES, N_POINTS), (MULTI_TILE, N_POSES, N_POINTS),
            ((1023, 1021), 3, 20_000), (VOLUME, 1, 1_000_000))
# B1 sums each window exactly in fixed point; its fp32 twin, the CPU's
# path, adds the same terms in fp32 in frame order (scaled max-abs)
B1_TWIN_TOL = 1e-6


def b7_inputs(grid, n_poses, n_points, dev):
    """[B7 frame]'s cloud on the card: the main path's own at its shapes
    (`flagship_inputs`, `volume_inputs`), seed 3 elsewhere -> (points,
    rotation, translation, point_weight, cotangent)."""
    if len(grid) == 3:
        host = volume_inputs(n_poses, n_points)
        host = host[:3] + host[5:]
    else:
        host = flagship_inputs(0 if grid in GRIDS else 3, n_points, n_poses)
    g = np.random.default_rng(2).standard_normal((n_poses,) + grid)
    return [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
            for a in (*host, g)]


def b7_writers(sb, tag, grid, pts, rot, tr, pw):
    """The frame writers of the card (B6 on a single tile, the frame
    gather after the sort on several) against the plain `_prep_direct` /
    `_prep_binned` on B6's own planes, bit for bit (int32 views): the
    forward's frame, uniform and weighted, and the standalone pullback's.
    Each frame costs B6 one launch, and the frame gather one on several
    tiles.  -> the largest difference of the int32 views of frame and slot
    table, kernels against plain."""
    def b6_planes(*args, **kw):
        # B6, but not as the package's own stage: `_frame` then writes the
        # frame the plain way
        return sb._keys_and_local(*args, **kw)

    halo = not sb._single_tile(grid)
    want = ({"coords": 1, "slot_prep": 1, "bin_scatter": 1,
             "frame_gather": 1} if halo else {"coords": 1})
    plain_name = "_prep_binned" if halo else "_prep_direct"
    apart = 0
    for label, build in (
            ("forward, uniform",
             lambda c: sb._fwd_prep(grid, pts, rot, tr, pw, True, c)),
            ("forward, weighted",
             lambda c: sb._fwd_prep(grid, pts, rot, tr, pw, False, c)),
            ("standalone pullback",
             lambda c: sb._bwd_frame(grid, pts, rot, tr, c))):
        before = dict(sb.LAUNCHES)
        kern = build(sb._keys_and_local)
        torch.cuda.synchronize()
        launched = ran({k: sb.LAUNCHES[k] - before[k] for k in before})
        plain = build(b6_planes)
        same = (kern[0].shape == plain[0].shape and torch.equal(
            kern[0].view(torch.int32), plain[0].view(torch.int32))
            and torch.equal(kern[1], plain[1]) and kern[2:] == plain[2:])
        if same:
            apart = max(apart, bits_apart(kern[0], plain[0]),
                        bits_apart(kern[1], plain[1]))
        print(f"[B7 frame] {tag} {label}: frame {tuple(kern[0].shape)} and "
              f"slot table {tuple(kern[1].shape)} written by {launched}, "
              f"bit-equal to {plain_name} on B6's planes {same}")
        check(launched == want, f"{tag} {label}: the frame cost {want}")
        check(same, f"{tag} {label}: the frame is {plain_name}'s bit for "
                    f"bit")
    return apart


def b7_writer_times(sb, smi, tag, grid, pts, rot, tr):
    """The writer of the uniform forward's frame at `grid`, timed against
    its plain version on the same inputs: B6 writing a single tile's frame
    (`direct_frame`), or the frame gather after the sort on several tiles
    -> (counter, {ms, dev_us, plain_ms, bound})."""
    ts = sb.tile_shape_for(grid)
    chunk = sb._default_chunk(grid, pts.shape[0])
    if sb._single_tile(grid):
        args = (grid, ts, pts, rot, tr, None, chunk)
        counter, name = "coords", "coords_kernel"
        run = functools.partial(sb.direct_frame, *args)
        plain = functools.partial(sb._direct_frame_plain, *args)
        bnd = direct_frame_bound(pts, rot, tr, *run())
    else:
        key, locs, nt = sb._keys_and_local(grid, ts, pts, rot, tr)
        perm, sorted_keys, _ = sb._slot_order(key, nt, chunk, True, True)
        index = perm if sorted_keys is None else sorted_keys
        counter, name = "frame_gather", "frame_gather_kernel"
        run = functools.partial(sb.frame_gather, index, locs, None)
        plain = functools.partial(sb._frame_gather_plain, index, locs, None)
        bnd = frame_gather_bound(run(), len(grid), pts.shape[0], index)
        library = gather_library(sb, index, locs)
    entry = {"ms": time_ms(run), "dev_us": launch_us(run, name, calls=5),
             "plain_ms": time_ms(plain, reps=5, warmup=1), "bound": bnd,
             "library_ms": None}
    if counter != "coords":
        entry["library_ms"] = time_ms(library)
        entry["library_busy_us"] = device_busy(library)[0]
    what = "B6 writing the frame" if counter == "coords" else counter
    print(f"[B7 frame] {smi} | {tag} {what}: {entry['ms']:.4f} ms (plain "
          f"{entry['plain_ms']:.4f}), device {us_text(entry['dev_us'])}, "
          f"{of_bound(bnd[0], entry['dev_us'])} of its "
          f"{bnd[0] * 1e3:.1f} us bound (by {bnd[1]})"
          + ("" if entry["library_ms"] is None else
             f"; one torch.gather of the prepared table "
             f"{entry['library_ms']:.4f} ms, device busy "
             f"{entry['library_busy_us']:.2f} us"))
    return counter, entry


def gather_library(sb, index, locs):
    """The frame gather's one-call yardstick: one `torch.gather` of a
    prepared (B, n_planes, P + 1) table (the encoded planes and the point
    ids, a filler column at P) by a prepared index of each row's source,
    clamped to P -> the call, its inputs made here once."""
    bsz, p = locs[0].shape
    ids = torch.arange(p, dtype=torch.float32, device=locs[0].device)
    table = torch.stack([torch.cat([pl_, torch.zeros(
        (bsz, 1), device=pl_.device)], dim=1) for pl_ in locs] + [
        torch.cat([ids, ids.new_full((1,), float(p))]).expand(bsz, p + 1)],
        dim=1).contiguous()
    at = torch.clamp(sb._frame_ids(index, p), max=p)[:, None, :].expand(
        bsz, table.shape[1], index.shape[1]).contiguous()
    return lambda: torch.gather(table, 2, at)


def b7_calls(sb, frame, win, ts, g_in, layout, terms, weighted):
    """B1 and B4 on the forward's frame ``frame = (data, slot_tile, nt,
    chunk)`` at `terms` -> {stage: (`_enc` call, lane call, plain call,
    `_enc` bound)}; the lane calls read the frame's lane planes
    (`_planes_fwd`, `_planes_bwd`), made here once."""
    data, st, nt, chunk = frame
    n_out = len(win)
    coord = data[:, :n_out]
    lane = sb._planes_fwd(coord, data[:, n_out] if weighted
                          else None).contiguous()
    lane_b = sb._planes_bwd(coord, ts).contiguous()
    b1 = (st, data, nt, win, chunk)
    b4 = (st, coord, ts, g_in, chunk)
    return {
        "b1": (lambda: sb.fwd_splat_enc(*b1, terms=terms),
               lambda: sb.fwd_splat(st, lane, nt, win, chunk, terms=terms),
               lambda: sb._fwd_splat_enc_plain(*b1, terms=terms),
               b1_enc_bound(*b1)),
        "b4": (lambda: sb.bwd_gather_enc(*b4, terms=terms, layout=layout),
               lambda: sb.bwd_gather(st, lane_b, g_in, chunk, terms=terms,
                                     layout=layout),
               lambda: sb._bwd_gather_enc_plain(*b4, terms=terms,
                                                layout=layout),
               b4_enc_bound(st, coord, g_in, chunk))}


def b7_kernels(sb, tag, grid, pts, rot, tr, pw, g):
    """The `_enc` instances of B1 and B4 on the forward's frame, uniform
    and weighted, terms 0 and 1, each against the same kernel on the
    frame's lane planes and against its plain version (`b7_calls`): B1
    bit-equal to the lane instance and to `_fwd_splat_enc_fixed_plain`
    and within `B1_TWIN_TOL` of the fp32 plain version, B4 bit-equal to
    both.  B4 reads what the main
    path hands it: the cotangent on a single tile, the cotangent as its
    grid source on several 2-D tiles, the unfolded windows in 3-D.  ->
    ({counter: worst error}, {(stage, terms): (counter, enc call, plain
    call, enc bound)} on the uniform frame)."""
    ts = sb.tile_shape_for(grid)
    win = sb._window(grid)
    if len(grid) == 3:
        layout, g_in = "natural", sb._unfold(g, grid, ts)
    elif sb._single_tile(grid):
        layout, g_in = "natural", g
    else:
        layout, g_in = "grid", g
    errs, calls = {}, {}
    for weighted in (False, True):
        frame = sb._fwd_prep(grid, pts, rot, tr, pw, not weighted)
        for terms in (0, 1):
            line = []
            for stage, (enc, lane, plain, bnd) in b7_calls(
                    sb, frame, win, ts, g_in, layout, terms,
                    weighted).items():
                before = dict(sb.LAUNCHES)
                out_e = enc()
                (counter,) = (k for k in before if sb.LAUNCHES[k] != before[k])
                out_l, out_p = lane(), plain()
                fixed = functools.partial(
                    sb._fwd_splat_enc_fixed_plain, frame[1], frame[0],
                    frame[2], win, frame[3], terms=terms)
                torch.cuda.synchronize()
                e_l, e_p = scaled_err(out_e, out_l), scaled_err(out_e, out_p)
                errs[counter] = max(errs.get(counter, 0.0), e_l, e_p)
                if stage == "b1":
                    same_l = same_values(out_e, out_l)
                    same_f = same_values(out_e, fixed())
                    line.append(f"{counter} bit-equal to lanes {same_l}, to "
                                f"_fwd_splat_enc_fixed_plain {same_f}; vs "
                                f"the fp32 plain version {e_p:.3e} (tol "
                                f"{B1_TWIN_TOL:g})")
                    check(same_l and same_f and e_p <= B1_TWIN_TOL,
                          f"{tag} {counter} bit-equal to the lane instance "
                          f"and the fixed-point plain version, and within "
                          f"{B1_TWIN_TOL:g} of the fp32 one")
                else:
                    same_l = torch.equal(out_e, out_l)
                    same_p = torch.equal(out_e, out_p)
                    line.append(f"{counter} bit-equal to lanes {same_l}, to "
                                f"plain {same_p}")
                    check(same_l and same_p, f"{tag} {counter} bit-equal to "
                                             f"the lane instance and the "
                                             f"plain version")
                if not weighted:
                    calls[stage, terms] = (counter, enc, plain, bnd)
            label = "weighted" if weighted else "uniform"
            print(f"[B7 frame] {tag} {label} terms={terms}: "
                  + "; ".join(line))
    return errs, calls


def b7_times(smi, tag, calls):
    """The `_enc` instances of `calls` (`b7_kernels`) timed: median ms by
    CUDA events, the kernel's device us a launch (`torch.profiler`) and
    their plain version's ms -> {counter: {ms, dev_us, plain_ms,
    bound}}."""
    kernel = {"b1": "fwd_splat_kernel", "b4": "bwd_gather_kernel"}
    out = {}
    for (stage, _), (counter, enc, plain, bnd) in calls.items():
        entry = {"ms": time_ms(enc),
                 "dev_us": launch_us(enc, kernel[stage], calls=5),
                 "plain_ms": time_ms(plain, reps=3, warmup=1), "bound": bnd}
        out[counter] = entry
        print(f"[B7 frame] {smi} | {tag} {counter}: {entry['ms']:.4f} ms "
              f"(plain {entry['plain_ms']:.4f}), device "
              f"{us_text(entry['dev_us'])}, "
              f"{of_bound(bnd[0], entry['dev_us'])} of its "
              f"{bnd[0] * 1e3:.1f} us bound (by {bnd[1]})")
    return out


def b7_no_planes(dprast_torch, sb, dev):
    """A fused step (`raster` and `torch.autograd.grad` of all six inputs)
    through `binned` and `binned_bf16` at the main path's three shapes,
    uniform and weighted, with spies on `_planes_fwd`, `_planes_bwd` and
    `_decode_coord`: none of them may see a CUDA tensor."""
    names = ("_planes_fwd", "_planes_bwd", "_decode_coord")
    real = {name: getattr(sb, name) for name in names}
    seen = []

    def spy(name):
        def wrapped(*args, **kw):
            seen.append((name, [str(a.device) for a in args
                                if isinstance(a, torch.Tensor)]))
            return real[name](*args, **kw)
        return wrapped

    for grid, n_poses, n_points in (B7_CASES[0], B7_CASES[1], B7_CASES[3]):
        pts, rot, tr, pw, g = b7_inputs(grid, n_poses, n_points, dev)
        for backend in ("binned", "binned_bf16"):
            for weighted in (False, True):
                leaves = [t.clone().requires_grad_() for t in (
                    pts, rot, tr, torch.zeros(n_poses, device=dev),
                    torch.ones(n_poses, device=dev),
                    pw if weighted else torch.tensor(1.5, device=dev))]
                del seen[:]
                for name in names:
                    setattr(sb, name, spy(name))
                reset_launches(sb)
                try:
                    out = dprast_torch.raster(grid, *leaves, backend=backend)
                    grads = torch.autograd.grad((out * g).sum(), leaves)
                    torch.cuda.synchronize()
                finally:
                    for name in names:
                        setattr(sb, name, real[name])
                launched = ran(sb.LAUNCHES)
                on_card = [name for name, devs in seen
                           if any(d.startswith("cuda") for d in devs)]
                check(not on_card and all(torch.isfinite(x).all()
                                          for x in (out, *grads)),
                      f"[B7 frame] {grid} {backend}: no lane planes or "
                      f"decode on the card ({on_card})")
                print(f"[B7 frame] {grid} {backend} "
                      f"{'weighted' if weighted else 'uniform'} fused step: "
                      f"launches {launched}; calls of {', '.join(names)}: "
                      f"{len(seen)}, on a CUDA tensor: {len(on_card)}")


def phase_b7(dprast_torch, sb, dev, smi):
    """[B7 frame]: the frame writers (`b7_writers`, timed at the main
    shapes by `b7_writer_times`) and the `_enc` instances of B1 and B4
    (`b7_kernels`, timed by `b7_times`) at `B7_CASES`, and fused steps at
    the main shapes with no lane planes made on the card
    (`b7_no_planes`).  -> {"errs": {counter: worst error; "frame": the
    writers' largest difference of int32 views}, "times": {(grid,
    counter): the timing dict}}."""
    errs, times = {"frame": 0}, {}
    for grid, n_poses, n_points in B7_CASES:
        tag = f"{grid} x {n_poses} x {n_points}"
        pts, rot, tr, pw, g = b7_inputs(grid, n_poses, n_points, dev)
        errs["frame"] = max(errs["frame"],
                            b7_writers(sb, tag, grid, pts, rot, tr, pw))
        if grid in GRIDS or grid == VOLUME:
            counter, entry = b7_writer_times(sb, smi, tag, grid, pts, rot,
                                             tr)
            times[grid, counter] = entry
        got, calls = b7_kernels(sb, tag, grid, pts, rot, tr, pw, g)
        for name, err in got.items():
            errs[name] = max(errs.get(name, 0.0), err)
        times.update({(grid, name): v
                      for name, v in b7_times(smi, tag, calls).items()})
    b7_no_planes(dprast_torch, sb, dev)
    return {"errs": errs, "times": times}


def phase_fit(dprast_torch, pts, rot, tr, steps=5):
    """[fit]: SGD on the points of the flagship cloud from a start
    perturbed by 0.3 voxel, towards the image of the true cloud; mean
    squared image difference through `auto` and autograd.  The step size
    moves the points by 0.01 voxel rms on the first step and stays: at
    this density (10^5 points on 128^2) a 0.05-voxel step overshoots
    after two steps."""
    voxel = 2.0 / FLAGSHIP[0]
    target = dprast_torch.raster(FLAGSHIP, pts, rot, tr)
    rng = np.random.default_rng(5)
    noise = torch.from_numpy((rng.standard_normal(pts.shape) * 0.3
                              * voxel).astype(np.float32)).to(pts.device)
    x = (pts + noise).requires_grad_()
    losses, lr = [], None
    for _ in range(steps + 1):
        img = dprast_torch.raster(FLAGSHIP, x, rot, tr)
        loss = ((img - target) ** 2).mean()
        (grad,) = torch.autograd.grad(loss, x)
        check(bool(torch.isfinite(grad).all()), "finite fit gradient")
        losses.append(float(loss.detach()))
        if lr is None:
            lr = 0.01 * voxel / float(grad.square().mean().sqrt())
        with torch.no_grad():
            x -= lr * grad
    print(f"[fit] {FLAGSHIP} x {N_POSES} poses x {N_POINTS} points, {steps} "
          f"SGD steps (lr {lr:.4e}): loss "
          + " -> ".join(f"{v:.6e}" for v in losses))
    check(all(b < a for a, b in zip(losses, losses[1:])),
          "the fit's loss strictly decreases")


def volume_inputs(n_poses, n_points, seed=11):
    """BASELINE config 4's inputs, made as in
    tests_tpu/test_hardware_parity.py:88-97: a 0.4-sigma Gaussian cloud,
    translations at 0.1 sigma, per-point weights uniform in (0.5, 2),
    background 0 and out_weight 1; the identity pose, or `n_poses` random
    rotations.  -> (points, rotation, translation, background, out_weight,
    point_weight) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    points = rng.standard_normal((n_points, 3)) * 0.4
    translation = rng.standard_normal((n_poses, 3)) * 0.1
    point_weight = rng.uniform(0.5, 2.0, n_points)
    if n_poses == 1:
        rotation = np.eye(3)[None]
    else:
        q, r = np.linalg.qr(rng.standard_normal((n_poses, 3, 3)))
        rotation = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
        rotation[np.linalg.det(rotation) < 0, :, 0] *= -1
    return tuple(np.asarray(a, np.float32) for a in (
        points, rotation, translation, np.zeros(n_poses), np.ones(n_poses),
        point_weight))


def phase_3d(dprast_torch, sb, dev):
    """[3d]: at 128^3, for one pose x 10^6 points and 4 poses x 10^5 (the
    coordinates of both are held in [B6 coords]): the 3-D branches of B1
    (at every cluster size, and on a frame with empty tiles and dead
    slots) and B4 against
    their twins, `raster` and the training step through `auto` against
    the `xla` backend on the card, each path run between a reset and a
    read of the launch counts.  The main path's instances on the frame are
    held to these lane instances in [B7 frame].  Returns the launch counts
    of the 10^6-point training steps."""
    grid = VOLUME
    ts = sb.tile_shape_for(grid)
    train_launches = {name: 0 for name in sb.LAUNCHES}
    for label, (n_poses, n_points) in VOLUME_CASES.items():
        host = volume_inputs(n_poses, n_points)
        args = [torch.from_numpy(a).to(dev) for a in host]
        pts, rot, tr, bg, ow, pw = args
        tag = f"[3d] {grid} {label}"

        nt = sb.n_tiles(grid)

        # B1 against its twin; B4 against its twin on the forward's frame
        # (an empty tile keeps a slot) and the standalone pullback's
        g = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (n_poses,) + grid).astype(np.float32)).to(dev)
        win = sb._unfold(g, grid, ts)
        b4_frames = []
        for weighted in (False, True):
            splat_args, data = sb._fwd_frame(grid, pts, rot, tr, pw,
                                             not weighted)
            ext_k = sb.fwd_splat(*splat_args)
            ext_p = sb._fwd_splat_plain(*splat_args)
            torch.cuda.synchronize()
            err = scaled_err(ext_k, ext_p)
            print(f"{tag} B1 fwd_splat_3d "
                  f"{'weighted' if weighted else 'uniform'}: ext "
                  f"{tuple(ext_k.shape)}, frame {tuple(data.shape)}, scaled "
                  f"max-abs err vs twin {err:.3e} (tol 1e-5)")
            check(err <= 1e-5, f"{tag}: B1-3D vs twin")
            if not weighted:
                b1_clusters(sb, f"{grid} {label} uniform", splat_args)
                # the load of the busiest (pose, tile), and of B1's busiest
                # block once the tile's cluster has shared its slots out
                slots = slots_per_tile(splat_args[0], nt)
                c = sb._b1_cluster(dev, n_poses, nt, splat_args[3])
                print(f"{tag} tile load: live slots per (pose, tile) max "
                      f"{int(slots.max())}, mean "
                      f"{float(slots.float().mean()):.2f}, one slot (empty "
                      f"or nearly) in {int((slots == 1).sum())} of "
                      f"{slots.numel()}; chunk {splat_args[-1]}; B1's "
                      f"cluster of {c}: busiest block "
                      f"{-(-int(slots.max()) // c)} slots")
                b4_frames.append(("forward frame", data[:, :3],
                                  splat_args[0], splat_args[-1]))
        if n_poses > 1:
            b1_clusters(sb, f"{grid} {label}, empty tiles and dead slots",
                        sparse_frame(sb, grid, pts * 0.3, rot, tr))
        data_s, st_s, chunk_s = sb._bwd_frame(grid, pts, rot, tr)
        b4_frames.append(("standalone frame", data_s[:, :3], st_s, chunk_s))
        for frame, coord, st, chunk in b4_frames:
            lane_b = sb._planes_bwd(coord, ts).contiguous()
            buf_k = sb.bwd_gather(st, lane_b, win, chunk)
            buf_p = sb._bwd_gather_plain(st, lane_b, win, chunk)
            torch.cuda.synchronize()
            err = scaled_err(buf_k, buf_p)
            print(f"{tag} B4 bwd_gather_3d {frame}: rows "
                  f"{tuple(buf_k.shape)}, scaled max-abs err vs twin "
                  f"{err:.3e} (tol 1e-6), bit-equal "
                  f"{torch.equal(buf_k, buf_p)}")
            check(err <= 1e-6, f"{tag}: B4-3D vs twin ({frame})")

        for weighted in (False, True):
            weight = "weighted" if weighted else "uniform"
            w = pw if weighted else None
            reset_launches(sb)
            img = dprast_torch.raster(grid, pts, rot, tr, bg, ow, w)
            torch.cuda.synchronize()
            launched = dict(sb.LAUNCHES)
            check(launched["fwd_splat_3d_enc"] >= 1
                  and launched["coords"] == launched["slot_prep"]
                  == launched["bin_scatter"] == launched["frame_gather"]
                  == 1,
                  f"{tag}: B6, B9, the frame gather and B1-3D ran in the "
                  f"forward")
            check(img.shape == (n_poses,) + grid and
                  bool(torch.isfinite(img).all()), f"{tag}: finite image")
            ref = dprast_torch.raster(grid, pts, rot, tr, bg, ow, w,
                                      backend="xla")
            err = scaled_err(img, ref)
            print(f"{tag} forward auto {weight}: launches {ran(launched)}; "
                  f"image sum {float(img.double().sum()):.6e}, scaled max-abs "
                  f"err vs the xla backend {err:.3e} (tol 2e-5)")
            check(err <= 2e-5, f"{tag}: auto vs xla forward ({weight})")

            # the training step: every input a leaf; the uniform case
            # passes a scalar weight
            leaves = [t.clone().requires_grad_() for t in (
                pts, rot, tr, bg, ow,
                pw if weighted else torch.tensor(1.5, device=dev))]
            reset_launches(sb)
            grads = train_grads(dprast_torch, grid, leaves, g)
            torch.cuda.synchronize()
            launched = dict(sb.LAUNCHES)
            for name in ("fwd_splat_3d_enc", "bwd_gather_3d_enc",
                         *EPILOGUE_TILES):
                check(launched[name] >= 1,
                      f"{tag}: {name} ran in the training step")
            # the fused pair reuses the forward's frame
            check(launched["coords"] == launched["slot_prep"]
                  == launched["bin_scatter"] == launched["frame_gather"]
                  == 1,
                  f"{tag}: B6, B9, B10 and the frame gather ran once in the "
                  f"training step")
            if n_poses == 1:
                for name in launched:
                    train_launches[name] += launched[name]
            ref = train_grads(dprast_torch, grid, leaves, g, backend="xla")
            errs = {}
            for name, a, r, x in zip(GRAD_NAMES, grads, ref, leaves):
                check(a.shape == x.shape and bool(torch.isfinite(a).all()),
                      f"{tag}: finite d_{name} of shape {tuple(x.shape)}")
                errs[name] = scaled_err(a, r)
            print(f"{tag} train auto {weight}: launches {ran(launched)}; "
                  f"scaled max-abs err vs the xla backend (tol 2e-5): "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
            check(max(errs.values()) <= 2e-5,
                  f"{tag}: training grads vs xla ({weight})")
    return train_launches


def times_3d(dprast_torch, sb, core, dev, smi):
    """[3d times]: the 3-D path's stages and steps at 128^3, one pose,
    10^6 and 10^5 points, uniform weights.  -> {(key, n_points): ms}."""
    grid = VOLUME
    ts = sb.tile_shape_for(grid)
    ms = {}
    for n_points in VOLUME_TIMED:
        host = volume_inputs(1, n_points)
        pts, rot, tr = (torch.from_numpy(a).to(dev) for a in host[:3])
        canon = (pts, rot, tr, torch.zeros(1, device=dev),
                 torch.ones(1, device=dev), torch.ones(n_points, device=dev))
        g = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (1,) + grid).astype(np.float32)).to(dev)
        data, st, nt, chunk = sb._fwd_prep(grid, pts, rot, tr, canon[5],
                                           True)
        ext = sb.fwd_splat_enc(st, data, nt, sb._window(grid), chunk)
        win = sb._unfold(g, grid, ts)
        buf = sb.bwd_gather_enc(st, data[:, :3], ts, win, chunk)
        ow, bg = canon[4].reshape(-1, 1, 1, 1), canon[3].reshape(-1, 1, 1, 1)

        def step():
            _, res = sb.raster_fwd_res(grid, *canon, pw_uniform=True)
            return sb.raster_pullback_res(grid, res, canon, g,
                                          pw_uniform=True)

        def step_twins():
            _, res = sb._fwd_impl(grid, *canon, pw_uniform=True,
                                  with_residuals=True,
                                  coords=sb._keys_and_local_plain,
                                  splat=sb._fwd_splat_enc_plain)
            coord, idx_rows, st_r = sb._residual_planes(res, True)
            return sb._pullback_from_frame(
                grid, coord, idx_rows, st_r, pts, rot, canon[4], canon[5], g,
                chunk=chunk, pw_uniform=True,
                gather=sb._bwd_gather_enc_plain, epilogue=sb._epilogue_plain)

        pts_req = pts.clone().requires_grad_()

        def step_autograd():
            out = dprast_torch.raster(grid, pts_req, rot, tr)
            return torch.autograd.grad((out * g).sum(), pts_req)

        stages = {
            "frame": lambda: sb._fwd_prep(grid, pts, rot, tr, canon[5],
                                          True),
            "fold": lambda: sb._fold(ext, grid, ts, True) * ow + bg,
            "fwd": lambda: dprast_torch.raster(grid, pts, rot, tr),
            "fwd_xla": lambda: dprast_torch.raster(grid, pts, rot, tr,
                                                   backend="xla"),
            "unfold": lambda: sb._unfold(g, grid, ts),
            "epilogue": lambda: sb.pullback_epilogue(
                grid, buf, data[:, -1], pts, rot, canon[4], canon[5],
                pw_uniform=True),
            "step": step,
            "step_autograd": step_autograd,
            "step_plain": step_twins,
            "step_xla": lambda: core.raster_pullback_res(
                grid, core.raster_fwd_res(grid, *canon)[1], canon, g),
        }
        for key, fn in stages.items():
            ms[key, n_points] = time_ms(fn)
        (ms["keys", n_points], ms["keys_plain", n_points],
         ms["keys_dev_us", n_points], _, _) = coords_in_turns(
            sb, smi, f"{grid} x 1 pose x {n_points} points", grid,
            (pts, rot, tr), phase="[3d times]")
        ms["keys_bound", n_points] = coords_bound(pts, rot, tr)
        ms["step_busy_us", n_points], ms["step_kernels", n_points] = \
            device_busy(step)
        t = {k: ms[k, n_points] for k in stages}
        print(f"[3d times] {smi} | {grid} x 1 pose x {n_points} points, "
              f"uniform weights, median ms (B1-3D and B4-3D in [B7 frame]): "
              f"frame {t['frame']:.4f}, plain fold + epilogue "
              f"{t['fold']:.4f}, forward {t['fwd']:.4f} (xla backend "
              f"{t['fwd_xla']:.4f})")
        print(f"[3d times] {smi} | {grid} x {n_points} backward, median ms: "
              f"plain unfold {t['unfold']:.4f}, epilogue (B8) "
              f"{t['epilogue']:.4f}")
        print(f"[3d times] {smi} | {grid} x {n_points} training step, median "
              f"ms: fused forward + pullback {t['step']:.4f}, through "
              f"autograd {t['step_autograd']:.4f}, with twins "
              f"{t['step_plain']:.4f}, xla backend {t['step_xla']:.4f}; the "
              f"fused step keeps the card busy "
              f"{ms['step_busy_us', n_points]:.1f} us in "
              f"{ms['step_kernels', n_points]:.0f} kernels and copies "
              f"(torch.profiler): idle "
              f"{1 - ms['step_busy_us', n_points] / t['step'] / 1e3:.1%} of "
              f"the step")
    return ms


# the fast mode's envelope against the exact backends (scaled max-abs),
# tests/test_grads.py::test_binned_bf16_fast_mode_close
BF16_TOL = 2e-2
# the fast mode's B1 and B4 instances on the main path, by n_out (they read
# the frame); on a multi-tile 2-D grid its B4 reads the cotangent itself
BF16_B4 = {2: "bwd_gather_bf16_enc", 3: "bwd_gather_3d_bf16_enc"}
BF16_B1 = {2: "fwd_splat_bf16_enc", 3: "fwd_splat_3d_bf16_enc"}
BF16_B4_GRID = "bwd_gather_grid_bf16_enc"


def phase_bf16(dprast_torch, sb, dev, smi, pts, rot, tr, pw, cots):
    """[bf16]: the `binned_bf16` fast mode (its B1 and B4 instances are
    held to the lane instances and their plain versions in [B7 frame]).
    The forward and `torch.autograd.grad` of all six inputs through
    `raster(..., backend="binned_bf16")` at 128^2, 1024^2 and 128^3 against
    the `xla` backend, each run between a reset and a read of the launch
    counts; forward and fused-step times beside `binned`.  -> (launch
    counts of the main-path runs, ms)."""
    from dprast_torch.ops import dispatch
    launches = {name: 0 for name in sb.LAUNCHES}
    ms = {}
    host = volume_inputs(1, VOLUME_CASES["1 pose x 1e6"][1])
    vol = [torch.from_numpy(a).to(dev) for a in host]
    g_vol = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1,) + VOLUME).astype(np.float32)).to(dev)

    flag_canon = (pts, rot, tr, torch.zeros(N_POSES, device=dev),
                  torch.ones(N_POSES, device=dev),
                  torch.ones(N_POINTS, device=dev))
    cases = [(grid, (pts, rot, tr, pw), cots[grid], flag_canon)
             for grid in GRIDS]
    cases.append((VOLUME, (vol[0], vol[1], vol[2], vol[5]), g_vol,
                  (vol[0], vol[1], vol[2], torch.zeros(1, device=dev),
                   torch.ones(1, device=dev),
                   torch.ones(host[0].shape[0], device=dev))))
    worst = 0.0
    for grid, (p_, r_, t_, w_), g, canon in cases:
        n_out = len(grid)
        for weighted in (False, True):
            label = "weighted" if weighted else "uniform"
            reset_launches(sb)
            img = dprast_torch.raster(grid, p_, r_, t_, None, None,
                                      w_ if weighted else None,
                                      backend="binned_bf16")
            torch.cuda.synchronize()
            fwd_launched = dict(sb.LAUNCHES)
            ref = dprast_torch.raster(grid, p_, r_, t_, None, None,
                                      w_ if weighted else None,
                                      backend="xla")
            check(img.shape == ref.shape and bool(torch.isfinite(img).all()),
                  f"[bf16] finite image at {grid}")
            err_img = scaled_err(img, ref)
            b = r_.shape[0]
            rng = np.random.default_rng(6)
            leaves = [x.clone().requires_grad_() for x in (
                p_, r_, t_,
                torch.from_numpy((rng.standard_normal(b) * 0.1).astype(
                    np.float32)).to(dev),
                torch.from_numpy(rng.uniform(0.5, 2.0, b).astype(
                    np.float32)).to(dev),
                w_ if weighted else torch.tensor(1.5, device=dev))]
            reset_launches(sb)
            grads = train_grads(dprast_torch, grid, leaves, g,
                                backend="binned_bf16")
            torch.cuda.synchronize()
            launched = dict(sb.LAUNCHES)
            for name in launched:
                launches[name] += launched[name] + fwd_launched[name]
            b4 = BF16_B4_GRID if grid == MULTI_TILE else BF16_B4[n_out]
            b8 = EPILOGUE_TILE if grid == FLAGSHIP else EPILOGUE_TILES
            for name in (BF16_B1[n_out], b4, *b8):
                check(launched[name] >= 1,
                      f"[bf16] {name} ran in the training step at {grid}")
            check(fwd_launched[BF16_B1[n_out]] >= 1,
                  f"[bf16] {BF16_B1[n_out]} ran in the forward at {grid}")
            exact = ("fwd_splat_enc", "bwd_gather_enc", "fwd_splat_3d_enc",
                     "bwd_gather_3d_enc", "bwd_gather_grid_enc",
                     "band_unfold")
            check(all(launched[k] == fwd_launched[k] == 0 for k in exact),
                  f"[bf16] no exact instance ran at {grid}")
            ref_g = train_grads(dprast_torch, grid, leaves, g, backend="xla")
            gerrs = {}
            for name, a, r, x in zip(GRAD_NAMES, grads, ref_g, leaves):
                check(a.shape == x.shape and bool(torch.isfinite(a).all()),
                      f"[bf16] finite d_{name} at {grid}")
                gerrs[name] = scaled_err(a, r)
            worst = max(worst, err_img, *gerrs.values())
            print(f"[bf16] binned_bf16 {grid} {label}: forward launches "
                  f"{ran(fwd_launched)}, step launches {ran(launched)}; "
                  f"scaled max-abs err vs the xla backend "
                  f"(tol {BF16_TOL:g}): image {err_img:.3e}, "
                  + ", ".join(f"{k} {v:.3e}" for k, v in gerrs.items()))
            check(max(err_img, *gerrs.values()) <= BF16_TOL,
                  f"[bf16] binned_bf16 vs xla at {grid} ({label})")

        # forward and fused step, uniform weights, fast mode beside exact
        for name in ("binned", "binned_bf16"):
            fwd_res, bwd_res = dispatch.vjp_pair(name)

            def step():
                _, res = fwd_res(grid, *canon, pw_uniform=True)
                return bwd_res(grid, res, canon, g, pw_uniform=True)

            ms[grid, name, "fwd"] = time_ms(lambda: dprast_torch.raster(
                grid, canon[0], canon[1], canon[2], backend=name))
            ms[grid, name, "step"] = time_ms(step)
        print(f"[bf16] {smi} | {grid} x {canon[1].shape[0]} poses x "
              f"{canon[0].shape[0]} points, uniform weights, median ms: "
              f"forward binned {ms[grid, 'binned', 'fwd']:.4f} / binned_bf16 "
              f"{ms[grid, 'binned_bf16', 'fwd']:.4f}; fused step binned "
              f"{ms[grid, 'binned', 'step']:.4f} / binned_bf16 "
              f"{ms[grid, 'binned_bf16', 'step']:.4f}")
    print(f"[bf16] worst scaled err vs xla over forward and six gradients: "
          f"{worst:.3e} (tol {BF16_TOL:g})")
    return launches, ms


# (grid, points, poses) of the stage profiler's runs and of the two
# gather experiments
PROFILE_CASES = ((MULTI_TILE, N_POINTS, N_POSES), (VOLUME, 1_000_000, 1))
EXP_XSEL = (FLAGSHIP, N_POINTS, N_POSES)
EXP_BAND = (MULTI_TILE, N_POINTS, N_POSES)


def phase_profile(sb, dev, smi):
    """[profile]: the stage profiler at 1024^2 x 64 x 10^5 and 128^3 x 1 x
    10^6, each run between a reset and a read of the launch counts; its
    standalone B1 / B4 outputs held to their twins on the same frame.  ->
    {grid: {launched, and for b1 / b4: _err, _ms, _plain (twin ms), _bound,
    _dev_us (the kernel's own device time)}}."""
    from dprast_torch.benchmarks import profile_binned
    out = {}
    for grid, points, batch in PROFILE_CASES:
        reset_launches(sb)
        res = profile_binned.run(grid, points, batch, device=dev)
        torch.cuda.synchronize()
        launched = dict(sb.LAUNCHES)
        tag = f"[profile] {smi} |"
        for line in profile_binned.report(res):
            print(f"{tag} {line}")
        ext_p = sb._fwd_splat_plain(*res["fwd_splat_args"])
        buf_p = sb._bwd_gather_plain(*res["bwd_gather_args"])
        torch.cuda.synchronize()
        b1_err = scaled_err(res["ext"], ext_p)
        same = torch.equal(res["buf"], buf_p)
        print(f"[profile] {grid}: launches {ran(launched)}; standalone "
              f"B1 scaled max-abs err vs twin {b1_err:.3e} (tol 1e-5), "
              f"standalone B4 bit-equal to twin {same}")
        check(b1_err <= 1e-5, f"[profile] B1 vs twin at {grid}")
        check(same, f"[profile] B4 bit-equal to its twin at {grid}")
        b1 = "fwd_splat_3d" if len(grid) == 3 else "fwd_splat"
        b4 = "bwd_gather_3d" if len(grid) == 3 else "bwd_gather"
        check(launched[b1] >= 1 and launched[b4] >= 1,
              f"[profile] B1 and B4 launched alone at {grid}")
        out[grid] = {
            "launched": launched, "b1_err": b1_err,
            "b4_err": scaled_err(res["buf"], buf_p),
            "b1_ms": res["ms"]["fwd kernel"],
            "b1_plain": time_ms(lambda: sb._fwd_splat_plain(
                *res["fwd_splat_args"])),
            "b4_ms": res["ms"]["bwd kernel"],
            "b4_plain": time_ms(lambda: sb._bwd_gather_plain(
                *res["bwd_gather_args"])),
            "b1_bound": b1_bound(*res["fwd_splat_args"]),
            "b4_bound": b4_bound(*res["bwd_gather_args"]),
            "b1_dev_us": launch_us(
                lambda: sb.fwd_splat(*res["fwd_splat_args"]),
                "fwd_splat_kernel"),
            "b4_dev_us": launch_us(
                lambda: sb.bwd_gather(*res["bwd_gather_args"]),
                "bwd_gather_kernel")}
        print(f"[profile] {smi} | {grid}: standalone kernel device time "
              f"(torch.profiler): B1 {us_text(out[grid]['b1_dev_us'])}, B4 "
              f"{us_text(out[grid]['b4_dev_us'])}")
    return out


def phase_exp(sb, dev, smi):
    """[exp]: `exp_xsel` at 128^2 and `exp_band` at 1024^2 (64 x 10^5),
    each run between a reset and a read of the launch counts; each of the
    three harness instances held to its twin (terms=2, natural window),
    the experiments' bit-exactness relations checked.  -> {entry: (launches,
    err, ms, twin ms, bound, device us)}."""
    from dprast_torch.benchmarks import exp_band, exp_xsel
    out = {}
    reset_launches(sb)
    xs = exp_xsel.run(dev, *EXP_XSEL)
    torch.cuda.synchronize()
    launched = dict(sb.LAUNCHES)
    for line in exp_xsel.report(xs):
        print(f"[exp] {smi} | exp_xsel {line}")
    twin = sb._bwd_gather_plain(*xs["gather_args"], terms=2)
    torch.cuda.synchronize()
    twin_ms = time_ms(lambda: sb._bwd_gather_plain(*xs["gather_args"],
                                                   terms=2))
    for name, rows, key in (("bwd_gather_split", xs["base"], "base"),
                            ("bwd_gather_split_t", xs["candidate"],
                             "candidate")):
        err = scaled_err(rows, twin)
        same = torch.equal(rows, twin)
        print(f"[exp] exp_xsel {key} ({name}): launches {launched[name]}, "
              f"scaled max-abs err vs twin {err:.3e} (tol 1e-6), bit-equal "
              f"{same}")
        check(launched[name] >= 1, f"[exp] {name} ran in exp_xsel")
        check(err <= 1e-6, f"[exp] exp_xsel {key} vs twin")
    # the candidate is the counterpart of `_kernel_absums`
    check(xs["max_abs_diff"] == 0.0, "[exp] exp_xsel candidate == base")
    st, lane_b, g, chunk = xs["gather_args"]
    us = in_turns(smi, "exp_xsel", {
        "base": lambda: sb.bwd_gather(st, lane_b, g, chunk, terms=2),
        "candidate": lambda: sb.bwd_gather(st, lane_b, xs["g_t"], chunk,
                                           terms=2, layout="transposed")})
    out["xsel", "bwd_gather_split_t"] = (
        launched["bwd_gather_split_t"],
        scaled_err(xs["candidate"], twin), xs["ms"]["candidate"], twin_ms,
        b4_bound(st, lane_b, xs["g_t"], chunk), us["candidate"])

    reset_launches(sb)
    eb = exp_band.run(dev, *EXP_BAND)
    torch.cuda.synchronize()
    launched = dict(sb.LAUNCHES)
    for line in exp_band.report(eb):
        print(f"[exp] {smi} | exp_band {line}")
    twin = sb._bwd_gather_plain(*eb["gather_args"], terms=2)
    torch.cuda.synchronize()
    twin_ms = time_ms(lambda: sb._bwd_gather_plain(*eb["gather_args"],
                                                   terms=2))
    st, lane_b, g_n, chunk = eb["gather_args"]
    us = in_turns(smi, "exp_band", {
        "NN": lambda: sb.bwd_gather(st, lane_b, eb["g_t"], chunk, terms=2,
                                    layout="transposed"),
        "TN": lambda: sb.bwd_gather(st, lane_b, g_n, chunk, terms=2),
        "presplit": lambda: sb.bwd_gather(st, lane_b, eb["g_split"], chunk,
                                          terms=2, layout="presplit")})
    for name, key, win in (("bwd_gather_split", "TN", g_n),
                           ("bwd_gather_split_t", "NN", eb["g_t"]),
                           ("bwd_gather_presplit", "presplit",
                            eb["g_split"])):
        rows = eb["rows"][key]
        err = scaled_err(rows, twin)
        same = torch.equal(rows, twin)
        print(f"[exp] exp_band {key} ({name}): launches {launched[name]}, "
              f"scaled max-abs err vs twin {err:.3e}, bit-equal {same}")
        check(launched[name] >= 1, f"[exp] {name} ran in exp_band")
        if key == "presplit":
            check(same, "[exp] presplit bit-equal to its twin")
        check(err <= 1e-6, f"[exp] exp_band {key} vs twin")
        out["band", name] = (launched[name], err, eb["ms"][key], twin_ms,
                             b4_bound(st, lane_b, win, chunk), us[key])
    check(eb["nn_tn_bit_exact"], "[exp] NN vs TN bit-exact")
    check(eb["presplit_bit_exact"], "[exp] presplit vs NN bit-exact")
    return out


def routes_in_turns(smi, ms, routes):
    """[times]: each of `routes` ({key: (before, now)}) timed in turns
    (before, now, now, before): median ms by CUDA events, and the device
    microseconds a call spends in B3 and B4.  The means go to
    ``ms[key + "_before" | "_now" (+ "_dev_us")]``."""
    kernels = ("band_unfold_kernel", "bwd_gather_kernel")
    for key, fns in routes.items():
        runs = {0: [], 1: []}
        dev_us = {0: [], 1: []}
        for i in (0, 1, 1, 0):
            runs[i].append(time_ms(fns[i]))
            dev_us[i].append(call_us(fns[i], kernels))
        for i, when in enumerate(("before", "now")):
            ms[f"{key}_{when}"] = sum(runs[i]) / 2
            ms[f"{key}_{when}_dev_us"] = (None if None in dev_us[i]
                                          else sum(dev_us[i]) / 2)
        print(f"[times] {smi} | {MULTI_TILE} {key}, B3 + the natural B4 "
              f"against B4's grid source in turns, median ms: "
              f"{ms[key + '_before']:.4f} -> {ms[key + '_now']:.4f}; device "
              f"time in B3 and B4: {us_text(ms[key + '_before_dev_us'])} -> "
              f"{us_text(ms[key + '_now_dev_us'])}")


def in_turns(smi, tag, variants):
    """The B4 kernel's device time per launch for each variant, profiled in
    turns (a, b, .., b, a), printed beside the card -> {variant: mean us},
    or None where the trace held no kernel rows."""
    us = {name: [] for name in variants}
    for name in list(variants) + list(variants)[::-1]:
        us[name].append(launch_us(variants[name], "bwd_gather_kernel"))
    if not all(all(v) for v in us.values()):
        print(f"[exp] {tag} kernel device time: not measured (no kernel "
              f"rows in the trace)")
        return dict.fromkeys(variants)
    means = {name: sum(v) / len(v) for name, v in us.items()}
    print(f"[exp] {smi} | {tag} kernel device us per launch "
          f"(torch.profiler, in turns): "
          + ", ".join(f"{k} {v:.2f}" for k, v in means.items()))
    return means

# the grids of the `matmul` path: (grid, poses, points, what `auto` picks
# there on the card); the first is driven with the flagship cloud, the
# volume with `volume_inputs`, the line with `line_inputs`
MATMUL_FLAG = ((64, 64), N_POSES, N_POINTS, "binned")
MATMUL_VOLUME = ((32, 32, 32), 4, 100_000, "binned")
MATMUL_LINE = ((4096,), 4, 10_000, "xla")
# the regimes in which `matmul` is timed beside `xla` and `binned`, one
# row each: (grid, poses, points).  `auto`'s rule on CUDA tensors
# (`dprast_torch.ops.dispatch.resolve`) is derived from these rows
MATMUL_TIMED = (((64, 64), N_POSES, N_POINTS), ((64, 64), 4, N_POINTS),
                ((64, 64), 1, N_POINTS), ((32, 32), N_POSES, N_POINTS),
                ((64, 64), N_POSES, 1000), MATMUL_VOLUME[:3],
                MATMUL_LINE[:3])
# the small configurations of `matmul` against the f64 oracles (grid,
# seed, points, poses; 3-D inputs)
MATMUL_SMALL = (((64, 64), 3, 1500, 4), ((16, 16, 16), 5, 1500, 4),
                ((200,), 3, 1500, 4), ((300, 200), 3, 1500, 4))


def line_inputs(n_poses, n_points, seed=13):
    """A 1-D cloud: points (P, 1) at 0.4 sigma, one scale per pose as its
    (1, 1) rotation, translations at 0.1 sigma, per-point weights in
    (0.5, 2) -> float32 numpy arrays in `volume_inputs`' order."""
    rng = np.random.default_rng(seed)
    scale = np.where(np.arange(n_poses) % 2 == 0, 1.0, -1.0) * rng.uniform(
        0.6, 1.0, n_poses)
    return tuple(np.asarray(a, np.float32) for a in (
        rng.standard_normal((n_points, 1)) * 0.4, scale[:, None, None],
        rng.standard_normal((n_poses, 1)) * 0.1, np.zeros(n_poses),
        np.ones(n_poses), rng.uniform(0.5, 2.0, n_points)))


class Bf16Products:
    """While open, counts the `torch.bmm` calls on bf16 operands and keeps,
    for each, whether the reduced-precision reduction was off and the
    result fp32."""

    def __enter__(self):
        self.calls = []
        self._bmm = torch.bmm
        mm = torch.backends.cuda.matmul

        def bmm(a, b, **kw):
            if a.dtype == torch.bfloat16:
                self.calls.append(
                    mm.allow_bf16_reduced_precision_reduction is False
                    and kw.get("out_dtype") is torch.float32)
            return self._bmm(a, b, **kw)

        torch.bmm = bmm
        return self

    def __exit__(self, *exc):
        torch.bmm = self._bmm


def timed_inputs(grid, n_poses, n_points, dev):
    """The canonical six arguments of a timed row on the card, uniform
    weights: the flagship cloud in 2-D, `volume_inputs` in 3-D,
    `line_inputs` in 1-D."""
    if len(grid) == 2:
        p_, r_, t_, _ = flagship_inputs(n_points=n_points, n_poses=n_poses)
    else:
        make = volume_inputs if len(grid) == 3 else line_inputs
        p_, r_, t_ = make(n_poses, n_points)[:3]
    return tuple(torch.from_numpy(a).to(dev) for a in (p_, r_, t_)) + (
        torch.zeros(n_poses, device=dev), torch.ones(n_poses, device=dev),
        torch.ones(n_points, device=dev))


def vs_xla(dprast_torch, tag, grid, inputs, backend):
    """The image and `torch.autograd.grad` of all six inputs on `backend`
    against the `xla` backend on the card -> (image err, {name: err}),
    scaled max-abs; the shapes and finiteness are checked here."""
    p_, r_, t_, _, _, w_ = inputs
    n_poses = r_.shape[0]
    dev = p_.device
    img = dprast_torch.raster(grid, p_, r_, t_, backend=backend)
    ref = dprast_torch.raster(grid, p_, r_, t_, backend="xla")
    check(img.shape == (n_poses,) + grid and img.dtype == torch.float32
          and bool(torch.isfinite(img).all()), f"{tag}: finite image")
    rng = np.random.default_rng(6)
    leaves = [x.clone().requires_grad_() for x in (
        p_, r_, t_,
        torch.from_numpy((rng.standard_normal(n_poses) * 0.1).astype(
            np.float32)).to(dev),
        torch.from_numpy(rng.uniform(0.5, 2.0, n_poses).astype(
            np.float32)).to(dev), w_)]
    g = torch.from_numpy(rng.standard_normal((n_poses,) + grid).astype(
        np.float32)).to(dev)
    grads = train_grads(dprast_torch, grid, leaves, g, backend=backend)
    torch.cuda.synchronize()
    ref_g = train_grads(dprast_torch, grid, leaves, g, backend="xla")
    errs = {}
    for name, a, r, x in zip(GRAD_NAMES, grads, ref_g, leaves):
        check(a.shape == x.shape and bool(torch.isfinite(a).all()),
              f"{tag}: finite d_{name} of shape {tuple(x.shape)}")
        errs[name] = scaled_err(a, r)
    return scaled_err(img, ref), errs


def phase_matmul(dprast_torch, sb, dev, smi, oracle, pts, rot, tr, pw):
    """[matmul]: the small grids.  At 64^2 x 64 x 10^5 (the flagship
    cloud), 32^3 x 4 x 10^5 and (4096,) x 4 x 10^4 the forward and
    `torch.autograd.grad` of all six inputs on ``backend="matmul"`` are
    held to the `xla` backend on the card within 2e-5, with TF32 and the
    bf16 reduced-precision reduction off in every product, and so is
    whatever `auto` picks there; small cases against the f64 oracles
    (`matmul_bf16` within 2e-2); an empty cloud at 64^2.  Then forward and
    fused-step ms of `matmul`, `xla` and `binned` in turns, one row per
    regime (`MATMUL_TIMED`): the rows `auto`'s rule is derived from.
    -> ms."""
    from dprast_torch.ops import dispatch
    mm = torch.backends.cuda.matmul
    check(mm.allow_tf32 is False, "[matmul] TF32 matmul is off")
    flag_before = mm.allow_bf16_reduced_precision_reduction
    cases = [(MATMUL_FLAG, (pts, rot, tr, None, None, pw))]
    for spec, make in ((MATMUL_VOLUME, volume_inputs),
                       (MATMUL_LINE, line_inputs)):
        cases.append((spec, tuple(torch.from_numpy(a).to(dev)
                                  for a in make(spec[1], spec[2]))))
    for (grid, n_poses, n_points, auto_picks), inputs in cases:
        tag = f"[matmul] {grid} x {n_poses} poses x {n_points} points"
        reset_launches(sb)
        with Bf16Products() as products:
            err_img, errs = vs_xla(dprast_torch, tag, grid, inputs, "matmul")
        print(f"{tag}: matmul by name; {len(products.calls)} bf16 products "
              f"with an fp32 result and full-precision sums in a forward "
              f"and a training step; scaled max-abs err vs the xla backend "
              f"(tol 2e-5): image {err_img:.3e}, "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        # a forward and the step's forward, 2 planes x 2 branches each,
        # and the pullback's products
        check(len(products.calls) >= 2 * 2 * 2 + 2,
              f"{tag}: the path ran the matmul products")
        check(all(products.calls),
              f"{tag}: every bf16 product ran with an fp32 result and the "
              f"reduced-precision reduction off")
        check(not binned_ran(sb.LAUNCHES), f"{tag}: no binned kernel ran")
        check(xla_ran(sb.LAUNCHES),
              f"{tag}: the xla reference ran X1-X3")
        check(max(err_img, *errs.values()) <= 2e-5, f"{tag}: matmul vs xla")

        picked = dispatch.resolve_pair("auto", len(grid), grid, n_points,
                                       accelerator=True)
        check(picked == (auto_picks, auto_picks),
              f"{tag}: auto picks {auto_picks}")
        with Bf16Products() as products:
            err_img, errs = vs_xla(dprast_torch, tag, grid, inputs, "auto")
        launched = binned_ran(sb.LAUNCHES)
        print(f"{tag}: auto -> {picked[0]}; launches {ran(sb.LAUNCHES)}; scaled "
              f"max-abs err vs the xla backend (tol 2e-5): image "
              f"{err_img:.3e}, "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        check(not products.calls, f"{tag}: auto ran no bf16 product")
        check(bool(launched) == (auto_picks == "binned"),
              f"{tag}: auto ran the binned kernels only where it picks "
              f"binned")
        check(max(err_img, *errs.values()) <= 2e-5, f"{tag}: auto vs xla")
    check(mm.allow_bf16_reduced_precision_reduction is flag_before,
          "[matmul] the reduction flag is as it was found")

    phase_small(dprast_torch, oracle, dev, "[matmul small]", MATMUL_SMALL,
                backend="matmul")
    phase_small(dprast_torch, oracle, dev, "[matmul small]", MATMUL_SMALL,
                backend="matmul_bf16", tol=BF16_TOL)

    # an empty cloud at 64^2 through auto: the background image, and zero
    # gradients but d_background
    grid = MATMUL_FLAG[0]
    bg = torch.linspace(-1.0, 1.0, N_POSES, device=dev)
    empty = pts[:0]
    img = dprast_torch.raster(grid, empty, rot, tr, bg)
    check(torch.equal(img, bg[:, None, None].expand(img.shape)),
          "[matmul] an empty cloud gives the background")
    g = torch.ones((N_POSES,) + grid, device=dev)
    res = dprast_torch.raster_pullback(g, empty, rot, tr, bg)
    check(res.points.shape == (0, 3) and not bool(res.rotation.any())
          and not bool(res.translation.any())
          and bool((res.background == grid[0] * grid[1]).all()),
          "[matmul] an empty cloud gives zero gradients but d_background")
    print(f"[matmul] empty cloud at {grid} through auto: the background "
          f"image, zero gradients")

    # forward and fused step (forward + pullback; `matmul` has no fused
    # pair, so its pullback recomputes from the six inputs, as under
    # autograd) beside `xla` and `binned`, in turns
    ms = {}
    for grid, n_poses, n_points in MATMUL_TIMED:
        canon = timed_inputs(grid, n_poses, n_points, dev)
        g = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (n_poses,) + grid).astype(np.float32)).to(dev)
        names = ("matmul", "xla") + (
            ("binned",) if sb.supported(len(grid), grid, n_points) else ())

        def step(name):
            pair = dispatch.vjp_pair(name)
            if pair is None:
                dispatch.fwd_fn(name)(grid, *canon, pw_uniform=True)
                return dispatch.bwd_fn(name)(grid, *canon, g,
                                             pw_uniform=True)
            _, res = pair[0](grid, *canon, pw_uniform=True)
            return pair[1](grid, res, canon, g, pw_uniform=True)

        runs = {(name, what): [] for name in names
                for what in ("fwd", "step")}
        for name in names + names[::-1]:
            reps = 2 if name == "matmul" else 7
            runs[name, "fwd"].append(time_ms(
                lambda: dprast_torch.raster(grid, *canon[:3],
                                            backend=name), reps, 1))
            runs[name, "step"].append(time_ms(lambda: step(name), reps, 1))
        for key, got in runs.items():
            ms[(grid, n_poses, n_points) + key] = sum(got) / len(got)
        row = (grid, n_poses, n_points)
        fastest = min(names, key=lambda n: ms[row + (n, "step")])
        auto = dispatch.resolve_pair("auto", len(grid), grid, n_points,
                                     accelerator=True)[0]
        print(f"[matmul] {smi} | {grid} x {n_poses} poses x {n_points} "
              f"points, uniform weights, median ms in turns ("
              + ", ".join(names + names[::-1]) + "): forward "
              + " / ".join(f"{n} {ms[row + (n, 'fwd')]:.4f}" for n in names)
              + "; fused step "
              + " / ".join(f"{n} {ms[row + (n, 'step')]:.4f}" for n in names)
              + f"; fastest fused step {fastest}; auto picks {auto}")
    row = MATMUL_TIMED[0]
    busy_us, n_kernels = device_busy(
        lambda: dprast_torch.raster(row[0], pts, rot, tr, backend="matmul"),
        calls=3)
    ms["busy_us"], ms["kernels"] = busy_us, n_kernels
    print(f"[matmul] {smi} | {row[0]} matmul forward keeps the card busy "
          f"{busy_us:.1f} us in {n_kernels:.0f} kernels and copies "
          f"(torch.profiler): idle "
          f"{1 - busy_us / ms[row + ('matmul', 'fwd')] / 1e3:.1%} of the call")
    return ms


def load_example(name):
    """A module of `examples/`, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_vs_xla(dprast_torch, sb, tag, grid, inputs):
    """One training step of an example at its own shapes: the image and the
    gradients of `inputs` (points, rotation, translation, background,
    out_weight) through `auto`, which must launch B6, B1 and B4 once each and
    no other kernel, held to the `xla` backend within 2e-5."""
    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    reset_launches(sb)
    img = dprast_torch.raster(grid, *leaves)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        tuple(img.shape)).astype(np.float32)).to(img.device)
    grads = torch.autograd.grad((img * g).sum(), leaves)
    launched = dict(sb.LAUNCHES)
    ref = dprast_torch.raster(grid, *leaves, backend="xla")
    ref_g = torch.autograd.grad((ref * g).sum(), leaves)
    check(img.shape == ref.shape and bool(torch.isfinite(img).all()),
          f"{tag}: finite image")
    errs = {"image": scaled_err(img.detach(), ref.detach())}
    for name, a, r, x in zip(GRAD_NAMES, grads, ref_g, leaves):
        check(a.shape == x.shape and bool(torch.isfinite(a).all()),
              f"{tag}: finite d_{name} of shape {tuple(x.shape)}")
        errs[name] = scaled_err(a, r)
    print(f"{tag}: image {tuple(img.shape)}, launches {ran(launched)}; "
          f"scaled max-abs err vs the xla backend (tol 2e-5): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    check(ran(launched) == {"coords": 1, "fwd_splat_enc": 1,
                            "bwd_gather_enc": 1, "epilogue_tile": 1,
                            "epilogue_poses": 1},
          f"{tag}: the step ran B6, B1, B4 and B8's two single-tile kernels "
          f"once each and no other kernel")
    check(max(errs.values()) <= 2e-5, f"{tag}: auto vs xla")


def phase_examples(dprast_torch, sb, dev, steps=20):
    """[examples]: the two single-card examples for `steps` steps on the
    card through `auto` (one tile: B6, B1 and B4).  Their losses must fall, B1
    must run once per step and per rendered target or final loss and B4
    once per step, and one step at each example's own inputs is held to
    the `xla` backend."""
    import contextlib
    import io
    fit = load_example("fit_langevin_torch")
    reset_launches(sb)
    with contextlib.redirect_stdout(io.StringIO()):
        target = fit.make_target(torch.Generator().manual_seed(42), dev)
        points, _, log_w, hist = fit.langevin_fit(target, steps=steps,
                                                  log_every=steps)
    torch.cuda.synchronize()
    launched = dict(sb.LAUNCHES)
    print(f"[examples] fit_langevin_torch {fit.GRID} x {fit.N_POINTS} "
          f"points, {steps} Langevin steps: loss {hist[0][1]:.6e} -> "
          f"{hist[-1][1]:.6e}; launches {ran(launched)}")
    check(points.device.type == "cuda" and bool(torch.isfinite(points).all()),
          "[examples] the fit's points are finite and on the card")
    check(hist[-1][1] < hist[0][1], "[examples] the Langevin fit's loss fell")
    # the target's render and one forward per step; one backward per step
    check(ran(launched) == {"coords": steps + 1, "fwd_splat_enc": steps + 1,
                            "bwd_gather_enc": steps, "epilogue_tile": steps,
                            "epilogue_poses": steps},
          "[examples] the fit ran B6 and B1 once per step and for the "
          "target, B4 and B8 once per step, and no other kernel")
    example_vs_xla(dprast_torch, sb, f"[examples] fit_langevin_torch "
                   f"{fit.GRID}, the fitted points, one pose", fit.GRID,
                   (points, torch.eye(2, device=dev),
                    torch.zeros(2, device=dev), torch.zeros((), device=dev),
                    torch.exp(log_w)))

    tomo = load_example("tomography_torch")
    reset_launches(sb)
    with contextlib.redirect_stdout(io.StringIO()):
        first, final = tomo.reconstruct(steps=steps, device=dev)
    torch.cuda.synchronize()
    launched = dict(sb.LAUNCHES)
    print(f"[examples] tomography_torch {tomo.GRID} x {tomo.N_VIEWS} views "
          f"x {tomo.N_POINTS} points, {steps} gradient steps: loss "
          f"{first:.6e} -> {final:.6e}; launches {ran(launched)}")
    check(final < first, "[examples] the reconstruction's loss fell")
    # the target's render, one forward per step and the two final losses
    check(ran(launched) == {"coords": steps + 3, "fwd_splat_enc": steps + 3,
                            "bwd_gather_enc": steps, "epilogue_tile": steps,
                            "epilogue_poses": steps},
          "[examples] the reconstruction ran B6 and B1 once per step, for "
          "the target and for the two final losses, B4 and B8 once per "
          "step, and no other kernel")
    example_vs_xla(dprast_torch, sb, f"[examples] tomography_torch "
                   f"{tomo.GRID}, the truth, {tomo.N_VIEWS} views", tomo.GRID,
                   (tomo.make_truth(torch.Generator().manual_seed(1), dev),
                    tomo.view_matrices(dev),
                    torch.zeros((tomo.N_VIEWS, 2), device=dev),
                    torch.zeros(tomo.N_VIEWS, device=dev),
                    torch.ones(tomo.N_VIEWS, device=dev)))


# the 2 x 2 mesh of [sharded]: (grid, poses, points, pw_fast).  10^5 + 1
# points pad the points axis, which turns the uniform-weight fast path
# off; 7 poses pad the poses axis with an inert pose
SHARDED_CASES = ((FLAGSHIP, N_POSES, N_POINTS + 1, False),
                 (MULTI_TILE, N_POSES, N_POINTS + 1, False),
                 (FLAGSHIP, N_POSES, N_POINTS, True),
                 (FLAGSHIP, 7, N_POINTS, True))
SHARDED_MESH = (2, 2)
# the kernels of one training step per process, by grid
SHARDED_WANT = {FLAGSHIP: {"coords": 1, "fwd_splat_enc": 1,
                           "bwd_gather_enc": 1, "epilogue_tile": 1,
                           "epilogue_poses": 1},
                MULTI_TILE: {"coords": 1, "slot_prep": 1, "bin_scatter": 1,
                             "frame_gather": 1, "fwd_splat_enc": 1,
                             "band_fold": 1, "bwd_gather_grid_enc": 1,
                             "epilogue_rows": 1, "epilogue_points": 1}}
# seconds the four workers may take, CUDA start-up included, before the
# parent kills them and fails
SHARDED_TIMEOUT = 120


def sharded_leaves(n_poses, n_points, dev):
    """The six inputs of a [sharded] case as leaves that require grad: the
    flagship cloud, per-pose background and out_weight, and a scalar point
    weight (the uniform path)."""
    p_, r_, t_, _ = flagship_inputs(n_points=n_points, n_poses=n_poses)
    rng = np.random.default_rng(4)
    bg = (rng.standard_normal(n_poses) * 0.1).astype(np.float32)
    ow = rng.uniform(0.5, 2.0, n_poses).astype(np.float32)
    return [torch.from_numpy(a).to(dev).requires_grad_()
            for a in (p_, r_, t_, bg, ow, np.asarray(1.5, np.float32))]


def sharded_vs_xla(dprast_torch, tag, grid, leaves, g, out, grads):
    """The image and the six gradients of a sharded step against the
    single-device `xla` backend on the same leaves -> {name: scaled
    max-abs err}."""
    ref = dprast_torch.raster(grid, *leaves, backend="xla")
    ref_g = torch.autograd.grad((ref * g).sum(), leaves)
    check(out.shape == ref.shape and out.dtype == torch.float32
          and bool(torch.isfinite(out).all()), f"{tag}: finite image")
    errs = {"image": scaled_err(out.detach(), ref.detach())}
    for name, a, r, x in zip(GRAD_NAMES, grads, ref_g, leaves):
        check(a.shape == x.shape and bool(torch.isfinite(a).all()),
              f"{tag}: finite d_{name} of shape {tuple(x.shape)}")
        errs[name] = scaled_err(a, r)
    return errs


def sharded_worker(rank, store, out_dir):
    """One of the four processes of [sharded]'s 2 x 2 mesh, all on the one
    card, joined by Gloo (NCCL refuses two processes on one card).  Runs
    every case of `SHARDED_CASES` through `raster_sharded` and autograd,
    checks its own launch counts, the size of its shard, its image and
    gradients against the single-device `xla` backend (2e-5) and that
    its gradients are rank 0's bit for bit, and writes what it read to
    ``out_dir/rank<rank>.json``.  Any failed check is an exception: the
    process exits non-zero."""
    import torch.distributed as dist
    import dprast_torch
    from dprast_torch import ad
    from dprast_torch.ops import splat_binned as sb
    from dprast_torch.parallel import make_mesh, multihost, raster_sharded

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    multihost.initialize(init_method=f"file://{store}",
                         world_size=SHARDED_MESH[0] * SHARDED_MESH[1],
                         rank=rank, backend="gloo", timeout=SHARDED_TIMEOUT)
    report = {"rank": rank, "cases": []}
    shards = []
    real = ad.raster_canonical

    def spy(grid_size, backend, pw_uniform, *args):
        shards.append((backend[0], pw_uniform, args[0].shape[0],
                       args[1].shape[0], str(args[0].device)))
        return real(grid_size, backend, pw_uniform, *args)

    try:
        mesh = make_mesh(*SHARDED_MESH)
        check(dist.get_backend() == "gloo", "the group runs on Gloo")
        for grid, n_poses, n_points, pw_fast in SHARDED_CASES:
            tag = (f"[sharded] rank {rank} {grid} x {n_poses} poses x "
                   f"{n_points} points")
            leaves = sharded_leaves(n_poses, n_points, dev)
            g = torch.from_numpy(np.random.default_rng(2).standard_normal(
                (n_poses,) + grid).astype(np.float32)).to(dev)

            def step():
                out = raster_sharded(grid, *leaves, mesh=mesh)
                return out, torch.autograd.grad((out * g).sum(), leaves)

            del shards[:]
            ad.raster_canonical = spy
            reset_launches(sb)
            try:
                out, grads = step()
                torch.cuda.synchronize()
            finally:
                ad.raster_canonical = real
            launched = ran(sb.LAUNCHES)
            check(launched == SHARDED_WANT[grid],
                  f"{tag}: one launch of each kernel of the step and no "
                  f"other, got {launched}")
            # a quarter of the work, on the card, on the binned backend
            want = ("binned", pw_fast, -(-n_points // SHARDED_MESH[1]),
                    -(-n_poses // SHARDED_MESH[0]), str(dev))
            check(shards == [want], f"{tag}: the shard is {want}, got "
                                    f"{shards}")
            errs = sharded_vs_xla(dprast_torch, tag, grid, leaves, g, out,
                                  grads)
            check(max(errs.values()) <= 2e-5, f"{tag}: sharded vs xla, "
                                              f"{errs}")
            for name, a in zip(("image",) + GRAD_NAMES, (out,) + grads):
                first = a.detach().clone()
                dist.broadcast(first, src=0)
                check(torch.equal(first.view(torch.int32),
                                  a.detach().view(torch.int32)),
                      f"{tag}: {name} is rank 0's bit for bit")
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            report["cases"].append({
                "grid": list(grid), "poses": n_poses, "points": n_points,
                "launches": launched, "errs": errs,
                "step_ms": float(np.median(times))})
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        multihost.shutdown()


def run_sharded_workers():
    """Start the four workers of the 2 x 2 mesh on the one card, wait for
    them under one deadline, kill what is left at it -> the ranks'
    reports.  A worker that exits non-zero, or the deadline, fails the
    run."""
    import os
    import shutil
    import subprocess
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="sharded_", dir=ROOT / "build"))
    launcher = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE")
    env = {k: v for k, v in os.environ.items() if k not in launcher}
    n = SHARDED_MESH[0] * SHARDED_MESH[1]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--sharded-worker",
         str(rank), str(work / "store"), str(work)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(n)]
    deadline = time.monotonic() + SHARDED_TIMEOUT
    outs, timed_out = [], False
    try:
        for proc in procs:
            try:
                outs.append(proc.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                timed_out = True
                break
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    try:
        check(not timed_out, f"[sharded] the workers ended within "
                             f"{SHARDED_TIMEOUT} s")
        for rank, (proc, out) in enumerate(zip(procs, outs)):
            check(proc.returncode == 0,
                  f"[sharded] worker {rank} exited {proc.returncode}:\n"
                  f"{out[-3000:]}")
        return [json.loads((work / f"rank{rank}.json").read_text())
                for rank in range(n)]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_sharded(dprast_torch, sb, smi, pts, rot, tr, pw, cots):
    """[sharded]: the distribution layer.  On the 1 x 1 mesh in this
    process (no process group): `raster_sharded` through `auto` and
    `torch.autograd.grad` of all six inputs at 128^2 and 1024^2 x 64 x
    10^5, exactly the unsharded step's launches, held to `raster` on the
    `xla` backend within 2e-5, and its step timed beside the unsharded
    one in turns.  On a 2 x 2 mesh: four worker processes on this one
    card over Gloo (`sharded_worker`).  -> (launches on the 1 x 1 mesh,
    launches summed over the four workers)."""
    from dprast_torch.parallel import make_mesh, raster_sharded
    mesh = make_mesh()
    check(mesh.shape == {"poses": 1, "points": 1} and not mesh.groups,
          "[sharded] without a process group the mesh is 1 x 1")
    totals = {name: 0 for name in sb.LAUNCHES}
    for grid in GRIDS:
        tag = f"[sharded] 1 x 1 {grid} x {N_POSES} poses x {N_POINTS} points"
        leaves = train_inputs(pts, rot, tr, pw, False)
        g = cots[grid]

        def sharded_step():
            out = raster_sharded(grid, *leaves, mesh=mesh)
            return out, torch.autograd.grad((out * g).sum(), leaves)

        def plain_step():
            out = dprast_torch.raster(grid, *leaves)
            return out, torch.autograd.grad((out * g).sum(), leaves)

        reset_launches(sb)
        out, grads = sharded_step()
        torch.cuda.synchronize()
        launched = dict(sb.LAUNCHES)
        for name in launched:
            totals[name] += launched[name]
        check(ran(launched) == SHARDED_WANT[grid],
              f"{tag}: one launch of each kernel of the unsharded step and "
              f"no other, got {ran(launched)}")
        errs = sharded_vs_xla(dprast_torch, tag, grid, leaves, g, out, grads)
        runs = {"plain": [], "sharded": []}
        for name, fn in (("plain", plain_step), ("sharded", sharded_step),
                         ("sharded", sharded_step), ("plain", plain_step)):
            runs[name].append(time_ms(fn, reps=7, warmup=2))
        print(f"{tag}: launches {ran(launched)}; scaled max-abs err vs the "
              f"xla backend (tol 2e-5): "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f"; {smi} | training step through autograd, all six "
                f"gradients, median ms in turns (raster, raster_sharded, "
                f"raster_sharded, raster): raster "
              + " / ".join(f"{v:.4f}" for v in runs["plain"])
              + ", raster_sharded "
              + " / ".join(f"{v:.4f}" for v in runs["sharded"]))
        check(max(errs.values()) <= 2e-5, f"{tag}: sharded vs xla")

    t0 = time.perf_counter()
    reports = run_sharded_workers()
    took = time.perf_counter() - t0
    workers = {name: 0 for name in sb.LAUNCHES}
    for i, (grid, n_poses, n_points, pw_fast) in enumerate(SHARDED_CASES):
        cases = [r["cases"][i] for r in reports]
        for case in cases:
            for name, count in case["launches"].items():
                workers[name] += count
        worst = max(max(c["errs"].values()) for c in cases)
        print(f"[sharded] 2 x 2, four processes on one card over Gloo, "
              f"{tuple(grid)} x {n_poses} poses x {n_points} points "
              f"(uniform fast path {'on' if pw_fast else 'off'}): every "
              f"rank launched {cases[0]['launches']} on its quarter, is "
              f"within {worst:.3e} of the single-device xla backend (tol "
              f"2e-5) and holds rank 0's image and gradients bit for bit; "
              f"{smi} | step ms by rank "
              + " / ".join(f"{c['step_ms']:.2f}" for c in cases))
    print(f"[sharded] the four processes share one card, and Gloo sums in "
          f"host memory: the 2 x 2 times above say what the layer costs "
          f"there and are no scaling number; workers took {took:.1f} s "
          f"with their start-up")
    return totals, workers


# [no sync]: the shapes of the main path through `auto`, a single tile past
# the 65,535 poses of a launch grid's y and z, and the backends asked for
# by name at the flagship
NO_SYNC_SHAPES = ((FLAGSHIP, N_POSES, N_POINTS),
                  (MULTI_TILE, N_POSES, N_POINTS), (VOLUME, 1, 1_000_000),
                  ((64, 64), 70_000, 1000))
NO_SYNC_BACKENDS = ("xla", "matmul", "binned_bf16")


def held_without_sync(fn):
    """One warm-up call of `fn` (the build, the card's occupancy queries:
    once per process), then one under
    ``torch.cuda.set_sync_debug_mode("error")``, where anything in the call
    that makes the host wait for the card raises and fails the run."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def no_sync_paths(dprast_torch, dispatch, grid, canon, g, weighted,
                  backend):
    """The calls a user makes -> {path: fn}: the forward, the standalone
    `raster_pullback`, the training step through autograd (gradients of
    ``sum(out * g)`` with respect to points and translation) and, where
    the backend has one, the fused pair, with default weights or the
    per-point weight ``canon[5]``."""
    pts, rot, tr = canon[:3]
    pw = canon[5] if weighted else None
    pts_req, tr_req = (t.clone().requires_grad_() for t in (pts, tr))

    def grad_step():
        out = dprast_torch.raster(grid, pts_req, rot, tr_req,
                                  point_weight=pw, backend=backend)
        return torch.autograd.grad((out * g).sum(), (pts_req, tr_req))

    paths = {
        "forward": lambda: dprast_torch.raster(grid, pts, rot, tr,
                                               point_weight=pw,
                                               backend=backend),
        "raster_pullback": lambda: dprast_torch.raster_pullback(
            g, pts, rot, tr, point_weight=pw, backend=backend),
        "autograd step": grad_step,
    }
    pair = dispatch.vjp_pair(dispatch.resolve(
        backend, len(grid), grid, pts.shape[0], accelerator=True))
    if pair is not None:
        args = canon if weighted else canon[:5] + (torch.ones_like(
            canon[5]),)

        def fused():
            _, res = pair[0](grid, *args, pw_uniform=not weighted)
            return pair[1](grid, res, args, g, pw_uniform=not weighted)

        paths["fused pair"] = fused
    return paths


def phase_no_sync(dprast_torch, dev):
    """[no sync]: no call of the card's path waits for the card.  Every
    path of `no_sync_paths` through `auto` at 128^2 and 1024^2 x 64 x 10^5
    and at 128^3 x 1 x 10^6, with default weights and a per-point weight;
    the same on `xla`, `matmul` and `binned_bf16` by name at 128^2; and
    `raster_sharded` (forward and autograd step) on the 1 x 1 mesh with no
    process group at the three shapes.  Each is held by
    `held_without_sync`.  -> the number of calls held."""
    from dprast_torch.ops import dispatch
    from dprast_torch.parallel import make_mesh, raster_sharded
    mesh = make_mesh()
    cases = [(grid, n_poses, n_points, "auto")
             for grid, n_poses, n_points in NO_SYNC_SHAPES]
    cases += [(FLAGSHIP, N_POSES, N_POINTS, name)
              for name in NO_SYNC_BACKENDS]
    held = 0
    for grid, n_poses, n_points, backend in cases:
        canon = main_inputs(grid, n_poses, n_points, dev)
        g = torch.randn((n_poses,) + grid, device=dev)
        for weighted in (False, True):
            paths = no_sync_paths(dprast_torch, dispatch, grid, canon, g,
                                  weighted, backend)
            for fn in paths.values():
                held_without_sync(fn)
            held += len(paths)
            print(f"[no sync] {backend} {grid} x {n_poses} poses x "
                  f"{n_points} points, "
                  f"{'per-point' if weighted else 'default'} weights: "
                  f"{', '.join(paths)} held")
        if backend != "auto":
            continue
        leaves = [t.clone().requires_grad_() for t in canon[:3]]

        def sharded_step():
            out = raster_sharded(grid, *leaves, mesh=mesh)
            return torch.autograd.grad((out * g).sum(), leaves)

        for fn in (lambda: raster_sharded(grid, *canon[:3], mesh=mesh),
                   sharded_step):
            held_without_sync(fn)
        held += 2
        print(f"[no sync] raster_sharded on the 1 x 1 mesh {grid} x "
              f"{n_poses} poses x {n_points} points, default weights: "
              f"forward, autograd step held")
    # the rows `auto` sends to `xla` (X1, the sort, X2, X3)
    for name, grid, n_poses, n_points in REPEAT_XLA:
        canon, g = xla_inputs(grid, n_poses, n_points, dev)
        for weighted in (False, True):
            paths = no_sync_paths(dprast_torch, dispatch, grid, canon, g,
                                  weighted, "auto")
            for fn in paths.values():
                held_without_sync(fn)
            held += len(paths)
            print(f"[no sync] auto -> xla {name}, "
                  f"{'per-point' if weighted else 'default'} weights: "
                  f"{', '.join(paths)} held")
        del canon, g
        torch.cuda.empty_cache()
    # numpy scalar weights and background are filled on the card, as
    # Python scalars are, not copied from the host
    canon = main_inputs(FLAGSHIP, N_POSES, N_POINTS, dev)
    held_without_sync(lambda: dprast_torch.raster(
        FLAGSHIP, *canon[:3], np.float32(0.1), np.float64(2.0),
        np.float32(1.5)))
    held += 1
    print("[no sync] numpy scalar background and weights (np.float32, "
          "np.float64) at the flagship: forward held")
    # the check has teeth: what the repaired sites ran raises under it
    probe = torch.ones(3, device=dev)
    syncing = {
        "a constant copied from the host": lambda: torch.tensor(
            (128, 128), dtype=torch.float32, device=dev),
        "bincount": lambda: torch.bincount(probe.long()),
        ".item()": lambda: probe.sum().item()}
    for what, fn in syncing.items():
        try:
            held_without_sync(fn)
        except RuntimeError:
            continue
        check(False, f"[no sync] {what} raises under the sync debug mode")
    print(f"[no sync] {held} calls held under "
          f"torch.cuda.set_sync_debug_mode('error'), each after a warm-up "
          f"call; a constant copied from the host, bincount and .item() "
          f"raise there")
    return held


# [B9 slot prep]: the main path's multi-tile shapes, timed; and a cloud
# whose ids do not fit the packed sort key (the stable sort's path)
SLOT_PREP_CASES = ((MULTI_TILE, N_POSES, N_POINTS), (VOLUME, 1, 1_000_000))
SLOT_PREP_UNPACKED = (VOLUME, 1, 2 ** 22)


def main_inputs(grid, n_poses, n_points, dev):
    """The main path's cloud at `grid` on the card: `flagship_inputs` in
    2-D, `volume_inputs` in 3-D -> (points, rotation, translation,
    background, out_weight, point_weight)."""
    if len(grid) == 3:
        arrays = volume_inputs(n_poses, n_points)
    else:
        pts, rot, tr, pw = flagship_inputs(0, n_points, n_poses)
        arrays = (pts, rot, tr, np.zeros(n_poses, np.float32),
                  np.ones(n_poses, np.float32), pw)
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def slot_prep_bound(key, out):
    """B9 on the keys `key` (B, P): the keys read once, the bases, the slot
    table and the counts (`out`) written once; no arithmetic that counts
    against the memory."""
    return bound((key.numel() + sum(t.numel() for t in out)) * 4, 0)


def bin_scatter_bound(key, out):
    """B10 on the keys `key` (B, P): the keys read once and the frame keys
    `out` written once (B9's bases and counts, which it reads besides,
    are B9's output)."""
    return bound(key.numel() * 4 + out.numel() * out.element_size(), 0)


def phase_slot_prep(sb, dev, smi):
    """[B9 slot prep]: B9's counts, slot table and bases (`slot_prep`)
    bit-equal to their plain versions (`_slot_prep_plain`, `_bases_plain`),
    and B10's frame keys (`bin_scatter`) bit-equal to `torch.sort` of the
    plain sort input and to themselves on a second run, at
    `SLOT_PREP_CASES` and `SLOT_PREP_UNPACKED`, on the keys B6 writes there
    and on random keys that fill every bin of [0, nt], with
    ``min_chunk_per_tile`` both ways, packed where the ids fit and
    unpacked; at `SLOT_PREP_CASES` timed in turns by CUDA events and by
    device busy time: B9 against its eager chain (kernel, eager, eager,
    kernel), B10 against `torch.sort` (scatter, sort, sort, scatter),
    each kernel's own device time against its bound, and the one ranged
    `torch.histc` call on the prepared bins as the count's library call.
    -> {grid: entry}."""
    out = {}
    for grid, n_poses, n_points in SLOT_PREP_CASES + (SLOT_PREP_UNPACKED,):
        pts, rot, tr = main_inputs(grid, n_poses, n_points, dev)[:3]
        key, _, nt = sb._keys_and_local(grid, sb.tile_shape_for(grid), pts,
                                        rot, tr)
        chunk = sb._default_chunk(grid, n_points)
        fits = (2 * nt + 1) * sb._id_span(n_points) + n_points < 2 ** 31
        wild = torch.randint(0, nt + 1, key.shape, dtype=torch.int32,
                             device=dev)
        tag = f"{grid} x {n_poses} x {n_points}"
        for keys, label in ((key, "B6's keys"), (wild, "random keys")):
            for min_chunk in (True, False):
                got = sb.slot_prep(keys, nt, chunk, min_chunk)
                _, ref_st, ref_counts = sb._slot_prep_plain(
                    keys, nt, chunk, min_chunk, False)
                ref = (sb._bases_plain(keys, ref_counts, nt, chunk,
                                       min_chunk), ref_st, ref_counts)
                torch.cuda.synchronize()
                same = [torch.equal(g, r) for g, r in zip(got, ref)]
                print(f"[B9 slot prep] {tag}, {label}, min_chunk_per_"
                      f"tile {min_chunk}: bases {tuple(got[0].shape)}, "
                      f"slot table {tuple(got[1].shape)}, counts "
                      f"{tuple(got[2].shape)} bit-equal to the plain "
                      f"versions {same}")
                check(all(same) and int(got[2].sum()) == keys.numel(),
                      f"[B9 slot prep] {tag} ({label}, {min_chunk}) "
                      f"bit-equal to its plain version")
                for packed in (True, False) if fits else (False,):
                    index = sb.bin_scatter(keys, got[2], got[0], nt, chunk,
                                           min_chunk, packed)
                    again = sb.bin_scatter(keys, got[2], got[0], nt, chunk,
                                           min_chunk, packed)
                    keys2 = sb._slot_prep_plain(keys, nt, chunk, min_chunk,
                                                packed)[0]
                    values, perm = torch.sort(keys2, dim=1,
                                              stable=not packed)
                    want = values if packed else perm
                    torch.cuda.synchronize()
                    same_sort = torch.equal(index, want)
                    print(f"[B10 bin scatter] {tag}, {label}, min_chunk_"
                          f"per_tile {min_chunk}, packed {packed}: "
                          f"{tuple(index.shape)} {index.dtype} bit-equal "
                          f"to torch.sort's {same_sort}; [repeat] "
                          f"{torch.equal(index, again)}")
                    check(same_sort and torch.equal(index, again),
                          f"[B10 bin scatter] {tag} ({label}, {min_chunk}, "
                          f"{packed}) is torch.sort's, twice")
                    del index, again, keys2, values, perm, want
        if (grid, n_poses, n_points) == SLOT_PREP_UNPACKED:
            check(not fits, f"[B9 slot prep] {tag} takes the unpacked path")
            continue
        offs = torch.arange(n_poses, device=dev)[:, None] * (nt + 1)
        bins = (key.double() + offs).reshape(-1)
        n_bins = n_poses * (nt + 1)
        b9 = (lambda: sb.slot_prep(key, nt, chunk, True),
              lambda: sb._slot_prep_plain(key, nt, chunk, True, fits))
        bases, _, counts = b9[0]()
        keys2 = sb._slot_prep_plain(key, nt, chunk, True, fits)[0]
        b10 = (lambda: sb.bin_scatter(key, counts, bases, nt, chunk, True,
                                      fits),
               lambda: torch.sort(keys2, dim=1, stable=not fits))
        entry = {}
        for name, fns in (("b9", b9), ("b10", b10)):
            ms, busy = {0: [], 1: []}, {0: [], 1: []}
            for i in (0, 1, 1, 0):
                ms[i].append(time_ms(fns[i]))
                busy[i].append(device_busy(fns[i]))
            entry[name] = {
                "ms": sum(ms[0]) / 2, "plain_ms": sum(ms[1]) / 2,
                "ms_in_turns": ms[0][:1] + ms[1] + ms[0][1:],
                "busy_us": sum(b[0] for b in busy[0]) / 2,
                "plain_busy_us": sum(b[0] for b in busy[1]) / 2,
                "launches": busy[0][0][1], "plain_launches": busy[1][0][1]}
        count_us = launch_us(b9[0], "slot_count_kernel")
        scan_us = launch_us(b9[0], "slot_scan_kernel")
        scatter_us = launch_us(b10[0], "bin_scatter_kernel")
        entry["b9"].update(count_us=count_us, scan_us=scan_us,
                           dev_us=(None if None in (count_us, scan_us)
                                   else count_us + scan_us),
                           bound=slot_prep_bound(key, b9[0]()))
        entry["b10"].update(dev_us=scatter_us,
                            bound=bin_scatter_bound(key, b10[0]()))
        histc = functools.partial(torch.histc, bins, bins=n_bins, min=-0.5,
                                  max=n_bins - 0.5)
        entry["b9"]["library_ms"] = time_ms(histc)
        entry["b9"]["library_busy_us"] = device_busy(histc)[0]
        entry["b10"]["library_ms"] = entry["b10"]["plain_ms"]
        out[grid] = entry
        e9, e10 = entry["b9"], entry["b10"]
        t9, t10 = e9["ms_in_turns"], e10["ms_in_turns"]
        print(f"[B9 slot prep] {smi} | {tag} in turns (kernel, eager, "
              f"eager, kernel): " + ", ".join(f"{t:.4f}" for t in t9)
              + f" ms; device busy {e9['busy_us']:.2f} us in "
              f"{e9['launches']:.0f} launches (the zero-fill and the two "
              f"kernels) against the eager chain's "
              f"{e9['plain_busy_us']:.2f} us in {e9['plain_launches']:.0f}; "
              f"pass 1 {us_text(count_us)}, pass 2 {us_text(scan_us)}, "
              f"together {of_bound(e9['bound'][0], e9['dev_us'])}"
              f" of their {e9['bound'][0] * 1e3:.2f} us bound; one histc "
              f"call on the prepared bins (the count alone) "
              f"{e9['library_ms']:.4f} ms, device busy "
              f"{e9['library_busy_us']:.2f} us")
        print(f"[B10 bin scatter] {smi} | {tag}, packed {fits}, in turns "
              f"(scatter, torch.sort, torch.sort, scatter): "
              + ", ".join(f"{t:.4f}" for t in t10)
              + f" ms; device busy {e10['busy_us']:.2f} us in "
              f"{e10['launches']:.0f} launches against torch.sort's "
              f"{e10['plain_busy_us']:.2f} us in "
              f"{e10['plain_launches']:.0f}; bin_scatter_kernel "
              f"{scatter_us:.2f} us, "
              f"{e10['bound'][0] * 1e3 / max(scatter_us, 1e-9):.1%} of its "
              f"{e10['bound'][0] * 1e3:.2f} us bound")
    return out

# [B8 epilogue]: the main path's three shapes
B8_CASES = ((FLAGSHIP, N_POSES, N_POINTS), (MULTI_TILE, N_POSES, N_POINTS),
            (VOLUME, 1, 1_000_000))
# B8 against its torch form `_epilogue_plain` (scaled max-abs), beyond
# the torch form's own distance from the exact sums of its fp32 terms
# (its sums run in fp32: 1.4e-6 from them at 128^3 x 10^6), and against
# those exact sums (B8 sums in fp64 and rounds once)
B8_TOL = 1e-6
B8_EXACT_TOL = 1e-7
B8_KERNELS = {"epilogue_tile": "epilogue_tile_kernel",
              "epilogue_rows": "epilogue_rows_kernel",
              "epilogue_points": "epilogue_points_kernel",
              "epilogue_poses": "epilogue_poses_kernel"}


def epilogue_bounds(sb, args, kw):
    """The bounds of B8's two kernels that run on the arguments of
    `pullback_epilogue`, and of the epilogue as a function -> {kernel
    name: bound, ..., "function": bound}.  Only the bytes the function
    needs, each once: B4's rows and their ids for the P point rows of each
    pose (not the fillers, nor the padding of a single tile's frame), the
    cloud, the weights and the rotations, the gradients, and the
    intermediates each kernel writes or reads (the point-order copy at the
    n_out floats a (pose, point) of the uniform path or the n_out + 1 of
    the per-point path; the fp64 partials); a broadcast weight counts one
    float.  E2 on several tiles reads the weights but not the cloud.  Operations per (pose, point): 1 + 2 n_out fp32 products, n_out
    n_in + 1 fp64 multiply-adds for the point's sums and n_out (n_in + 1)
    + 1 for the pose's, one add a partial in the final sums."""
    grid, buf, _, pts, rot, _, pw = args
    single = sb._single_tile(grid)
    uniform = kw.get("pw_uniform", False) and not single
    bsz, n_rows_b, s_pad = buf.shape
    n_out = n_rows_b - 1
    p, n_in = pts.shape
    rows = bsz * p
    kp = n_out * (1 + n_in) + 1
    n_part = bsz * kp * (-(-p // (8 // sb._pose_groups(bsz) * 128))
                         if single else -(-s_pad // 1024))
    pw_n = 1 if pw.stride(0) == 0 else p
    weights = (pw_n + bsz) * 4
    cloud = p * n_in * 4 + weights
    rotations = bsz * n_out * n_in * 4
    grads_pt = p * (n_in + 1) * 4
    grads_pose = bsz * (n_out + n_out * n_in + 1) * 4
    b4_rows = rows * (n_out + 1) * 4
    ids = 0 if single else rows * 4
    copy = 0 if single else rows * (n_out + (not uniform)) * 4
    ops_pt = rows * (1 + 2 * n_out + n_out * n_in + 1)
    ops_pose = rows * (1 + 2 * n_out + kp)
    finals = bound(n_part * 8 + grads_pose, n_part)
    if single:
        bounds = {"epilogue_tile": bound(b4_rows + cloud + rotations
                                         + grads_pt + n_part * 8,
                                         ops_pt + ops_pose - rows * (
                                             1 + 2 * n_out)),
                  "epilogue_poses": finals}
    else:
        bounds = {"epilogue_rows": bound(b4_rows + ids + cloud + copy
                                         + n_part * 8, ops_pose),
                  "epilogue_points": bound(
                      copy + weights + rotations + grads_pt + n_part * 8
                      + grads_pose, ops_pt + n_part)}
    bounds["function"] = bound(b4_rows + ids + cloud + rotations + grads_pt
                               + grads_pose, ops_pt + ops_pose)
    return bounds


def b8_args(sb, grid, n_poses, n_points, dev, *, weighted, terms,
            standalone=False, nan=False, inf_weight=False, n_in=3):
    """The arguments the main path hands `pullback_epilogue` at `grid`,
    caught from `_pullback_from_frame` on the forward's frame (or the
    standalone pullback's): B4's rows, the id plane, the cloud, the
    rotations and the weights (a broadcast scalar on the uniform path,
    as the API passes it) -> (args, kw).  `n_in` other than the main
    path's 3 drops input axes of the cloud or adds random ones."""
    pts, rot, tr, bg, ow, pw = main_inputs(grid, n_poses, n_points, dev)
    if n_in < 3:
        pts, rot = pts[:, :n_in].contiguous(), rot[..., :n_in].contiguous()
    elif n_in > 3:
        rng = np.random.default_rng(3)
        more = [rng.standard_normal(shape) * sd for shape, sd in (
            ((n_points, n_in - 3), 0.4), (rot.shape[:2] + (n_in - 3,), 0.2))]
        pts, rot = (torch.cat([x, torch.from_numpy(m.astype(np.float32)).to(
            dev)], -1) for x, m in zip((pts, rot), more))
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (n_poses,) + grid).astype(np.float32)).to(dev)
    if nan:
        # on the brightest pixel of the middle pose, which points touch
        img = sb.raster_fwd(grid, pts, rot, tr, bg, ow, pw)[n_poses // 2]
        g[n_poses // 2].view(-1)[int(img.argmax())] = float("nan")
    if not weighted:
        pw = torch.full((), 1.5, device=dev).expand(n_points)
    elif inf_weight:
        pw = pw.clone()
        pw[n_points // 3] = float("inf")
    caught = []

    def catch(*args, **kw):
        caught.append((args, kw))
        return sb.pullback_epilogue(*args, **kw)

    if standalone:
        data, st, chunk = sb._bwd_frame(grid, pts, rot, tr)
        coord, idx_rows = data[:, :-1], data[:, -1]
    else:
        res = sb.raster_fwd_res(grid, pts, rot, tr, bg, ow, pw,
                                pw_uniform=not weighted, terms=terms)[1]
        coord, idx_rows, st = sb._residual_planes(res, not weighted)
        chunk = sb._default_chunk(grid, n_points)
    sb._pullback_from_frame(grid, coord, idx_rows, st, pts, rot, ow, pw, g,
                            chunk=chunk, pw_uniform=not weighted,
                            terms=terms, epilogue=catch)
    return caught[0]


def epilogue_f64(sb, grid, buf, idx_rows, pts, rot, ow, pw, pw_uniform):
    """The epilogue's gradients as the exact sums (in float64) of the
    torch form's fp32 terms ``scaled``: the reference both orders of
    summation are read against."""
    n_out = len(grid)
    p = pts.shape[0]
    halo = not sb._single_tile(grid)
    per = sb._unsort(buf, idx_rows, p) if halo else buf[:, :, :p]
    scale = torch.full((n_out,), 1.0, device=buf.device)
    for i, g in enumerate(grid):
        scale[i] = g / 2
    s = ((per[:, :n_out] * scale[None, :, None])
         * (ow[:, None, None] * pw[None, None, :])).double()
    gw = per[:, n_out].double()
    if pw_uniform and halo:
        sums = buf[:, n_out].double().sum(-1)
        d_ow, d_pw = sums * pw[0].double(), (sums @ ow.double() / p).repeat(p)
    else:
        d_ow, d_pw = gw @ pw.double(), ow.double() @ gw
    return (torch.einsum("bns,bni->si", s, rot.double()),
            torch.einsum("bns,si->bni", s, pts.double()), s.sum(-1), d_ow,
            d_pw)


def b8_check(sb, tag, args, kw):
    """B8 on `args` twice against `_epilogue_fixed_plain` (every output the
    same bits, any NaN matching any NaN), against the exact sums of the
    torch form's fp32 terms (`epilogue_f64`, within `B8_EXACT_TOL`) and
    against the torch form `_epilogue_plain` on the card (NaN and
    infinities where it has them, the finite entries within `B8_TOL` of
    it beyond its own distance from the exact sums) -> the scaled max-abs
    error against the torch form."""
    names = ("d_points", "d_r", "d_t", "d_ow", "d_pw")
    first = sb.pullback_epilogue(*args, **kw)
    second = sb.pullback_epilogue(*args, **kw)
    fixed = sb._epilogue_fixed_plain(*args, **kw)
    plain = sb._epilogue_plain(*args, **kw)
    exact = epilogue_f64(sb, *args, **kw)
    torch.cuda.synchronize()
    err = {"plain": 0.0, "exact": 0.0, "plain_exact": 0.0}
    for name, a, a2, f, r, x in zip(names, first, second, fixed, plain,
                                    exact):
        check(same_values(a, f) and same_values(a2, f),
              f"[B8 epilogue] {tag}: {name} bit-equal to "
              f"_epilogue_fixed_plain, twice")
        check(torch.equal(torch.isnan(a), torch.isnan(r))
              and torch.equal(torch.isinf(a), torch.isinf(r)),
              f"[B8 epilogue] {tag}: {name} non-finite where the torch form "
              f"is")
        fin = torch.isfinite(r) & torch.isfinite(x)
        if bool(fin.any()):
            err["plain"] = max(err["plain"], scaled_err(a[fin], r[fin]))
            err["exact"] = max(err["exact"], scaled_err(a[fin], x[fin]))
            err["plain_exact"] = max(err["plain_exact"],
                                     scaled_err(r[fin], x[fin]))
    n_bad = sum(int((~torch.isfinite(a)).sum()) for a in first)
    print(f"[B8 epilogue] {tag}: bit-equal to _epilogue_fixed_plain twice; "
          f"scaled max-abs err vs the exact sums {err['exact']:.3e} (tol "
          f"{B8_EXACT_TOL:g}), vs the torch form {err['plain']:.3e} (tol "
          f"{B8_TOL:g} beyond the torch form's own {err['plain_exact']:.3e} "
          f"from the exact sums); non-finite entries {n_bad}, where the "
          f"torch form has them")
    check(err["exact"] <= B8_EXACT_TOL
          and err["plain"] <= B8_TOL + err["plain_exact"],
          f"[B8 epilogue] {tag}: vs the exact sums and the torch form")
    return err["plain"]


def phase_b8(sb, dev, smi):
    """[B8 epilogue]: the epilogue's two kernels on what the main path
    hands them at `B8_CASES` (one tile: `epilogue_tile` and
    `epilogue_poses`; several: `epilogue_rows` and `epilogue_points`),
    uniform and per-point weights, terms 0 and 1 (`b8_check`); also on
    the standalone pullback's frame, with a NaN in the cotangent, with an
    infinite weight, and with clouds of 2 and 5 input axes.  At terms 0
    it times them: each kernel's device us against its bound, the
    epilogue's ms, busy us and launches in turns against the torch form
    (torch form, kernels, kernels, torch form).  -> {"err": worst error,
    "times": {(grid, weighted): entry}}."""
    worst, times = 0.0, {}
    for grid, n_poses, n_points in B8_CASES:
        shape = f"{grid} x {n_poses} x {n_points}"
        for weighted in (False, True):
            for terms in (0, 1):
                args, kw = b8_args(sb, grid, n_poses, n_points, dev,
                                   weighted=weighted, terms=terms)
                label = (f"{shape} {'weighted' if weighted else 'uniform'} "
                         f"terms={terms}")
                worst = max(worst, b8_check(sb, label, args, kw))
                if terms:
                    continue
                fns = (lambda: sb._epilogue_plain(*args, **kw),
                       lambda: sb.pullback_epilogue(*args, **kw))
                ms, busy = {0: [], 1: []}, {0: [], 1: []}
                for i in (0, 1, 1, 0):
                    ms[i].append(time_ms(fns[i]))
                    busy[i].append(device_busy(fns[i]))
                bounds = epilogue_bounds(sb, args, kw)
                entry = {"ms": sum(ms[1]) / 2, "plain_ms": sum(ms[0]) / 2,
                         "bounds": bounds,
                         "dev_us": {name: launch_us(
                             fns[1], B8_KERNELS[name], calls=5)
                             for name in bounds if name != "function"}}
                times[grid, weighted] = entry
                order = ((0, 0), (1, 0), (1, 1), (0, 1))
                shares = []
                for name, us in entry["dev_us"].items():
                    b_ms, by = bounds[name]
                    shares.append(f"{name} {us_text(us)}, "
                                  f"{of_bound(b_ms, us)} of its "
                                  f"{b_ms * 1e3:.2f} us bound (by {by})")
                print(f"[B8 epilogue] {smi} | {label} in turns (torch form, "
                      f"kernels, kernels, torch form): ms "
                      + ", ".join(f"{ms[i][j]:.4f}" for i, j in order)
                      + "; busy us in launches "
                      + ", ".join(f"{busy[i][j][0]:.2f} in "
                                  f"{busy[i][j][1]:.0f}" for i, j in order)
                      + "; " + ", ".join(shares)
                      + f"; the function's bound "
                        f"{bounds['function'][0] * 1e3:.2f} us")
    for label, kw in (("standalone frame", {"standalone": True}),
                      ("NaN in the cotangent", {"nan": True}),
                      ("an infinite weight", {"inf_weight": True})):
        for grid in GRIDS:
            args, ekw = b8_args(sb, grid, N_POSES, N_POINTS, dev,
                                weighted=True, terms=0, **kw)
            worst = max(worst, b8_check(
                sb, f"{grid} x {N_POSES} x {N_POINTS} weighted, {label}",
                args, ekw))
    # the instances that take n_in at run time (5 in 2-D, 2 in 3-D) and the
    # unrolled n_in = 2 in 2-D
    for (grid, n_poses, n_points), n_in in ((B8_CASES[0], 5),
                                            (B8_CASES[1], 5),
                                            (B8_CASES[1], 2),
                                            (B8_CASES[2], 2)):
        for weighted in (False, True):
            args, ekw = b8_args(sb, grid, n_poses, n_points, dev,
                                weighted=weighted, terms=0, n_in=n_in)
            worst = max(worst, b8_check(
                sb, f"{grid} x {n_poses} x {n_points} "
                    f"{'weighted' if weighted else 'uniform'}, {n_in} input "
                    f"axes", args, ekw))
    return {"err": worst, "times": times}


def flat_outputs(result):
    """The tensors of a call's result (a tensor or nested tuples of them),
    in order."""
    if isinstance(result, torch.Tensor):
        return [result.detach()]
    return [t for r in result for t in flat_outputs(r)]


def repeats(fn):
    """`fn` run twice gives the same bits in every output -> (bool, the
    number of output tensors)."""
    a, b = flat_outputs(fn()), flat_outputs(fn())
    torch.cuda.synchronize()
    return (len(a) == len(b) and all(same_values(x, y) for x, y in
                                     zip(a, b))), len(a)


def six_grad_step(dprast_torch, grid, canon, g, weighted, backend):
    """The autograd step of all six inputs: `raster`, then the gradients of
    ``sum(out * g)``."""
    leaves = [t.clone().requires_grad_() for t in canon[:5]]
    leaves.append(canon[5].clone().requires_grad_() if weighted else None)

    def step():
        out = dprast_torch.raster(grid, *leaves[:5], point_weight=leaves[5],
                                  backend=backend)
        wrt = [t for t in leaves if t is not None]
        return (out, *torch.autograd.grad((out * g).sum(), wrt))
    return step


# [repeat]: the rows that `auto` sends to the `xla` backend on the card
REPEAT_XLA = (("1024cube_1e5", (1024, 1024, 1024), 1, 100_000),
              ("(4096,) x 4 x 1e4", (4096,), 4, 10_000),
              ("16^4 x 4 x 1e4", (16, 16, 16, 16), 4, 10_000))


def phase_repeat(dprast_torch, dev):
    """[repeat]: with torch's deterministic mode off, the `binned` forward
    (`raster`) and fused step (the backend's pair) run twice at the main
    path's three shapes and 64^2 x 70,000 poses, default and per-point
    weights, give the same bits; and so do the forward and fused step of
    the rows that `auto` sends to `xla` (`REPEAT_XLA`), whose scatter adds
    in a fixed order.  -> the calls compared."""
    from dprast_torch.ops import dispatch, splat_binned as sb
    n = 0
    for name, grid, n_poses, n_points in REPEAT_XLA:
        args, g = xla_inputs(grid, n_poses, n_points, dev)
        backend = dispatch.resolve("auto", len(grid), grid, n_points,
                                   accelerator=True)
        check(backend == "xla", f"[repeat] auto takes xla at {name}")
        xla = dispatch.vjp_pair("xla")

        def fused():
            out, res = xla[0](grid, *args)
            return out, xla[1](grid, res, args, g)

        reset_launches(sb)
        same_f, _ = repeats(functools.partial(dprast_torch.raster, grid,
                                              *args, backend="auto"))
        same_s, k = repeats(fused)
        n += 2
        print(f"[repeat] auto -> xla {name}, per-point weights: forward "
              f"bit-equal on two runs {same_f}; fused step ({k} tensors) "
              f"{same_s}; launches {ran(sb.LAUNCHES)}")
        check(same_f and same_s, f"[repeat] xla {name} repeats bit for bit")
        check(ran(sb.LAUNCHES) == {"xla_neighbours": 4, "xla_scatter": 4,
                                   "xla_gather": 2},
              f"[repeat] xla {name} runs through X1-X3")
        del args, g
        torch.cuda.empty_cache()
    pair = dispatch.vjp_pair("binned")
    for grid, n_poses, n_points in NO_SYNC_SHAPES:
        canon = main_inputs(grid, n_poses, n_points, dev)
        g = torch.randn((n_poses,) + grid, device=dev)
        for weighted in (False, True):
            args = canon if weighted else canon[:5] + (
                torch.ones_like(canon[5]),)

            def fused():
                out, res = pair[0](grid, *args, pw_uniform=not weighted)
                return out, pair[1](grid, res, args, g,
                                    pw_uniform=not weighted)

            fwd = functools.partial(dprast_torch.raster, grid, *canon[:5],
                                    point_weight=canon[5] if weighted
                                    else None, backend="binned")
            same_f, _ = repeats(fwd)
            same_s, k = repeats(fused)
            n += 2
            label = "per-point" if weighted else "default"
            print(f"[repeat] binned {grid} x {n_poses} x {n_points}, {label} "
                  f"weights: forward bit-equal on two runs {same_f}; fused "
                  f"step ({k} tensors) {same_s}")
            check(same_f and same_s, f"[repeat] binned {grid} {label} "
                                     f"repeats bit for bit")
    return n


# [deterministic]: every entry point through `auto` at the main shapes,
# and the backends asked for by name at the flagship
DETERMINISTIC_BACKENDS = ("binned_bf16", "xla", "matmul")


def deterministic_worker():
    """The body of [deterministic], in a process started with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``: under
    ``torch.use_deterministic_algorithms(True)`` every entry point (the
    forward, `raster_pullback`, the autograd step of all six inputs, the
    fused pair where the backend has one, and `raster_sharded` forward and
    step on the 1 x 1 mesh) through `auto` at `NO_SYNC_SHAPES` and on
    `DETERMINISTIC_BACKENDS` by name at the flagship, default and per-point
    weights, runs without an error and twice to the same bits."""
    torch.use_deterministic_algorithms(True)
    import dprast_torch
    from dprast_torch.ops import dispatch, splat_binned as sb
    from dprast_torch.parallel import make_mesh, raster_sharded
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_mesh()
    cases = [(grid, n_poses, n_points, "auto")
             for grid, n_poses, n_points in NO_SYNC_SHAPES]
    cases += [(FLAGSHIP, N_POSES, N_POINTS, name)
              for name in DETERMINISTIC_BACKENDS]
    n = 0
    reset_launches(sb)
    for grid, n_poses, n_points, backend in cases:
        canon = main_inputs(grid, n_poses, n_points, dev)
        g = torch.randn((n_poses,) + grid, device=dev)
        for weighted in (False, True):
            paths = no_sync_paths(dprast_torch, dispatch, grid, canon, g,
                                  weighted, backend)
            paths["autograd step"] = six_grad_step(
                dprast_torch, grid, canon, g, weighted, backend)
            if backend == "auto" and not weighted:
                leaves = [t.clone().requires_grad_() for t in canon[:3]]

                def sharded_step():
                    out = raster_sharded(grid, *leaves, mesh=mesh)
                    return (out, *torch.autograd.grad((out * g).sum(),
                                                      leaves))

                paths["raster_sharded"] = lambda: raster_sharded(
                    grid, *canon[:3], mesh=mesh)
                paths["raster_sharded step"] = sharded_step
            got = {name: repeats(fn) for name, fn in paths.items()}
            n += len(got)
            print(f"[deterministic] {backend} {grid} x {n_poses} x "
                  f"{n_points}, {'per-point' if weighted else 'default'} "
                  f"weights, bit-equal on two runs: "
                  + ", ".join(f"{k} ({m} tensors) {v}"
                              for k, (v, m) in got.items()))
            check(all(v for v, _ in got.values()),
                  f"[deterministic] {backend} {grid} repeats bit for bit")
    launched = ran(sb.LAUNCHES)
    print(f"[deterministic] {n} calls ran twice each under "
          f"torch.use_deterministic_algorithms(True), all bit-equal; "
          f"launches {launched}")
    check(launched.get("slot_prep", 0) >= 1 and
          launched.get("bin_scatter", 0) >= 1 and
          launched.get("frame_gather", 0) >= 1 and
          launched.get("fwd_splat_enc", 0) >= 1,
          "[deterministic] B9, B10, the frame gather and B1 ran under the "
          "mode")
    check(xla_ran(launched), "[deterministic] X1-X3 ran under the mode")


def phase_deterministic():
    """[deterministic]: `deterministic_worker` in a process of its own,
    started with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` as torch asks for its
    deterministic mode; it must exit 0.  -> its output lines."""
    import os
    import subprocess
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--deterministic"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    for ln in lines:
        print(ln)
    check(proc.returncode == 0,
          f"[deterministic] the worker exited {proc.returncode}:\n"
          f"{proc.stderr[-4000:]}")
    return lines


# [poses]: past the 65,535 that CUDA allows a launch grid's y and z
# (csrc/poses.cuh): one tile at 65,536 and 70,000 poses; two tiles in 2-D
# (B9, the sort, the frame gather, B2, B4's grid source, E1 and E2) and in
# 3-D (B4 on the unfolded windows); 10^3 points
POSES_CASES = (((64, 64), 65_536), ((64, 64), 70_000),
               ((127, 130), 70_000), ((7, 15, 130), 70_000))
POSES_POINTS = 1000
# [poses rows]: B2 past 65,535 grid rows, through `auto`
POSES_ROWS = ((70_000, 64), 4, 100_000)
# poses a chunk of the `xla` reference takes
REF_POSES = 8192


def poses_kernels(sb, grid):
    """The kernels the fused step runs at `grid`: B4's grid source counts
    as ``_ldg`` where a grid row is no multiple of 16 bytes."""
    if len(grid) == 3:
        return ("coords", "slot_prep", "bin_scatter", "frame_gather",
                "fwd_splat_3d_enc", "bwd_gather_3d_enc", *EPILOGUE_TILES)
    if sb._single_tile(grid):
        return ("coords", "fwd_splat_enc", "bwd_gather_enc", *EPILOGUE_TILE)
    return ("coords", "slot_prep", "bin_scatter", "frame_gather",
            "fwd_splat_enc", "band_fold", "bwd_gather_grid_enc"
            + ("" if grid[1] % 4 == 0 else sb._GRID_LOADS), *EPILOGUE_TILES)


def equal_bits(a, b):
    """Two float32 tensors on the card hold the same bits (no copy to the
    host, no NaN expected)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def poses_inputs(grid, n_poses, n_points, dev):
    """The six inputs of a [poses] case on the card: `main_inputs`' cloud
    and poses with per-point weights, and per-pose background and
    out_weight (`vs_xla`'s) -> (args, cotangent)."""
    pts, rot, tr, _, _, pw = main_inputs(grid, n_poses, n_points, dev)
    rng = np.random.default_rng(6)
    bg = (rng.standard_normal(n_poses) * 0.1).astype(np.float32)
    ow = rng.uniform(0.5, 2.0, n_poses).astype(np.float32)
    g = torch.randn((n_poses,) + grid, generator=torch.Generator(
        device=dev).manual_seed(8), device=dev)
    return (pts, rot, tr, torch.from_numpy(bg).to(dev),
            torch.from_numpy(ow).to(dev), pw), g


def errs_vs_xla(dprast_torch, grid, args, g, out, grads):
    """Scaled max-abs errors (`scaled_err`) of a call's image `out` and six
    gradients `grads` (`GRAD_NAMES` order, per pose and per point) against
    the `xla` backend on the same inputs, run `REF_POSES` poses at a time
    (its memory); d_points and d_pw, sums over the poses, add up over the
    chunks in float64 -> {"image" | name: err}."""
    pts, rot, tr, bg, ow, pw = args
    diff = dict.fromkeys(("image",) + GRAD_NAMES, 0.0)
    top = dict(diff)
    d_pts, d_pw = pts.double() * 0.0, pw.double() * 0.0

    def note(name, a, ref):
        ref = ref.double()
        diff[name] = max(diff[name], float((a.double() - ref).abs().max()))
        top[name] = max(top[name], float(ref.abs().max()))

    for lo in range(0, rot.shape[0], REF_POSES):
        at = slice(lo, lo + REF_POSES)
        part = (rot[at], tr[at], bg[at], ow[at])
        note("image", out[at], dprast_torch.raster(
            grid, pts, *part, pw, backend="xla"))
        ref = dprast_torch.raster_pullback(g[at], pts, *part, pw,
                                           backend="xla")
        for i in (1, 2, 3, 4):
            note(GRAD_NAMES[i], grads[i][at], ref[i].double())
        d_pts += ref.points.double()
        d_pw += ref.point_weight.double()
    note("points", grads[0], d_pts)
    note("point_weight", grads[5], d_pw)
    return {k: diff[k] / max(top[k], 1.0) for k in diff}


def xla_past_65535(dprast_torch, grid, args, g):
    """The `xla` backend's forward and `raster_pullback` at all of the
    poses in one call (X1-X3 carry the pose's high part on z,
    `csrc/poses.cuh`) against the same calls `REF_POSES` poses at a time,
    bit for bit in the image and every per-pose gradient -> bool."""
    pts, rot, tr, bg, ow, pw = args
    img = dprast_torch.raster(grid, *args, backend="xla")
    res = dprast_torch.raster_pullback(g, *args, backend="xla")
    same = True
    for lo in range(0, rot.shape[0], REF_POSES):
        at = slice(lo, lo + REF_POSES)
        part = (rot[at], tr[at], bg[at], ow[at])
        same = same and equal_bits(img[at], dprast_torch.raster(
            grid, pts, *part, pw, backend="xla"))
        ref = dprast_torch.raster_pullback(g[at], pts, *part, pw,
                                           backend="xla")
        same = same and all(equal_bits(res[i][at], ref[i])
                            for i in (1, 2, 3, 4))
    return same


def poses_case(dprast_torch, sb, smi, tag, grid, args, g, kernels):
    """One case of [poses] / [poses rows] through `auto`: the forward
    (`raster`) and the fused step (the pair of the backend `auto` names,
    all six gradients) each twice, bit-equal; both against the `xla`
    backend within 2e-5 scaled (`errs_vs_xla`); and every kernel of
    `kernels` launched.  -> (the fused step's image and gradients, its
    launches)."""
    from dprast_torch.ops import dispatch
    n_poses, p = args[1].shape[0], args[0].shape[0]
    backend = dispatch.resolve("auto", len(grid), grid, p, accelerator=True)
    check(backend == "binned", f"{tag} auto takes binned at {grid}")
    pair = dispatch.vjp_pair(backend)

    def fused():
        out, res = pair[0](grid, *args, pw_uniform=False)
        return out, tuple(pair[1](grid, res, args, g, pw_uniform=False))

    reset_launches(sb)
    first = fused()
    second = fused()
    launched = ran(sb.LAUNCHES)
    same_s = all(equal_bits(a, b) for a, b in zip(
        flat_outputs(first), flat_outputs(second)))
    del second
    img = dprast_torch.raster(grid, *args)
    same_f = equal_bits(img, dprast_torch.raster(grid, *args))
    same_f = same_f and equal_bits(img, first[0])
    del img
    torch.cuda.synchronize()
    out, grads = first
    check(out.shape == (n_poses,) + grid and bool(torch.isfinite(out).all())
          and all(bool(torch.isfinite(x).all()) for x in grads),
          f"{tag} {grid}: finite image and gradients")
    errs = errs_vs_xla(dprast_torch, grid, args, g, out, grads)
    if grid == (64, 64) and n_poses == max(n for _, n in POSES_CASES):
        same_x = xla_past_65535(dprast_torch, grid, args, g)
        print(f"{tag} {grid} x {n_poses} poses: the xla backend in one call "
              f"bit-equal to its calls {REF_POSES} poses at a time in the "
              f"image and every per-pose gradient {same_x}")
        check(same_x, f"{tag} {grid}: xla past 65,535 poses")
    # the `xla` reference runs through X1-X3
    from dprast_torch.ops import core
    launched.update((k, v) for k, v in ran(sb.LAUNCHES).items()
                    if k in core.XLA_KERNELS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{tag} {smi} | {grid} x {n_poses} poses x {p} points, per-point "
          f"weights, auto -> {backend}: forward bit-equal on two runs (and "
          f"to the fused step's) {same_f}; fused step (7 tensors) {same_s}; "
          f"scaled max-abs err vs the xla backend, {REF_POSES} poses at a "
          f"time (tol 2e-5): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; launches {launched}; peak device memory so far "
            f"{peak:.2f} GB")
    check(same_f and same_s, f"{tag} {grid} repeats bit for bit")
    check(max(errs.values()) <= 2e-5, f"{tag} {grid} vs xla")
    for name in kernels:
        check(launched.get(name, 0) >= 1, f"{tag} {grid}: {name} ran")
    return first, launched


def poses_instances(sb, smi, grid, args, g):
    """Every B1 and B4 instance that reads a frame of `grid` at 70,000
    poses, terms 0 and 1 (`b7_calls`): on the encoded frame bit-equal to
    the same kernel on the frame's lane planes, B4 also to its plain
    version pose chunk by chunk.  B4 reads what the path hands it (the
    cotangent on one tile, the unfolded windows in 3-D, the cotangent as
    its grid source on 2-D tiles, there also a (rows, 132) cotangent,
    whose rows are multiples of 16 bytes, through the TMA tiled load) ->
    launches."""
    pts, rot, tr, _, _, pw = args
    ts = sb.tile_shape_for(grid)
    win = sb._window(grid)
    at_chunks = [slice(lo, lo + REF_POSES)
                 for lo in range(0, g.shape[0], REF_POSES)]
    if len(grid) == 3:
        sources = [("natural", sb._unfold(g, grid, ts))]
    elif sb._single_tile(grid):
        sources = [("natural", g)]
    else:
        g_tma = torch.randn((g.shape[0], grid[0], 132), device=g.device,
                            generator=torch.Generator(device=g.device)
                            .manual_seed(9))
        check(sb._b4_staging("grid", g_tma, 0) == "tensor",
              "[poses] a (rows, 132) cotangent takes the TMA tiled load")
        sources = [("grid", g), ("grid", g_tma)]
    reset_launches(sb)
    frame = sb._fwd_prep(grid, pts, rot, tr, pw, False)
    data, st, _, chunk = frame
    coord = data[:, :len(grid)]
    same = True
    for terms in (0, 1):
        for k, (layout, g_in) in enumerate(sources):
            calls = b7_calls(sb, frame, win, ts, g_in, layout, terms, True)
            if k == 0:
                b1_enc, b1_lane = calls["b1"][:2]
                same = same and equal_bits(b1_enc(), b1_lane())
            b4_enc, b4_lane = calls["b4"][:2]
            buf = b4_enc()
            same = same and equal_bits(buf, b4_lane()) and all(
                equal_bits(buf[at], sb._bwd_gather_enc_plain(
                    st[at], coord[at], ts, g_in[at], chunk, terms=terms,
                    layout=layout)) for at in at_chunks)
            del calls, buf
    torch.cuda.synchronize()
    launched = ran(sb.LAUNCHES)
    print(f"[poses] {smi} | {grid} x {g.shape[0]} poses, every B1 and B4 "
          f"instance on its frame, terms 0 and 1: bit-equal to the lane "
          f"instance (B4 also to its plain version) {same}; launches "
          f"{launched}")
    check(same, f"[poses] {grid} B1 and B4 instances bit-equal")
    return launched


def poses_band(sb, smi, grid, args, g, fused_out):
    """At (127, 130) x 70,000 poses: B3 (bit-equal to `_unfold`, pose chunk
    by chunk); the harness's B4 variants on B3's windows (natural at terms
    0, 1 and 2, transposed and presplit at 2; `_LAYOUTS`), each bit-equal
    to its plain version pose chunk by chunk; and the `binned_bf16` fused
    step within `BF16_TOL` of `binned`'s (`fused_out`) -> launches."""
    from dprast_torch.ops import dispatch
    pts, rot, tr, _, _, pw = args
    ts = sb.tile_shape_for(grid)
    chunks = [slice(lo, lo + REF_POSES)
              for lo in range(0, g.shape[0], REF_POSES)]
    reset_launches(sb)
    windows = sb.band_unfold(g, grid, ts)
    same_b3 = all(equal_bits(windows[at], sb._unfold(g[at], grid, ts))
                  for at in chunks)
    data, st, _, chunk = sb._fwd_prep(grid, pts, rot, tr, pw, False)
    lane_b = sb._planes_bwd(data[:, :len(grid)], ts).contiguous()
    del data

    def held(win, terms, layout, part):
        buf = sb.bwd_gather(st, lane_b, win, chunk, terms=terms,
                            layout=layout)
        return all(equal_bits(buf[at], sb._bwd_gather_plain(
            st[at], lane_b[at], part(at), chunk, terms=terms,
            layout=layout)) for at in chunks)

    same_b5 = all(held(windows, terms, "natural", lambda at: windows[at])
                  for terms in (0, 1, 2))
    win_t = windows.transpose(-1, -2).contiguous()
    del windows
    same_b5 = same_b5 and held(win_t, 2, "transposed", lambda at: win_t[at])
    hi = win_t.to(torch.bfloat16)
    lo = (win_t - hi.float()).to(torch.bfloat16)
    del win_t
    same_b5 = same_b5 and held((hi, lo), 2, "presplit",
                               lambda at: (hi[at], lo[at]))
    del hi, lo, lane_b
    bf16 = dispatch.vjp_pair("binned_bf16")
    out, res = bf16[0](grid, *args, pw_uniform=False)
    grads = bf16[1](grid, res, args, g, pw_uniform=False)
    del res
    errs = [scaled_err(a, b) for a, b in zip((out, *grads),
                                             flat_outputs(fused_out))]
    torch.cuda.synchronize()
    launched = ran(sb.LAUNCHES)
    print(f"[poses] {smi} | {grid} x {g.shape[0]} poses: band_unfold "
          f"bit-equal to _unfold {same_b3}; B4 on its windows, natural "
          f"(terms 0, 1, 2), transposed and presplit (terms 2), bit-equal "
          f"to the plain version {same_b5}; binned_bf16 fused step vs "
          f"binned, worst scaled max-abs err {max(errs):.3e} (tol "
          f"{BF16_TOL:g}); launches {launched}")
    check(same_b3 and same_b5, f"[poses] {grid} B3 and B4's variants "
                               f"bit-equal")
    check(max(errs) <= BF16_TOL, f"[poses] {grid} binned_bf16")
    return launched


def phase_poses(dprast_torch, sb, dev, smi):
    """[poses] and [poses rows]: the shapes that CUDA's 65,535 on a launch
    grid's y and z kept from the card before (`POSES_CASES`, and
    `POSES_ROWS` for B2's rows), through `auto` as a user calls them
    (`poses_case`), every other kernel instance at 70,000 poses
    (`poses_instances`, `poses_band`), which must leave no counter of
    `LAUNCHES` at 0; the device memory is freed between cases, and the
    peak printed.  -> {kernel: launches in these phases}."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    total = {}

    def add(launched):
        for name, count in launched.items():
            total[name] = total.get(name, 0) + count

    for grid, n_poses in POSES_CASES:
        args, g = poses_inputs(grid, n_poses, POSES_POINTS, dev)
        fused_out, launched = poses_case(dprast_torch, sb, smi, "[poses]",
                                         grid, args, g,
                                         poses_kernels(sb, grid))
        add(launched)
        if n_poses == max(n for _, n in POSES_CASES):
            torch.cuda.empty_cache()
            add(poses_instances(sb, smi, grid, args, g))
            if len(grid) == 2 and not sb._single_tile(grid):
                add(poses_band(sb, smi, grid, args, g, fused_out))
        del args, g, fused_out
        torch.cuda.empty_cache()
    grid, n_poses, n_points = POSES_ROWS
    args, g = poses_inputs(grid, n_poses, n_points, dev)
    check(sb.n_tiles(grid) > 1, "[poses rows] a multi-tile grid")
    _, launched = poses_case(dprast_torch, sb, smi, "[poses rows]", grid,
                             args, g, poses_kernels(sb, grid))
    add(launched)
    del args, g
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"[poses] {smi} | peak device memory of [poses] and [poses rows] "
          f"{peak:.2f} GB; launches {total}")
    missing = [name for name in sb.LAUNCHES if not total.get(name)]
    check(not missing, f"[poses] every kernel instance launched past 65,535 "
                       f"poses; not: {missing}")
    return total


BENCH_DETAIL = ("backend", "platform", "t_fwd_ms", "t_bwd_ms", "t_fwd_ms_pm",
                "t_bwd_ms_pm", "n_points", "batch", "grid", "name",
                "power_limit", "t_step_ms", "t_grad_ms", "busy_ms",
                "launches")


def phase_bench():
    """[bench]: `python3 bench_torch.py` as the benchmark runs it, in a
    process of its own; its one JSON line must carry `bench.py`'s keys and
    the port's, a positive value, the card as platform and `binned` as
    backend.  -> the record."""
    import subprocess
    proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and len(lines) == 1,
          f"[bench] bench_torch.py printed one line and exited 0 (rc "
          f"{proc.returncode}):\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    rec = json.loads(lines[0])
    detail = rec.get("detail", {})
    missing = [k for k in ("metric", "value", "unit", "vs_baseline")
               if k not in rec] + [k for k in BENCH_DETAIL
                                   if k not in detail]
    check(not missing, f"[bench] keys missing: {missing}")
    check(rec["value"] > 0 and detail["platform"] == "cuda"
          and detail["backend"] == "binned",
          f"[bench] a positive value on the card through binned: {rec}")
    print(f"[bench] {json.dumps(rec)}")
    return rec


RUN_ROWS = ("128sq_1e5", "1024cube_1e5")
RUN_BACKENDS = {"128sq_1e5": "binned", "1024cube_1e5": "xla"}
RUN_KEYS = ("config", "backend", "inputs", "card", "power_limit",
            "t_fwd_ms", "t_fwd_ms_pm", "t_bwd_ms", "t_bwd_ms_pm", "t_step_ms",
            "t_grad_ms", "t_grad_ms_pm", "busy_ms", "launches", "splats_per_s",
            "vs_a100", "peak_mem_gb")


def phase_run():
    """[run]: rows of `dprast_torch.benchmarks.run` with the training step
    (`--grad`), in this process: the flagship and 1024^3, whose 4.3 GB
    volume goes to `xla` (91,287 tiles, above `binned`'s 4,096).  Every
    timing must be there and no error, the backend `auto`'s, and the peak
    memory at 1024^3 under 40 GB (it also counts what this process still
    holds from earlier phases).  -> the records."""
    from dprast_torch.benchmarks import run as bench_run
    rows = {cfg[0]: cfg for cfg in bench_run.CONFIGS}
    recs = []
    for name in RUN_ROWS:
        rec = bench_run.run_config(*rows[name], with_grad=True)
        missing = [k for k in RUN_KEYS if k not in rec]
        errors = [k for k in rec if k.endswith("error")]
        check(not missing and not errors,
              f"[run] {name}: keys missing {missing}, errors {errors}")
        check(rec["backend"] == RUN_BACKENDS[name],
              f"[run] {name} runs on {RUN_BACKENDS[name]}, got "
              f"{rec['backend']}")
        recs.append(rec)
    check(recs[-1]["peak_mem_gb"] < 40,
          f"[run] 1024cube_1e5 peaks at {recs[-1]['peak_mem_gb']:.2f} GB")
    return recs


def phase_tests_gpu():
    """[tests_gpu]: the on-card parity suite, ``python -m pytest
    tests_gpu``, in a process of its own; every test it collects must pass
    (a suite that skips on the card fails).  -> (passed, collected)."""
    import subprocess
    import tempfile
    import xml.etree.ElementTree as ET
    with tempfile.TemporaryDirectory() as tmp:
        xml = Path(tmp) / "tests_gpu.xml"
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "tests_gpu", "-q",
             "-p", "no:cacheprovider", f"--junitxml={xml}"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        suite = ET.parse(xml).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    collected = int(suite.get("tests"))
    passed = collected - sum(int(suite.get(k)) for k in
                             ("errors", "failures", "skipped"))
    summary = proc.stdout.strip().splitlines()[-1:]
    print(f"[tests_gpu] {passed} of {collected} passed (rc "
          f"{proc.returncode}): {' '.join(summary)}")
    check(proc.returncode == 0 and passed == collected and collected >= 13,
          f"[tests_gpu] every collected test passes:\n"
          f"{proc.stdout[-4000:]}\n{proc.stderr[-2000:]}")
    return passed, collected


# [xla path]: the `xla` backend's kernels (csrc/xla_path.cu) X1
# `xla_neighbours`, X2 `xla_scatter` and X3 `xla_gather`.  Each held to
# its plain version bit for bit at (name, grid, poses, points, dtype): the
# rows `auto` sends to `xla` on the card ([repeat]'s), a sparse 1024^2
# cloud, float64, a rank-5 grid (the instances that take the rank at run
# time), and two poses of 1024^3, whose B * total passes 2^31 (int64 keys)
XLA_CASES = (("1024cube_1e5", (1024, 1024, 1024), 1, 100_000, torch.float32),
             ("1024cube x 2 x 1e5", (1024, 1024, 1024), 2, 100_000,
              torch.float32),
             ("(4096,) x 4 x 1e4", (4096,), 4, 10_000, torch.float32),
             ("16^4 x 4 x 1e4", (16, 16, 16, 16), 4, 10_000, torch.float32),
             ("1024^2 x 64 x 1e3", (1024, 1024), 64, 1000, torch.float32),
             ("64^2 x 4 x 1e4 float64", (64, 64), 4, 10_000, torch.float64),
             ("(7, 6, 5, 4, 3) x 2 x 2000", (7, 6, 5, 4, 3), 2, 2000,
              torch.float32),
             ("(7, 6, 5, 4, 3) x 2 x 2000 float64", (7, 6, 5, 4, 3), 2, 2000,
              torch.float64))
# the timed rows: the reference table's 1024^3 row and a tomography-sized
# volume past `supported()` (12,950 tiles), one pose
XLA_TIMED = (("1024cube_1e5", (1024, 1024, 1024), 1, 100_000),
             ("512cube_1e6", (512, 512, 512), 1, 1_000_000))
# the longest run X2 meets: every point of a 1-D cloud in one voxel, so
# two voxels take a run of this many terms each
XLA_LONG_RUN = ((64,), 1_200_000)
# small cases against the f64 oracles: (grid, seed, points, poses)
XLA_SMALL = (((17,), 3, 1500, 4), ((9, 12), 5, 1500, 4),
             ((6, 7, 5), 6, 1500, 4), ((300, 200), 7, 1500, 4))
# C8 on the card: second derivatives through `xla` in float32 against the
# CPU's float64 run, within this share of each pair's largest entry
SECOND_FIELDS = ("points", "rotation", "translation", "point_weight")
SECOND_GRID = (8, 9)
SECOND_TOL = 1e-5


def xla_bits(a, b):
    """Two tensors of one shape and dtype hold the same bits (floats read
    as integers of their width)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        as_int = {4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(as_int), b.view(as_int)
    return torch.equal(a, b.to(a.device))


def xla_inputs(grid, n_poses, n_points, dev, dtype=torch.float32):
    """A row's six inputs (`benchmarks.run`'s, per-point weights) and its
    cotangent on the card, in `dtype`."""
    from dprast_torch.benchmarks.run import _args_for, _cotangent
    arrays = _args_for(n_points, n_poses, grid, max(3, len(grid)))
    return (tuple(torch.from_numpy(a).to(dev, dtype) for a in arrays),
            _cotangent(n_poses, grid, dev).to(dtype))


def xla_filled(bg, grid):
    """The volume X2 adds into: each pose's background."""
    shape = (bg.shape[0],) + tuple(grid)
    return bg.reshape((bg.shape[0],) + (1,) * len(grid)).expand(
        shape).contiguous()


def x2_cpu_reference(filled, order, perm, vals):
    """The CPU's `index_add_` of the terms in input order onto the voxels
    they reach, from the background (the stable sort keeps each voxel's
    terms in input order) -> (those voxels, on the card; their sums)."""
    keys = order.cpu()
    terms = vals.cpu()[perm.cpu()]
    live = keys < filled.numel()
    voxels, inv = torch.unique_consecutive(keys[live], return_inverse=True)
    voxels = voxels.long().to(filled.device)
    sums = filled.reshape(-1)[voxels].cpu().index_add_(0, inv, terms[live])
    return voxels, sums


def x2_matches(filled, out, voxels, sums):
    """X2's volume holds `sums` at `voxels` and the background elsewhere."""
    flat = out.reshape(-1)
    rest = flat.clone()
    rest[voxels] = filled.reshape(-1)[voxels]
    return xla_bits(flat[voxels].cpu(), sums) and xla_bits(
        rest, filled.reshape(-1))


def x2_err(filled, out, voxels, sums):
    """X2's largest absolute differences from `x2_cpu_reference` -> (the
    fill's: the background on the voxels no term reaches; the run
    kernel's: `sums` at `voxels`)."""
    flat = out.reshape(-1)
    rest = flat.clone()
    rest[voxels] = filled.reshape(-1)[voxels]
    fill = float((rest - filled.reshape(-1)).abs().max())
    runs = float((flat[voxels].cpu() - sums).abs().max()) \
        if voxels.numel() else 0.0
    return fill, runs


def max_abs_err(got, want):
    """The largest absolute difference over pairs of tensors (integers
    read as float64)."""
    return max(float((a.double() - b.double().to(a.device)).abs().max())
               if a.numel() else 0.0 for a, b in zip(got, want))


class NoScatterCopies:
    """While open, records each call of `index_put_`, `index_add_` and
    `torch.cat`: the card's `xla` path runs none of them."""

    NAMES = ((torch.Tensor, "index_put_"), (torch.Tensor, "index_add_"),
             (torch, "cat"))

    def __enter__(self):
        self.calls, self._real = [], []
        for owner, name in self.NAMES:
            real = getattr(owner, name)
            self._real.append((owner, name, real))

            def spy(*a, _real=real, _name=name, **kw):
                self.calls.append(_name)
                return _real(*a, **kw)

            setattr(owner, name, spy)
        return self

    def __exit__(self, *exc):
        for owner, name, real in self._real:
            setattr(owner, name, real)


def xla_case(dprast_torch, sb, core, dev, name, grid, n_poses, n_points,
             dtype):
    """One [xla path] case: X1, X2 and X3 against their plain versions
    (X1 and X3 on the card and X1 on the CPU too, X2 against the CPU's
    `index_add_`), bit for bit; then `raster` through `auto`, the autograd
    step of all six inputs and `raster_pullback`, each between a reset and
    a read of the launch counts and under `NoScatterCopies`."""
    from dprast_torch.ops import dispatch
    args, g = xla_inputs(grid, n_poses, n_points, dev, dtype)
    pts, rot, tr, bg, ow, pw = args
    five = (pts, rot, tr, ow, pw)
    kern = core.xla_neighbours(grid, *five)
    plain = core._xla_neighbours_plain(grid, *five)
    on_cpu = core._xla_neighbours_plain(grid, *(x.cpu() for x in five))
    flat = [kern[0], kern[1], *kern[2]]
    x1 = all(xla_bits(a, b) for a, b in zip(
        flat, [plain[0], plain[1], *plain[2]]))
    x1_cpu = all(xla_bits(a.cpu(), b) for a, b in zip(
        flat, [on_cpu[0], on_cpu[1], *on_cpu[2]]))
    del plain, on_cpu
    keys, vals, res = kern
    wide = n_poses * math.prod(grid) >= 2 ** 31
    check(keys.dtype == (torch.int64 if wide else torch.int32),
          f"[xla path] {name}: {keys.dtype} keys for B * total = "
          f"{n_poses * math.prod(grid)}")
    order, perm = torch.sort(keys.reshape(-1), stable=True)
    filled = xla_filled(bg, grid)
    out = core.xla_scatter(bg, grid, order, perm, vals.reshape(-1))
    again = core.xla_scatter(bg, grid, order, perm, vals.reshape(-1))
    voxels, sums = x2_cpu_reference(filled, order, perm, vals.reshape(-1))
    x2 = x2_matches(filled, out, voxels, sums) and xla_bits(out, again)
    del again
    scaled, gw = core.xla_gather(grid, g, res, ow, pw)
    scaled_p, gw_p = core._xla_gather_plain(grid, g, res, ow, pw)
    x3 = xla_bits(scaled, scaled_p) and xla_bits(gw, gw_p)
    torch.cuda.synchronize()
    print(f"[xla path] {name}: X1 bit-equal to its plain version on the "
          f"card {x1} and on the CPU {x1_cpu} ({keys.dtype} keys, "
          f"{int((order < filled.numel()).sum())} of {order.numel()} terms "
          f"in the grid); X2 bit-equal to the CPU's index_add_ of the same "
          f"terms onto the background on {voxels.numel()} voxels, the "
          f"background elsewhere, and on a second run {x2}; X3 bit-equal "
          f"to its plain version {x3}")
    check(x1 and x1_cpu and x2 and x3,
          f"[xla path] {name}: X1-X3 bit-equal to their plain versions")
    del kern, keys, vals, res, order, perm, out, filled, scaled, gw, \
        scaled_p, gw_p

    backend = dispatch.resolve("auto", len(grid), grid, n_points,
                               accelerator=True, f64=dtype == torch.float64)
    check(backend == "xla", f"[xla path] {name}: auto takes xla")
    step = six_grad_step(dprast_torch, grid, args, g, True, "auto")
    calls = {"forward": (lambda: dprast_torch.raster(grid, *args),
                         {"xla_neighbours": 1, "xla_scatter": 1}),
             "autograd step": (step, dict.fromkeys(core.XLA_KERNELS, 1)),
             "raster_pullback": (lambda: dprast_torch.raster_pullback(
                 g, *args), {"xla_neighbours": 1, "xla_gather": 1})}
    got = {}
    with NoScatterCopies() as spy:
        for what, (fn, want) in calls.items():
            reset_launches(sb)
            result = fn()
            torch.cuda.synchronize()
            got[what] = ran(sb.LAUNCHES)
            check(got[what] == want, f"[xla path] {name} {what}: launches "
                                     f"{got[what]}, want {want}")
            check(all(bool(torch.isfinite(t).all())
                      for t in flat_outputs(result)),
                  f"[xla path] {name} {what}: finite")
    print(f"[xla path] {name}: auto -> xla; launches "
          + "; ".join(f"{k} {v}" for k, v in got.items())
          + f"; index_put_ / index_add_ / torch.cat calls {spy.calls}")
    check(not spy.calls, f"[xla path] {name}: no index_put_, index_add_ or "
                         f"torch.cat on the card's path")
    return got["autograd step"]


def xla_old_forward(core, grid, args):
    """The forward the card ran before X1-X3: the eager neighbour stage,
    one buffer of B blocks of total + 1 (the last entry of each absorbs
    the out-of-grid terms) and `index_put_` with accumulate."""
    pts, rot, tr, bg, ow, pw = args
    b, total = rot.shape[0], math.prod(grid)
    idx, ws, _, _ = core._neighbour_data(pts, rot, tr, grid)
    w = ws * ow[:, None, None] * pw[None, :, None]
    buf = bg[:, None].expand(b, total + 1).contiguous()
    base = torch.arange(b, device=pts.device)[:, None, None] * (total + 1)
    buf.view(-1).index_put_(((idx + base).reshape(-1),), w.reshape(-1),
                            accumulate=True)
    return buf[:, :total].reshape((b,) + tuple(grid))


def xla_ops(n_in, n_out):
    """X1's rounded fp32 operations per (pose, point), counted from
    `csrc/xla_path.cu` and `twofloat.cuh`: 3 per input axis (the point's
    split); per output axis 20 per input axis (the rotation entry's split
    3, TwoProd 9, TwoSum 6, the lo term 2) and 52 (the scale's split 3,
    the + 1, * scale, - 1/2 and renormalising steps 35, voxel, delta and
    fix-up 13, 1 - dl 1); per shift n_out + 1 (the hat weight's products
    and the term's two)."""
    return 3 * n_in + n_out * (20 * n_in + 52) + 2 ** n_out * (n_out + 1)


def xla_bounds(pts, rot, keys, vals, res, order, perm, total):
    """X1, X2 and X3 on this run's data -> {name: (ms, "bytes" |
    "operations")}: each input read once, each output written once.  X1
    writes the keys, the terms and the residuals (the voxel and deltas).
    X2's fill ("xla_fill") writes the volume once; its run kernel
    ("xla_scatter") reads a key, an index and a term a sorted position and
    writes each voxel it adds to.  X3 reads the residuals, the cotangent at
    each voxel the terms reach, the weights, and writes (B, P, n_out + 1)
    values.  Beside them ("<name> sectors": (count, ms)) the 32-byte
    sectors the function touches where its random accesses take a sector
    apiece: X2's terms read through the permutation and its voxels
    written, X3's cotangent reads (the two neighbours along the last axis
    mostly in one)."""
    r0, dl = res
    bsz, p, n_out = r0.shape
    n_in = rot.shape[2]
    t = dl.element_size()
    live = order < bsz * total
    voxels = torch.unique_consecutive(order[live])
    n_live = int(live.sum())
    x1_bytes = ((pts.numel() + rot.numel() + rot.shape[0] * (n_out + 1) + p)
                * t + keys.numel() * keys.element_size() + vals.numel() * t
                + r0.numel() * 4 + dl.numel() * t)
    x2_reads = order.numel() * (order.element_size() + 8 + t)
    x3_io = r0.numel() * 4 + dl.numel() * t + (bsz + p) * t \
        + bsz * p * (n_out + 1) * t

    def sectors(index, width):
        return int(torch.unique(torch.div(index, 32 // width,
                                          rounding_mode="floor")).numel())

    x2_sectors = (x2_reads // 32 + sectors(perm[live], t)
                  + sectors(voxels.long(), t))
    x3_sectors = x3_io // 32 + sectors(voxels.long(), t)
    return {"xla_neighbours": bound(x1_bytes,
                                    2 * bsz * p * xla_ops(n_in, n_out)),
            "xla_fill": bound(bsz * total * t, 0),
            "xla_scatter": bound(x2_reads + voxels.numel() * t, n_live),
            "xla_gather": bound(x3_io + voxels.numel() * t,
                                bsz * p * 2 ** n_out * (4 * n_out + 4)),
            "xla_scatter sectors": (x2_sectors,
                                    bound(32 * x2_sectors, 0)[0]),
            "xla_gather sectors": (x3_sectors, bound(32 * x3_sectors, 0)[0])}


def us_text(us):
    """A device time for a line of output: "12.34 us" or "not measured"."""
    return "not measured" if us is None else f"{us:.2f} us"


def call_us(fn, names, calls=10):
    """Device us a call of `fn` spends in the kernels whose name holds one
    of `names`: the sum of their `by_kernel` rows (where a call launches
    them more than once, or names several); None where three traces hold
    none."""
    rows = by_kernel(fn, calls, "cuda", names)
    return None if rows is None else sum(row[1] for row in rows)


def of_bound(bound_ms, us):
    """A device time as a share of its bound for a line of output: "47.1%"
    or "not measured"."""
    return ("not measured" if us is None
            else f"{bound_ms * 1e3 / max(us, 1e-9):.1%}")


def xla_times(dprast_torch, sb, core, dev, smi, name, grid, n_poses,
              n_points):
    """A timed row: X1, X2 and X3 alone (wrapper ms, the kernel's device
    us), each held to its plain version at the row (X1 and X3 bit for bit
    against theirs on the card, X2 against the CPU's `index_add_`; the
    measured max-abs error goes into the kernels line), beside their plain
    versions' times on the card and their bounds; X2's fill and run kernel
    each by its device us, X2 beside `index_put_` with accumulate into the
    (B, total + 1) buffer and X3 beside `torch.gather` of a padded
    cotangent at the expanded indices, each one call (its device us too);
    the forward, the fused step and the autograd step with what they keep
    the card busy with, and the fused step's peak memory.  -> {key: value}."""
    args, g = xla_inputs(grid, n_poses, n_points, dev)
    pts, rot, tr, bg, ow, pw = args
    five = (pts, rot, tr, ow, pw)
    keys, vals, res = core.xla_neighbours(grid, *five)
    order, perm = torch.sort(keys.reshape(-1), stable=True)
    flat_vals = vals.reshape(-1)
    total = math.prod(grid)
    b = n_poses
    sink = torch.cat([xla_filled(bg, grid).reshape(b, -1),
                      bg.new_zeros((b, 1))], dim=1).reshape(-1)
    # the (B, total + 1) buffer's index of each term, the sink for an
    # out-of-grid one
    idx = core.expand_residuals(grid, res)[0]
    unsorted = (idx + torch.arange(b, device=dev)[:, None, None]
                * (total + 1)).reshape(-1)
    g_pad = torch.cat([g.reshape(b, -1), g.new_zeros((b, 1))], dim=1)
    gather_idx = idx.reshape(b, -1)
    del idx
    t = {"bounds": xla_bounds(pts, rot, keys, vals, res, order, perm,
                              total)}
    plain = core._xla_neighbours_plain(grid, *five)
    got, want = [keys, vals, *res], [plain[0], plain[1], *plain[2]]
    x1_same = all(xla_bits(a, b) for a, b in zip(got, want))
    errs = {"xla_neighbours": max_abs_err(got, want)}
    del plain, got, want
    filled = xla_filled(bg, grid)
    out = core.xla_scatter(bg, grid, order, perm, flat_vals)
    voxels, sums = x2_cpu_reference(filled, order, perm, flat_vals)
    x2_same = x2_matches(filled, out, voxels, sums)
    errs["xla_fill"], errs["xla_scatter"] = x2_err(filled, out, voxels,
                                                   sums)
    del filled, out, voxels, sums
    got = core.xla_gather(grid, g, res, ow, pw)
    want = core._xla_gather_plain(grid, g, res, ow, pw)
    x3_same = all(xla_bits(a, b) for a, b in zip(got, want))
    errs["xla_gather"] = max_abs_err(got, want)
    del got, want
    torch.cuda.empty_cache()
    print(f"[xla path] {name}: X1 bit-equal to its plain version {x1_same},"
          f" X2 to the CPU's index_add_ {x2_same}, X3 to its plain version "
          f"{x3_same}; max-abs errors "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    check(x1_same and x2_same and x3_same,
          f"[xla path] {name}: X1-X3 bit-equal to their plain versions at "
          f"the timed row")
    fns = {
        "xla_neighbours": (lambda: core.xla_neighbours(grid, *five),
                           lambda: core._xla_neighbours_plain(grid, *five),
                           None),
        "xla_scatter": (lambda: core.xla_scatter(bg, grid, order, perm,
                                                 flat_vals),
                        lambda: core._xla_scatter_plain(bg, grid, order,
                                                        perm, flat_vals),
                        lambda: sink.index_put_((unsorted,), flat_vals,
                                                accumulate=True)),
        "xla_gather": (lambda: core.xla_gather(grid, g, res, ow, pw),
                       lambda: core._xla_gather_plain(grid, g, res, ow, pw),
                       lambda: torch.gather(g_pad, 1, gather_idx))}
    for kname, (kernel_fn, plain_fn, library_fn) in fns.items():
        t[kname] = {
            "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn),
            "dev_us": launch_us(kernel_fn, kname + "_kernel"),
            "library_ms": None if library_fn is None else time_ms(library_fn),
            "max_abs_err": errs[kname]}
    t["xla_scatter"]["library_dev_us"] = launch_us(
        fns["xla_scatter"][2], "indexing_backward_kernel")
    t["xla_gather"]["library_dev_us"] = launch_us(fns["xla_gather"][2],
                                                  "gather")
    # X2's two kernels, each its own entry: the fill, then the runs
    t["xla_fill"] = dict(t["xla_scatter"], library_ms=None,
                         max_abs_err=errs["xla_fill"],
                         dev_us=launch_us(fns["xla_scatter"][0],
                                          "xla_fill_kernel"))
    t["xla_scatter"]["dev_us"] = launch_us(fns["xla_scatter"][0],
                                           "xla_scatter_kernel")
    del sink, unsorted, g_pad, fns
    leaves = [x.clone().requires_grad_() for x in args]

    def fused():
        out, r = core.raster_fwd_res(grid, *args)
        return out, core.raster_pullback_res(grid, r, args, g)

    def autograd():
        out = dprast_torch.raster(grid, *leaves)
        return torch.autograd.grad((out * g).sum(), leaves)

    torch.cuda.synchronize()
    t["resident GB"] = torch.cuda.memory_allocated(dev) / 1e9
    for what, fn in (("forward", lambda: dprast_torch.raster(grid, *args)),
                     ("fused step", fused), ("autograd step", autograd)):
        t[what + " ms"] = time_ms(fn)
        t[what + " busy us"], t[what + " launches"] = device_busy(fn)
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize()
        t[what + " peak GB"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"[xla path] {smi} | {name}: "
          + "; ".join(f"{k} {us_text(v['dev_us'])} on the card (bound "
                      f"{t['bounds'][k][0] * 1e3:.2f} us by "
                      f"{t['bounds'][k][1]}), wrapper {v['ms']:.4f} ms, plain "
                      f"{v['plain_ms']:.4f} ms"
                      + ("" if v["library_ms"] is None else
                         f", one library call {v['library_ms']:.4f} ms")
                      for k, v in ((k, t[k]) for k in core.XLA_KERNELS))
          + f"; X2's fill {us_text(t['xla_fill']['dev_us'])} (bound "
            f"{t['bounds']['xla_fill'][0] * 1e3:.2f} us) and runs "
            f"{us_text(t['xla_scatter']['dev_us'])} (the ms of X2 are "
            f"both's); index_put_'s kernel "
            f"{us_text(t['xla_scatter']['library_dev_us'])} (the library "
            f"call: index_put_ with accumulate into the filled volume); "
            f"torch.gather's {us_text(t['xla_gather']['library_dev_us'])} "
            f"(X3's yardstick: the gathers alone, no products); sectors "
            + "; ".join(f"{k[:-8]} {n} ({ms * 1e3:.2f} us)"
                        for k, (n, ms) in t["bounds"].items()
                        if k.endswith(" sectors"))
            + "; each kernel alone, so X3's gathers find the "
            f"cotangent warm in L2 where the step's do not (by-kernel lines "
            f"below)")
    print(f"[xla path] {smi} | {name}: "
          + "; ".join(f"{what} {t[what + ' ms']:.4f} ms, busy "
                      f"{t[what + ' busy us']:.1f} us in "
                      f"{t[what + ' launches']:.0f} launches, peak "
                      f"{t[what + ' peak GB']:.2f} GB"
                      for what in ("forward", "fused step", "autograd step"))
          + f" (the inputs, the cotangent and the filled volume held "
            f"before: {t['resident GB']:.2f} GB)")
    for what, fn in (("forward", lambda: dprast_torch.raster(grid, *args)),
                     ("fused step", fused)):
        print(f"[xla path] {smi} | {name} {what} by kernel (us, launches): "
              + "; ".join(f"{k[:60]} {us:.1f} x{n:.2f}"
                          for k, us, n in by_kernel(fn, 3, dev) or ()))
    return t


def xla_long_run_inputs(core, dev):
    """The long run's X2 arguments: a 1-D cloud of `XLA_LONG_RUN` points
    in one voxel's span of its grid -> (bg, grid, sorted keys, perm,
    terms)."""
    grid, p = XLA_LONG_RUN
    gen = torch.Generator(device=dev).manual_seed(3)
    pts = 0.1 + 1e-4 * torch.rand((p, 1), generator=gen, device=dev)
    pw = 0.5 + torch.rand(p, generator=gen, device=dev)
    rot = torch.ones((1, 1, 1), device=dev)
    tr, bg, ow = (torch.zeros((1, 1), device=dev),
                  torch.zeros(1, device=dev), torch.ones(1, device=dev))
    keys, vals, _ = core.xla_neighbours(grid, pts, rot, tr, ow, pw,
                                        residuals=False)
    order, perm = torch.sort(keys.reshape(-1), stable=True)
    return bg, grid, order, perm, vals.reshape(-1)


def xla_long_run(core, dev, smi):
    """X2 on the longest run: a 1-D cloud of `XLA_LONG_RUN` points in one
    voxel's span, so two voxels take a run of that many terms each; bit
    for bit against the CPU's `index_add_`, and timed -> (ms, device us a
    launch)."""
    bg, grid, order, perm, vals = xla_long_run_inputs(core, dev)
    filled = xla_filled(bg, grid)
    out = core.xla_scatter(bg, grid, order, perm, vals)
    voxels, sums = x2_cpu_reference(filled, order, perm, vals)
    runs = torch.unique_consecutive(order, return_counts=True)[1]
    same = x2_matches(filled, out, voxels, sums)

    def scatter():
        return core.xla_scatter(bg, grid, order, perm, vals)

    t0 = time.perf_counter()
    scatter()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    ms = time_ms(scatter, reps=5, warmup=1)
    dev_us = launch_us(scatter, "xla_scatter_kernel", calls=3)
    print(f"[xla path] {smi} | X2 on runs of {runs.tolist()} terms ({grid} "
          f"x 1 pose x {order.numel() // 2} points): bit-equal to the CPU's "
          f"index_add_ {same}; {first_s:.3f} s the first call, {ms:.3f} ms; "
          f"the run kernel {us_text(dev_us)} on the card")
    check(same and int(runs.max()) >= 1_000_000,
          "[xla path] X2 adds a run of 10^6 terms in input order")
    check(first_s < 10, "[xla path] X2's longest run takes seconds")
    return ms, dev_us


# X2's run shapes, each against the CPU's `index_add_`: (name, run lengths
# of consecutive voxels of a 1-D grid, poses).  Runs that end one before,
# on and one past a warp's, a carry round's (448) and a block's (1,024)
# positions, runs that fill blocks, and one run across several blocks
XLA_RUN_SHAPES = (
    ("runs across warps and blocks",
     (31, 32, 33, 447, 448, 449, 1023, 1024, 1025, 896, 2000, 1, 1, 5), 2),
    ("every block one run", (1024,) * 12, 1),
    ("one run over blocks", (5000,), 1))


def xla_run_shapes(core, dev, smi):
    """X2's run kernel on hand-made runs (`XLA_RUN_SHAPES`, the terms in a
    shuffled input order so the permutation is no identity, out-of-grid
    keys after them) and on the (4096,) x 1 x 10^6 cloud through X1 (runs
    of ~500 terms), each bit for bit against the CPU's `index_add_`."""
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = []
    for name, lengths, n_poses in XLA_RUN_SHAPES:
        total = len(lengths) // n_poses + 1
        keys = torch.repeat_interleave(
            torch.arange(len(lengths), device=dev),
            torch.tensor(lengths, device=dev))
        keys = torch.cat([keys, torch.full((77,), n_poses * total,
                                           device=dev)])
        keys = keys[torch.randperm(keys.numel(), generator=gen,
                                   device=dev)].to(torch.int32)
        vals = torch.randn(keys.numel(), generator=gen, device=dev) * \
            10 ** (6 * torch.rand(keys.numel(), generator=gen,
                                  device=dev) - 3)
        bg = torch.randn(n_poses, generator=gen, device=dev)
        order, perm = torch.sort(keys, stable=True)
        cases.append((name, bg, (total,), order, perm, vals))
    args, _ = xla_inputs((4096,), 1, 1_000_000, dev)
    pts, rot, tr, bg, ow, pw = args
    keys, vals, _ = core.xla_neighbours((4096,), pts, rot, tr, ow, pw,
                                        residuals=False)
    order, perm = torch.sort(keys.reshape(-1), stable=True)
    cases.append(("(4096,) x 1 x 1e6 cloud", bg, (4096,), order, perm,
                  vals.reshape(-1)))
    for name, bg, grid, order, perm, vals in cases:
        filled = xla_filled(bg, grid)
        out = core.xla_scatter(bg, grid, order, perm, vals)
        voxels, sums = x2_cpu_reference(filled, order, perm, vals)
        same = x2_matches(filled, out, voxels, sums)
        runs = torch.unique_consecutive(order, return_counts=True)[1]
        us = launch_us(lambda: core.xla_scatter(bg, grid, order, perm, vals),
                       "xla_scatter_kernel")
        print(f"[xla path] {smi} | X2 run shape {name}: {order.numel()} "
              f"terms, runs of {int(runs.min())}-{int(runs.max())}; "
              f"bit-equal to the CPU's index_add_ {same}; the run kernel "
              f"{us_text(us)}")
        check(same, f"[xla path] X2 run shape {name}")


def second_derivatives(dprast_torch, args, dirs, dev):
    """The 16 (inner, outer) second derivatives through `raster` on `xla`
    on `dev`: ``d/d outer <d sum(out^2) / d inner, dirs[inner]>``."""
    names = ("points", "rotation", "translation", "background", "out_weight",
             "point_weight")
    got = {}
    for inner in SECOND_FIELDS:
        for outer in SECOND_FIELDS:
            leaves = [torch.from_numpy(a).to(dev).requires_grad_()
                      for a in args]
            out = dprast_torch.raster(SECOND_GRID, *leaves, backend="xla")
            (first,) = torch.autograd.grad(
                (out ** 2).sum(), leaves[names.index(inner)],
                create_graph=True)
            h = (first * torch.from_numpy(dirs[inner]).to(dev)).sum()
            (second,) = torch.autograd.grad(h, leaves[names.index(outer)])
            got[inner, outer] = second.double().cpu()
    return got


def phase_c8(dprast_torch, sb, core, testing, dev):
    """C8 on the card: the 16 second derivatives through `xla` in float32
    on the card against the CPU's float64 run, within `SECOND_TOL` of each
    pair's largest entry.  Each pair's first derivative (a backward under
    ``create_graph=True``) runs the graph-recording form; its derivative
    reaches the forward's output once more through ``d sum(out^2) / d out
    = 2 out``, a first-order backward, which runs X3."""
    fx = testing.fixtures(seed=5, n_points=50, batch_size=2, n_in=3,
                          n_out=2)
    dirs64 = {name: np.random.default_rng(7 + k).standard_normal(
        np.shape(fx[name])) for k, name in enumerate(SECOND_FIELDS)}
    args32 = [np.asarray(v, np.float32) for v in fx.values()]
    dirs32 = {k: v.astype(np.float32) for k, v in dirs64.items()}
    before = core.GRAPH_FORM_CALLS["xla_plain"]
    reset_launches(sb)
    card = second_derivatives(dprast_torch, args32, dirs32, dev)
    torch.cuda.synchronize()
    launched = ran(sb.LAUNCHES)
    graph = core.GRAPH_FORM_CALLS["xla_plain"] - before
    cpu = second_derivatives(dprast_torch, [np.asarray(v, np.float64)
                                            for v in fx.values()],
                             dirs64, "cpu")
    errs = {k: float((card[k] - cpu[k]).abs().max() / cpu[k].abs().max())
            for k in card}
    print(f"[xla path] C8: second derivatives through xla, float32 on the "
          f"card vs float64 on the CPU, max-abs err / the pair's largest "
          f"entry (tol {SECOND_TOL:g}): "
          + ", ".join(f"({i}, {o}) {e:.2e}" for (i, o), e in errs.items())
          + f"; graph-recording pullbacks {graph}, launches {launched}")
    check(max(errs.values()) <= SECOND_TOL,
          "[xla path] C8: second derivatives on the card")
    want = dict.fromkeys(core.XLA_KERNELS, len(card))
    check(graph == len(card) and launched == want,
          f"[xla path] C8: one graph-recording pullback a pair, and the "
          f"launches {want}")


def phase_xla_path(dprast_torch, sb, core, testing, dev, smi):
    """[xla path]: `XLA_CASES`, the long run, the path at `XLA_SMALL`
    against the f64 oracles, the image at 1024cube_1e5 against the form
    it replaced, C8 on the card, and the timed rows `XLA_TIMED`.  ->
    {"launches": the autograd step's launches at 1024cube_1e5, "times":
    {row: xla_times}, "long_run": `xla_long_run`'s}."""
    launches = None
    for case in XLA_CASES:
        got = xla_case(dprast_torch, sb, core, dev, *case)
        if case[0] == "1024cube_1e5":
            launches = got
        torch.cuda.empty_cache()
    long_run = xla_long_run(core, dev, smi)
    xla_run_shapes(core, dev, smi)
    phase_small(dprast_torch, testing, dev, "[xla small]", XLA_SMALL,
                backend="xla")
    args, _ = xla_inputs(*XLA_CASES[0][1:4], dev)
    img = dprast_torch.raster(XLA_CASES[0][1], *args)
    old = xla_old_forward(core, XLA_CASES[0][1], args)
    scale = float(old.abs().max())
    diff = float((img - old).abs().max())
    print(f"[xla path] 1024cube_1e5: image against the index_put_ form it "
          f"replaced: max-abs difference {diff:.3e} of max {scale:.3e} "
          f"(tol 8 eps x max)")
    check(diff <= 8 * torch.finfo(torch.float32).eps * scale,
          "[xla path] 1024cube_1e5 within fp32 rounding of the index_put_ "
          "form")
    del args, img, old
    torch.cuda.empty_cache()
    phase_c8(dprast_torch, sb, core, testing, dev)
    times = {}
    for name, grid, n_poses, n_points in XLA_TIMED:
        times[name] = xla_times(dprast_torch, sb, core, dev, smi, name, grid,
                                n_poses, n_points)
        torch.cuda.empty_cache()
    return {"launches": launches, "times": times, "long_run": long_run}


def xla_path_alone():
    """`python3 chip_smoke.py --xla-path`: the build and [xla path] alone,
    without the lines a whole run ends with."""
    import dprast_torch
    from dprast_torch.ops import _build, core, splat_binned as sb
    from dprast_torch.utils import profiling, testing
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = profiling.card(0)
    print(smi)
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    entry = False
    for ln in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in ln:
            entry = "xla_" in ln
        if entry and ("Compiling entry" in ln or "registers" in ln
                      or "spill" in ln):
            print(f"[build] {ln.strip()}")
    t0 = time.perf_counter()
    phase_xla_path(dprast_torch, sb, core, testing, dev, smi)
    print(f"[xla path] took {time.perf_counter() - t0:.1f} s")


def slot_prep_alone():
    """`python3 chip_smoke.py --slot-prep`: the build, [B9 slot prep] (B9
    and B10), [B7 frame] (the frame gather after B10), [repeat],
    [deterministic] and [no sync] alone, without the lines a whole run
    ends with."""
    import dprast_torch
    from dprast_torch.ops import _build, splat_binned as sb
    from dprast_torch.utils import profiling
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = profiling.card(0)
    print(smi)
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    entry = False
    for ln in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in ln:
            entry = "slot_" in ln or "bin_scatter" in ln
        if entry and ("Compiling entry" in ln or "registers" in ln
                      or "spill" in ln):
            print(f"[build] {ln.strip()}")
    for tag, phase in (
            ("[B9 slot prep]", lambda: phase_slot_prep(sb, dev, smi)),
            ("[B7 frame]", lambda: phase_b7(dprast_torch, sb, dev, smi)),
            ("[repeat]", lambda: phase_repeat(dprast_torch, dev)),
            ("[deterministic]", phase_deterministic),
            ("[no sync]", lambda: phase_no_sync(dprast_torch, dev))):
        t0 = time.perf_counter()
        phase()
        print(f"{tag} took {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": smi}))


def no_sync_alone():
    """`python3 chip_smoke.py --no-sync`: the build and [no sync] alone,
    first with no profiler, then under one that records the host's ranges
    and the card's activity, so that the port's stage spans
    (`profiling.annotate`) open theirs inside every call held."""
    import dprast_torch
    from dprast_torch.ops import _build
    from dprast_torch.utils import profiling
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(profiling.card(0))
    t0 = time.perf_counter()
    _build.load()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    held = phase_no_sync(dprast_torch, dev)
    print(f"[no sync] took {time.perf_counter() - t0:.1f} s")
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        held_on = phase_no_sync(dprast_torch, dev)
    spans = sum(e.count for e in prof.key_averages()
                if e.key.startswith("dprast."))
    check(held_on == held and spans > 0,
          f"[no sync] under the profiler: {held_on} calls, {spans} spans")
    print(f"[no sync] under a recording profiler: {held_on} calls held, "
          f"{spans} program spans recorded; took "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "no_sync_calls": held,
                      "spans_recorded": spans}))


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")
    if sys.argv[1:2] == ["--sharded-worker"]:
        # one process of [sharded]'s 2 x 2 mesh, started by the run itself
        return sharded_worker(int(sys.argv[2]), *sys.argv[3:5])
    if sys.argv[1:2] == ["--deterministic"]:
        # [deterministic]'s process, started by the run itself
        return deterministic_worker()
    if sys.argv[1:2] == ["--xla-path"]:
        # the build and [xla path] alone, for a short call
        return xla_path_alone()
    if sys.argv[1:2] == ["--no-sync"]:
        # the build and [no sync] alone, off and under the profiler
        return no_sync_alone()
    if sys.argv[1:2] == ["--slot-prep"]:
        # the build, B9 and B10 and the phases that hold the path they
        # make, alone
        return slot_prep_alone()

    import dprast_torch
    from dprast_torch.ops import _build, core, splat_binned as sb
    from dprast_torch.utils import profiling, testing

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # --- 1. device ---
    smi = profiling.card(0)
    print(smi)
    kind = torch.cuda.get_device_name(0)
    tf32_mm = torch.backends.cuda.matmul.allow_tf32
    tf32_cudnn = torch.backends.cudnn.allow_tf32
    print(f"[device] {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; allow_tf32 matmul={tf32_mm} "
          f"cudnn={tf32_cudnn}")
    check(tf32_mm is False, "TF32 matmul is off")

    # --- 2. build ---
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "Compiling entry" in ln
             or "spill" in ln]
    print(f"[build] {build_s:.1f} s -> {so.relative_to(ROOT)}")
    b1_sass = sass_atomics(so, _build._nvcc())
    for ln in ptxas + b1_sass:
        print(f"[build] {ln}")
    # B1's fixed-point window adds with native 32-bit integer atomics: no
    # compare-and-swap loop is left in any of its instances
    check(len(b1_sass) == 8 and all("ATOMS.ADD" in ln and "CAS" not in ln
                                    for ln in b1_sass),
          "every B1 instance adds with ATOMS.ADD and no compare-and-swap")

    pts_np, rot_np, tr_np, pw_np = flagship_inputs()
    pts, rot, tr, pw = (torch.from_numpy(a).to(dev)
                        for a in (pts_np, rot_np, tr_np, pw_np))

    # --- 3. B6 against its twin, on the card and on the CPU ---
    coords_err = phase_coords(sb, dev, testing, (pts_np, rot_np, tr_np))

    # --- 4. B1 against its twin on the card ---
    frames = phase_b1(sb, dev, pts, rot, tr, pw, testing, dprast_torch)

    # --- 5. B2 against its twin on the card ---
    rng = np.random.default_rng(1)
    ow = torch.from_numpy(rng.uniform(0.5, 2.0, N_POSES).astype(np.float32)
                          ).to(dev)
    bg = torch.from_numpy((rng.standard_normal(N_POSES) * 0.1).astype(
        np.float32)).to(dev)
    ext_mt = frames[MULTI_TILE, False][1]
    ts_mt = sb.tile_shape_for(MULTI_TILE)
    b2_err = phase_b2(sb, dev, ext_mt, ow, bg)

    # --- 6. B3 against its twin on the card ---
    cots = {grid: torch.from_numpy(
        np.random.default_rng(2).standard_normal((N_POSES,) + grid)
        .astype(np.float32)).to(dev) for grid in GRIDS}
    b3_err = 0.0
    b3_cases = [(MULTI_TILE, cots[MULTI_TILE])] + [
        (grid, torch.randn((3,) + grid, device=dev))
        for grid in ((999, 777), (130, 1)) + tuple(g for g, _, _ in ODD_GRIDS)]
    for grid, g in b3_cases:
        ts = sb.tile_shape_for(grid)
        win_k = sb.band_unfold(g, grid, ts)
        win_p = sb._unfold(g, grid, ts)
        torch.cuda.synchronize()
        err = scaled_err(win_k, win_p)
        b3_err = max(b3_err, err)
        same = torch.equal(win_k, win_p)
        print(f"[B3 band_unfold] {tuple(g.shape)}: windows "
              f"{tuple(win_k.shape)}, bit-equal to twin {same}")
        check(same, f"B3 bit-equal to its twin at {grid}")
        if grid == MULTI_TILE:
            win_mt = win_k
    # the kernel is written for the 128-wide window: another width is
    # refused, not copied by a twin
    try:
        sb.band_unfold(cots[MULTI_TILE][:1], MULTI_TILE, (127, 63))
    except ValueError as exc:
        print(f"[B3 band_unfold] tiles (127, 63) refused: {exc}")
    else:
        check(False, "B3 refuses a window that is not 128 columns wide")

    # --- 7. B4 against its twin on the card ---
    # the forward's residual frames (an empty tile keeps a slot) and, at
    # 1024^2, the standalone pullback's frame (it does not)
    b4_cases = []
    for grid in GRIDS:
        _, _, data = frames[grid, False]
        st = frames[grid, False][0][0]
        chunk = sb._default_chunk(grid, N_POINTS)
        b4_cases.append((grid, "forward frame", data, st, chunk))
    data_s, st_s, chunk_s = sb._bwd_frame(MULTI_TILE, pts, rot, tr)
    b4_cases.append((MULTI_TILE, "standalone frame", data_s, st_s, chunk_s))
    grid_cases = []
    for grid, label, data, st, chunk in b4_cases:
        lane_b = sb._planes_bwd(data[:, :2],
                                sb.tile_shape_for(grid)).contiguous()
        win = win_mt if grid == MULTI_TILE else cots[grid]
        grid_cases.append((grid, label, st, lane_b, cots[grid], chunk))
        buf_k = sb.bwd_gather(st, lane_b, win, chunk)
        buf_p = sb._bwd_gather_plain(st, lane_b, win, chunk)
        torch.cuda.synchronize()
        err = scaled_err(buf_k, buf_p)
        print(f"[B4 bwd_gather] {grid} {label}: rows {tuple(buf_k.shape)}, "
              f"scaled max-abs err vs twin {err:.3e} (tol 1e-6), bit-equal "
              f"{torch.equal(buf_k, buf_p)}")
        check(err <= 1e-6, f"B4 vs twin at {grid} ({label})")

    # --- 7b. B4's grid source: the window cut out of the cotangent ---
    phase_b4_grid(sb, dev, grid_cases)

    # --- 7c. B7: the frame writers, and B1 and B4 on the frame ---
    b7 = phase_b7(dprast_torch, sb, dev, smi)

    # --- 7d. B9: the binning sort's preparation ---
    t0 = time.perf_counter()
    slot_prep = phase_slot_prep(sb, dev, smi)
    print(f"[B9 slot prep] took {time.perf_counter() - t0:.1f} s")

    # --- 7e. B8: the pullback's epilogue ---
    t0 = time.perf_counter()
    b8 = phase_b8(sb, dev, smi)
    print(f"[B8 epilogue] took {time.perf_counter() - t0:.1f} s")

    # --- 8. the forward path: raster through auto ---
    reset_launches(sb)
    img_flag = dprast_torch.raster(FLAGSHIP, pts, rot, tr)
    torch.cuda.synchronize()
    after_flag = dict(sb.LAUNCHES)
    img_mt = dprast_torch.raster(MULTI_TILE, pts, rot, tr)
    torch.cuda.synchronize()
    launches = dict(sb.LAUNCHES)
    print(f"[main] launches: {FLAGSHIP} {ran(after_flag)}; {MULTI_TILE} "
          f"{ran({k: launches[k] - after_flag[k] for k in launches})}")
    check(after_flag["fwd_splat_enc"] >= 1, "B1 ran on the flagship forward")
    check(launches["fwd_splat_enc"] > after_flag["fwd_splat_enc"],
          "B1 ran on the 1024^2 forward")
    check(launches["band_fold"] > after_flag["band_fold"],
          "B2 ran on the 1024^2 forward")
    for grid, img in ((FLAGSHIP, img_flag), (MULTI_TILE, img_mt)):
        check(img.shape == (N_POSES,) + grid and img.dtype == torch.float32,
              f"image shape at {grid}")
        check(bool(torch.isfinite(img).all()), f"finite image at {grid}")
        ref = dprast_torch.raster(grid, pts, rot, tr, backend="xla")
        err = scaled_err(img, ref)
        print(f"[main] auto {grid}: image {tuple(img.shape)}, sum "
              f"{float(img.double().sum()):.6e}, scaled max-abs err vs the "
              f"xla oracle backend {err:.3e} (tol 2e-5)")
        check(err <= 2e-5, f"auto vs xla at {grid}")

    # --- 9. the training path: autograd through auto ---
    train_launches = {name: 0 for name in sb.LAUNCHES}
    phase_train(dprast_torch, sb, pts, rot, tr, pw, cots, train_launches)

    # --- 10. small configurations vs the f64 oracles ---
    # (999, 777) and (130, 1) have rows that are no multiple of 16 bytes:
    # there B4's grid source stages with plain loads (the `_ldg` counters)
    reset_launches(sb)
    phase_small(dprast_torch, testing, dev, "[small]",
                [(grid, 3, 1500, 4) for grid in SMALL_GRIDS])
    phase_small(dprast_torch, testing, dev, "[small bf16]",
                [((999, 777), 3, 1500, 4)], backend="binned_bf16",
                tol=BF16_TOL)
    small_launches = dict(sb.LAUNCHES)
    print(f"[small] launches: {ran(small_launches)}")
    for name in ("bwd_gather_grid_enc", "bwd_gather_grid_enc_ldg",
                 "bwd_gather_grid_bf16_enc_ldg", *EPILOGUE_TILE,
                 *EPILOGUE_TILES):
        check(small_launches[name] >= 1, f"{name} ran in [small]")
    check(small_launches["band_unfold"] == 0, "B3 did not run in [small]")

    # --- 11. a few SGD steps of a fit at the flagship width ---
    phase_fit(dprast_torch, pts, rot, tr)

    # --- 12. the 3-D path at 128^3, and small volumes vs the f64 oracles ---
    launches_3d = phase_3d(dprast_torch, sb, dev)
    phase_small(dprast_torch, testing, dev, "[3d small]",
                [(grid, seed, n, 2) for grid, seed, n in SMALL_VOLUMES])

    # --- 13. times ---
    ms = {}
    canon = (pts, rot, tr, torch.zeros(N_POSES, device=dev),
             torch.ones(N_POSES, device=dev),
             torch.ones(N_POINTS, device=dev))
    # (B1 and B4 on the frame, and the frame writers, are timed in
    # [B7 frame])
    for grid in GRIDS:
        g = cots[grid]
        chunk = sb._default_chunk(grid, N_POINTS)
        (ms["keys", grid], ms["keys_plain", grid], ms["keys_dev_us", grid],
         _, _) = coords_in_turns(
            sb, smi, f"{grid} x {N_POSES} poses x {N_POINTS} points", grid,
            (pts, rot, tr))
        ms["frame", grid] = time_ms(lambda: sb._fwd_prep(
            grid, pts, rot, tr, canon[5], True))
        ms["fwd", grid] = time_ms(lambda: dprast_torch.raster(grid, pts, rot,
                                                              tr))
        ms["fwd_plain", grid] = time_ms(lambda: sb._fwd_impl(
            grid, *canon, pw_uniform=True, coords=sb._keys_and_local_plain,
            splat=sb._fwd_splat_enc_plain, fold=sb._band_fold_plain))
        ms["fwd_xla", grid] = time_ms(lambda: dprast_torch.raster(
            grid, pts, rot, tr, backend="xla"))

        # the backward's stages, on the standalone pullback's frame
        data_b, st_b, _ = sb._bwd_frame(grid, pts, rot, tr)
        ms["bwd_frame", grid] = time_ms(
            lambda: sb._bwd_frame(grid, pts, rot, tr))
        if grid == MULTI_TILE:
            buf = sb.bwd_gather_enc(st_b, data_b[:, :2], ts_mt, g, chunk,
                                    layout="grid")
            ms["b3", grid] = time_ms(
                lambda: sb.band_unfold(g, grid, ts_mt))
            ms["b3_plain", grid] = time_ms(
                lambda: sb._unfold(g, grid, ts_mt))
            ms["epilogue", grid] = time_ms(lambda: sb.pullback_epilogue(
                grid, buf, data_b[:, 2], *canon[:2], *canon[4:],
                pw_uniform=True))
        ms["pullback", grid] = time_ms(
            lambda: sb.raster_pullback(grid, *canon, g, pw_uniform=True))
        fwd_res = sb.raster_fwd_res(grid, *canon, pw_uniform=True)[1]
        ms["pullback_res", grid] = time_ms(
            lambda: sb.raster_pullback_res(grid, fwd_res, canon, g,
                                           pw_uniform=True))

        def step():
            _, res = sb.raster_fwd_res(grid, *canon, pw_uniform=True)
            return sb.raster_pullback_res(grid, res, canon, g,
                                          pw_uniform=True)

        if grid == MULTI_TILE:
            def pullback_b3(res):
                # the route through the unfold stage: B3 writes the
                # windows, B4's natural instance reads them
                coord, idx_rows, st = sb._residual_planes(res, True)
                return sb._pullback_from_frame(
                    grid, coord, idx_rows, st, pts, rot, canon[4], canon[5],
                    g, chunk=chunk, pw_uniform=True, unfold=sb.band_unfold)

            def step_b3():
                return pullback_b3(sb.raster_fwd_res(grid, *canon,
                                                     pw_uniform=True)[1])

            # B4 on the forward's frame, as the fused pair runs it
            args_f, _, data_f = frames[grid, False]
            st_f, coord_f = args_f[0], data_f[:, :2]
            routes_in_turns(smi, ms, {
                "b4_route": (
                    lambda: sb.bwd_gather_enc(st_f, coord_f, ts_mt,
                                              sb.band_unfold(g, grid, ts_mt),
                                              chunk),
                    lambda: sb.bwd_gather_enc(st_f, coord_f, ts_mt, g, chunk,
                                              layout="grid")),
                "pullback_res": (lambda: pullback_b3(fwd_res),
                                 lambda: sb.raster_pullback_res(
                                     grid, fwd_res, canon, g,
                                     pw_uniform=True)),
                "step": (step_b3, step)})

        def step_twins():
            _, res = sb._fwd_impl(grid, *canon, pw_uniform=True,
                                  with_residuals=True,
                                  coords=sb._keys_and_local_plain,
                                  splat=sb._fwd_splat_enc_plain,
                                  fold=sb._band_fold_plain)
            coord, idx_rows, st = sb._residual_planes(res, True)
            return sb._pullback_from_frame(
                grid, coord, idx_rows, st, pts, rot, canon[4], canon[5], g,
                chunk=chunk, pw_uniform=True, unfold=sb._unfold,
                gather=sb._bwd_gather_enc_plain, epilogue=sb._epilogue_plain)

        pts_req = pts.clone().requires_grad_()

        def step_autograd():
            out = dprast_torch.raster(grid, pts_req, rot, tr)
            return torch.autograd.grad((out * g).sum(), pts_req)

        ms["step", grid] = time_ms(step)
        ms["step_busy_us", grid], ms["step_kernels", grid] = device_busy(step)
        ms["fwd_busy_us", grid], ms["fwd_kernels", grid] = device_busy(
            lambda: sb.raster_fwd(grid, *canon, pw_uniform=True))
        ms["step_plain", grid] = time_ms(step_twins)
        ms["step_autograd", grid] = time_ms(step_autograd)
        ms["step_xla", grid] = time_ms(lambda: core.raster_pullback_res(
            grid, core.raster_fwd_res(grid, *canon)[1], canon, g))
    ms["b2", MULTI_TILE] = time_ms(
        lambda: sb.band_fold(ext_mt, MULTI_TILE, ts_mt, ow, bg))
    ms["b2_plain", MULTI_TILE] = time_ms(
        lambda: sb._band_fold_plain(ext_mt, MULTI_TILE, ts_mt, ow, bg))
    ms["b2_dev_us"] = launch_us(
        lambda: sb.band_fold(ext_mt, MULTI_TILE, ts_mt, ow, bg),
        "band_fold_kernel")
    # B3 launches once a call; its time a call is printed beside a
    # launch's because here a trace has held two B3 rows a call (a launch
    # read half) and, in another run, lost some (a call read short)
    b3_call = functools.partial(sb.band_unfold, cots[MULTI_TILE], MULTI_TILE,
                                ts_mt)
    ms["b3_dev_us"] = launch_us(b3_call, "band_unfold_kernel")
    ms["b3_call_us"] = call_us(b3_call, "band_unfold_kernel")
    b3_bound = copy_bound(cots[MULTI_TILE], win_mt)
    # the library routes to what B2 and B3 compute, timed once each and
    # used nowhere in the package
    lib_fold = fold_library(ext_mt, MULTI_TILE, ts_mt, ow, bg)
    lib_unfold = unfold_library(cots[MULTI_TILE], MULTI_TILE, ts_mt)
    torch.cuda.synchronize()
    check(scaled_err(lib_fold, sb.band_fold(ext_mt, MULTI_TILE, ts_mt, ow,
                                            bg)) <= 1e-6,
          "the F.fold route computes what B2 computes")
    check(torch.equal(lib_unfold, win_mt),
          "the F.unfold route computes what B3 computes")
    del lib_fold, lib_unfold
    ms["b2_library"] = time_ms(
        lambda: fold_library(ext_mt, MULTI_TILE, ts_mt, ow, bg), reps=5,
        warmup=1)
    ms["b3_library"] = time_ms(
        lambda: unfold_library(cots[MULTI_TILE], MULTI_TILE, ts_mt), reps=5,
        warmup=1)
    for grid in GRIDS:
        print(f"[times] {smi} | {grid} x {N_POSES} poses x {N_POINTS} "
              f"points, uniform weights, median ms: keys (B6) "
              f"{ms['keys', grid]:.4f} (twin {ms['keys_plain', grid]:.4f}), "
              f"frame {ms['frame', grid]:.4f}, forward {ms['fwd', grid]:.4f} "
              f"(with twins {ms['fwd_plain', grid]:.4f}, xla backend "
              f"{ms['fwd_xla', grid]:.4f}); the forward keeps the card busy "
              f"{ms['fwd_busy_us', grid]:.1f} us in "
              f"{ms['fwd_kernels', grid]:.0f} kernels and copies")
        b3 = (f", B3 {ms['b3', grid]:.4f} (twin {ms['b3_plain', grid]:.4f})"
              f", epilogue (B8) {ms['epilogue', grid]:.4f}"
              if grid == MULTI_TILE
              else "")
        print(f"[times] {smi} | {grid} backward, median ms: frame "
              f"{ms['bwd_frame', grid]:.4f}{b3}, standalone pullback "
              f"{ms['pullback', grid]:.4f}, pullback from the forward's "
              f"frame {ms['pullback_res', grid]:.4f}")
        rate = N_POINTS * N_POSES * 4 / (ms["step", grid] * 1e-3)
        print(f"[times] {smi} | {grid} training step, median ms: fused "
              f"forward + pullback {ms['step', grid]:.4f} ({rate:.4e} "
              f"points*splats/s), with twins {ms['step_plain', grid]:.4f}, "
              f"through autograd {ms['step_autograd', grid]:.4f}, xla "
              f"backend {ms['step_xla', grid]:.4f}; the fused step keeps the "
              f"card busy {ms['step_busy_us', grid]:.1f} us in "
              f"{ms['step_kernels', grid]:.0f} kernels and copies "
              f"(torch.profiler): idle "
              f"{1 - ms['step_busy_us', grid] / ms['step', grid] / 1e3:.1%} "
              f"of the step")
    print(f"[times] {smi} | B2 {MULTI_TILE}: {ms['b2', MULTI_TILE]:.4f} ms "
          f"(twin {ms['b2_plain', MULTI_TILE]:.4f} ms, the F.fold route "
          f"{ms['b2_library']:.4f} ms), kernel device "
          f"{us_text(ms['b2_dev_us'])}; B3 {ms['b3', MULTI_TILE]:.4f} ms "
          f"(twin {ms['b3_plain', MULTI_TILE]:.4f} ms, the F.unfold route "
          f"{ms['b3_library']:.4f} ms), kernel device "
          f"{us_text(ms['b3_dev_us'])} a launch ("
          f"{us_text(ms['b3_call_us'])} a call), "
          f"{of_bound(b3_bound[0], ms['b3_dev_us'])} of its "
          f"{b3_bound[0] * 1e3:.1f} us bound")
    ms_3d = times_3d(dprast_torch, sb, core, dev, smi)

    # --- 14. the binned_bf16 fast mode ---
    launches_bf16, ms_bf16 = phase_bf16(dprast_torch, sb, dev, smi, pts, rot,
                                        tr, pw, cots)

    # --- 15. the stage profiler: B1 and B4 launched alone ---
    prof = phase_profile(sb, dev, smi)

    # --- 16. the gather experiments: B4 in three window layouts ---
    exp = phase_exp(sb, dev, smi)

    # --- 17. the small grids: auto -> the matmul backend ---
    phase_matmul(dprast_torch, sb, dev, smi, testing, pts, rot,
                 tr, pw)

    # --- 18. the single-card examples ---
    phase_examples(dprast_torch, sb, dev)

    # --- 19. the distribution layer: 1 x 1 here, 2 x 2 in four workers ---
    sharded_launches, worker_launches = phase_sharded(
        dprast_torch, sb, smi, pts, rot, tr, pw, cots)

    # --- 20. past 65,535 poses and grid rows ---
    t0 = time.perf_counter()
    poses_launches = phase_poses(dprast_torch, sb, dev, smi)
    print(f"[poses] took {time.perf_counter() - t0:.1f} s")

    # --- 20b. the `xla` path's kernels X1-X3 ---
    t0 = time.perf_counter()
    xla = phase_xla_path(dprast_torch, sb, core, testing, dev, smi)
    print(f"[xla path] took {time.perf_counter() - t0:.1f} s")

    # --- 21. no host sync on the card's path; the benchmark entry points;
    # the on-card parity suite ---
    for tag, phase in (("[no sync]", lambda: phase_no_sync(dprast_torch, dev)),
                       ("[repeat]", lambda: phase_repeat(dprast_torch, dev)),
                       ("[deterministic]", phase_deterministic),
                       ("[bench]", phase_bench), ("[run]", phase_run),
                       ("[tests_gpu]", phase_tests_gpu)):
        t0 = time.perf_counter()
        phase()
        print(f"{tag} took {time.perf_counter() - t0:.1f} s")

    src = "dprast/ops/splat_binned.py"
    fwd_cu = "dprast_torch/csrc/fwd_splat.cu"
    bwd_cu = "dprast_torch/csrc/bwd_gather.cu"

    def kernel(name, source, replaces, launches, err, k_ms, plain_ms, bound_,
               shape, *, variant=None, device_us=None, library_ms=None):
        """One entry of the `kernels` line; B1 and B4 have no library
        call that computes them."""
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches,
                 "max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms,
                 "bound_ms": bound_[0], "bound_by": bound_[1],
                 "library_ms": library_ms, "shape": shape}
        if variant is not None:
            entry["variant"] = variant
        if device_us is not None:
            entry["device_us"] = device_us
        return entry

    flag = "128x128, 64 poses, 1e5 points, uniform"
    mt = "1024x1024, 64 poses, 1e5 points, uniform"
    vol = "128x128x128, 1 pose, 1e6 points, uniform"
    n_vol = VOLUME_TIMED[0]
    b7_shape = {grid: f"{'x'.join(map(str, grid))}, {n_poses} poses, "
                      f"{n_points:.0e} points, uniform".replace("e+0", "e")
                for grid, n_poses, n_points in B7_CASES}

    def b7_kernel(grid, name, source, replaces, counted, *, variant,
                  err=None):
        """An entry of a kernel timed in [B7 frame] at `grid`."""
        t = b7["times"][grid, name]
        return kernel(name, source, replaces, counted[name],
                      b7["errs"][name] if err is None else err, t["ms"],
                      t["plain_ms"], t["bound"], b7_shape[grid],
                      variant=variant, device_us=t["dev_us"],
                      library_ms=t.get("library_ms"))

    def b1_variant(n_poses, grid, terms):
        size = sb._b1_cluster(dev, n_poses, sb.n_tiles(grid),
                              sb._window(grid), terms, encoded=True)
        return (f"terms={terms}, reads the encoded frame; thread-block "
                f"cluster of {size}")

    coords_cu = "dprast_torch/csrc/coords.cu"
    gather_cu = "dprast_torch/csrc/frame_gather.cu"
    coords_variant = ("{} unfused operations per (pose, point); bit-equal to "
                      "its twin on the card and on the CPU ([B6 coords])")
    kernels = [
        b7_kernel(FLAGSHIP, "coords", coords_cu, f"{src}:189, :391",
                  train_launches,
                  err=max(coords_err[FLAGSHIP], b7["errs"]["frame"]),
                  variant=coords_variant.format(coords_ops(3, 2))
                  + "; writes the single tile's frame and slot table "
                    "(direct_frame, bit-equal to _prep_direct)"),
        kernel("coords", coords_cu, f"{src}:189", train_launches["coords"],
               coords_err[MULTI_TILE], ms["keys", MULTI_TILE],
               ms["keys_plain", MULTI_TILE], coords_bound(pts, rot, tr), mt,
               variant=coords_variant.format(coords_ops(3, 2)),
               device_us=ms["keys_dev_us", MULTI_TILE]),
        kernel("coords", coords_cu, f"{src}:189", launches_3d["coords"],
               coords_err[VOLUME], ms_3d["keys", n_vol],
               ms_3d["keys_plain", n_vol], ms_3d["keys_bound", n_vol], vol,
               variant=coords_variant.format(coords_ops(3, 3)),
               device_us=ms_3d["keys_dev_us", n_vol]),
        kernel("band_fold", "dprast_torch/csrc/band_fold.cu", f"{src}:687",
               train_launches["band_fold"], b2_err, ms["b2", MULTI_TILE],
               ms["b2_plain", MULTI_TILE],
               copy_bound(ext_mt, cots[MULTI_TILE], ops_per_out=2),
               "1024x1024, 64 poses", device_us=ms["b2_dev_us"],
               library_ms=ms["b2_library"]),
        kernel("band_unfold", "dprast_torch/csrc/band_unfold.cu",
               f"{src}:836", prof[MULTI_TILE]["launched"]["band_unfold"],
               b3_err,
               ms["b3", MULTI_TILE], ms["b3_plain", MULTI_TILE],
               b3_bound, "1024x1024, 64 poses",
               variant="the unfold stage of profile_binned and exp_band; no "
                       "launch in the training step, where B4 reads the "
                       "cotangent",
               device_us=ms["b3_dev_us"], library_ms=ms["b3_library"]),
    ]
    # the frame gather after the sort (replaces the per-plane gathers and
    # the stack of `_prep_binned`, which XLA fuses)
    for grid, counted in ((MULTI_TILE, train_launches),
                          (VOLUME, launches_3d)):
        entry = b7_kernel(
            grid, "frame_gather", gather_cu, f"{src}:334-346", counted,
            err=b7["errs"]["frame"],
            variant="writes the multi-tile frame after B10 from "
                    "the packed sorted keys and B6's interleaved planes; "
                    "bit-equal to _prep_binned; library_ms is one "
                    "torch.gather of a prepared table")
        entry["library_busy_us"] = b7["times"][grid, "frame_gather"][
            "library_busy_us"]
        kernels.append(entry)
    # B9, the binning sort's preparation (replaces `_prep_binned`'s count,
    # offsets, filler keys, packed keys and slot table, which XLA fuses)
    for grid, counted, shape in ((MULTI_TILE, train_launches, mt),
                                 (VOLUME, launches_3d, vol)):
        t = slot_prep[grid]["b9"]
        entry = kernel(
            "slot_prep", "dprast_torch/csrc/slot_prep.cu", f"{src}:279-353",
            counted["slot_prep"], 0.0, t["ms"], t["plain_ms"], t["bound"],
            shape,
            variant="two kernels (the counts of each stretch of keys; their "
                    "prefix, the bases, and the slot table); bit-equal to "
                    "the eager _slot_prep_plain and _bases_plain; "
                    "library_ms is the ranged histc of the count alone",
            device_us=t["dev_us"], library_ms=t["library_ms"])
        entry.update(count_us=t["count_us"], scan_us=t["scan_us"],
                     busy_us=t["busy_us"], plain_busy_us=t["plain_busy_us"],
                     library_busy_us=t["library_busy_us"])
        kernels.append(entry)
    # B10, the binning sort as a counting scatter (replaces the sort of
    # `_prep_binned`, which the port ran as torch.sort)
    for grid, counted, shape in ((MULTI_TILE, train_launches, mt),
                                 (VOLUME, launches_3d, vol)):
        t = slot_prep[grid]["b10"]
        entry = kernel(
            "bin_scatter", "dprast_torch/csrc/bin_scatter.cu",
            f"{src}:322-333", counted["bin_scatter"], 0.0, t["ms"],
            t["plain_ms"], t["bound"], shape,
            variant="the sorted frame keys written to their places from "
                    "B9's counts and bases; bit-equal to torch.sort, which "
                    "is both its plain version and library_ms",
            device_us=t["dev_us"], library_ms=t["library_ms"])
        entry.update(busy_us=t["busy_us"], plain_busy_us=t["plain_busy_us"])
        kernels.append(entry)
    # B8, the pullback's epilogue (replaces the XLA code after B4's
    # `pallas_call`, which XLA fuses), at the main path's three shapes:
    # each kernel that runs there
    for grid, counted, shape in ((FLAGSHIP, train_launches, flag),
                                 (MULTI_TILE, train_launches, mt),
                                 (VOLUME, launches_3d, vol)):
        t = b8["times"][grid, False]
        for name, us in t["dev_us"].items():
            entry = kernel(
                name, "dprast_torch/csrc/epilogue.cu", f"{src}:1355-1423",
                counted[name], b8["err"], None if us is None else us / 1e3,
                t["plain_ms"], t["bounds"][name], shape,
                variant="bit-equal to _epilogue_fixed_plain; max_abs_err "
                        "against the torch form _epilogue_plain; ms is "
                        "this kernel's device time, plain_ms the whole "
                        "torch form's, epilogue_ms all the epilogue's "
                        "launches' and function_bound_ms the bound of the "
                        "epilogue as a whole",
                device_us=us)
            entry["epilogue_ms"] = t["ms"]
            entry["function_bound_ms"] = t["bounds"]["function"][0]
            kernels.append(entry)
    # B1 and B4 on the frame: the main path's instances (2-D at 128^2 and
    # 1024^2, 3-D at 128^3; the fast mode's at terms=1), and the grid
    # source's plain-load staging, which [small] drives
    grid_variant = ("terms={}, window cut out of the cotangent (replaces "
                    "`_unfold_pl_2d` + `_bwd_kernel`), {}")
    for grid, name, counted, line, variant in (
            (FLAGSHIP, "fwd_splat_enc", train_launches, 538,
             b1_variant(N_POSES, FLAGSHIP, 0)),
            (MULTI_TILE, "fwd_splat_enc", train_launches, 538,
             b1_variant(N_POSES, MULTI_TILE, 0)),
            (FLAGSHIP, "fwd_splat_bf16_enc", launches_bf16, 538,
             b1_variant(N_POSES, FLAGSHIP, 1)),
            (MULTI_TILE, "fwd_splat_bf16_enc", launches_bf16, 538,
             b1_variant(N_POSES, MULTI_TILE, 1)),
            (VOLUME, "fwd_splat_3d_enc", launches_3d, 584,
             b1_variant(1, VOLUME, 0)),
            (VOLUME, "fwd_splat_3d_bf16_enc", launches_bf16, 584,
             b1_variant(1, VOLUME, 1)),
            (FLAGSHIP, "bwd_gather_enc", train_launches, 1085,
             "terms=0, reads the encoded frame"),
            (FLAGSHIP, "bwd_gather_bf16_enc", launches_bf16, 1085,
             "terms=1, reads the encoded frame"),
            (VOLUME, "bwd_gather_3d_enc", launches_3d, 1135,
             "terms=0, reads the encoded frame, makes the flat rows"),
            (VOLUME, "bwd_gather_3d_bf16_enc", launches_bf16, 1135,
             "terms=1, reads the encoded frame, makes the flat rows"),
            (MULTI_TILE, "bwd_gather_grid_enc", train_launches, 1085,
             grid_variant.format(0, "TMA tiled load")),
            (MULTI_TILE, "bwd_gather_grid_bf16_enc", launches_bf16, 1085,
             grid_variant.format(1, "TMA tiled load")),
            ((1023, 1021), "bwd_gather_grid_enc_ldg", small_launches, 1085,
             grid_variant.format(0, "plain loads")),
            ((1023, 1021), "bwd_gather_grid_bf16_enc_ldg", small_launches,
             1085, grid_variant.format(1, "plain loads"))):
        cu = fwd_cu if name.startswith("fwd") else bwd_cu
        kernels.append(b7_kernel(grid, name, cu, f"{src}:{line}", counted,
                                 variant=variant))
    for grid, shape, dims in (
            ((1024, 1024), "1024x1024, 64 poses, 1e5 points, weighted", ""),
            (VOLUME, "128x128x128, 1 pose, 1e6 points, weighted", "_3d")):
        kernels += [
            kernel(f"{name}{dims}", cu, f"benchmarks/profile_binned.py:{line}",
                   prof[grid]["launched"][f"{name}{dims}"],
                   prof[grid][f"{stage}_err"], prof[grid][f"{stage}_ms"],
                   prof[grid][f"{stage}_plain"], prof[grid][f"{stage}_bound"],
                   shape, variant="standalone (profile_binned)",
                   device_us=prof[grid][f"{stage}_dev_us"])
            for stage, name, cu, line in (("b1", "fwd_splat", fwd_cu, 131),
                                          ("b4", "bwd_gather", bwd_cu, 195))]
    band = "1024x1024, 64 poses, 1e5 points"
    for key, replaces, variant, shape in (
            (("xsel", "bwd_gather_split_t"), "benchmarks/exp_xsel.py:38",
             "terms=2, transposed cotangent (_kernel_absums)",
             "128x128, 64 poses, 1e5 points"),
            (("band", "bwd_gather_split"), "benchmarks/exp_band.py:36",
             "terms=2, natural windows (transposed=False)", band),
            (("band", "bwd_gather_split_t"), "benchmarks/exp_band.py:36",
             "terms=2, transposed windows (transposed=True)", band),
            (("band", "bwd_gather_presplit"), "benchmarks/exp_band.py:91",
             "terms=2, presplit bf16 windows", band)):
        launched, err, k_ms, plain_ms, bound_, dev_us = exp[key]
        kernels.append(kernel(key[1], bwd_cu, replaces, launched, err, k_ms,
                              plain_ms, bound_, shape, variant=variant,
                              device_us=dev_us))
    # the `xla` path's kernels (replace the device code XLA compiles
    # `dprast/ops/core.py` into), at the timed rows; launches from the
    # autograd step through `auto` at 1024cube_1e5
    xla_cu = "dprast_torch/csrc/xla_path.cu"
    xla_src = "dprast/ops/core.py"
    xla_lines = {"xla_neighbours": f"{xla_src}:44-70",
                 "xla_fill": f"{xla_src}:103-112",
                 "xla_scatter": f"{xla_src}:103-112",
                 "xla_gather": f"{xla_src}:160-193"}
    xla_variant = {
        "xla_neighbours": "X1: keys, terms and the fused pair's residuals "
                          "(each point's voxel and deltas); bit-equal to "
                          "_xla_neighbours_plain",
        "xla_fill": "X2's fill: each pose's background over the volume, "
                    "launched by the xla_scatter wrapper with the run "
                    "kernel (its count); ms and plain_ms are the whole "
                    "X2 call's",
        "xla_scatter": "X2's run kernel: a block's 1,024 sorted positions "
                       "staged in shared memory, each run walked by its "
                       "head from the pose's background, the run past the "
                       "block finished by the block; bit-equal to the CPU's "
                       "index_add_; ms is the whole X2 call's; library_ms "
                       "is index_put_ with accumulate into the filled "
                       "volume",
        "xla_gather": "X3: each point's neighbours made from its voxel and "
                      "deltas, the cotangent read in place, all 2^N reads "
                      "first; bit-equal to _xla_gather_plain; library_ms "
                      "is torch.gather of a padded cotangent at the "
                      "expanded indices (library_device_us its device "
                      "time)"}
    xla_counter = {"xla_fill": "xla_scatter"}
    for row, t in xla["times"].items():
        for name in xla_lines:
            entry = kernel(name, xla_cu, xla_lines[name],
                           xla["launches"][xla_counter.get(name, name)],
                           t[name]["max_abs_err"], t[name]["ms"],
                           t[name]["plain_ms"], t["bounds"][name],
                           f"{row}, per-point weights",
                           variant=xla_variant[name],
                           device_us=t[name]["dev_us"],
                           library_ms=t[name]["library_ms"])
            if name in ("xla_scatter", "xla_gather"):
                sectors, sector_ms = t["bounds"][name + " sectors"]
                entry.update(sectors=sectors, sector_bound_ms=sector_ms,
                             library_device_us=t[name]["library_dev_us"])
            if name == "xla_scatter":
                # the run of 1.2 x 10^6 terms
                entry.update(long_run_device_us=xla["long_run"][1])
            kernels.append(entry)
    # [sharded] is a main path too: its 1 x 1 mesh, driven in this
    # process between a reset and a read of the counts, adds to `launches`;
    # the four workers' own counts stand beside it
    for entry in kernels:
        if (entry["replaces"].startswith(src) and entry["shape"] != vol
                and sharded_launches.get(entry["name"])):
            entry["launches"] += sharded_launches[entry["name"]]
            entry["launches_sharded_workers"] = worker_launches[
                entry["name"]]
    for entry in kernels:
        check(entry["launches"] >= 1,
              f"{entry['name']} ({entry['shape']}) was launched on its path")
        # its launches past 65,535 poses or grid rows ([poses], [poses rows])
        entry["launches_poses"] = poses_launches.get(entry["name"], 0)
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
