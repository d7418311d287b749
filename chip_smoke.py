"""Smoke run of dprast_torch on one CUDA card.

Builds the port's CUDA kernels from `dprast_torch/csrc/`, holds each
against its plain torch twin on the card at the shapes of the main path,
drives the forward `raster` through `auto` at the flagship size (3D->2D
orthographic, 64 poses, 10^5 points, 128x128) and at 1024x1024, checks the
images against the port's scatter oracle on the card and, at a small size,
against the float64 numpy oracle, and times the kernels and the forward
against the same forward run through the twins.

Run from the root of the repository:

    python3 chip_smoke.py

The last line of its output is one JSON object, ``{"ok": true, "device":
{...}}``; the line before it lists the kernels with their launch counts
on the main path, errors and times.  It exits non-zero when no CUDA device
is present or any check fails.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

FLAGSHIP = (128, 128)
MULTI_TILE = (1024, 1024)
N_POINTS = 100_000
N_POSES = 64


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def scaled_err(out, ref):
    """max |out - ref| / max(max |ref|, 1), in float64."""
    out = out.double()
    ref = ref.double().to(out.device)
    return float((out - ref).abs().max() / max(float(ref.abs().max()), 1.0))


def flagship_inputs(seed=0):
    """The flagship benchmark's inputs: a Gaussian cloud and rotations
    about the y axis projected onto (x, y)."""
    rng = np.random.default_rng(seed)
    points = (rng.standard_normal((N_POINTS, 3)) * 0.4).astype(np.float32)
    angles = rng.uniform(0, 2 * np.pi, N_POSES)
    c, s = np.cos(angles), np.sin(angles)
    rot = np.zeros((N_POSES, 2, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 2] = c, -s
    rot[:, 1, 1] = 1.0
    translation = (rng.standard_normal((N_POSES, 2)) * 0.1).astype(np.float32)
    point_weight = rng.uniform(0.5, 2.0, N_POINTS).astype(np.float32)
    return points, rot, translation, point_weight


def time_ms(fn, reps=15, warmup=3):
    """Median milliseconds of `fn` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def load_numpy_oracle():
    """`raster_numpy` from dprast/utils/testing.py, loaded by path so that
    the JAX package's `__init__` never runs."""
    spec = importlib.util.spec_from_file_location(
        "dprast_numpy_oracle", ROOT / "dprast" / "utils" / "testing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")

    import dprast_torch
    from dprast_torch.ops import _build, splat_binned as sb

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # --- 1. device ---
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
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
             .splitlines() if "registers" in ln or "Compiling entry" in ln]
    print(f"[build] {build_s:.1f} s -> {so.relative_to(ROOT)}")
    for ln in ptxas:
        print(f"[build] {ln}")

    pts_np, rot_np, tr_np, pw_np = flagship_inputs()
    pts, rot, tr, pw = (torch.from_numpy(a).to(dev)
                        for a in (pts_np, rot_np, tr_np, pw_np))

    # --- 3. geometry on the card is bit-equal to the CPU ---
    for grid in (FLAGSHIP, MULTI_TILE):
        ts = sb.tile_shape_for(grid)
        k_gpu, l_gpu, _ = sb._keys_and_local(grid, ts, pts, rot, tr)
        k_cpu, l_cpu, _ = sb._keys_and_local(
            grid, ts, *(torch.from_numpy(a) for a in (pts_np, rot_np,
                                                       tr_np)))
        check(torch.equal(k_gpu.cpu(), k_cpu), f"tile keys at {grid}")
        for a, b in zip(l_gpu, l_cpu, strict=True):
            check(torch.equal(a.cpu().view(torch.int32),
                              b.view(torch.int32)),
                  f"encoded planes at {grid}")
    print(f"[geometry] keys and encoded planes bit-equal CUDA vs CPU at "
          f"{FLAGSHIP} and {MULTI_TILE}, {N_POSES} poses x {N_POINTS} "
          f"points")

    # --- 4. B1 against its twin on the card ---
    frames = {}
    b1_err = 0.0
    for grid in (FLAGSHIP, MULTI_TILE):
        for weighted in (False, True):
            args = sb._fwd_frame(grid, pts, rot, tr, pw, not weighted)
            ext_k = sb.fwd_splat(*args)
            ext_p = sb._fwd_splat_plain(*args)
            torch.cuda.synchronize()
            err = scaled_err(ext_k, ext_p)
            b1_err = max(b1_err, err)
            print(f"[B1 fwd_splat] {grid} {'weighted' if weighted else 'uniform'}"
                  f": ext {tuple(ext_k.shape)}, scaled max-abs err vs twin "
                  f"{err:.3e} (tol 1e-5)")
            check(err <= 1e-5, f"B1 vs twin at {grid}")
            frames[grid, weighted] = (args, ext_k)

    # --- 5. B2 against its twin on the card ---
    rng = np.random.default_rng(1)
    ow = torch.from_numpy(rng.uniform(0.5, 2.0, N_POSES).astype(np.float32)
                          ).to(dev)
    bg = torch.from_numpy((rng.standard_normal(N_POSES) * 0.1).astype(
        np.float32)).to(dev)
    ext_mt = frames[MULTI_TILE, False][1]
    ts_mt = sb.tile_shape_for(MULTI_TILE)
    out_k = sb.band_fold(ext_mt, MULTI_TILE, ts_mt, ow, bg)
    out_p = sb._band_fold_plain(ext_mt, MULTI_TILE, ts_mt, ow, bg)
    torch.cuda.synchronize()
    b2_err = scaled_err(out_k, out_p)
    print(f"[B2 band_fold] {MULTI_TILE}: out {tuple(out_k.shape)}, scaled "
          f"max-abs err vs twin {b2_err:.3e} (tol 1e-6), bit-equal "
          f"{torch.equal(out_k, out_p)}")
    check(b2_err <= 1e-6, "B2 vs twin")

    # --- 6. the main path: raster through auto ---
    for name in sb.LAUNCHES:
        sb.LAUNCHES[name] = 0
    img_flag = dprast_torch.raster(FLAGSHIP, pts, rot, tr)
    torch.cuda.synchronize()
    after_flag = dict(sb.LAUNCHES)
    img_mt = dprast_torch.raster(MULTI_TILE, pts, rot, tr)
    torch.cuda.synchronize()
    launches = dict(sb.LAUNCHES)
    print(f"[main] launches: {FLAGSHIP} {after_flag}; {MULTI_TILE} "
          f"{ {k: launches[k] - after_flag[k] for k in launches} }")
    check(after_flag["fwd_splat"] >= 1, "B1 ran on the flagship forward")
    check(launches["fwd_splat"] > after_flag["fwd_splat"],
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

    oracle = load_numpy_oracle()
    fx = oracle.fixtures(seed=3, n_points=1500, batch_size=4, n_in=3,
                         n_out=2)
    small = [np.asarray(v, np.float32) for v in fx.values()]
    # the flagship grid, two multi-tile grids, and edge shapes: a tiny
    # window, a one-row strip, a one-column multi-tile grid
    for grid in ((128, 128), (256, 256), (999, 777), (5, 5), (3, 200),
                 (130, 1)):
        for weighted in (False, True):
            args = small if weighted else small[:5]
            ref = oracle.raster_numpy(
                grid, *small[:5],
                small[5] if weighted else np.ones(1500, np.float32))
            out = dprast_torch.raster(
                grid, *(torch.from_numpy(a).to(dev) for a in args),
                backend="binned")
            err = scaled_err(out, torch.from_numpy(ref))
            print(f"[small] binned {grid} {'weighted' if weighted else 'uniform'}"
                  f": scaled max-abs err vs f64 oracle {err:.3e} (tol 1e-5)")
            check(err <= 1e-5, f"binned vs f64 oracle at {grid}")

    # --- 7. times ---
    ms = {}
    for grid in (FLAGSHIP, MULTI_TILE):
        args = frames[grid, False][0]
        ms["b1", grid] = time_ms(lambda: sb.fwd_splat(*args))
        ms["b1_plain", grid] = time_ms(lambda: sb._fwd_splat_plain(*args))
        canon = (pts, rot, tr, torch.zeros(N_POSES, device=dev),
                 torch.ones(N_POSES, device=dev),
                 torch.ones(N_POINTS, device=dev))
        ms["frame", grid] = time_ms(lambda: sb._fwd_frame(
            grid, pts, rot, tr, canon[5], True))
        ms["fwd", grid] = time_ms(lambda: dprast_torch.raster(grid, pts, rot,
                                                              tr))
        ms["fwd_plain", grid] = time_ms(lambda: sb._fwd_impl(
            grid, *canon, pw_uniform=True, splat=sb._fwd_splat_plain,
            fold=sb._band_fold_plain))
        ms["fwd_xla", grid] = time_ms(lambda: dprast_torch.raster(
            grid, pts, rot, tr, backend="xla"))
    ms["b2", MULTI_TILE] = time_ms(
        lambda: sb.band_fold(ext_mt, MULTI_TILE, ts_mt, ow, bg))
    ms["b2_plain", MULTI_TILE] = time_ms(
        lambda: sb._band_fold_plain(ext_mt, MULTI_TILE, ts_mt, ow, bg))
    for grid in (FLAGSHIP, MULTI_TILE):
        print(f"[times] {smi} | {grid} x {N_POSES} poses x {N_POINTS} "
              f"points, uniform weights, median ms: frame "
              f"{ms['frame', grid]:.4f}, B1 {ms['b1', grid]:.4f} (twin "
              f"{ms['b1_plain', grid]:.4f}), forward {ms['fwd', grid]:.4f} "
              f"(with twins {ms['fwd_plain', grid]:.4f}, xla backend "
              f"{ms['fwd_xla', grid]:.4f})")
    print(f"[times] {smi} | B2 {MULTI_TILE}: {ms['b2', MULTI_TILE]:.4f} ms "
          f"(twin {ms['b2_plain', MULTI_TILE]:.4f} ms)")

    kernels = [
        {"name": "fwd_splat", "route": "cuda",
         "source": "dprast_torch/csrc/fwd_splat.cu",
         "replaces": "dprast/ops/splat_binned.py:538",
         "launches": launches["fwd_splat"], "max_abs_err": b1_err,
         "ms": ms["b1", FLAGSHIP], "plain_ms": ms["b1_plain", FLAGSHIP],
         "shape": "128x128, 64 poses, 1e5 points, uniform"},
        {"name": "band_fold", "route": "cuda",
         "source": "dprast_torch/csrc/band_fold.cu",
         "replaces": "dprast/ops/splat_binned.py:687",
         "launches": launches["band_fold"], "max_abs_err": b2_err,
         "ms": ms["b2", MULTI_TILE], "plain_ms": ms["b2_plain", MULTI_TILE],
         "shape": "1024x1024, 64 poses"},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
