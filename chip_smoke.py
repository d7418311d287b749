"""Smoke run of dprast_torch on one CUDA card.

Builds the port's CUDA kernels from `dprast_torch/csrc/`, holds each
against its plain torch twin on the card at the shapes of the main path,
and drives the two main paths at the flagship size (3D->2D orthographic,
64 poses, 10^5 points, 128x128) and at 1024x1024:

- the forward `raster` through `auto` (kernels B1, and B2 at 1024^2),
  checked against the port's scatter oracle on the card;
- the training step, `torch.autograd.grad` through `raster` (B1 + B4,
  and B2 + B3 at 1024^2), checked against the same autograd through the
  oracle on the card, and a few SGD steps of a point-cloud fit.

At small sizes the forward and `raster_pullback` are checked against the
float64 numpy oracles.  Then it times the kernels against their twins,
and the forward and the training step against the same work run through
the twins.

Run from the root of the repository:

    python3 chip_smoke.py

The last line of its output is one JSON object, ``{"ok": true, "device":
{...}}``; the line before it lists the kernels with their launch counts
on the training path, errors and times.  It exits non-zero when no CUDA
device is present or any check fails.
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


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def scaled_err(out, ref):
    """max |out - ref| / max(max |ref|, 1), in float64."""
    out = torch.as_tensor(out).double()
    ref = torch.as_tensor(ref).double().to(out.device)
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
    """`raster_numpy` and `raster_pullback_numpy` from
    dprast/utils/testing.py, loaded by path so that the JAX package's
    `__init__` never runs."""
    spec = importlib.util.spec_from_file_location(
        "dprast_numpy_oracle", ROOT / "dprast" / "utils" / "testing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reset_launches(sb):
    for name in sb.LAUNCHES:
        sb.LAUNCHES[name] = 0


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
    want = {FLAGSHIP: ("fwd_splat", "bwd_gather"),
            MULTI_TILE: ("fwd_splat", "band_fold", "band_unfold",
                         "bwd_gather")}
    for grid in GRIDS:
        for weighted in (False, True):
            inputs = train_inputs(pts, rot, tr, pw, weighted)
            reset_launches(sb)
            grads = train_grads(dprast_torch, grid, inputs, cots[grid])
            torch.cuda.synchronize()
            launched = dict(sb.LAUNCHES)
            for name in launched:
                totals[name] += launched[name]
            for name in want[grid]:
                check(launched[name] >= 1,
                      f"{name} ran in the training step at {grid}")
            ref = train_grads(dprast_torch, grid, inputs, cots[grid],
                              backend="xla")
            errs = {}
            for name, a, r, x in zip(GRAD_NAMES, grads, ref, inputs):
                check(a.shape == x.shape and bool(torch.isfinite(a).all()),
                      f"finite d_{name} of shape {tuple(x.shape)} at {grid}")
                errs[name] = scaled_err(a, r)
            label = "weighted" if weighted else "uniform"
            print(f"[train] auto {grid} {label}: launches {launched}; "
                  f"scaled max-abs err vs the xla backend (tol 2e-5): "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
            check(max(errs.values()) <= 2e-5, f"training grads at {grid}")


def phase_small(dprast_torch, oracle, dev):
    """[small]: the forward and `raster_pullback` on the binned backend
    vs the f64 oracles."""
    fx = oracle.fixtures(seed=3, n_points=1500, batch_size=4, n_in=3,
                         n_out=2)
    small = [np.asarray(v, np.float32) for v in fx.values()]
    ones = np.ones(1500, np.float32)
    on_dev = [torch.from_numpy(a).to(dev) for a in small]
    rng = np.random.default_rng(7)
    for grid in SMALL_GRIDS:
        for weighted in (False, True):
            args = on_dev if weighted else on_dev[:5]
            ref = oracle.raster_numpy(grid, *small[:5],
                                      small[5] if weighted else ones)
            out = dprast_torch.raster(grid, *args, backend="binned")
            err = scaled_err(out, ref)
            print(f"[small] binned {grid} "
                  f"{'weighted' if weighted else 'uniform'}: forward scaled "
                  f"max-abs err vs f64 oracle {err:.3e} (tol 1e-5)")
            check(err <= 1e-5, f"binned forward vs f64 oracle at {grid}")
        g = rng.standard_normal((4,) + grid)
        g_dev = torch.from_numpy(g.astype(np.float32)).to(dev)
        # a per-point weight, the defaulted one (exact per-point d_pw) and
        # a scalar one (summed d_pw, the uniform unsort-free path)
        for label, pw, pw_ref in (("weighted", on_dev[5], small[5]),
                                  ("uniform", None, ones),
                                  ("scalar 1.7", 1.7,
                                   np.full(1500, 1.7, np.float32))):
            ref = oracle.raster_pullback_numpy(grid, *small[:5], pw_ref, g)
            if label.startswith("scalar"):
                ref["point_weight"] = ref["point_weight"].sum()
            res = dprast_torch.raster_pullback(g_dev, *on_dev[:5], pw,
                                               backend="binned")
            errs = {k: scaled_err(getattr(res, k), ref[k])
                    for k in GRAD_NAMES}
            worst = max(errs, key=errs.get)
            print(f"[small] binned raster_pullback {grid} {label}: scaled "
                  f"max-abs err vs f64 oracle {errs[worst]:.3e} (d_{worst}; "
                  f"tol 1e-5)")
            check(errs[worst] <= 1e-5,
                  f"binned pullback vs f64 oracle at {grid} ({label})")


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


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")

    import dprast_torch
    from dprast_torch.ops import _build, core, splat_binned as sb

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
    for grid in GRIDS:
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
    for grid in GRIDS:
        for weighted in (False, True):
            args, data = sb._fwd_frame(grid, pts, rot, tr, pw, not weighted)
            ext_k = sb.fwd_splat(*args)
            ext_p = sb._fwd_splat_plain(*args)
            torch.cuda.synchronize()
            err = scaled_err(ext_k, ext_p)
            b1_err = max(b1_err, err)
            print(f"[B1 fwd_splat] {grid} {'weighted' if weighted else 'uniform'}"
                  f": ext {tuple(ext_k.shape)}, scaled max-abs err vs twin "
                  f"{err:.3e} (tol 1e-5)")
            check(err <= 1e-5, f"B1 vs twin at {grid}")
            frames[grid, weighted] = (args, ext_k, data)

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

    # --- 6. B3 against its twin on the card ---
    cots = {grid: torch.from_numpy(
        np.random.default_rng(2).standard_normal((N_POSES,) + grid)
        .astype(np.float32)).to(dev) for grid in GRIDS}
    b3_err = 0.0
    for grid, g in ((MULTI_TILE, cots[MULTI_TILE]),
                    ((999, 777), torch.randn((3, 999, 777), device=dev)),
                    ((130, 1), torch.randn((3, 130, 1), device=dev))):
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
    b4_err = 0.0
    b4_args = {}
    for grid, label, data, st, chunk in b4_cases:
        lane_b = sb._planes_bwd(data[:, :2]).contiguous()
        win = win_mt if grid == MULTI_TILE else cots[grid]
        buf_k = sb.bwd_gather(st, lane_b, win, chunk)
        buf_p = sb._bwd_gather_plain(st, lane_b, win, chunk)
        torch.cuda.synchronize()
        err = scaled_err(buf_k, buf_p)
        b4_err = max(b4_err, err)
        print(f"[B4 bwd_gather] {grid} {label}: rows {tuple(buf_k.shape)}, "
              f"scaled max-abs err vs twin {err:.3e} (tol 1e-6), bit-equal "
              f"{torch.equal(buf_k, buf_p)}")
        check(err <= 1e-6, f"B4 vs twin at {grid} ({label})")
        b4_args.setdefault(grid, (st, lane_b, win, chunk))

    # --- 8. the forward path: raster through auto ---
    reset_launches(sb)
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

    # --- 9. the training path: autograd through auto ---
    train_launches = {name: 0 for name in sb.LAUNCHES}
    phase_train(dprast_torch, sb, pts, rot, tr, pw, cots, train_launches)

    # --- 10. small configurations vs the f64 oracles ---
    phase_small(dprast_torch, load_numpy_oracle(), dev)

    # --- 11. a few SGD steps of a fit at the flagship width ---
    phase_fit(dprast_torch, pts, rot, tr)

    # --- 12. times ---
    ms = {}
    canon = (pts, rot, tr, torch.zeros(N_POSES, device=dev),
             torch.ones(N_POSES, device=dev),
             torch.ones(N_POINTS, device=dev))
    for grid in GRIDS:
        args = frames[grid, False][0]
        g = cots[grid]
        chunk = sb._default_chunk(grid, N_POINTS)
        ms["b1", grid] = time_ms(lambda: sb.fwd_splat(*args))
        ms["b1_plain", grid] = time_ms(lambda: sb._fwd_splat_plain(*args))
        ms["b4", grid] = time_ms(lambda: sb.bwd_gather(*b4_args[grid]))
        ms["b4_plain", grid] = time_ms(
            lambda: sb._bwd_gather_plain(*b4_args[grid]))
        ms["frame", grid] = time_ms(lambda: sb._fwd_frame(
            grid, pts, rot, tr, canon[5], True))
        ms["fwd", grid] = time_ms(lambda: dprast_torch.raster(grid, pts, rot,
                                                              tr))
        ms["fwd_plain", grid] = time_ms(lambda: sb._fwd_impl(
            grid, *canon, pw_uniform=True, splat=sb._fwd_splat_plain,
            fold=sb._band_fold_plain))
        ms["fwd_xla", grid] = time_ms(lambda: dprast_torch.raster(
            grid, pts, rot, tr, backend="xla"))

        # the backward's stages, on the standalone pullback's frame
        data_b, st_b, _ = sb._bwd_frame(grid, pts, rot, tr)
        ms["bwd_frame", grid] = time_ms(
            lambda: sb._bwd_frame(grid, pts, rot, tr))
        ms["planes_bwd", grid] = time_ms(
            lambda: sb._planes_bwd(data_b[:, :2]).contiguous())
        if grid == MULTI_TILE:
            buf = sb.bwd_gather(*b4_args[grid])
            ms["b3", grid] = time_ms(
                lambda: sb.band_unfold(g, grid, ts_mt))
            ms["b3_plain", grid] = time_ms(
                lambda: sb._unfold(g, grid, ts_mt))
            ms["unsort", grid] = time_ms(
                lambda: sb._unsort(buf, data_b[:, 2], N_POINTS))
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

        def step_twins():
            _, res = sb._fwd_impl(grid, *canon, pw_uniform=True,
                                  with_residuals=True,
                                  splat=sb._fwd_splat_plain,
                                  fold=sb._band_fold_plain)
            coord, idx_rows, st = sb._residual_planes(res, True)
            return sb._pullback_from_frame(
                grid, coord, idx_rows, st, pts, rot, canon[4], canon[5], g,
                chunk=chunk, pw_uniform=True, unfold=sb._unfold,
                gather=sb._bwd_gather_plain)

        pts_req = pts.clone().requires_grad_()

        def step_autograd():
            out = dprast_torch.raster(grid, pts_req, rot, tr)
            return torch.autograd.grad((out * g).sum(), pts_req)

        ms["step", grid] = time_ms(step)
        ms["step_plain", grid] = time_ms(step_twins)
        ms["step_autograd", grid] = time_ms(step_autograd)
        ms["step_xla", grid] = time_ms(lambda: core.raster_pullback_res(
            grid, core.raster_fwd_res(grid, *canon)[1], canon, g))
    ms["b2", MULTI_TILE] = time_ms(
        lambda: sb.band_fold(ext_mt, MULTI_TILE, ts_mt, ow, bg))
    ms["b2_plain", MULTI_TILE] = time_ms(
        lambda: sb._band_fold_plain(ext_mt, MULTI_TILE, ts_mt, ow, bg))
    for grid in GRIDS:
        print(f"[times] {smi} | {grid} x {N_POSES} poses x {N_POINTS} "
              f"points, uniform weights, median ms: frame "
              f"{ms['frame', grid]:.4f}, B1 {ms['b1', grid]:.4f} (twin "
              f"{ms['b1_plain', grid]:.4f}), forward {ms['fwd', grid]:.4f} "
              f"(with twins {ms['fwd_plain', grid]:.4f}, xla backend "
              f"{ms['fwd_xla', grid]:.4f})")
        b3 = (f", B3 {ms['b3', grid]:.4f} (twin {ms['b3_plain', grid]:.4f})"
              f", unsort {ms['unsort', grid]:.4f}" if grid == MULTI_TILE
              else "")
        print(f"[times] {smi} | {grid} backward, median ms: frame "
              f"{ms['bwd_frame', grid]:.4f}, planes "
              f"{ms['planes_bwd', grid]:.4f}{b3}, B4 {ms['b4', grid]:.4f} "
              f"(twin {ms['b4_plain', grid]:.4f}), standalone pullback "
              f"{ms['pullback', grid]:.4f}, pullback from the forward's "
              f"frame {ms['pullback_res', grid]:.4f}")
        rate = N_POINTS * N_POSES * 4 / (ms["step", grid] * 1e-3)
        print(f"[times] {smi} | {grid} training step, median ms: fused "
              f"forward + pullback {ms['step', grid]:.4f} ({rate:.4e} "
              f"points*splats/s), with twins {ms['step_plain', grid]:.4f}, "
              f"through autograd {ms['step_autograd', grid]:.4f}, xla "
              f"backend {ms['step_xla', grid]:.4f}")
    print(f"[times] {smi} | B2 {MULTI_TILE}: {ms['b2', MULTI_TILE]:.4f} ms "
          f"(twin {ms['b2_plain', MULTI_TILE]:.4f} ms)")

    src = "dprast/ops/splat_binned.py"
    kernels = [
        {"name": "fwd_splat", "route": "cuda",
         "source": "dprast_torch/csrc/fwd_splat.cu",
         "replaces": f"{src}:538",
         "launches": train_launches["fwd_splat"], "max_abs_err": b1_err,
         "ms": ms["b1", FLAGSHIP], "plain_ms": ms["b1_plain", FLAGSHIP],
         "shape": "128x128, 64 poses, 1e5 points, uniform"},
        {"name": "band_fold", "route": "cuda",
         "source": "dprast_torch/csrc/band_fold.cu",
         "replaces": f"{src}:687",
         "launches": train_launches["band_fold"], "max_abs_err": b2_err,
         "ms": ms["b2", MULTI_TILE], "plain_ms": ms["b2_plain", MULTI_TILE],
         "shape": "1024x1024, 64 poses"},
        {"name": "band_unfold", "route": "cuda",
         "source": "dprast_torch/csrc/band_unfold.cu",
         "replaces": f"{src}:836",
         "launches": train_launches["band_unfold"], "max_abs_err": b3_err,
         "ms": ms["b3", MULTI_TILE], "plain_ms": ms["b3_plain", MULTI_TILE],
         "shape": "1024x1024, 64 poses"},
        {"name": "bwd_gather", "route": "cuda",
         "source": "dprast_torch/csrc/bwd_gather.cu",
         "replaces": f"{src}:1085",
         "launches": train_launches["bwd_gather"], "max_abs_err": b4_err,
         "ms": ms["b4", FLAGSHIP], "plain_ms": ms["b4_plain", FLAGSHIP],
         "shape": "128x128, 64 poses, 1e5 points, uniform"},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
