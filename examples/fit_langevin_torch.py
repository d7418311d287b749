"""Langevin-dynamics point-cloud fitting with `dprast_torch`: the PyTorch
twin of `examples/fit_langevin.py`.

Model: raster points into an image with a global log-weight, blur with an
FFT gaussian of a learnable log-bandwidth, L2-compare to a target image.
Optimisation: Langevin dynamics on the points + plain gradient steps on
the two scalars, all through `torch.autograd` on the analytic pullback.
The random numbers come from one explicit `torch.Generator` made from the
seed (drawn on the host, so a seed gives the same run on every device).

Runs on the CUDA device unless `--device cpu` asks for the CPU; where
there is no CUDA device it raises.

Run: python examples/fit_langevin_torch.py [--steps 400] [--out DIR]
"""

from __future__ import annotations

import os
import sys

# runnable straight from a checkout (no install needed)
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import argparse
import math
import tempfile

import numpy as np
import torch

import dprast_torch

GRID = (128, 128)
N_POINTS = 3000


def run_device(name="cuda"):
    """The device of a run: `name`, which must exist (no CUDA device raises
    a RuntimeError, as the `dprast_torch` entry points do)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this example runs on the CUDA device by default and "
            "torch.cuda.is_available() is False; pass --device cpu to run "
            "on the CPU")
    return device


def gaussian_blur_fft(img, sigma):
    """FFT gaussian blur of (..., h, w) images."""
    h, w = img.shape[-2:]
    fy = torch.fft.fftfreq(h, device=img.device, dtype=img.dtype)
    fx = torch.fft.fftfreq(w, device=img.device, dtype=img.dtype)
    # gaussian transfer function: exp(-2 pi^2 sigma^2 f^2)
    gy = torch.exp(-2 * (math.pi * sigma * fy) ** 2)
    gx = torch.exp(-2 * (math.pi * sigma * fx) ** 2)
    ker = gy[:, None] * gx[None, :]
    return torch.fft.ifft2(torch.fft.fft2(img) * ker).real


def model(points, log_bandwidth, log_weight, backend="auto"):
    """Differentiable image formation: splat + blur."""
    dev = points.device
    img = dprast_torch.raster(GRID, points, torch.eye(2, device=dev),
                              torch.zeros(2, device=dev), 0.0,
                              torch.exp(log_weight), backend=backend)
    return gaussian_blur_fft(img, torch.exp(log_bandwidth))


def loss(points, log_bandwidth, log_weight, target, backend="auto"):
    pred = model(points, log_bandwidth, log_weight, backend)
    return torch.mean((pred - target) ** 2)


def make_target(generator, device="cuda"):
    """A procedural target: three rings of points (stands in for the logo
    image asset), drawn from `generator` (a CPU `torch.Generator`)."""
    device = run_device(device)
    centers = torch.tensor([[-0.35, -0.35], [-0.35, 0.35], [0.35, 0.0]])
    n = N_POINTS // 3
    pts = []
    for center in centers:
        ang = torch.rand(n, generator=generator) * 2 * math.pi
        r = 0.25 + 0.02 * torch.randn(n, generator=generator)
        pts.append(center + torch.stack([r * torch.sin(ang),
                                         r * torch.cos(ang)], -1))
    target_pts = torch.cat(pts).to(device)
    img = dprast_torch.raster(GRID, target_pts, torch.eye(2, device=device),
                              torch.zeros(2, device=device), 0.0, 1.0)
    return gaussian_blur_fft(img, 2.0)


def langevin_fit(target, steps=400, seed=0, step_size=5.0, noise=1e-5,
                 log_every=50, backend="auto"):
    """x += -eps * grad + sqrt(2 eps T) xi on the points; plain gradient
    steps for the two scalars.  Runs on the device of `target`.

    ``backend="binned_bf16"`` runs the fit in the documented ~2e-3 fast
    mode; fits at rendering tolerance converge the same."""
    dev = target.device
    gen = torch.Generator().manual_seed(seed)
    points = (torch.rand((N_POINTS, 2), generator=gen) * 1.6 - 0.8).to(dev)
    log_bw = torch.tensor(math.log(2.0), device=dev)
    log_w = torch.tensor(0.0, device=dev)

    history = []
    for i in range(steps):
        leaves = [t.detach().requires_grad_() for t in (points, log_bw,
                                                        log_w)]
        val = loss(*leaves, target, backend=backend)
        g_p, g_bw, g_w = torch.autograd.grad(val, leaves)
        val = val.detach()
        xi = torch.randn(points.shape, generator=gen).to(dev)
        points = points - step_size * g_p \
            + math.sqrt(2 * step_size * noise) * xi
        log_bw = log_bw - 1e-2 * g_bw
        log_w = log_w - 1e-2 * g_w
        if i % log_every == 0 or i == steps - 1:
            history.append((i, float(val)))
            print(f"step {i:5d}  loss {float(val):.3e}  "
                  f"bw {float(torch.exp(log_bw)):.2f}  "
                  f"w {float(torch.exp(log_w)):.3f}")
    return points, log_bw, log_w, history


def load_image_target(path, device="cuda"):
    """PNG -> blurred target image (an original asset ships at
    examples/data/logo.png)."""
    from PIL import Image

    device = run_device(device)
    img = Image.open(path).convert("L").resize(GRID[::-1])
    arr = torch.from_numpy(np.asarray(img, np.float32) / 255.0).to(device)
    arr = arr * (N_POINTS / torch.clamp(torch.sum(arr), min=1e-6))
    return gaussian_blur_fft(arr, 2.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "dprast_fit_torch"))
    ap.add_argument("--image", default=None,
                    help="PNG target (e.g. examples/data/logo.png); "
                         "default: procedural three-ring target")
    ap.add_argument("--fast", action="store_true",
                    help="run in the binned_bf16 fast mode (~2e-3 error)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where there is none) or cpu")
    args = ap.parse_args(argv)

    device = run_device(args.device)
    if args.image:
        target = load_image_target(args.image, device)
    else:
        target = make_target(torch.Generator().manual_seed(42), device)
    backend = "binned_bf16" if args.fast else "auto"
    points, log_bw, log_w, history = langevin_fit(target, steps=args.steps,
                                                  backend=backend)

    os.makedirs(args.out, exist_ok=True)
    final = model(points, log_bw, log_w).cpu().numpy()
    np.save(os.path.join(args.out, "target.npy"), target.cpu().numpy())
    np.save(os.path.join(args.out, "final.npy"), final)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(8, 4))
        axes[0].imshow(target.cpu().numpy()); axes[0].set_title("target")
        axes[1].imshow(final); axes[1].set_title("fit")
        fig.savefig(os.path.join(args.out, "fit.png"), dpi=120)
        print("wrote", os.path.join(args.out, "fit.png"))
    except ImportError:
        print("matplotlib unavailable; wrote .npy arrays to", args.out)
    assert history[-1][1] < history[0][1], "loss did not decrease"
    return history


if __name__ == "__main__":
    main()
