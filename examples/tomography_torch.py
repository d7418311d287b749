"""Tomographic point-cloud reconstruction with `dprast_torch`: the PyTorch
twin of `examples/tomography.py` (the 3D->2D projection use case,
cryo-EM style).

A ground-truth 3D point cloud (two interlocked rings) is rendered to B
2D projections at known rotations (orthographic `(2, 3)` pose matrices);
a randomly initialised cloud is then fitted to those projections by
gradient descent through the analytic pullback.  The random numbers come
from explicit `torch.Generator`s made from seeds (drawn on the host).

Runs on the CUDA device unless `--device cpu` asks for the CPU; where
there is no CUDA device it raises.

Run: python examples/tomography_torch.py [--steps 300]
"""

from __future__ import annotations

import os
import sys

# runnable straight from a checkout (no install needed)
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import argparse
import math

import numpy as np
import torch

import dprast_torch

GRID = (96, 96)
N_POINTS = 2000
N_VIEWS = 24


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


def make_truth(generator, device="cuda"):
    """Two interlocked rings, (N_POINTS, 3) float32, drawn from `generator`
    (a CPU `torch.Generator`)."""
    n = N_POINTS // 2
    a1 = torch.rand(n, generator=generator) * 2 * math.pi
    ring1 = torch.stack([0.5 * torch.cos(a1), 0.5 * torch.sin(a1),
                         torch.zeros_like(a1)], dim=1)
    a2 = torch.rand(n, generator=generator) * 2 * math.pi
    ring2 = torch.stack([0.25 + 0.5 * torch.cos(a2), torch.zeros_like(a2),
                         0.5 * torch.sin(a2)], dim=1)
    return torch.cat([ring1, ring2]).to(run_device(device))


def view_matrices(device="cuda"):
    """B orthographic (2, 3) projection matrices: rotate about z then
    project away the third axis."""
    mats = []
    for a in np.linspace(0, np.pi, N_VIEWS, endpoint=False):
        c, s = np.cos(a), np.sin(a)
        rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        rx = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]])
        mats.append((rx @ rz)[:2])
    return torch.from_numpy(np.stack(mats).astype(np.float32)).to(
        run_device(device))


def _blur_matrix(n, sigma, like):
    """The (n, n) band matrix of a 9-tap gaussian with zero padding
    ("same" convolution along one axis)."""
    x = torch.arange(-4, 5.0)
    k = torch.exp(-x ** 2 / (2 * sigma ** 2))
    k = k / k.sum()
    offset = torch.arange(n)[None, :] - torch.arange(n)[:, None]
    band = torch.where(offset.abs() <= 4, k[(offset + 4).clamp(0, 8)],
                       torch.zeros(()))
    return band.to(device=like.device, dtype=like.dtype)


def blur(imgs, sigma=1.5):
    """Separable gaussian blur of (B, h, w) images, one fp32 matrix product
    per axis."""
    h, w = imgs.shape[-2:]
    imgs = torch.einsum("ij,bjw->biw", _blur_matrix(h, sigma, imgs), imgs)
    return torch.einsum("bhj,ij->bhi", imgs, _blur_matrix(w, sigma, imgs))


def reconstruct(steps=300, backend="auto", device="cuda", log_every=50):
    """Fit a random cloud to the truth's projections by `steps` gradient
    steps -> (loss of the start, loss of the result)."""
    device = run_device(device)
    rots = view_matrices(device)
    trans = torch.zeros((N_VIEWS, 2), device=device)
    truth = make_truth(torch.Generator().manual_seed(1), device)
    target = blur(dprast_torch.raster(GRID, truth, rots, trans))

    start = (torch.rand((N_POINTS, 3),
                        generator=torch.Generator().manual_seed(2))
             * 1.2 - 0.6).to(device)

    def loss(points):
        pred = blur(dprast_torch.raster(GRID, points, rots, trans,
                                        backend=backend))
        return torch.mean((pred - target) ** 2)

    points = start
    lr = 3.0
    for i in range(steps):
        leaf = points.detach().requires_grad_()
        val = loss(leaf)
        (g,) = torch.autograd.grad(val, leaf)
        points = points - lr * g
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:4d}  projection loss {float(val.detach()):.3e}")

    with torch.no_grad():
        return float(loss(start)), float(loss(points))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--fast", action="store_true",
                    help="reconstruct in the binned_bf16 fast mode "
                         "(~2e-3 error; reconstruction-tolerance work)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where there is none) or cpu")
    args = ap.parse_args(argv)
    first, final = reconstruct(
        args.steps, "binned_bf16" if args.fast else "auto", args.device)
    print(f"loss {first:.3e} -> {final:.3e} "
          f"({final / first:.1%} of initial)")
    assert final < 0.5 * first, "reconstruction failed to converge"


if __name__ == "__main__":
    main()
