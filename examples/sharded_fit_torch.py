"""Multi-device point-cloud fitting with `dprast_torch.parallel`: the
PyTorch twin of `examples/sharded_fit.py`.

A 3D cloud is fitted to multi-view 2D projections (the tomography setup)
with autograd flowing through `raster_sharded`: every process renders its
block of poses and points with the ordinary kernels, the partial images
are summed over the "points" group, and the gradient collectives are the
hand-written transposes of `dprast_torch/parallel/sharded.py`
(`docs/torch.md`).  Every process runs this same script on the same
seeded inputs and ends with the same points (SPMD).

Runs on the CUDA device unless `--device cpu` asks for the CPU; where
there is no CUDA device it raises.

Run, one process (the 1 x 1 mesh, no process group):
    python examples/sharded_fit_torch.py [--steps 200]
Four processes on the CPU (a 4 x 1 mesh over Gloo):
    torchrun --nproc-per-node=4 examples/sharded_fit_torch.py --device cpu
"""

from __future__ import annotations

import os
import sys

# runnable straight from a checkout (no install needed)
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from dprast_torch.parallel import make_mesh, multihost, raster_sharded

GRID = (64, 64)
N_VIEWS = 6          # deliberately NOT divisible by typical mesh axes
N_POINTS = 501       # (uneven batches pad with inert poses / 0-weight points)


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


def view_matrices(n=N_VIEWS):
    """n orthographic 3D->2D projections around the z axis, float32 (a
    float64 array would make the whole call float64)."""
    a = np.linspace(0, np.pi, n, endpoint=False)
    rot = np.zeros((n, 2, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 2] = np.cos(a), -np.sin(a)
    rot[:, 1, 1] = 1.0
    return torch.from_numpy(rot)


def _blur_axis(imgs, dim):
    """The "same" convolution with (0.25, 0.5, 0.25) along `dim`: zeros
    beyond the edges."""
    n = imgs.shape[dim]
    pad = [0, 0] * imgs.ndim
    pad[2 * (imgs.ndim - 1 - dim)] = pad[2 * (imgs.ndim - 1 - dim) + 1] = 1
    wide = torch.nn.functional.pad(imgs, pad)
    return (0.25 * wide.narrow(dim, 0, n) + 0.5 * imgs
            + 0.25 * wide.narrow(dim, 2, n))


def blur(imgs):
    """(B, h, w) images blurred with (0.25, 0.5, 0.25) along each axis."""
    return _blur_axis(_blur_axis(imgs, 1), 2)


def fit(steps=200, lr=30.0, seed=0, mesh=None, log_every=50, device="cuda"):
    """Gradient-descend a 3D cloud onto blurred multi-view targets.

    Returns (points, loss_history)."""
    device = run_device(device)
    if mesh is None:
        mesh = make_mesh()          # every process on the poses axis
    rng = np.random.default_rng(seed)
    rots = view_matrices().to(device)
    trans = torch.zeros((N_VIEWS, 2), device=device)
    truth = torch.from_numpy(
        (rng.standard_normal((N_POINTS, 3)) * 0.35).astype(np.float32)
    ).to(device)
    targets = blur(raster_sharded(GRID, truth, rots, trans, mesh=mesh))

    def loss_fn(pts):
        imgs = raster_sharded(GRID, pts, rots, trans, mesh=mesh)
        return torch.mean((blur(imgs) - targets) ** 2)

    pts = truth + torch.from_numpy(
        (rng.standard_normal((N_POINTS, 3)) * 0.05).astype(np.float32)
    ).to(device)
    hist = []
    for i in range(steps):
        leaf = pts.detach().requires_grad_()
        loss = loss_fn(leaf)
        (g,) = torch.autograd.grad(loss, leaf)
        pts = pts - lr * g
        if i % log_every == 0 or i == steps - 1:
            hist.append((i, float(loss.detach())))
            if mesh.rank == 0:
                print(f"step {i:4d}  loss {hist[-1][1]:.3e}", flush=True)
    return pts, hist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=30.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where there is none) or cpu")
    args = ap.parse_args(argv)
    device = run_device(args.device)
    # CPU tensors need Gloo, whatever cards the host has
    multihost.initialize(backend="gloo" if device.type == "cpu" else None)
    try:
        mesh = make_mesh()
        if mesh.rank == 0:
            print(f"processes: {mesh.shape['poses'] * mesh.shape['points']} "
                  f"({device.type}), mesh {mesh}", flush=True)
        _, hist = fit(steps=args.steps, lr=args.lr, mesh=mesh, device=device)
        if mesh.rank == 0:
            print(f"loss {hist[0][1]:.3e} -> {hist[-1][1]:.3e}")
    finally:
        multihost.shutdown()
    return hist


if __name__ == "__main__":
    main()
