"""Public API: argument normalisation + shape validation, `raster`
through autograd and the analytic `raster_pullback` (PyTorch port of
`dprast/api.py`).

Layout (the JAX package's, so both take the same arrays):

    points       (P, N_in)
    rotation     (N_out, N_in)  or (B, N_out, N_in)
    translation  (N_out,)       or (B, N_out)
    background   scalar         or (B,)
    out_weight   scalar         or (B,)
    point_weight scalar or (P,)
    output       (*grid_size)   or (B, *grid_size)

Inputs may be tensors, numpy arrays, nested lists or Python scalars.  The
device is that of the tensor inputs, which must agree (a CPU tensor asks
for the CPU); with no tensor input it is the `device` argument, and with
neither it is the current CUDA device: the entry points run on the card
unless the caller asks for the CPU with ``device="cpu"``, and raise where
there is no card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dprast_torch import ad
from dprast_torch.ops import dispatch


class RasterGrads(NamedTuple):
    """Gradients of a scalar loss w.r.t. the six `raster` inputs."""

    points: torch.Tensor
    rotation: torch.Tensor
    translation: torch.Tensor
    background: torch.Tensor
    out_weight: torch.Tensor
    point_weight: torch.Tensor


def _device_of(values, device):
    """The device of a call: that of its tensor inputs and of the `device`
    argument, which must agree; with neither, the current CUDA device."""
    devices = {v.device for v in values if isinstance(v, torch.Tensor)}
    if device is None and not devices:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dprast_torch runs on the CUDA device by default and "
                "torch.cuda.is_available() is False; pass device=\"cpu\" "
                "(or CPU tensors) to run on the CPU")
        device = "cuda"
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        devices.add(device)
    if len(devices) > 1:
        raise ValueError(
            f"all inputs must be on one device; got {sorted(map(str, devices))}")
    return devices.pop()


def _as_tensor(value, device):
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value), device=device)


def _normalise(grid_size, points, rotation, translation, background,
               out_weight, point_weight, dtype, device=None):
    """Coerce to canonical batched form.  Returns (grid_size, canonical
    6-tuple of tensors, batched, pw_uniform)."""
    grid_size = tuple(int(s) for s in grid_size)
    n_out = len(grid_size)
    if n_out < 1:
        raise ValueError("grid_size must have at least one dimension")
    raw = (points, rotation, translation, background, out_weight,
           point_weight)
    device = _device_of(raw, device)
    # Python scalars and defaults are weakly typed, as in JAX: they take
    # the dtype of the arrays and never promote it
    strong = [v is not None and not isinstance(v, (int, float))
              for v in raw]

    points = _as_tensor(points, device)
    if points.ndim != 2:
        raise ValueError(
            f"points must have shape (n_points, N_in); got "
            f"{tuple(points.shape)}")
    n_points, n_in = points.shape

    rotation = _as_tensor(rotation, device)
    if rotation.ndim == 2:
        batched = False
        rotation = rotation[None]
    elif rotation.ndim == 3:
        batched = True
    else:
        raise ValueError(
            "rotation must be a (N_out, N_in) matrix or a (B, N_out, N_in) "
            f"batch of matrices; got shape {tuple(rotation.shape)}")
    b = rotation.shape[0]

    translation = _as_tensor(translation, device)
    if not batched:
        if translation.ndim != 1:
            raise ValueError(
                "translation must be a vector for a single pose; got shape "
                f"{tuple(translation.shape)}")
        translation = translation[None]
    elif translation.ndim != 2:
        raise ValueError(
            "translation must have shape (B, N_out) for batched poses; "
            f"got shape {tuple(translation.shape)}")

    # --- dimension errors, with the reference's wording ---
    n_out_trans = translation.shape[-1]
    n_out_rot, n_in_rot = rotation.shape[-2], rotation.shape[-1]
    if n_out_trans != n_out:
        raise ValueError(
            f"Dimension of translation (got {n_out_trans}) and output "
            f"dimension (got {n_out}) must agree!")
    if n_out_rot != n_out:
        raise ValueError(
            f"Row dimension of rotation (got {n_out_rot}) and output "
            f"dimension (got {n_out}) must agree!")
    if n_in_rot != n_in:
        raise ValueError(
            f"Column dimension of rotation (got {n_in_rot}) and points "
            f"(got {n_in}) must agree!")
    if translation.shape[0] != b:
        raise ValueError(
            f"Batch size of rotation (got {b}) and translation (got "
            f"{translation.shape[0]}) must agree!")

    def _per_pose(name, value, default):
        value = _as_tensor(default if value is None else value, device)
        if value.ndim == 0:
            return value.expand(b)
        if value.ndim == 1:
            if value.shape[0] != b:
                raise ValueError(
                    f"Batch size of rotation (got {b}) and {name} (got "
                    f"{value.shape[0]}) must agree!")
            if not batched:
                raise ValueError(
                    f"{name} must be a scalar for a single pose; got shape "
                    f"{tuple(value.shape)}")
            return value
        raise ValueError(
            f"{name} must be a scalar or a (B,) vector; got shape "
            f"{tuple(value.shape)}")

    background = _per_pose("background", background, 0.0)
    out_weight = _per_pose("out_weight", out_weight, 1.0)

    point_weight = _as_tensor(1.0 if point_weight is None else point_weight,
                              device)
    # a defaulted or scalar point_weight is a broadcast constant: backends
    # may drop the per-point weight plane from their data path
    pw_uniform = point_weight.ndim == 0
    if pw_uniform:
        point_weight = point_weight.expand(n_points)
    elif point_weight.ndim != 1 or point_weight.shape[0] != n_points:
        raise ValueError(
            f"point_weight must be a scalar or a (n_points,) vector; got "
            f"shape {tuple(point_weight.shape)} for {n_points} points")

    args = (points, rotation, translation, background, out_weight,
            point_weight)
    if dtype is None:
        dtype = torch.float32
        for a, is_strong in zip(args, strong):
            if is_strong:
                dtype = torch.promote_types(dtype, a.dtype)
    args = tuple(a.to(device=device, dtype=dtype) for a in args)
    return grid_size, args, batched, pw_uniform


def raster(grid_size, points, rotation, translation, background=None,
           out_weight=None, point_weight=None, *, dtype=None,
           backend: str = "auto", device=None):
    """Rasterise a point cloud into an N-dimensional grid (differentiable).

    Each point ``p`` is transformed to ``q = rotation @ p + translation``
    and, if it falls inside (-1, 1)^N, its weight ``out_weight *
    point_weight`` is distributed onto the 2^N nearest voxels by
    multilinear interpolation.  The output starts at `background`.
    Gradients of all six inputs flow through autograd to the analytic
    pullback of the chosen backend.  A numpy float64 input makes the whole
    call float64 and sends 'auto' to the float64 oracle, so cast what
    `np.random` returns to float32 first.  The 'binned' and 'matmul'
    backends can be differentiated once; 'xla' also a second time.

    Args:
      grid_size: tuple of N_out ints, the output grid shape.
      points: (P, N_in) point coordinates.
      rotation: (N_out, N_in) matrix, or (B, N_out, N_in) for a batch of
        poses; may be an orthographic projection (N_out < N_in).
      translation: (N_out,) or (B, N_out), applied after the rotation.
      background, out_weight: scalar, or (B,) per pose (defaults 0, 1).
      point_weight: scalar or (P,) per point (default 1).
      dtype: result dtype; defaults to the promoted input dtype, at least
        float32.
      backend: 'auto' | 'xla' | 'matmul' | 'matmul_bf16' | 'binned' |
        'binned_bf16' (the `_bf16` names are the ~2e-3 fast modes of
        'matmul' and 'binned', never chosen by 'auto').  On a CUDA device
        'auto' takes 'binned' for 2-D and 3-D grids (but for a cloud too
        sparse for its grid) and 'xla' otherwise; on the CPU and for
        float64 'xla'.
      device: where numpy / list inputs go when no input is a tensor;
        by default the current CUDA device (a RuntimeError where there is
        none), ``"cpu"`` for the CPU.

    Returns:
      (*grid_size) for a single pose, (B, *grid_size) for a batch.
    """
    grid_size, args, batched, pw_uniform = _normalise(
        grid_size, points, rotation, translation, background, out_weight,
        point_weight, dtype, device)
    resolved = dispatch.resolve_pair(
        backend, len(grid_size), grid_size, args[0].shape[0],
        accelerator=args[0].device.type == "cuda",
        f64=args[0].dtype == torch.float64)
    if args[0].shape[0] == 0:
        # empty cloud: the background image
        b = args[1].shape[0]
        out = args[3].reshape((b,) + (1,) * len(grid_size)).expand(
            (b,) + grid_size).contiguous()
    else:
        out = ad.raster_canonical(grid_size, resolved, pw_uniform, *args)
    return out if batched else out[0]


def _ndim(value):
    return value.ndim if isinstance(value, torch.Tensor) else np.ndim(value)


def raster_pullback(ds_dout, points, rotation, translation, background=None,
                    out_weight=None, point_weight=None, *, dtype=None,
                    backend: str = "auto", device=None) -> RasterGrads:
    """Analytic pullback of :func:`raster`: the gradients of all six
    inputs for the cotangent `ds_dout` of the output ((*grid_size) or
    (B, *grid_size)), given the same arguments as `raster`.

    Gradient shapes follow the input forms: a batch gets per-pose
    gradients, a single pose squeezed ones, and a scalar that was
    broadcast gets the summed gradient.  A defaulted `point_weight` gets
    the exact per-point gradient; a scalar one gets its sum.  `backend`
    and `device` are `raster`'s: one of the five backends or 'auto'; the
    card unless a tensor input or ``device="cpu"`` asks for the CPU.
    """
    device = _device_of((ds_dout, points, rotation, translation, background,
                         out_weight, point_weight), device)
    ds_dout = _as_tensor(ds_dout, device)
    bg_scalar = background is None or _ndim(background) == 0
    ow_scalar = out_weight is None or _ndim(out_weight) == 0
    grid_size, args, batched, pw_uniform = _normalise(
        tuple(ds_dout.shape[1:] if _ndim(rotation) == 3 else ds_dout.shape),
        points, rotation, translation, background, out_weight, point_weight,
        dtype, device)
    # the binned backend's uniform d_pw is only sum-exact, so take that
    # path ONLY where the summing below applies (a scalar weight was
    # passed); a defaulted weight still gets the exact per-point d_pw
    pw_scalar = point_weight is not None and pw_uniform
    if not batched:
        ds_dout = ds_dout[None]
    b = args[1].shape[0]
    if tuple(ds_dout.shape) != (b,) + grid_size:
        raise ValueError(
            f"ds_dout shape {tuple(ds_dout.shape)} does not match output "
            f"shape {(b,) + grid_size}")
    _, resolved = dispatch.resolve_pair(
        backend, len(grid_size), grid_size, args[0].shape[0],
        accelerator=device.type == "cuda",
        f64=args[0].dtype == torch.float64)
    g = ds_dout.to(args[0].dtype)
    if args[0].shape[0] == 0:
        zeros = args[0].new_zeros
        res = (zeros(args[0].shape), zeros(args[1].shape),
               zeros(args[2].shape), torch.sum(g.reshape(b, -1), dim=-1),
               zeros((b,)), zeros((0,)))
    else:
        res = dispatch.bwd_fn(resolved)(grid_size, *args, g,
                                        pw_uniform=pw_scalar)
    d_points, d_rot, d_trans, d_bg, d_ow, d_pw = res
    if not batched:
        d_rot, d_trans = d_rot[0], d_trans[0]
        d_bg, d_ow = d_bg[0], d_ow[0]
    else:
        if bg_scalar and background is not None:
            d_bg = torch.sum(d_bg)
        if ow_scalar and out_weight is not None:
            d_ow = torch.sum(d_ow)
    if pw_scalar:
        d_pw = torch.sum(d_pw)
    return RasterGrads(points=d_points, rotation=d_rot, translation=d_trans,
                       background=d_bg, out_weight=d_ow, point_weight=d_pw)
