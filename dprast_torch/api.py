"""Public API, forward half: argument normalisation + shape validation
(PyTorch port of `dprast/api.py`).

Layout (the JAX package's, so both take the same arrays):

    points       (P, N_in)
    rotation     (N_out, N_in)  or (B, N_out, N_in)
    translation  (N_out,)       or (B, N_out)
    background   scalar         or (B,)
    out_weight   scalar         or (B,)
    point_weight scalar or (P,)
    output       (*grid_size)   or (B, *grid_size)

Inputs may be tensors, numpy arrays, nested lists or Python scalars.  The
device is that of the tensor inputs, which must agree; with no tensor
input it is the `device` argument (default CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from dprast_torch.ops import dispatch

_NAMES = ("points", "rotation", "translation", "background", "out_weight",
          "point_weight")


def _device_of(values, device):
    devices = {v.device for v in values if isinstance(v, torch.Tensor)}
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        devices.add(device)
    if len(devices) > 1:
        raise ValueError(
            f"all inputs must be on one device; got {sorted(map(str, devices))}")
    return devices.pop() if devices else torch.device("cpu")


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
    """Rasterise a point cloud into an N-dimensional grid (forward).

    Each point ``p`` is transformed to ``q = rotation @ p + translation``
    and, if it falls inside (-1, 1)^N, its weight ``out_weight *
    point_weight`` is distributed onto the 2^N nearest voxels by
    multilinear interpolation.  The output starts at `background`.

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
      backend: 'auto' | 'xla' | 'binned'.
      device: where numpy / list inputs go when no input is a tensor.

    Returns:
      (*grid_size) for a single pose, (B, *grid_size) for a batch.

    Raises NotImplementedError for inputs that require grad: the gradients
    arrive with the backward kernels.
    """
    raw = (points, rotation, translation, background, out_weight,
           point_weight)
    grads = [n for n, v in zip(_NAMES, raw)
             if isinstance(v, torch.Tensor) and v.requires_grad]
    if grads:
        raise NotImplementedError(
            f"{', '.join(grads)} require grad; gradients arrive with the "
            f"backward kernels (ROADMAP A4/A5 backward)")
    grid_size, args, batched, pw_uniform = _normalise(
        grid_size, points, rotation, translation, background, out_weight,
        point_weight, dtype, device)
    fwd_name, _ = dispatch.resolve_pair(
        backend, len(grid_size), grid_size, args[0].shape[0],
        accelerator=args[0].device.type == "cuda",
        f64=args[0].dtype == torch.float64)
    if args[0].shape[0] == 0:
        # empty cloud: the background image
        b = args[1].shape[0]
        out = args[3].reshape((b,) + (1,) * len(grid_size)).expand(
            (b,) + grid_size).contiguous()
    else:
        out = dispatch.fwd_fn(fwd_name)(grid_size, *args,
                                        pw_uniform=pw_uniform)
    return out if batched else out[0]
