"""Autograd wiring on canonical batched arguments (PyTorch port of
`dprast/ad.py`): one `torch.autograd.Function` whose forward runs the
selected backend and whose backward is that backend's analytic pullback.
"""

from __future__ import annotations

import torch

from dprast_torch.ops import dispatch


class _Raster(torch.autograd.Function):
    """Static arguments: `grid_size` (tuple of ints), `backend` (the
    resolved (forward, backward) name pair) and `pw_uniform` (the promise
    that point_weight is a broadcast scalar).  The six tensors are
    differentiable.

    When both directions run on one backend with a fused pair, the
    forward saves that backend's residuals (the binned backend's sorted
    slot frame, the oracle's neighbour geometry) and the backward reuses
    them; otherwise the backward recomputes from the six inputs."""

    @staticmethod
    def forward(ctx, grid_size, backend, pw_uniform, *args):
        fwd_name, bwd_name = backend
        pair = dispatch.vjp_pair(fwd_name) if fwd_name == bwd_name else None
        ctx.grid_size, ctx.backend, ctx.pw_uniform = (grid_size, backend,
                                                      pw_uniform)
        if pair is None:
            out = dispatch.fwd_fn(fwd_name)(grid_size, *args,
                                            pw_uniform=pw_uniform)
            res = ()
        else:
            out, res = pair[0](grid_size, *args, pw_uniform=pw_uniform)
        ctx.fused = pair is not None
        ctx.save_for_backward(*args, *res)
        return out

    @staticmethod
    def backward(ctx, ds_dout):
        saved = ctx.saved_tensors
        args, res = saved[:6], saved[6:]
        # `loss = out.sum()` hands back a stride-0 expanded cotangent
        ds_dout = ds_dout.contiguous()
        fwd_name, bwd_name = ctx.backend
        if ctx.fused:
            grads = dispatch.vjp_pair(fwd_name)[1](
                ctx.grid_size, res, args, ds_dout, pw_uniform=ctx.pw_uniform)
        else:
            grads = dispatch.bwd_fn(bwd_name)(
                ctx.grid_size, *args, ds_dout, pw_uniform=ctx.pw_uniform)
        # PullbackResult's field order is the canonical argument order
        return (None, None, None) + tuple(grads)


class _RasterOnce(_Raster):
    """`_Raster` for a backend whose pullback runs CUDA kernels (or, on the
    CPU, their plain twins): the kernels record no graph, so a gradient
    taken with ``create_graph=True`` would be cut from it without a word.
    Asking for such a gradient raises instead."""

    @staticmethod
    def backward(ctx, ds_dout):
        # grad mode is on inside a backward only under create_graph=True
        if torch.is_grad_enabled():
            raise RuntimeError(
                f"raster: the {ctx.backend[1]!r} backend can be "
                f"differentiated once; a gradient with create_graph=True "
                f"(a second derivative) needs backend='xla'")
        return _Raster.backward(ctx, ds_dout)


# the backend whose pullback is plain differentiable torch
_TWICE_DIFFERENTIABLE = ("xla",)


def raster_canonical(grid_size, backend, pw_uniform, points, rotation,
                     translation, background, out_weight, point_weight):
    """Forward rasterisation on canonical batched args -> (B, *grid_size),
    differentiable in the six tensors.  `backend` is a resolved name or a
    (forward, backward) name pair.  Without a tensor that requires grad
    (or under `torch.no_grad`) this is the plain forward, which keeps no
    residuals.  Only a backward on `_TWICE_DIFFERENTIABLE` can itself be
    differentiated; on any other a backward under ``create_graph=True``
    raises."""
    if isinstance(backend, str):
        backend = (backend, backend)
    args = (points, rotation, translation, background, out_weight,
            point_weight)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        fn = _Raster if backend[1] in _TWICE_DIFFERENTIABLE else _RasterOnce
        return fn.apply(grid_size, tuple(backend), pw_uniform, *args)
    return dispatch.fwd_fn(backend[0])(grid_size, *args,
                                       pw_uniform=pw_uniform)
