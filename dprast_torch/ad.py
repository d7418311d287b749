"""Autograd wiring on canonical batched arguments (PyTorch port of
`dprast/ad.py`): one `torch.autograd.Function` whose forward runs the
selected backend and whose backward is that backend's analytic pullback,
which computes only the gradients autograd asks for.
"""

from __future__ import annotations

import torch

from dprast_torch.ops import dispatch
from dprast_torch.utils.profiling import annotate


class _Raster(torch.autograd.Function):
    """Static arguments: `grid_size` (tuple of ints), `backend` (the
    resolved (forward, backward) name pair) and `pw_uniform` (the promise
    that point_weight is a broadcast scalar).  The six tensors are
    differentiable.

    When both directions run on one backend with a fused pair, the
    forward saves that backend's residuals (the binned backend's sorted
    slot frame, the oracle's neighbour geometry) and the backward reuses
    them; otherwise the backward recomputes from the six inputs.  The
    residuals are made with grad mode off and carry no graph: under
    ``create_graph=True`` (a second derivative; grad mode is on inside
    the backward only then) the oracle's fused pullback
    (`core.raster_pullback_res`) recomputes them from the inputs in plain
    torch, so that the graph holds every second-order term of the point
    geometry.

    The backward passes the six tensors' `ctx.needs_input_grad` to the
    pullback as its `asked` mask, so that the work only an unasked
    gradient needs (the background's sum of the cotangent, the oracle's
    contractions) is skipped, and returns None for each unasked input."""

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
        fwd_name, bwd_name = ctx.backend
        # the six tensors' flags in the canonical order (PullbackResult's
        # field order): the pullback skips what only an unasked one needs
        asked = tuple(ctx.needs_input_grad[3:9])
        # on autograd's own thread where the cotangent is on the card
        with annotate(f"dprast.pullback[{bwd_name}]"):
            saved = ctx.saved_tensors
            args, res = saved[:6], saved[6:]
            # `loss = out.sum()` hands back a stride-0 expanded cotangent
            ds_dout = ds_dout.contiguous()
            if ctx.fused:
                grads = dispatch.vjp_pair(fwd_name)[1](
                    ctx.grid_size, res, args, ds_dout,
                    pw_uniform=ctx.pw_uniform, asked=asked)
            else:
                grads = dispatch.bwd_fn(bwd_name)(
                    ctx.grid_size, *args, ds_dout, pw_uniform=ctx.pw_uniform,
                    asked=asked)
            return (None, None, None) + tuple(
                g if wanted else None for g, wanted in zip(grads, asked))


class _RasterOnce(_Raster):
    """`_Raster` for a backend whose pullback cannot itself be
    differentiated.  The binned pullback runs CUDA kernels (or, on the CPU,
    their plain twins), which record no graph, so a gradient taken with
    ``create_graph=True`` would be cut from it without a word; the matmul
    pullback rounds its operands to bf16 planes, through which autograd
    would carry a second derivative in bf16.  Asking for such a gradient
    raises instead."""

    @staticmethod
    def backward(ctx, ds_dout):
        # grad mode is on inside a backward only under create_graph=True
        if torch.is_grad_enabled():
            raise RuntimeError(
                f"raster: the {ctx.backend[1]!r} backend can be "
                f"differentiated once; a gradient with create_graph=True "
                f"(a second derivative) needs backend='xla'")
        return _Raster.backward(ctx, ds_dout)


# the backend whose pullback has a plain torch form in the inputs' own
# precision, which a backward under create_graph=True runs
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
