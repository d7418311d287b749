"""Scatter/gather oracle (the ``"xla"`` backend)
(PyTorch port of `dprast/ops/core.py`).

Works for any (N_in, N_out) with N_in >= N_out, on any device.  The
forward is a scatter-add in a fixed order; the pullback is a pure
gather.  On the card three hand-written kernels run the path
(`csrc/xla_path.cu`), the device code that XLA compiles the JAX
functions into:

- X1 `xla_neighbours`: per (pose, point) the compensated voxel and
  deltas -- the fused pair's residuals -- and per neighbour its flat
  index, hat weight and term -- the scatter's sort keys and terms;
- the keys sorted stably (`torch.sort`), then X2 `xla_scatter`: the
  volume filled with each pose's background, and each run of equal keys
  added onto its voxel in the sort's order, one add at a time, which is
  `index_add_`'s order on the CPU, so the card's forward has the CPU's
  bits;
- X3 `xla_gather`: per (pose, point) its neighbours' indices and hat
  weights made again from the voxel and deltas, the 2^N cotangent values
  read in place and the products of the pullback; the sums over poses
  and points stay small torch contractions, as JAX computes them outside
  any kernel.

On CPU tensors each wrapper runs its plain version (`_xla_*_plain`),
which gives the kernel's bits.  A pullback that must record a graph
(grad mode on, and an input or the cotangent that requires grad: a
second derivative) runs the plain torch form from the inputs, on any
device, and counts it in `GRAPH_FORM_CALLS`; the kernels record no graph,
and neither do the residuals the forward saved.

All functions take canonical batched arguments:

    points       (P, N_in)
    rotation     (B, N_out, N_in)
    translation  (B, N_out)
    background   (B,)
    out_weight   (B,)
    point_weight (P,)
    out          (B, *grid_size)
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from dprast_torch.ops import geometry
from dprast_torch.utils.profiling import annotate

# the path's kernels, by the names their launches count under in
# `splat_binned.LAUNCHES`
XLA_KERNELS = ("xla_neighbours", "xla_scatter", "xla_gather")
# calls of the graph-recording pullback form (`_pullback_graph`)
GRAPH_FORM_CALLS = {"xla_plain": 0}
# by input, the gradients whose own work a pullback skipped because the
# caller did not ask for them (`asked`, autograd's `needs_input_grad`)
UNASKED_SKIPS = {name: 0 for name in ("points", "rotation", "translation",
                                      "background", "out_weight",
                                      "point_weight")}

# the ranks the kernels take (their per-axis tables, csrc/xla_path.cu)
MAX_AXES = 16


class PullbackResult(NamedTuple):
    """Gradients w.r.t. the six canonical inputs; None where a pullback
    was not asked for one (its `asked` mask)."""

    points: torch.Tensor        # (P, N_in)
    rotation: torch.Tensor      # (B, N_out, N_in)
    translation: torch.Tensor   # (B, N_out)
    background: torch.Tensor    # (B,)
    out_weight: torch.Tensor    # (B,)
    point_weight: torch.Tensor  # (P,)


# a pullback's `asked` mask where the caller gives none: all six gradients
ALL_ASKED = (True,) * 6


def note_unasked(asked, names):
    """Count in `UNASKED_SKIPS` each input of `names` whose gradient
    `asked` (six flags in the canonical order) leaves out: a pullback
    calls this for the gradients whose own work it skipped."""
    for name, wanted in zip(PullbackResult._fields, asked):
        if not wanted and name in names:
            UNASKED_SKIPS[name] += 1


def _neighbour_data(points, rotation, translation, grid_size):
    """Neighbour indices, per-shift multilinear weights and deltas.

    Returns (idx_flat (B, P, S) int64 with out-of-grid neighbours mapped to
    ``total``, wsplat (B, P, S), dl (B, P, N_out), shifts (S, N_out))."""
    res = geometry.pose_voxel_and_deltas(points, rotation, translation,
                                         grid_size)
    return (*expand_residuals(grid_size, res),
            geometry.shift_table(len(grid_size), points.device))


def expand_residuals(grid_size, residuals):
    """The fused pair's residuals ``(r0, dl)`` -- each (pose, point)'s
    voxel (B, P, N) int32 and deltas (B, P, N) -- expanded to
    `_neighbour_data`'s ``(idx_flat, wsplat, dl)``."""
    r0, dl = residuals
    dev = dl.device
    n_out = len(grid_size)
    shifts = geometry.shift_table(n_out, dev)
    idx = r0[..., None, :] + shifts                          # (B, P, S, N)
    sizes = geometry.axis_values(grid_size, torch.int32, dev)
    inb = torch.all((idx >= 0) & (idx < sizes), dim=-1)     # (B, P, S)
    strides = geometry.axis_values(
        [math.prod(grid_size[i + 1:]) for i in range(n_out)], torch.int64,
        dev)
    total = int(math.prod(grid_size))
    idx_flat = torch.sum(idx.long() * strides, dim=-1)
    # out-of-grid -> one past the end, which the scatter never stores and
    # the gather reads as 0 (the reference's silent per-neighbour drop)
    idx_flat = torch.where(inb, idx_flat, total)
    wsplat = geometry.splat_weights(dl, shifts)             # (B, P, S)
    return idx_flat, wsplat, dl


def _key_dtype(bsz, total):
    """The sort keys' dtype: int32 while every key, B * total for an
    out-of-grid term among them, fits."""
    return torch.int32 if bsz * total < 2 ** 31 else torch.int64


# ---------------------------------------------------------------------------
# X1: the neighbour stage
# ---------------------------------------------------------------------------


def _xla_neighbours_plain(grid_size, points, rotation, translation,
                          out_weight, point_weight, *, terms=True,
                          residuals=True):
    """Plain version of X1 -> ``(keys, vals, residuals)``: the sort keys
    (B, P, S), ``b * total + flat`` and B * total where out of grid, int32
    or int64 (`_key_dtype`); the terms ``(W_s * ow[b]) * pw[p]`` (B, P,
    S); the residuals ``(r0, dl)``, each (pose, point)'s voxel (int32) and
    deltas (B, P, N), which `expand_residuals` makes `_neighbour_data`'s.
    What is not asked for (`terms`, `residuals`) is None."""
    r0, dl = geometry.pose_voxel_and_deltas(points, rotation, translation,
                                            grid_size)
    keys = vals = None
    if terms:
        idx_flat, wsplat, _ = expand_residuals(grid_size, (r0, dl))
        bsz = rotation.shape[0]
        total = int(math.prod(grid_size))
        base = torch.arange(bsz, device=points.device)[:, None, None] * total
        keys = torch.where(idx_flat < total, idx_flat + base,
                           bsz * total).to(_key_dtype(bsz, total))
        vals = wsplat * out_weight[:, None, None] * point_weight[None, :, None]
    return keys, vals, ((r0, dl) if residuals else None)


def _coordinate_dtype(points, rotation, translation):
    """What `geometry.pose_voxel_and_deltas` computes in: float64 where an
    input is, else float32."""
    if torch.float64 in (points.dtype, rotation.dtype, translation.dtype):
        return torch.float64
    return torch.float32


def _weight(name, w, dtype, n, dev):
    """A per-pose or per-point value (a weight, the background) for a
    kernel: `dtype` on `dev`, (n,) with any element stride (0 for a
    broadcast value)."""
    from dprast_torch.ops import splat_binned as sb
    w = w.to(dtype)
    if w.shape != (n,) or not sb._on_card(w) or w.device != dev:
        raise ValueError(f"{name}: a weight of shape {tuple(w.shape)} on "
                         f"{w.device}; expected ({n},) on the CUDA device "
                         f"{dev}")
    return w


def _sizes(grid_size):
    n = len(grid_size)
    if not 1 <= n <= MAX_AXES:
        raise ValueError(f"xla path: a grid of {n} axes exceeds the "
                         f"kernels' {MAX_AXES}")
    return (ctypes.c_int * n)(*grid_size)


@annotate("dprast.x1.neighbours")
def xla_neighbours(grid_size, points, rotation, translation, out_weight,
                   point_weight, *, terms=True, residuals=True):
    """X1 -> ``(keys, vals, residuals)`` as `_xla_neighbours_plain` gives
    them.  CPU tensors take the plain version, CUDA tensors one launch of
    `csrc/xla_path.cu` (fp32 coordinates by the double-float32 transform,
    or fp64 where an input of the transform is; the weights are cast to
    that dtype), which gives the plain version's bits."""
    if points.device.type == "cpu":
        return _xla_neighbours_plain(grid_size, points, rotation,
                                     translation, out_weight, point_weight,
                                     terms=terms, residuals=residuals)
    from dprast_torch.ops import splat_binned as sb
    dtype = _coordinate_dtype(points, rotation, translation)
    pts, rot, tr = (x.to(dtype).contiguous()
                    for x in (points, rotation, translation))
    sb._check_cuda("xla_neighbours", pts, dtype, rot, dtype, tr, dtype)
    n_out = len(grid_size)
    bsz = rot.shape[0]
    p, n_in = pts.shape if pts.dim() == 2 else (0, 0)
    if pts.dim() != 2 or n_in < 1 or rot.shape != (bsz, n_out, n_in) or \
            tr.shape != (bsz, n_out):
        raise ValueError(f"xla_neighbours: points {tuple(pts.shape)}, "
                         f"rotation {tuple(rot.shape)} and translation "
                         f"{tuple(tr.shape)} do not form poses onto the "
                         f"grid {tuple(grid_size)}")
    if p >= 2 ** 31:
        raise ValueError(f"xla_neighbours: P={p} exceeds the kernel's "
                         f"launch bounds")
    dev = pts.device
    ow = _weight("xla_neighbours", out_weight, dtype, bsz, dev)
    pw = _weight("xla_neighbours", point_weight, dtype, p, dev)
    sizes = _sizes(grid_size)
    total = int(math.prod(grid_size))
    n_s = 2 ** n_out
    key_dtype = _key_dtype(bsz, total)
    keys = torch.empty((bsz, p, n_s), dtype=key_dtype, device=dev) \
        if terms else None
    vals = torch.empty((bsz, p, n_s), dtype=dtype, device=dev) \
        if terms else None
    res = (torch.empty((bsz, p, n_out), dtype=torch.int32, device=dev),
           torch.empty((bsz, p, n_out), dtype=dtype, device=dev)) \
        if residuals else None
    if bsz and p and (terms or residuals):
        def ptr(t):
            return None if t is None else sb._ptr(t)
        r0, dl = res if residuals else (None, None)
        sb._launch("xla_neighbours", dev,
                   sb._build.load().dprast_xla_neighbours, ptr(pts),
                   ptr(rot), ptr(tr), ptr(ow), ow.stride(0), ptr(pw),
                   pw.stride(0), ptr(keys), int(key_dtype == torch.int64),
                   ptr(vals), ptr(r0), ptr(dl), bsz, p, n_in, n_out, sizes,
                   int(dtype == torch.float64))
        sb.LAUNCHES["xla_neighbours"] += 1
    return keys, vals, res


# ---------------------------------------------------------------------------
# X2: the fixed-order scatter
# ---------------------------------------------------------------------------


def _xla_scatter_plain(background, grid_size, keys, perm, vals):
    """Plain version of X2 -> (B, *grid): each pose's background, then
    ``flat[keys[i]] += vals[perm[i]]`` (``vals[i]`` where `perm` is None)
    in the order of i by `index_add_` (the CPU adds in input order), keys
    at or past B * total into a sink that is dropped."""
    bsz, total = background.shape[0], int(math.prod(grid_size))
    buf = vals.new_empty(bsz * total + 1)
    buf[:-1].view(bsz, total).copy_(background.to(vals.dtype)[:, None])
    buf[-1:].zero_()
    buf.index_add_(0, keys, vals if perm is None else vals[perm])
    return buf[:-1].view((bsz,) + tuple(grid_size))


@annotate("dprast.x2.scatter")
def xla_scatter(background, grid_size, keys, perm, vals):
    """X2 -> out (B, *grid): each pose's background (B,), plus each term
    ``vals[perm[i]]`` at ``keys[i]`` of the flat volume, where `keys` (n,)
    are sorted stably and `perm` (n,) int64 is the sort's permutation of
    the terms `vals` (n,); keys at or past B * total are out of grid and
    skipped.  Each run of equal keys is added onto its voxel in the order
    of i, one add at a time, from the background: the bits of `index_add_`
    of the terms in input order on the CPU.  CPU tensors take the plain
    version, CUDA tensors one call of `csrc/xla_path.cu` (the fill, then
    the runs: no atomics, one writer a voxel)."""
    if vals.device.type == "cpu":
        return _xla_scatter_plain(background, grid_size, keys, perm, vals)
    from dprast_torch.ops import splat_binned as sb
    dtype = vals.dtype
    if dtype not in (torch.float32, torch.float64) or \
            keys.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"xla_scatter: {dtype} terms and {keys.dtype} "
                         f"keys; expected float32 or float64 and int32 or "
                         f"int64")
    sb._check_cuda("xla_scatter", vals, dtype, keys, keys.dtype, perm,
                   torch.int64)
    n = keys.numel()
    if keys.dim() != 1 or perm.shape != (n,) or vals.shape != (n,):
        raise ValueError(f"xla_scatter: keys {tuple(keys.shape)}, perm "
                         f"{tuple(perm.shape)} and terms {tuple(vals.shape)} "
                         f"are not three vectors of one length")
    bsz, total = background.shape[0], int(math.prod(grid_size))
    bg = _weight("xla_scatter", background, dtype, bsz, vals.device)
    if keys.dtype == torch.int32 and bsz * total >= 2 ** 31:
        raise ValueError(f"xla_scatter: int32 keys into a volume of "
                         f"{bsz * total} entries")
    out = torch.empty((bsz,) + tuple(grid_size), dtype=dtype,
                      device=vals.device)
    if out.numel():
        sb._launch("xla_scatter", out.device,
                   sb._build.load().dprast_xla_scatter, sb._ptr(out),
                   sb._ptr(bg), bg.stride(0), sb._ptr(keys),
                   int(keys.dtype == torch.int64), sb._ptr(perm),
                   sb._ptr(vals), n, bsz, total,
                   int(dtype == torch.float64))
        sb.LAUNCHES["xla_scatter"] += 1
    return out


# ---------------------------------------------------------------------------
# X3: the in-place pullback gather
# ---------------------------------------------------------------------------


def _xla_gather_plain(grid_size, ds_dout, residuals, out_weight,
                      point_weight):
    """Plain version of X3 -> ``(scaled (B, P, N), gw (B, P))`` from the
    residuals ``(r0, dl)``: `_gather_expanded` on their expansion, plain
    torch, so it records a graph where one is wanted."""
    return _gather_expanded(grid_size, ds_dout,
                            expand_residuals(grid_size, residuals),
                            out_weight, point_weight)


def _gather_expanded(grid_size, ds_dout, expanded, out_weight,
                     point_weight):
    """X3's function on `_neighbour_data`'s ``(idx_flat, wsplat, dl)``:
    per (pose, point) the cotangent at its 2^N neighbours (0 out of grid),
    ``gw = sum_s g_s W_s`` and ``scaled_i = (sum_s g_s (ow pw) dW_s/ddl_i)
    * g_i / 2``, each sum in increasing s, each product of the hat
    weight's derivative left to right."""
    idx_flat, wsplat, dl = expanded
    bsz, p, n_s = idx_flat.shape
    n = dl.shape[-1]
    total = int(math.prod(grid_size))
    g_flat = ds_dout.reshape(bsz, -1)
    inb = idx_flat < total
    g = torch.gather(g_flat, 1, torch.clamp(idx_flat, max=total - 1)
                     .reshape(bsz, -1)).reshape(idx_flat.shape)
    g = torch.where(inb, g, 0)
    c = out_weight[:, None] * point_weight[None, :]          # (B, P)
    one_minus = 1 - dl
    sign = torch.ones((), dtype=dl.dtype, device=dl.device)
    gw = None
    acc = [None] * n
    for s in range(n_s):
        gs = g[..., s]
        t = gs * wsplat[..., s]
        gw = t if gw is None else gw + t
        f = gs * c
        sel = [dl[..., j] if (s >> j) & 1 else one_minus[..., j]
               for j in range(n)]
        for i in range(n):
            d = None
            for j in range(n):
                if j != i:
                    d = sel[j] if d is None else d * sel[j]
            d = sign if d is None else d
            d = (sign if (s >> i) & 1 else -sign) * d
            term = f * d
            acc[i] = term if acc[i] is None else acc[i] + term
    scale = geometry.axis_values([x / 2 for x in grid_size], dl.dtype,
                                 dl.device)
    return torch.stack(acc, dim=-1) * scale, gw


@annotate("dprast.x3.gather")
def xla_gather(grid_size, ds_dout, residuals, out_weight, point_weight):
    """X3 -> ``(scaled, gw)`` as `_xla_gather_plain` gives them, from the
    cotangent (B, *grid) read in place and X1's residuals ``(r0, dl)``.
    CPU tensors take the plain version, CUDA tensors one launch of
    `csrc/xla_path.cu`, which gives its bits."""
    if ds_dout.device.type == "cpu":
        return _xla_gather_plain(grid_size, ds_dout, residuals, out_weight,
                                 point_weight)
    from dprast_torch.ops import splat_binned as sb
    r0, dl = residuals
    dtype = dl.dtype
    g = ds_dout.to(dtype).contiguous()
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"xla_gather: {dtype} residuals; expected float32 "
                         f"or float64")
    sb._check_cuda("xla_gather", g, dtype, r0, torch.int32, dl, dtype)
    n_out = len(grid_size)
    bsz, p = r0.shape[:2] if r0.dim() == 3 else (0, 0)
    total = int(math.prod(grid_size))
    if g.numel() != bsz * total or r0.shape != (bsz, p, n_out) or \
            dl.shape != r0.shape:
        raise ValueError(f"xla_gather: cotangent {tuple(g.shape)} and "
                         f"residuals {tuple(r0.shape)}, {tuple(dl.shape)} "
                         f"do not match the grid {tuple(grid_size)}")
    if p >= 2 ** 31:
        raise ValueError(f"xla_gather: P={p} exceeds the kernel's launch "
                         f"bounds")
    dev = g.device
    ow = _weight("xla_gather", out_weight, dtype, bsz, dev)
    pw = _weight("xla_gather", point_weight, dtype, p, dev)
    scaled = torch.empty((bsz, p, n_out), dtype=dtype, device=dev)
    gw = torch.empty((bsz, p), dtype=dtype, device=dev)
    if bsz and p:
        sb._launch("xla_gather", dev, sb._build.load().dprast_xla_gather,
                   sb._ptr(g), sb._ptr(r0), sb._ptr(dl),
                   sb._ptr(ow), ow.stride(0), sb._ptr(pw), pw.stride(0),
                   sb._ptr(scaled), sb._ptr(gw), bsz, p, n_out,
                   _sizes(grid_size), int(dtype == torch.float64))
        sb.LAUNCHES["xla_gather"] += 1
    return scaled, gw


# ---------------------------------------------------------------------------
# the backend
# ---------------------------------------------------------------------------


def raster_fwd(grid_size, points, rotation, translation, background,
               out_weight, point_weight, *, pw_uniform: bool = False):
    """Forward rasterisation on canonical batched args -> (B, *grid_size):
    background per pose, every point splats ``out_weight[b] *
    point_weight[p]`` multilinearly onto its 2^N neighbours, out-of-grid
    neighbours dropped.  (`pw_uniform` is accepted for dispatch
    uniformity; the weight multiply is fused into the scatter operand.)"""
    del pw_uniform
    return _forward(grid_size, points, rotation, translation, background,
                    out_weight, point_weight, residuals=False)[0]


def raster_fwd_res(grid_size, points, rotation, translation, background,
                   out_weight, point_weight, *, pw_uniform: bool = False):
    """Forward + the neighbour-geometry residuals ``(r0, dl)``: each
    (pose, point)'s voxel and deltas, so that the pullback of the fused
    autograd pair skips the compensated transform (X3 makes the
    neighbours' indices and weights from them again)."""
    del pw_uniform
    return _forward(grid_size, points, rotation, translation, background,
                    out_weight, point_weight, residuals=True)


def _forward(grid_size, points, rotation, translation, background,
             out_weight, point_weight, *, residuals):
    """X1, the stable sort of its keys, and X2 (the background, then the
    terms) -> (out, residuals or None); on the CPU X1's terms go unsorted
    into X2's plain version.  Nothing reads a size back to the host."""
    keys, vals, res = xla_neighbours(grid_size, points, rotation,
                                     translation, out_weight, point_weight,
                                     residuals=residuals)
    keys, vals = keys.reshape(-1), vals.reshape(-1)
    if vals.device.type == "cpu":
        # the CPU's `index_add_` adds in input order, the order the stable
        # sort keeps within a voxel: the sort would move no bit
        with annotate("dprast.x2.scatter"):
            return _xla_scatter_plain(background, grid_size, keys, None,
                                      vals), res
    with annotate("dprast.sort"):
        order, perm = torch.sort(keys, stable=True)
    return xla_scatter(background, grid_size, order, perm, vals), res


def _records_graph(*tensors):
    """Whether a pullback must record a graph: grad mode on (inside a
    backward only under ``create_graph=True``) and a tensor that requires
    grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def raster_pullback_res(grid_size, residuals, args, ds_dout, *,
                        pw_uniform: bool = False,
                        asked=ALL_ASKED) -> PullbackResult:
    """Pullback reusing the `raster_fwd_res` residuals: X3 and the
    contractions.  The residuals carry no graph, so where one must be
    recorded (`_records_graph`) this recomputes from `args` as
    `raster_pullback` does.  `asked` as in `raster_pullback`."""
    del pw_uniform
    points, rotation, translation, _, out_weight, point_weight = args
    if _records_graph(points, rotation, translation, out_weight,
                      point_weight, ds_dout):
        return _pullback_graph(grid_size, points, rotation, translation,
                               out_weight, point_weight, ds_dout, asked)
    scaled, gw = xla_gather(grid_size, ds_dout, residuals, out_weight,
                            point_weight)
    return _contract(points, rotation, out_weight, point_weight, ds_dout,
                     scaled, gw, asked)


def raster_pullback(grid_size, points, rotation, translation, background,
                    out_weight, point_weight, ds_dout, *,
                    pw_uniform: bool = False,
                    asked=ALL_ASKED) -> PullbackResult:
    """Analytic pullback on canonical batched args.

    A pure gather: recompute the forward's neighbour geometry (X1's
    residuals), read the 2^N cotangent values per (pose, point) (X3) and
    contract:

      ds/du_i  = sum_s g * ow * pw * dW_s/ddl_i
      scaled   = ds/du * (n/2)
      ds/dt    = sum_p scaled
      ds/dR    = sum_p scaled (x) p
      ds/dp    = sum_b R^T scaled
      ds/dbg   = sum_grid ds_dout
      ds/dow   = sum_{p,s} g * W_s * pw
      ds/dpw   = sum_{b,s} g * W_s * ow

    `asked` (six flags in the canonical order) names the gradients
    wanted: the contraction of each other one is skipped and its entry
    is None.

    Where a graph must be recorded (grad mode on and a tensor that
    requires grad: the pullback differentiated once more) it runs the
    plain torch form instead (`_pullback_graph`), on any device."""
    del pw_uniform, background
    if _records_graph(points, rotation, translation, out_weight,
                      point_weight, ds_dout):
        return _pullback_graph(grid_size, points, rotation, translation,
                               out_weight, point_weight, ds_dout, asked)
    _, _, res = xla_neighbours(grid_size, points, rotation, translation,
                               out_weight, point_weight, terms=False)
    scaled, gw = xla_gather(grid_size, ds_dout, res, out_weight,
                            point_weight)
    return _contract(points, rotation, out_weight, point_weight, ds_dout,
                     scaled, gw, asked)


def _pullback_graph(grid_size, points, rotation, translation, out_weight,
                    point_weight, ds_dout, asked=ALL_ASKED) -> PullbackResult:
    """The pullback in plain torch from the inputs (the voxel and deltas,
    `_xla_gather_plain`, the contractions), which records the graph of
    every input and the cotangent: the form a second derivative runs."""
    GRAPH_FORM_CALLS["xla_plain"] += 1
    res = geometry.pose_voxel_and_deltas(points, rotation, translation,
                                         grid_size)
    scaled, gw = _xla_gather_plain(grid_size, ds_dout, res, out_weight,
                                   point_weight)
    return _contract(points, rotation, out_weight, point_weight, ds_dout,
                     scaled, gw, asked)


def _contract(points, rotation, out_weight, point_weight, ds_dout, scaled,
              gw, asked=ALL_ASKED) -> PullbackResult:
    """The gradients from X3's ``(scaled, gw)``: small contractions over
    poses and points (fp32 products: TF32 stays off), and `d_bg`, one sum
    of the cotangent.  Each gradient runs only where `asked`, else it is
    None (counted in `UNASKED_SKIPS`).  The three gradients that have
    work of their own each run in a span (``dprast.grad.<input>``), so a
    trace shows what each costs where it runs."""
    b = rotation.shape[0]
    note_unasked(asked, PullbackResult._fields)
    want = PullbackResult(*asked)
    d_points = d_rot = d_trans = d_bg = d_ow = d_pw = None
    if want.points or want.rotation or want.translation:
        with annotate("dprast.contract"):
            if want.points:
                d_points = torch.einsum("boi,bpo->pi", rotation, scaled)
            if want.rotation:
                d_rot = torch.einsum("bpo,pi->boi", scaled, points)
            if want.translation:
                d_trans = torch.sum(scaled, dim=1)
    if want.background:
        with annotate("dprast.grad.background"):
            d_bg = torch.sum(ds_dout.reshape(b, -1), dim=-1)
    if want.out_weight:
        with annotate("dprast.grad.out_weight"):
            d_ow = torch.einsum("bp,p->b", gw, point_weight)
    if want.point_weight:
        with annotate("dprast.grad.point_weight"):
            d_pw = torch.einsum("bp,b->p", gw, out_weight)
    return PullbackResult(points=d_points, rotation=d_rot,
                          translation=d_trans, background=d_bg,
                          out_weight=d_ow, point_weight=d_pw)
