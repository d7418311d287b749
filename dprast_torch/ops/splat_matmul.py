"""Scatter-free matrix-product formulation of the multilinear splat (the
``"matmul"`` and ``"matmul_bf16"`` backends; PyTorch port of
`dprast/ops/splat_matmul.py`).

The splat weight factorises over output axes.  Split the stencil of the
LAST axis into its two branches ``sx in {0, 1}`` and write the one-hot of
column ``r0_x + sx`` as an EXACT 0/1 matrix ``O_sx`` (exactly representable
in bf16); everything else, the product of the leading-axis pair factors,
the per-point weight and the branch weight ``w_sx(dl_x)``, is a dense f32
"value" operand ``V_sx``.  The forward is then

    out[b] = bg[b] + ow[b] * sum_sx einsum('pr,px->rx', V_sx, O_sx)

i.e. dense matrix products with no scatter and no atomics.  Out-of-grid
neighbours drop out because the index comparison never matches.

Precision: each ``V`` is decomposed into an error-free sum of `terms` bf16
planes and each plane is multiplied once with the exact one-hot, with fp32
accumulation.  With no cross terms, 3 planes reproduce every product to
~2^-24.  The JAX package leaves these products to XLA outside any Pallas
kernel; here they are `torch.bmm`, a library product, too.

The backward reuses the same selection family: ``T_sx = O_sx @ g`` gathers,
per point, the two x-stencil columns of the cotangent across all
leading-axis rows; every gradient then follows from row reductions against
the leading-axis pair factors.

Points are processed in chunks by a Python loop, so that the transient
operands stay bounded; the voxel coordinates of the whole cloud are worked
out once, ahead of the loop.  Eager torch materialises the value operand, its
planes and the one-hots of a chunk in device memory (XLA fuses their
construction into the product's operand reads), so the path is bound by
bytes here.  float64 inputs skip the bf16 decomposition and run the same
products in float64.

On a CUDA device the products of bf16 planes run with an fp32 result
(``out_dtype``) and with
`torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction` set to
False for the call and restored after it (`_bf16_bmm`); the flag is global
to the process, so a thread that multiplies bf16 matrices at the same
moment sees it off.  On the CPU, where `bmm` has no fp32-result form for
bf16 operands, the planes and the one-hot are widened to fp32 and
multiplied there: every product is a bf16 value times 0 or 1, exact either
way, and only the order of the fp32 sums differs.  The fp32 reductions of
the pullback must run in true fp32: keep
`torch.backends.cuda.matmul.allow_tf32` at its default, False.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F

from dprast_torch.ops import geometry
from dprast_torch.ops.core import ALL_ASKED, PullbackResult, note_unasked

# Error-free bf16 planes per value operand; 1 plane is the documented
# 'matmul_bf16' fast mode (~2e-3 relative error).  The forward's planes are
# one product each, the backward's ride ONE product, concatenated along its
# contraction axis.  Both defaults sit inside the <= 1e-5 contract against
# the f64 oracles.
FWD_TERMS = 2
BWD_TERMS = 3


def supported(n_out: int) -> bool:
    return n_out in (1, 2, 3)


def _split_planes(x, terms):
    """Error-free decomposition of f32 `x` into `terms` bf16 planes, each
    the remainder so far rounded to the nearest bf16 (ties to even)."""
    planes = []
    rem = x
    for i in range(terms):
        t = rem.to(torch.bfloat16)
        planes.append(t)
        if i < terms - 1:
            rem = rem - t.float()
    return planes


@contextlib.contextmanager
def _full_precision_bf16_sums():
    """bf16 matrix products on CUDA accumulate in fp32 throughout while
    this is open (split-K partial sums are not rounded to bf16)."""
    mm = torch.backends.cuda.matmul
    before = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_bf16_reduced_precision_reduction = before


def _bf16_bmm(a, b):
    """Batched product of bf16 `a` (B, M, K) and `b` (B, K, N) with fp32
    accumulation and an fp32 result.  CUDA tensors take `torch.bmm` with
    ``out_dtype``; CPU tensors are widened to fp32 first (see the module
    docstring)."""
    if a.device.type == "cpu":
        return torch.bmm(a.float(), b.float())
    with _full_precision_bf16_sums():
        return torch.bmm(a, b, out_dtype=torch.float32)


def _branch_dot(value, onehot_mask, terms):
    """``einsum("bpr,bpx->brx", value, onehot)``: bf16 planes of `value`
    times the exact 0/1 one-hot with fp32 accumulation, summed in plane
    order; float64 runs one float64 product instead."""
    if value.dtype == torch.float64:
        return torch.bmm(value.transpose(1, 2), onehot_mask.to(torch.float64))
    o = onehot_mask.to(torch.bfloat16)
    out = None
    for vt in _split_planes(value, terms):
        part = _bf16_bmm(vt.transpose(1, 2), o)
        out = part if out is None else out + part
    return out


def _pick_chunk(n_points: int, batch: int, grid_size) -> int:
    """Point-chunk size: bound the transient (B, C, R) value operand to
    ~128 MiB while keeping the contraction dimension large.  (The budget
    is the JAX package's, read on its own chip: to re-measure here.)"""
    if len(grid_size) == 3:
        width = grid_size[0] * grid_size[1] + sum(grid_size)
    else:
        width = sum(grid_size)
    budget = 128 * 1024 * 1024
    chunk = budget // max(1, 4 * batch * width)
    chunk = max(8, min(n_points, chunk))
    # lower bound 8 also covers the degenerate P=0 call
    return max(8, min(int(-(-n_points // 8) * 8), int(-(-chunk // 8) * 8)))


def _chunked(points, point_weight, chunk):
    """Pad the point axis to a multiple of `chunk` and reshape to
    (K, chunk, ...).  Padded entries are masked via `valid`."""
    p = points.shape[0]
    k = -(-p // chunk)
    pad = k * chunk - p
    pts = F.pad(points, (0, 0, 0, pad))
    pw = F.pad(point_weight, (0, pad))
    valid = torch.arange(k * chunk, device=points.device) < p
    return (pts.reshape(k, chunk, points.shape[1]), pw.reshape(k, chunk),
            valid.reshape(k, chunk), k, pad)


def _chunked_voxels(points, rotation, translation, grid_size, chunk, pad):
    """``(r0, dl)`` of every (pose, point), computed once for the whole
    cloud and cut into the chunks of `_chunked`: (K, B, chunk, N_out)
    each.  They are a thousandth of the value operand that the chunks
    bound, and the eager coordinate pipeline costs some forty launches,
    which a chunk need not repeat.  The padded entries (zeros) are masked
    by `valid`."""
    r0, dl = geometry.pose_voxel_and_deltas(points, rotation, translation,
                                            grid_size)
    b, _, n_out = r0.shape

    def cut(x):
        x = F.pad(x, (0, 0, 0, pad))
        return x.reshape(b, -1, chunk, n_out).transpose(0, 1)

    return cut(r0), cut(dl)


def _axis_pair(r0_ax, dl_ax, n, cdt):
    """Dense pair factor (A, dA) for one leading axis: (B, C, n) with
    ``1-dl`` at row r0 and ``dl`` at row r0+1 (dA: -1/+1 there);
    out-of-grid rows never match."""
    h = torch.arange(n, dtype=torch.int32, device=r0_ax.device)
    lo = h == r0_ax[..., None]
    hi = h == (r0_ax[..., None] + 1)
    dl = dl_ax[..., None].to(cdt)
    zero = dl.new_zeros(())
    one = dl.new_ones(())
    a = torch.where(lo, 1 - dl, zero) + torch.where(hi, dl, zero)
    da = torch.where(hi, one, zero) - torch.where(lo, one, zero)
    return a, da


def _result_dtype(*dtypes):
    return functools.reduce(torch.promote_types, dtypes)


def _compute_dtype(*dtypes):
    d = _result_dtype(*dtypes)
    return torch.float64 if d == torch.float64 else torch.float32


def _per_pose(x, n_out, cdt):
    return x.reshape((-1,) + (1,) * n_out).to(cdt)


def raster_fwd(grid_size, points, rotation, translation, background,
               out_weight, point_weight, *, chunk: int | None = None,
               terms: int = FWD_TERMS, pw_uniform: bool = False):
    """Forward rasterisation via exact-one-hot branch products.

    Canonical batched args (see `dprast_torch.ops.core`) -> (B,
    *grid_size).  (`pw_uniform` is accepted for dispatch uniformity; the
    per-point weight multiply is one pass here either way.)"""
    del pw_uniform
    n_out = len(grid_size)
    if not supported(n_out):
        raise ValueError(
            f"matmul path supports N_out in (1,2,3), got {n_out}")
    b = rotation.shape[0]
    p, _ = points.shape
    if chunk is None:
        chunk = _pick_chunk(p, b, grid_size)
    _, pw_k, valid_k, _, pad = _chunked(points, point_weight, chunk)
    r0_k, dl_k = _chunked_voxels(points, rotation, translation, grid_size,
                                 chunk, pad)
    dtype = _result_dtype(points.dtype, rotation.dtype, translation.dtype)
    cdt = _compute_dtype(dtype)
    nx = grid_size[-1]
    xiota = torch.arange(nx, dtype=torch.int32, device=points.device)

    acc = torch.zeros((b,) + tuple(grid_size), dtype=cdt,
                      device=points.device)
    for r0, dl, pw_c, valid_c in zip(r0_k, dl_k, pw_k, valid_k):
        # leading-axis dense value factor (B, C, R), point weight folded in
        lead = (pw_c.to(cdt)[None, :] * valid_c[None, :].to(cdt))[..., None]
        for i in range(n_out - 1):
            a_i, _ = _axis_pair(r0[..., i], dl[..., i], grid_size[i], cdt)
            lead = (lead * a_i if i == 0 else
                    (lead[..., :, None] * a_i[..., None, :]).reshape(
                        b, chunk, -1))
        dlx = dl[..., n_out - 1].to(cdt)
        upd = None
        for s, wx in ((0, 1 - dlx), (1, dlx)):
            o = xiota == (r0[..., n_out - 1] + s)[..., None]
            part = _branch_dot(lead * wx[..., None], o, terms)
            upd = part if upd is None else upd + part
        # chunk order, into the one accumulator (updated in place)
        acc += upd.reshape(acc.shape)
    out = acc * _per_pose(out_weight, n_out, cdt)
    out = out + _per_pose(background, n_out, cdt)
    return out.to(dtype)


def raster_pullback(grid_size, points, rotation, translation, background,
                    out_weight, point_weight, ds_dout, *,
                    chunk: int | None = None, terms: int = BWD_TERMS,
                    pw_uniform: bool = False,
                    asked=ALL_ASKED) -> PullbackResult:
    """Analytic pullback via one exact selection-product family per chunk
    (gather-free AND scatter-free).  Returns `PullbackResult`; `d_bg`'s
    sum of the cotangent runs only where `asked` names it (as in
    `core.raster_pullback`: the chunks make the other five together)."""
    del pw_uniform
    n_out = len(grid_size)
    if not supported(n_out):
        raise ValueError(
            f"matmul path supports N_out in (1,2,3), got {n_out}")
    b = rotation.shape[0]
    p, n_in = points.shape
    if chunk is None:
        chunk = _pick_chunk(p, b, grid_size)
    pts_k, pw_k, valid_k, k, pad = _chunked(points, point_weight, chunk)
    r0_k, dl_k = _chunked_voxels(points, rotation, translation, grid_size,
                                 chunk, pad)
    dtype = _result_dtype(points.dtype, rotation.dtype, ds_dout.dtype)
    cdt = _compute_dtype(dtype)
    dev = points.device

    nx = grid_size[-1]
    r_lead = math.prod(grid_size[:-1])
    g = ds_dout.to(cdt)
    gf = g.reshape(b, r_lead, nx)
    # hoisted: the cotangent's bf16 planes, CONCATENATED along the last
    # axis, are shared by every chunk.  Each branch selection is then ONE
    # product whose contraction runs over all planes at once (a product
    # per plane would write a full (B, C, R) fp32 output each).
    if cdt == torch.float64:
        g_cat_t = gf.transpose(1, 2)
        xiota = torch.arange(nx, dtype=torch.int32, device=dev)
    else:
        g_cat_t = torch.cat(_split_planes(gf, terms), dim=-1).transpose(1, 2)
        xiota = torch.arange(terms * nx, dtype=torch.int32, device=dev) % nx

    def selection(o_mask):
        """T = O @ g_cat over the (plane-tiled) last axis: (B, C, R)
        per-point selected cotangent columns, exact to the plane sum."""
        if cdt == torch.float64:
            return torch.bmm(o_mask.to(cdt), g_cat_t)
        return _bf16_bmm(o_mask.to(torch.bfloat16), g_cat_t)

    ow = out_weight.to(cdt)
    rot = rotation.to(cdt)
    scale = geometry.axis_values([g / 2 for g in grid_size], cdt, dev)
    d_t = torch.zeros((b, n_out), dtype=cdt, device=dev)
    d_r = torch.zeros((b, n_out, n_in), dtype=cdt, device=dev)
    d_ow = torch.zeros((b,), dtype=cdt, device=dev)
    d_p_k, d_pw_k = [], []
    for r0, dl, pts_c, pw_c, valid_c in zip(r0_k, dl_k, pts_k, pw_k,
                                            valid_k):
        r0x = r0[..., n_out - 1][..., None]
        t0 = selection(xiota == r0x)
        t1 = selection(xiota == r0x + 1)
        dlx = dl[..., n_out - 1].to(cdt)[..., None]
        v1 = (1 - dlx) * t0 + dlx * t1                        # (B, C, R)
        dvx = t1 - t0

        vmask = valid_c[None, :].to(cdt)
        if n_out == 1:
            gw = v1[..., 0] * vmask
            ds_du = (dvx[..., 0] * vmask)[..., None]
        elif n_out == 2:
            ay, day = _axis_pair(r0[..., 0], dl[..., 0], grid_size[0], cdt)
            gw = torch.sum(ay * v1, dim=-1) * vmask
            du_y = torch.sum(day * v1, dim=-1) * vmask
            du_x = torch.sum(ay * dvx, dim=-1) * vmask
            ds_du = torch.stack([du_y, du_x], dim=-1)
        else:
            gz, gy = grid_size[0], grid_size[1]
            az, daz = _axis_pair(r0[..., 0], dl[..., 0], gz, cdt)
            ay, day = _axis_pair(r0[..., 1], dl[..., 1], gy, cdt)
            v1zy = v1.reshape(b, chunk, gz, gy)
            dvzy = dvx.reshape(b, chunk, gz, gy)
            # the y contractions as broadcast products and sums: fp32
            # whatever the matrix-product settings
            ay_, day_ = ay[:, :, None, :], day[:, :, None, :]
            ey = torch.sum(ay_ * v1zy, dim=-1)                # (B, C, gz)
            gw = torch.sum(az * ey, dim=-1) * vmask
            du_z = torch.sum(daz * ey, dim=-1) * vmask
            du_y = torch.sum(az * torch.sum(day_ * v1zy, dim=-1),
                             dim=-1) * vmask
            du_x = torch.sum(az * torch.sum(ay_ * dvzy, dim=-1),
                             dim=-1) * vmask
            ds_du = torch.stack([du_z, du_y, du_x], dim=-1)

        # weight gradients from gw = sum_s g * W_s per (b, p)
        pw_cdt = pw_c.to(cdt)
        d_ow += torch.einsum("bp,p->b", gw, pw_cdt)
        d_pw_k.append(torch.einsum("bp,b->p", gw, ow))

        coeff = (ow[:, None] * pw_cdt[None, :])[..., None]
        scaled = ds_du * coeff * scale                        # (B, C, N_out)

        d_t += torch.sum(scaled, dim=1)
        d_r += torch.einsum("bpo,pi->boi", scaled, pts_c.to(cdt))
        d_p_k.append(torch.einsum("boi,bpo->pi", rot, scaled))

    if k == 0:
        d_points = torch.zeros((0, n_in), dtype=cdt, device=dev)
        d_pw = torch.zeros((0,), dtype=cdt, device=dev)
    else:
        d_points = torch.cat(d_p_k)[:p]
        d_pw = torch.cat(d_pw_k)[:p]
    d_bg = torch.sum(g.reshape(b, -1), dim=-1) \
        if PullbackResult(*asked).background else None
    note_unasked(asked, ("background",))

    return PullbackResult(*(None if a is None else a.to(dtype) for a in (
        d_points, d_r, d_t, d_bg, d_ow, d_pw)))
