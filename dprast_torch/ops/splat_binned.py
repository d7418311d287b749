"""Slot-scheduled tile-binned backend (``"binned"``), forward, 2-D grids
(PyTorch port of `dprast/ops/splat_binned.py`).

The data path, for a batch of B poses:

1. **Coordinates.** `_keys_and_local` runs the compensated double-f32
   transform and stores each point's tile-local coordinates as 31-bit
   fixed point (`_FIX` fraction bits) plus a flat tile key.
2. **Frame.** A single-tile grid (both axes <= 128) keeps the point order
   (`_prep_direct`).  A multi-tile grid sorts the points by tile into a
   padded *slot frame* (`_prep_binned`): slot ``s`` covers rows
   ``[s*chunk, (s+1)*chunk)`` of one tile, every tile owns at least one
   slot, and ``slot_tile[b, -1]`` counts the live slots.
3. **Planes.** `_planes_fwd` decodes the frame into the lane planes the
   splat reads: ``[iy0, dly, (w,) dlx, ix0]`` per row.
4. **Splat** (`fwd_splat`, kernel B1): every row adds its four bilinear
   weights into its tile's window ``ext[b, tile]`` -- a 128x128 window
   (127-voxel body plus a 1-voxel halo) on a multi-tile grid, the grid
   itself on a single tile.
5. **Fold** (`band_fold`, kernel B2): the overlapping windows are summed
   into the dense grid, with the ``* ow + bg`` epilogue fused.  A single
   tile needs no fold: a reshape and the epilogue.

Each kernel wrapper runs its plain torch twin for a CPU tensor and the
CUDA kernel (`dprast_torch/csrc/`) for a CUDA tensor; it raises for any
other device and never falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from dprast_torch.ops import _build, geometry

TILE = 128
# bf16 split depth of the JAX kernels' value operands; the port's kernels
# splat in plain fp32, and the 1-term fast mode (``binned_bf16``, ROADMAP
# A7) is not ported yet
_SPLIT_TERMS = 2

# kernel launches per wrapper: a run reads these to show that its path
# went through the kernels (CPU twin calls do not count)
LAUNCHES = {"fwd_splat": 0, "band_fold": 0}


def tile_shape_for(grid_size):
    """Per-axis BODY tile shape; the window is body + 1 halo voxel per
    axis: 2D (127, 127) -> 128x128; 3D (7, 15, 127).  A small 2D grid (both
    axes <= 128) is a single halo-free tile."""
    if len(grid_size) == 2:
        gy, gx = grid_size
        if gy <= TILE and gx <= TILE:
            return (gy, gx)
        return (TILE - 1, TILE - 1)
    return (7, 15, TILE - 1)


def n_tiles(grid_size, ts=None):
    ts = ts or tile_shape_for(grid_size)
    return math.prod(-(-g // t) for g, t in zip(grid_size, ts))


def supported(n_out: int, grid_size=None, n_points=None) -> bool:
    """CAPABILITY check, as in the JAX package: any 2D/3D grid up to the
    tile-count bound, point counts below 2^24 (point ids ride float32
    planes).  3-D answers True so that `auto` picks what the JAX package
    picks; the 3-D forward itself raises until ROADMAP A6."""
    if n_out not in (2, 3):
        return False
    if n_points is not None and n_points >= (1 << 24):
        return False
    if grid_size is None:
        return True
    if any(g < 1 for g in grid_size):
        return False
    return n_tiles(grid_size) <= 4096


def profitable(n_out: int, grid_size, n_points=None) -> bool:
    """Auto-dispatch profitability on top of :func:`supported`: the slot
    frame's ~nt*chunk inert padding rows must not dwarf the real work."""
    if not supported(n_out, grid_size, n_points):
        return False
    chunk = _default_chunk(grid_size, n_points)
    if n_points is not None and n_tiles(grid_size) * chunk > \
            8 * max(n_points, 1024):
        return False
    return True


def _single_tile(grid_size) -> bool:
    return len(grid_size) == 2 and n_tiles(grid_size) == 1


def _default_chunk(grid_size, n_points=None) -> int:
    # rows per slot: 1024 on a single tile (no padding per tile), 256 on a
    # multi-tile grid, 128 where the per-tile padding would outnumber the
    # points
    if _single_tile(grid_size):
        return 1024
    if n_points is not None and n_tiles(grid_size) * 256 > 2 * n_points:
        return 128
    return 256


# ---------------------------------------------------------------------------
# binning prep
# ---------------------------------------------------------------------------


_FIX = 23  # fixed-point fraction bits for encoded local coordinates


def _keys_and_local(grid_size, ts, points, rotation, translation):
    """Per (pose, point): flat tile key (sentinel nt if no grid overlap)
    and one encoded-coordinate plane per axis, all (B, P).

    ``enc = (r0_local + 2) << 23 | round(dl * 2^23)``, bit-cast to f32 so
    the planes stack with the weights: uniform 2^-23 resolution at any
    grid size.  ``dl == 1`` carries into the integer part, which
    `_decode_coord` undoes.  No-overlap points get ``enc = 0``, which
    decodes to ``r0 = -3`` and lands outside every window."""
    n = len(grid_size)
    nts = [-(-g // t) for g, t in zip(grid_size, ts)]
    nt = math.prod(nts)
    u_hi, u_lo = geometry.grid_coords_2f(points, rotation, translation,
                                         grid_size)
    r0, dl = geometry.reference_voxel_and_deltas_2f(u_hi, u_lo)
    key = torch.zeros(r0.shape[:2], dtype=torch.int32, device=r0.device)
    overlap = torch.ones(r0.shape[:2], dtype=torch.bool, device=r0.device)
    locs = []
    for i in range(n):
        g, t = grid_size[i], ts[i]
        ri = r0[..., i]
        overlap = overlap & (ri + 1 >= 0) & (ri <= g - 1)
        ti = torch.clamp(ri, 0, g - 1) // t
        key = key * nts[i] + ti
        r_loc = ri - ti * t                                # in [-1, t-1]
        enc = ((r_loc + 2) << _FIX) + torch.round(
            dl[..., i] * (1 << _FIX)).to(torch.int32)
        enc = torch.where(overlap, enc, 0)
        locs.append(enc.view(torch.float32))
    key = torch.where(overlap, key, nt)
    return key, locs, nt


def _decode_coord(col):
    """Encoded-coordinate plane (f32 bits, any shape) -> (r0_local int32,
    dl f32) with ``dl in (0, 1]``."""
    enc = col.view(torch.int32)
    i_part = enc >> _FIX
    frac = enc - (i_part << _FIX)
    zero = frac == 0
    dl = torch.where(zero, 1.0, frac.to(torch.float32) * (2.0 ** -_FIX))
    r0 = i_part - 2 - zero.to(torch.int32)
    return r0, dl


def _slot_frame_size(p, nt, chunk):
    return -(-p // chunk) * chunk + nt * chunk


def _prep_binned(key, planes, fills, nt, chunk, min_chunk_per_tile,
                 pack_idx=False):
    """Sort `planes` (list of (B, P) f32) into the padded slot frame.

    Returns (data (B, len(planes), s_pad) f32, slot_tile (B, n_slots + 1)
    int32); the trailing entry is ``n_live``, the count of slots that carry
    frame rows.  Filler rows get the per-plane `fills` values.

    ONE sort builds the frame: per-tile counts come from the unsorted keys,
    so filler rows can be emitted up front with interleaving keys -- reals
    of tile t sort as ``2t``, exactly the right number of fillers as
    ``2t+1``, everything else (no-overlap points at key ``nt``, excess
    fillers) past the frame at ``>= 2*nt``.

    With ``pack_idx=True`` the last plane must be the point-id plane
    (values ``0..p-1``, fill ``p``); when the combined bits fit an int32
    it rides inside the sort key (``key * P2 + id``), the keys are unique
    and the sort needs no stability.  Otherwise it rides as a payload and
    the sort is stable."""
    bsz, p = key.shape
    dev = key.device
    i32 = torch.int32
    s_pad = _slot_frame_size(p, nt, chunk)
    n_slots = s_pad // chunk

    p2 = 1 << max(int(p).bit_length(), 1)
    packed = pack_idx and (2 * nt + 1) * p2 + p < 2 ** 31
    if packed:
        planes = planes[:-1]

    # per-tile counts of every pose in one bincount; the no-overlap
    # sentinel nt gets its own bin and is dropped
    offs = torch.arange(bsz, device=dev)[:, None] * (nt + 1)
    counts = torch.bincount((key.long() + offs).reshape(-1),
                            minlength=bsz * (nt + 1))
    counts = counts.reshape(bsz, nt + 1)[:, :nt].to(i32)
    padded = -(-counts // chunk) * chunk
    if min_chunk_per_tile:
        padded = torch.clamp(padded, min=chunk)
    poffs = torch.cat([torch.zeros((bsz, 1), dtype=i32, device=dev),
                       torch.cumsum(padded, dim=1).to(i32)], dim=1)
    # filler rows: exactly padded-counts of tile t keyed to sort directly
    # after tile t's real rows; the rest past every real key
    iota_t = torch.arange(nt, dtype=i32, device=dev)
    f_k = torch.arange(chunk, dtype=i32, device=dev).repeat(nt)
    f_needed = torch.repeat_interleave(padded - counts, chunk, dim=1)
    f_tile = torch.repeat_interleave(iota_t, chunk)
    f_key = torch.where(f_k < f_needed, 2 * f_tile + 1, 2 * nt + 1)
    # top the input up to >= s_pad rows (p + nt*chunk falls short when p
    # is not a chunk multiple)
    n_extra = max(s_pad - p - nt * chunk, 0)
    n_fill = nt * chunk + n_extra
    keys2 = torch.cat([2 * key, f_key,
                       torch.full((bsz, n_extra), 2 * nt + 1, dtype=i32,
                                  device=dev)], dim=1)
    if packed:
        sub = torch.cat([torch.arange(p, dtype=i32, device=dev),
                         torch.full((n_fill,), p, dtype=i32, device=dev)])
        keys2 = keys2 * p2 + sub
    sorted_keys, perm = torch.sort(keys2, dim=1, stable=not packed)
    perm = perm[:, :s_pad]
    data = [torch.gather(
        torch.cat([pl_.expand(bsz, p),
                   torch.full((bsz, n_fill), fills[i], dtype=torch.float32,
                              device=dev)], dim=1), 1, perm)
            for i, pl_ in enumerate(planes)]
    if packed:
        data.append((sorted_keys[:, :s_pad] % p2).to(torch.float32))
    data = torch.stack(data, dim=1)
    # slot s belongs to tile #(count of poffs[t+1] <= s*chunk)
    starts = (torch.arange(n_slots, device=dev) * chunk).expand(bsz, n_slots)
    tile_of = torch.searchsorted(poffs[:, 1:].long().contiguous(),
                                 starts.contiguous(), right=True)
    slot_tile = torch.clamp(tile_of, max=nt - 1).to(i32)
    n_live = poffs[:, nt:] // chunk
    return data, torch.cat([slot_tile, n_live], dim=1)


def _prep_direct(planes, fills, chunk):
    """Single-tile frame: no binning, rows keep the point order; the same
    slot-table layout as `_prep_binned`, with every slot live."""
    bsz, p = planes[0].shape
    p_pad = -(-p // chunk) * chunk
    data = torch.stack([F.pad(pl_, (0, p_pad - p), value=fills[i])
                        for i, pl_ in enumerate(planes)], dim=1)
    n_slots = p_pad // chunk
    dev = data.device
    return data, torch.cat(
        [torch.zeros((bsz, n_slots), dtype=torch.int32, device=dev),
         torch.full((bsz, 1), n_slots, dtype=torch.int32, device=dev)],
        dim=1)


def _planes_fwd(coord, w):
    """2-D lane planes (B, L, s_pad) f32 for the splat from the frame's
    encoded coordinate planes ``coord`` (B, 2, s_pad) and the per-row
    weight plane ``w`` (B, s_pad), or ``w=None`` on the uniform-weight
    path: ``[iy0, dly, w, dlx, ix0]`` (L = 5) or ``[iy0, dly, dlx, ix0]``
    (L = 4).  Small integers ride as exact f32."""
    f32 = torch.float32
    iy0, dly = _decode_coord(coord[:, 0])
    ix0, dlx = _decode_coord(coord[:, 1])
    w_rows = [] if w is None else [w]
    return torch.stack([iy0.to(f32), dly] + w_rows + [dlx, ix0.to(f32)],
                       dim=1)


# ---------------------------------------------------------------------------
# B1: the forward splat
# ---------------------------------------------------------------------------


def _fwd_splat_plain(slot_tile, lane, nt, rows_e, cols_e, chunk):
    """Plain twin of B1: every live frame row adds ``(hy * w) * cx`` for
    its four (row, col) targets into ``ext[b, tile]`` (B, nt, rows_e,
    cols_e); targets outside the window are dropped.  Rows of dead slots
    (past ``slot_tile[b, -1]``) add nothing."""
    bsz, n_lane, s_pad = lane.shape
    dev = lane.device
    n_slots = s_pad // chunk
    iy0 = lane[:, 0].long()
    dly = lane[:, 1]
    dlx = lane[:, -2]
    ix0 = lane[:, -1].long()
    hy = [1.0 - dly, dly]
    if n_lane == 5:
        hy = [h * lane[:, 2] for h in hy]
    cx = [1.0 - dlx, dlx]
    tile = torch.repeat_interleave(slot_tile[:, :n_slots].long(), chunk,
                                   dim=1)
    live = torch.repeat_interleave(
        torch.arange(n_slots, device=dev) < slot_tile[:, n_slots:], chunk,
        dim=1)
    win = rows_e * cols_e
    total = bsz * nt * win
    base = (torch.arange(bsz, device=dev)[:, None] * nt + tile) * win
    ext = torch.zeros(total + 1, dtype=torch.float32, device=dev)
    for sy in (0, 1):
        r = iy0 + sy
        for sx in (0, 1):
            c = ix0 + sx
            ok = live & (r >= 0) & (r < rows_e) & (c >= 0) & (c < cols_e)
            idx = torch.where(ok, base + r * cols_e + c, total)
            ext.index_add_(0, idx.reshape(-1), (hy[sy] * cx[sx]).reshape(-1))
    return ext[:total].reshape(bsz, nt, rows_e, cols_e)


def _split_count(device, blocks):
    """Blocks per tile for B1: enough (pose, tile) blocks to give every SM
    two, at most 16 per tile."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(16, -(-2 * n_sm // blocks)))


def fwd_splat(slot_tile, lane, nt, rows_e, cols_e, chunk):
    """B1: splat the lane planes of a slot frame into the per-tile windows
    -> ext (B, nt, rows_e, cols_e) f32.  CPU tensors take the plain twin,
    CUDA tensors the kernel in `csrc/fwd_splat.cu`."""
    if lane.device.type == "cpu":
        return _fwd_splat_plain(slot_tile, lane, nt, rows_e, cols_e, chunk)
    _check_cuda("fwd_splat", slot_tile, torch.int32, lane, torch.float32)
    bsz, n_lane, s_pad = lane.shape
    n_slots = s_pad // chunk
    if n_lane not in (4, 5) or s_pad != n_slots * chunk or \
            slot_tile.shape != (bsz, n_slots + 1):
        raise ValueError(f"fwd_splat: lane {tuple(lane.shape)} and slot "
                         f"table {tuple(slot_tile.shape)} do not form a "
                         f"frame of chunk {chunk}")
    if rows_e * cols_e * 4 > _build.MAX_WINDOW_BYTES or bsz > 65535 \
            or nt > 65535:
        raise ValueError(f"fwd_splat: window {rows_e}x{cols_e}, B={bsz}, "
                         f"nt={nt} exceed the kernel's launch bounds")
    dev = lane.device
    # each tile's live slot range [first, end): the frame is tile-sorted,
    # so searchsorted over the live prefix (dead slots pushed past nt)
    live = torch.arange(n_slots, device=dev) < slot_tile[:, n_slots:]
    st = torch.where(live, slot_tile[:, :n_slots].long(), nt).contiguous()
    tiles = torch.arange(nt, device=dev).expand(bsz, nt).contiguous()
    first = torch.searchsorted(st, tiles, out_int32=True)
    end = torch.searchsorted(st, tiles, right=True, out_int32=True)
    nsplit = _split_count(dev, bsz * nt)
    alloc = torch.zeros if nsplit > 1 else torch.empty
    ext = alloc((bsz, nt, rows_e, cols_e), dtype=torch.float32, device=dev)
    lib = _build.load()
    rc = lib.dprast_fwd_splat(
        _ptr(lane), _ptr(first), _ptr(end), _ptr(ext), bsz, nt, n_lane,
        s_pad, chunk, rows_e, cols_e, nsplit, _stream(dev))
    _raise_on(rc, "fwd_splat")
    LAUNCHES["fwd_splat"] += 1
    return ext


# ---------------------------------------------------------------------------
# B2: the band fold
# ---------------------------------------------------------------------------


def _fold(ext, grid_size, ts, halo):
    """Sum the per-tile extended windows back into the dense grid.
    ext (B, nt, rows_e, cols_e) -> (B, *grid_size).

    Separable: per axis, the window bodies tile ``ceil(g/t)*t`` positions
    contiguously (a reshape) and the +1 halo slivers add at positions
    ``t, 2t, ...``.  Positions past the real grid are sliced off at the
    end (the reference's out-of-grid drop)."""
    n = len(grid_size)
    b = ext.shape[0]
    nts = [-(-g // t) for g, t in zip(grid_size, ts)]
    if not halo:
        return ext.reshape((b,) + tuple(grid_size))
    x = ext.reshape((b,) + tuple(nts) + tuple(t + 1 for t in ts))
    perm = [0]
    for i in range(n):
        perm += [1 + i, 1 + n + i]
    x = x.permute(perm)            # (B, m0, t0+1, m1, t1+1, ...)
    for i in range(n):
        # axes before i are already merged: m_i sits at axis 1 + i
        ax = 1 + i
        t, m = ts[i], nts[i]
        body = x.narrow(ax + 1, 0, t)
        ns = body.shape[:ax] + (m * t,) + body.shape[ax + 2:]
        body = F.pad(body.reshape(ns), _pad_spec(len(ns), ax, 1))
        halo_s = x.narrow(ax + 1, t, 1).reshape(ns[:ax] + (m,)
                                                + ns[ax + 1:])
        at_kt = [slice(None)] * len(ns)
        at_kt[ax] = slice(t, None, t)                  # positions k*t
        body[tuple(at_kt)] += halo_s
        x = body
    for i in range(n):
        x = x.narrow(1 + i, 0, grid_size[i])
    return x.contiguous()


def _pad_spec(ndim, ax, after):
    """`F.pad` spec that appends `after` zeros to axis `ax` only."""
    spec = [0] * (2 * ndim)
    spec[2 * (ndim - 1 - ax) + 1] = after
    return spec


def _band_fold_plain(ext, grid_size, ts, ow, bg):
    """Plain twin of B2: `_fold` followed by ``* ow[b] + bg[b]``."""
    out = _fold(ext, grid_size, ts, True)
    return out * ow[:, None, None] + bg[:, None, None]


def band_fold(ext, grid_size, ts, ow, bg):
    """B2: fold the 2-D multi-tile windows ext (B, nt, t0+1, t1+1) into
    the (B, gy, gx) grid with the ``* ow[b] + bg[b]`` epilogue fused.
    CPU tensors take the plain twin, CUDA tensors the kernel in
    `csrc/band_fold.cu`."""
    if ext.device.type == "cpu":
        return _band_fold_plain(ext, grid_size, ts, ow, bg)
    _check_cuda("band_fold", ext, torch.float32, ow, torch.float32,
                bg, torch.float32)
    gy, gx = grid_size
    t0, t1 = ts
    n0, n1 = -(-gy // t0), -(-gx // t1)
    bsz = ext.shape[0]
    if ext.shape != (bsz, n0 * n1, t0 + 1, t1 + 1) or \
            ow.shape != (bsz,) or bg.shape != (bsz,):
        raise ValueError(f"band_fold: ext {tuple(ext.shape)}, ow "
                         f"{tuple(ow.shape)}, bg {tuple(bg.shape)} do not "
                         f"match grid {grid_size} with tiles {ts}")
    if bsz > 65535 or gy > 65535:
        raise ValueError(f"band_fold: B={bsz}, gy={gy} exceed the kernel's "
                         f"launch bounds")
    out = torch.empty((bsz, gy, gx), dtype=torch.float32, device=ext.device)
    lib = _build.load()
    rc = lib.dprast_band_fold(
        _ptr(ext), _ptr(ow), _ptr(bg), _ptr(out), bsz, gy, gx, t0, t1,
        _stream(ext.device))
    _raise_on(rc, "band_fold")
    LAUNCHES["band_fold"] += 1
    return out


def _check_cuda(name, *pairs):
    """Every tensor on one CUDA device, of its dtype, contiguous."""
    tensors = pairs[0::2]
    dev = tensors[0].device
    for t, dtype in zip(tensors, pairs[1::2]):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device; "
                             f"got {t.device} beside {dev}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dtype} "
                             f"tensor; got {t.dtype}, contiguous="
                             f"{t.is_contiguous()}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({_build.error_string(rc)})")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _fwd_frame(grid_size, points, rotation, translation, point_weight,
               pw_uniform):
    """Coordinates -> frame -> lane planes for a 2-D grid.  Returns the
    arguments of `fwd_splat`: ``(slot_tile, lane, nt, rows_e, cols_e,
    chunk)``."""
    ts = tile_shape_for(grid_size)
    halo = not _single_tile(grid_size)
    p = points.shape[0]
    bsz = rotation.shape[0]
    chunk = _default_chunk(grid_size, p)
    key, locs, nt = _keys_and_local(grid_size, ts, points, rotation,
                                    translation)
    planes = list(locs)
    fills = [0.0, 0.0]                              # enc 0 = inert
    if not pw_uniform:
        # the per-row weight plane carries the POINT weight only; the
        # per-pose out_weight is applied after the fold (the splat is
        # linear in it)
        planes.append(point_weight.to(torch.float32)[None, :]
                      .expand(bsz, p))
        fills.append(0.0)                           # filler weight = 0
    # the point-id plane rides the sort (packed into the key when the bits
    # fit): unique keys let the sort drop stability
    planes.append(torch.arange(p, dtype=torch.float32, device=points.device)
                  [None, :].expand(bsz, p))
    fills.append(float(p))
    if halo:
        data, slot_tile = _prep_binned(key, planes, fills, nt, chunk, True,
                                       pack_idx=True)
    else:
        data, slot_tile = _prep_direct(planes, fills, chunk)
    w_plane = None if pw_uniform else data[:, 2]
    lane = _planes_fwd(data[:, :2], w_plane).contiguous()
    rows_e, cols_e = (t + 1 for t in ts) if halo else ts
    return slot_tile.contiguous(), lane, nt, rows_e, cols_e, chunk


def raster_fwd(grid_size, points, rotation, translation, background,
               out_weight, point_weight, *, pw_uniform: bool = False):
    """Forward rasterisation on canonical batched args -> (B, *grid_size).

    ``pw_uniform=True`` promises that every `point_weight` entry equals
    ``point_weight[0]``: the weight plane is dropped and the scalar factor
    is applied after the fold."""
    return _fwd_impl(grid_size, points, rotation, translation, background,
                     out_weight, point_weight, pw_uniform=pw_uniform)


def _fwd_impl(grid_size, points, rotation, translation, background,
              out_weight, point_weight, *, pw_uniform=False,
              splat=fwd_splat, fold=band_fold):
    """`raster_fwd` with its two kernel stages as arguments, so a
    measurement can run the same forward through the plain twins."""
    n_out = len(grid_size)
    p = points.shape[0]
    if n_out == 3:
        raise NotImplementedError(
            "the binned backend's 3-D forward is not ported yet "
            "(ROADMAP A6)")
    if not supported(n_out, grid_size, p):
        raise ValueError(f"binned backend does not support grid="
                         f"{grid_size} P={p}")
    if p == 0:
        raise ValueError("binned backend requires n_points > 0")
    ext = splat(*_fwd_frame(grid_size, points, rotation, translation,
                            point_weight, pw_uniform))

    f32 = torch.float32
    ow_eff = out_weight.to(f32)
    if pw_uniform:
        # all entries equal by the contract; fold the scalar in
        ow_eff = ow_eff * point_weight.to(f32)[0]
    bg_f = background.to(f32)
    ts = tile_shape_for(grid_size)
    if _single_tile(grid_size):
        out = (_fold(ext, grid_size, ts, False) * ow_eff[:, None, None]
               + bg_f[:, None, None])
    else:
        out = fold(ext, grid_size, ts, ow_eff.contiguous(), bg_f.contiguous())
    dtype = torch.promote_types(points.dtype, torch.promote_types(
        rotation.dtype, translation.dtype))
    return out.to(dtype)
