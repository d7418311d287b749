"""Slot-scheduled tile-binned backend (``"binned"``), 2-D and 3-D grids
(PyTorch port of `dprast/ops/splat_binned.py`).

The forward, for a batch of B poses:

1. **Coordinates.** `_keys_and_local` (kernel B6) runs the compensated
   double-f32 transform and stores each point's tile-local coordinates
   as 31-bit fixed point (`_FIX` fraction bits) plus a flat tile key: one
   launch of `csrc/coords.cu` on the card, whose every sum and product is
   rounded on its own as in the eager twin `_keys_and_local_plain`
   (`geometry.grid_coords_2f`, ~170 elementwise launches), to the same
   bits.
2. **Frame** (`_frame`): ``data`` (B, n_planes, s_pad) holds per row
   ``[enc..., (w,) point id]``.  A single-tile 2-D grid (both axes <= 128)
   keeps the point order: on the card B6 writes the padded frame and its
   slot table in the same launch (`direct_frame`; plain: `_prep_direct`).
   A multi-tile grid sorts the points by tile into a padded *slot frame*:
   slot ``s`` covers rows ``[s*chunk, (s+1)*chunk)`` of one tile, every
   tile owns at least one slot, and ``slot_tile[b, -1]`` counts the live
   slots; on the card two kernels write the per-tile counts, the slot
   table and each stretch of points' first place per tile (`slot_prep`,
   kernel B9), one kernel writes the sorted frame keys straight to their
   places from them (`bin_scatter`, kernel B10, a counting scatter in
   place of a sort), and one kernel writes the frame (`frame_gather`;
   plain: `_prep_binned`, whose sort is `torch.sort`).  A 3-D grid is
   always multi-tile: (7, 15, 127)-voxel bodies.
3. **Planes.** The JAX package decodes the frame outside its kernels into
   lane planes (``[iy0, dly, (w,) dlx, ix0]`` per row in 2-D,
   ``[iz0, dlz, iy0, dly, (w,) dlx, ix0]`` in 3-D, `_planes_fwd`).  Here
   the main path's B1 and B4 read the encoded frame and decode each row
   themselves (their ``_enc`` instances); `_planes_fwd` / `_planes_bwd`
   remain their plain versions' first step and the lane instances' input.
4. **Splat** (`fwd_splat_enc`, kernel B1): every row adds its four (2-D) or
   eight (3-D) multilinear weights into its tile's window
   ``ext[b, tile]`` -- 128x128 fp32: a 127-voxel body plus a 1-voxel
   halo per axis in 2-D, the flattened (8 z x 16 y) rows by 128 x
   columns in 3-D, the grid itself on a single tile.
5. **Fold**: the overlapping windows are summed into the dense grid with
   the ``* ow + bg`` epilogue -- kernel B2 (`band_fold`) on a 2-D grid,
   plain torch (`_fold`) in 3-D, as the JAX package runs it in XLA.  A
   single tile needs no fold: a reshape and the epilogue.

The pullback reuses the forward's frame (`raster_fwd_res`, the fused
autograd pair) or builds its own (`raster_pullback`):

6. **Windows**: the gather reads the cotangent through the same
   overlapping windows, zero outside the grid.  On a multi-tile 2-D grid
   B4 cuts them out of the cotangent itself (its ``"grid"`` window
   source) and nothing is unfolded; a single tile's window is the
   cotangent; 3-D unfolds with plain torch (`_unfold`).  Kernel B3
   (`band_unfold`) writes the 2-D windows out for the harness, and for a
   pullback that is handed it as its ``unfold`` stage.
7. **Gather** (`bwd_gather_enc`, kernel B4): every frame row reads its four
   (2-D) or eight (3-D) window values and writes ``[du_y, du_x, gw]`` or
   ``[du_z, du_y, du_x, gw]``; rows of dead slots write zeros.
8. **Epilogue** (`pullback_epilogue`, kernel B8): the unsort of B4's rows
   by the point-id plane (a single tile keeps the order) and the products
   and sums that finish five of the six gradients -- two launches of
   `csrc/epilogue.cu` on the card, the eager scatter, products, sums and
   einsums (`_epilogue_plain`) on the CPU.  The background's gradient is
   one sum of the cotangent.

``terms`` is the depth of the JAX kernels' bf16 split of their value
operands, which B1 and B4 apply here: 0 keeps fp32 (``"binned"``), 1 is
the ~2e-3 fast mode (``"binned_bf16"``: B1 rounds each weight product to
bf16, B4 the cotangent window), 2 the JAX kernels' faithful two-part
split of the window, which only the harness's B4 variants run
(`dprast_torch.benchmarks`).

Each kernel wrapper runs its plain torch twin for a CPU tensor and the
CUDA kernel (`dprast_torch/csrc/`) for a CUDA tensor; it raises for any
other device and never falls back.  Nothing on the path calls a twin
when its tensors are on the card.
"""

from __future__ import annotations

import ctypes
import itertools
import math

import torch
import torch.nn.functional as F

from dprast_torch.ops import _build, core, geometry
from dprast_torch.utils.profiling import annotate

TILE = 128
# bf16 split depth of the JAX kernels' value operands by default; the
# port's `binned` runs terms=0 (fp32), and the harness's B4 variants run
# this depth
_SPLIT_TERMS = 2

# the CUDA instance of B1 for each (n_out, terms), and of B4 for each
# (n_out, terms, window layout); their names are the launch counters
_B1_INSTANCES = {(2, 0): "fwd_splat", (3, 0): "fwd_splat_3d",
                 (2, 1): "fwd_splat_bf16", (3, 1): "fwd_splat_3d_bf16"}
# B4's window sources, by their code in csrc/bwd_gather.cu: natural
# (rows_e, cols_e) fp32 windows; transposed (cols_e, rows_e) fp32;
# presplit, a pair (hi, lo) of transposed bf16 windows; grid, the 2-D
# cotangent (B, gy, gx) itself, out of which the kernel cuts the windows
# that `_unfold` would write
_LAYOUTS = ("natural", "transposed", "presplit", "grid")
_B4_INSTANCES = {(2, 0, "natural"): "bwd_gather",
                 (3, 0, "natural"): "bwd_gather_3d",
                 (2, 1, "natural"): "bwd_gather_bf16",
                 (3, 1, "natural"): "bwd_gather_3d_bf16",
                 (2, 2, "natural"): "bwd_gather_split",
                 (2, 2, "transposed"): "bwd_gather_split_t",
                 (2, 2, "presplit"): "bwd_gather_presplit",
                 (2, 0, "grid"): "bwd_gather_grid",
                 (2, 1, "grid"): "bwd_gather_grid_bf16"}
# how B4 stages a window into shared memory, by its code in
# csrc/bwd_gather.cu: plain loads, one bulk copy of a contiguous fp32
# window, or one TMA tiled load of a box of the cotangent
_STAGINGS = ("loads", "bulk", "tensor")
# a grid-source launch that cannot take the tiled load (a grid row that is
# no multiple of 16 bytes) stages with plain loads and counts under the
# instance's name with this suffix
_GRID_LOADS = "_ldg"
# the instances of the main path read the encoded frame (`fwd_splat_enc`,
# `bwd_gather_enc`) and count under the lane instance's name with this
# suffix: every B1 instance, and B4's natural and grid sources at terms 0
# and 1; the harness's B4 variants read lane planes only
_ENC = "_enc"
_B4_ENC = tuple(k for k in _B4_INSTANCES
                if k[1] in (0, 1) and k[2] in ("natural", "grid"))

# kernel launches per CUDA instance: a run reads these to show that its
# path went through the kernels (CPU twin calls do not count); "coords"
# counts B6 whether it writes planes or a single tile's frame; the `xla`
# backend's X1-X3 (`core.xla_neighbours`, `xla_scatter`, `xla_gather`)
# count here too
LAUNCHES = dict.fromkeys(
    ["coords", "slot_prep", "bin_scatter", "frame_gather", "band_fold",
     "band_unfold", "epilogue_tile", "epilogue_poses", "epilogue_rows",
     "epilogue_points",
     *_B1_INSTANCES.values(), *_B4_INSTANCES.values(),
     *(name + _GRID_LOADS for (_, _, layout), name in _B4_INSTANCES.items()
       if layout == "grid"),
     *(name + _ENC for name in _B1_INSTANCES.values()),
     *(_B4_INSTANCES[k] + _ENC for k in _B4_ENC),
     *(_B4_INSTANCES[k] + _ENC + _GRID_LOADS for k in _B4_ENC
       if k[2] == "grid"), *core.XLA_KERNELS], 0)


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
    planes)."""
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


def _keys_and_local_plain(grid_size, ts, points, rotation, translation,
                          want_key=True):
    """Plain twin of B6.  Per (pose, point): flat tile key (sentinel nt if
    no grid overlap) and one encoded-coordinate plane per axis, all (B, P)
    -> ``(key, locs, nt)``; with ``want_key=False`` `key` is None, as the
    kernel gives it.

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
    key = torch.where(overlap, key, nt) if want_key else None
    return key, locs, nt


@annotate("dprast.b6.coords")
def _keys_and_local(grid_size, ts, points, rotation, translation,
                    want_key=True):
    """B6: the coordinate stage -> ``(key (B, P) int32, locs, nt)`` with
    one encoded-coordinate plane (B, P) per axis in `locs` (see
    `_keys_and_local_plain`).  CPU tensors take the plain twin, CUDA
    tensors the kernel in `csrc/coords.cu`, which gives the twin's bits in
    one launch; inputs of another type are cast to contiguous fp32 first,
    as the twin casts them.  On the card the planes are views of one (B,
    P, L) tensor that holds a point's planes side by side (`_lanes`), the
    layout `frame_gather` reads.  With ``want_key=False`` `key` is None
    (the kernel leaves the keys unwritten)."""
    if points.device.type == "cpu":
        return _keys_and_local_plain(grid_size, ts, points, rotation,
                                     translation, want_key)
    pts, rot, tr = _coords_inputs(grid_size, ts, points, rotation,
                                  translation)
    bsz, n_out = rot.shape[:2]
    p = pts.shape[0]
    key = torch.empty((bsz, p), dtype=torch.int32, device=pts.device) \
        if want_key else None
    planes = torch.empty((bsz, p, _lanes(n_out)), dtype=torch.float32,
                         device=pts.device)
    _coords_launch(grid_size, ts, pts, rot, tr, key, planes, None, None, p,
                   -1, 0)
    return key, list(planes.unbind(-1)[:n_out]), n_tiles(grid_size, ts)


def _lanes(n_out):
    """The lanes a point takes in B6's interleaved planes: its n_out
    encoded coordinates, padded to 4 in 3-D, so that one 8- or 16-byte
    load reads them."""
    return 2 if n_out == 2 else 4


def _interleaved(locs):
    """The (B, P, L) tensor whose first lanes are the planes `locs`, where
    they are B6's interleaved views (`_keys_and_local` on the card);
    raises otherwise."""
    bsz, p = locs[0].shape
    lanes = _lanes(len(locs))
    if not (2 <= len(locs) <= 3 and all(
            pl_.shape == (bsz, p) and pl_.dtype == torch.float32
            and pl_.stride() == (p * lanes, lanes)
            and pl_.data_ptr() == locs[0].data_ptr() + 4 * i
            for i, pl_ in enumerate(locs))):
        got = [(tuple(pl_.shape), pl_.stride()) for pl_ in locs]
        raise ValueError(f"frame_gather: planes {got} are not B6's "
                         f"interleaved (B, P, {lanes}) planes")
    return locs[0].as_strided((bsz, p, lanes), (p * lanes, lanes, 1))


def _coords_inputs(grid_size, ts, points, rotation, translation):
    """B6's inputs as contiguous fp32 on one card, checked against the
    grid and the kernel's launch bounds."""
    f32 = torch.float32
    pts, rot, tr = (x.to(f32).contiguous()
                    for x in (points, rotation, translation))
    _check_cuda("coords", pts, f32, rot, f32, tr, f32)
    n_out = len(grid_size)
    bsz = rot.shape[0]
    if n_out not in (2, 3) or len(ts) != n_out or pts.dim() != 2 or \
            rot.shape != (bsz, n_out, pts.shape[1]) or \
            tr.shape != (bsz, n_out):
        raise ValueError(f"coords: points {tuple(pts.shape)}, rotation "
                         f"{tuple(rot.shape)} and translation "
                         f"{tuple(tr.shape)} do not form poses onto the "
                         f"grid {tuple(grid_size)} with tiles {tuple(ts)}")
    p, n_in = pts.shape
    if not (bsz >= 1 and 1 <= p < 2 ** 31 and n_in >= 1):
        raise ValueError(f"coords: B={bsz}, P={p}, n_in={n_in} exceed the "
                         f"kernel's launch bounds")
    return pts, rot, tr


def _coords_launch(grid_size, ts, pts, rot, tr, key, planes, weight, slots,
                   n_rows, id_plane, n_slots):
    """One launch of B6 on checked inputs (`_coords_inputs`), into
    `planes` (B, P, `_lanes`) with ``id_plane=-1``, or into a single tile's
    frame (B, id_plane + 1, n_rows) and its slot table `slots`."""
    n_out = len(grid_size)
    bsz, _, n_in = rot.shape
    # g / 2, which the call rounds to fp32: the twin's halved fp32 grid
    # size (halving commutes with the rounding)
    scale = [g / 2 for g in grid_size]
    pad = (0,) * (3 - n_out)
    _launch("coords", pts.device, _build.load().dprast_coords, _ptr(pts),
            _ptr(rot), _ptr(tr), None if key is None else _ptr(key),
            _ptr(planes), None if weight is None else _ptr(weight),
            None if slots is None else _ptr(slots), bsz, pts.shape[0],
            n_rows, id_plane, n_slots, n_in, n_out, *grid_size, *pad, *ts,
            *pad, *scale, *pad)
    LAUNCHES["coords"] += 1


def _direct_frame_plain(grid_size, ts, points, rotation, translation,
                        weight, chunk):
    """Plain twin of `direct_frame`: the twin's planes without keys, then
    `_prep_direct`."""
    _, locs, _ = _keys_and_local_plain(grid_size, ts, points, rotation,
                                       translation, want_key=False)
    return _prep_direct(*_frame_planes(locs, weight), chunk)


@annotate("dprast.b6.coords")
def direct_frame(grid_size, ts, points, rotation, translation, weight,
                 chunk):
    """B6 writing a single tile's frame -> ``(data (B, n_planes, p_pad),
    slot_tile (B, n_slots + 1))``: `_prep_direct` of the encoded planes,
    the point weight `weight` (P,) where it is given (``None`` on the
    uniform path) and the point ids, with every slot live.  CPU tensors
    take the plain twin, CUDA tensors one launch of `csrc/coords.cu`, which
    writes the frame and its slot table itself (counted under
    ``"coords"``)."""
    if points.device.type == "cpu":
        return _direct_frame_plain(grid_size, ts, points, rotation,
                                   translation, weight, chunk)
    pts, rot, tr = _coords_inputs(grid_size, ts, points, rotation,
                                  translation)
    bsz, n_out = rot.shape[:2]
    p = pts.shape[0]
    dev = pts.device
    w = None
    if weight is not None:
        w = weight.to(torch.float32).contiguous()
        _check_cuda("coords", pts, torch.float32, w, torch.float32)
        if w.shape != (p,):
            raise ValueError(f"coords: weight {tuple(w.shape)} is not one "
                             f"per point of {p}")
    n_planes = n_out + (1 if w is None else 2)
    p_pad = -(-p // chunk) * chunk
    n_slots = p_pad // chunk
    data = torch.empty((bsz, n_planes, p_pad), dtype=torch.float32,
                       device=dev)
    slot_tile = torch.empty((bsz, n_slots + 1), dtype=torch.int32,
                            device=dev)
    _coords_launch(grid_size, ts, pts, rot, tr, None, data, w, slot_tile,
                   p_pad, n_planes - 1, n_slots)
    return data, slot_tile


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


# keys a stretch: B9 counts each stretch of a pose's keys apart and B10
# scatters it from the counts' prefix (`csrc/bins.cuh`)
_STRETCH = 4096


def _slot_frame_size(p, nt, chunk):
    return -(-p // chunk) * chunk + nt * chunk


def _prep_binned(key, planes, fills, nt, chunk, min_chunk_per_tile,
                 pack_idx=False):
    """Sort `planes` (list of (B, P) f32) into the padded slot frame.

    Returns (data (B, len(planes), s_pad) f32, slot_tile (B, n_slots + 1)
    int32); the trailing entry is ``n_live``, the count of slots that carry
    frame rows.  Filler rows get the per-plane `fills` values.

    ONE sort builds the frame (`_slot_order`).  With ``pack_idx=True`` the
    last plane must be the point-id plane (values ``0..p-1``, fill ``p``);
    when the combined bits fit an int32 it rides inside the sort key
    (``key * P2 + id``), the keys are unique and the sort needs no
    stability.  Otherwise it rides as a payload and the sort is stable.
    This is the plain version of what `frame_gather` writes on the card."""
    bsz, p = key.shape
    perm, sorted_keys, slot_tile = _slot_order(key, nt, chunk,
                                               min_chunk_per_tile, pack_idx)
    if perm is None:
        # the card's packed keys: each filler row reads the first fill
        perm = _frame_ids(sorted_keys, p)
    s_pad = perm.shape[1]
    n_fill = max(s_pad - p, nt * chunk)
    if sorted_keys is not None:
        planes = planes[:-1]
    with annotate("dprast.frame_gather"):
        data = [torch.gather(
            torch.cat([pl_.expand(bsz, p),
                       torch.full((bsz, n_fill), fills[i],
                                  dtype=torch.float32, device=key.device)],
                      dim=1), 1, perm)
                for i, pl_ in enumerate(planes)]
        if sorted_keys is not None:
            data.append((sorted_keys % _id_span(p)).to(torch.float32))
        return torch.stack(data, dim=1), slot_tile


def _id_span(p):
    """The power of two above every point id and the filler id `p`."""
    return 1 << max(int(p).bit_length(), 1)


def _slot_order(key, nt, chunk, min_chunk_per_tile, pack_idx):
    """The binning sort of the keys `key` (B, P) -> ``(perm (B, s_pad)
    int64, sorted_keys, slot_tile)``: frame row ``r`` of pose ``b`` takes
    point ``perm[b, r]`` where that is below P, else it is a filler row.
    `sorted_keys` (B, s_pad) carries the packed point ids (``key * P2 +
    id``) where ``pack_idx`` and the bits fit an int32, else it is None
    (a stable sort; the id is the payload ``perm``).

    On the CPU B9's plain version writes the sort's input and
    `torch.sort` sorts it.  On the card B9 (`slot_prep`) counts and B10
    (`bin_scatter`) writes the one of the two that the frame gather reads
    straight to its place, bit for bit what the sort gives: `perm` is
    then None where the keys are packed."""
    p = key.shape[1]
    packed = pack_idx and (2 * nt + 1) * _id_span(p) + p < 2 ** 31
    if key.device.type == "cpu":
        with annotate("dprast.b9.slot_prep"):
            keys2, slot_tile, _ = _slot_prep_plain(key, nt, chunk,
                                                   min_chunk_per_tile, packed)
        with annotate("dprast.sort"):
            sorted_keys, perm = torch.sort(keys2, dim=1, stable=not packed)
        return perm, sorted_keys if packed else None, slot_tile
    bases, slot_tile, counts = slot_prep(key, nt, chunk, min_chunk_per_tile)
    index = bin_scatter(key, counts, bases, nt, chunk, min_chunk_per_tile,
                        packed)
    return (None, index, slot_tile) if packed else (index, None, slot_tile)


def _padded_offsets(counts, chunk, min_chunk_per_tile):
    """The rows of each tile in the frame and where each starts: counts (B,
    nt) -> ``(padded (B, nt), poffs (B, nt + 1))``, ``poffs[:, nt]`` the
    rows of every tile."""
    padded = -(-counts // chunk) * chunk
    if min_chunk_per_tile:
        padded = torch.clamp(padded, min=chunk)
    zero = torch.zeros((counts.shape[0], 1), dtype=torch.int32,
                       device=counts.device)
    return padded, torch.cat([zero, torch.cumsum(padded, dim=1).to(
        torch.int32)], dim=1)


def _slot_prep_plain(key, nt, chunk, min_chunk_per_tile, packed):
    """Plain version of B9 and of the sort's input, in eager torch ops ->
    ``(keys2 (B, s_pad), slot_tile (B, n_slots + 1), counts (B, nt +
    1))``, all int32: `keys2` is the binning sort's input, ``2 key`` for
    the real rows, then per tile t exactly ``padded - count`` filler rows
    keyed ``2t + 1`` and the rest ``2nt + 1`` (each times ``_id_span(P)``
    plus the row's id, P for a filler, where `packed`); the slot table
    and the counts are `slot_prep`'s.  The CPU sorts it with `torch.sort`
    (`_slot_order`, `bin_scatter`).

    Per-tile counts come from the unsorted keys, so filler rows can be
    emitted up front with interleaving keys -- reals of tile t sort as
    ``2t``, exactly the right number of fillers as ``2t+1``, everything
    else (no-overlap points at key ``nt``, excess fillers) past the frame
    at ``>= 2*nt``."""
    bsz, p = key.shape
    dev = key.device
    i32 = torch.int32
    s_pad = _slot_frame_size(p, nt, chunk)
    n_slots = s_pad // chunk
    p2 = _id_span(p)

    # per-tile counts; the no-overlap sentinel nt has its own bin, dropped
    counts_all = _tile_count_plain(key, nt)
    counts = counts_all[:, :nt]
    padded, poffs = _padded_offsets(counts, chunk, min_chunk_per_tile)
    # filler rows: exactly padded-counts of tile t keyed to sort directly
    # after tile t's real rows; the rest past every real key
    iota_t = torch.arange(nt, dtype=i32, device=dev)
    f_k = torch.arange(chunk, dtype=i32, device=dev).repeat(nt)
    f_needed = (padded - counts)[:, :, None].expand(bsz, nt, chunk).reshape(
        bsz, nt * chunk)
    f_tile = iota_t[:, None].expand(nt, chunk).reshape(-1)
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
    # slot s belongs to tile #(count of poffs[t+1] <= s*chunk)
    starts = (torch.arange(n_slots, device=dev) * chunk).expand(bsz, n_slots)
    tile_of = torch.searchsorted(poffs[:, 1:].long().contiguous(),
                                 starts.contiguous(), right=True)
    slot_tile = torch.clamp(tile_of, max=nt - 1).to(i32)
    n_live = poffs[:, nt:] // chunk
    return keys2, torch.cat([slot_tile, n_live], dim=1), counts_all


def _bases_plain(key, counts, nt, chunk, min_chunk_per_tile):
    """Plain version of B9's bases: the frame row at which each stretch of
    `_STRETCH` keys of a pose starts each tile, ``poffs[t]`` plus the
    pose's points of tile t in the stretches before -> (B, ceil(P /
    _STRETCH), nt + 1) int32; `counts` (B, nt + 1) as `_tile_count_plain`
    gives them."""
    bsz, p = key.shape
    n_str = -(-p // _STRETCH)
    # the last stretch topped up with a key of a bin of its own, dropped
    whole = torch.full((bsz, n_str * _STRETCH), nt + 1, dtype=torch.int32,
                       device=key.device)
    whole[:, :p] = key
    per = _tile_count_plain(whole.reshape(bsz * n_str, _STRETCH), nt + 1)
    per = per[:, :nt + 1].reshape(bsz, n_str, nt + 1)
    _, poffs = _padded_offsets(counts[:, :nt], chunk, min_chunk_per_tile)
    return (poffs[:, None, :] + torch.cumsum(per, dim=1) - per).to(
        torch.int32)


def _check_frame_bounds(name, bsz, p, nt, chunk):
    """B9 and B10 take 1 to 4,096 tiles, slots of a multiple of 4 rows, and
    a frame of fewer than 2^31 rows a pose."""
    if not (bsz >= 1 and p >= 1 and 1 <= nt <= 4096 and chunk >= 4
            and chunk % 4 == 0 and _slot_frame_size(p, nt, chunk) < 2 ** 31):
        raise ValueError(f"{name}: B={bsz}, P={p}, nt={nt}, chunk={chunk} "
                         f"exceed the kernel's launch bounds")


@annotate("dprast.b9.slot_prep")
def slot_prep(key, nt, chunk, min_chunk_per_tile):
    """B9, the binning sort's preparation: the tile keys `key` (B, P)
    int32 in [0, nt] (``nt``: no tile) -> ``(bases (B, ceil(P /
    _STRETCH), nt + 1), slot_tile (B, n_slots + 1), counts (B, nt + 1))``,
    all int32.  ``bases[b, j, t]`` is the frame row of the first point of
    tile t among the `_STRETCH` keys of stretch j, as a stable sort by
    tile places it: ``poffs[t]`` (the tile's first row, the sentinel's
    after every tile's padded rows) plus the tile's points in the
    stretches before; `slot_tile` the tile of each slot and, last, the
    live slots; `counts` the points of each tile, the sentinel bin last.
    B10 (`bin_scatter`) writes the sorted frame keys from them.  CPU
    tensors take the plain versions (`_slot_prep_plain`, `_bases_plain`),
    CUDA tensors the two kernels of `csrc/slot_prep.cu` (integer
    arithmetic: the same bits in any order, and no host sync)."""
    if key.device.type == "cpu":
        _, slot_tile, counts = _slot_prep_plain(key, nt, chunk,
                                                min_chunk_per_tile, False)
        return (_bases_plain(key, counts, nt, chunk, min_chunk_per_tile),
                slot_tile, counts)
    bsz, p = key.shape
    _check_frame_bounds("slot_prep", bsz, p, nt, chunk)
    _check_cuda("slot_prep", key, torch.int32)
    dev = key.device
    i32 = torch.int32
    bases = torch.empty((bsz, -(-p // _STRETCH), nt + 1), dtype=i32,
                        device=dev)
    slot_tile = torch.empty((bsz, _slot_frame_size(p, nt, chunk) // chunk
                             + 1), dtype=i32, device=dev)
    counts = torch.empty((bsz, nt + 1), dtype=i32, device=dev)
    _launch("slot_prep", dev, _build.load().dprast_slot_prep, _ptr(key),
            _ptr(bases), _ptr(slot_tile), _ptr(counts), bsz, p, nt, chunk,
            int(min_chunk_per_tile))
    LAUNCHES["slot_prep"] += 1
    return bases, slot_tile, counts


@annotate("dprast.sort")
def bin_scatter(key, counts, bases, nt, chunk, min_chunk_per_tile, packed):
    """B10, the binning sort: the tile keys `key` (B, P) int32 in [0, nt],
    with B9's `counts` and `bases` of them (`slot_prep`, the same `chunk`
    and ``min_chunk_per_tile``) -> the frame's keys (B, s_pad) in frame
    order.  Where `packed` they are the sorted int32 keys ``(2t + (1 for
    a filler)) * _id_span(P) + id`` (id P for a filler), else the int64
    permutation that a stable sort of B9's plain sort input
    (`_slot_prep_plain`) gives: a point's id, or P plus the input's
    filler index.  CPU tensors take that sort (`torch.sort` of
    `_slot_prep_plain`'s input, which `counts` and `bases` do not enter),
    CUDA tensors the counting scatter of `csrc/bin_scatter.cu`, which
    writes each row straight to its place, bit for bit the sort's
    (integer arithmetic, no atomics, no host sync)."""
    if key.device.type == "cpu":
        keys2 = _slot_prep_plain(key, nt, chunk, min_chunk_per_tile,
                                 packed)[0]
        values, perm = torch.sort(keys2, dim=1, stable=not packed)
        return values if packed else perm
    bsz, p = key.shape
    p2 = _id_span(p)
    _check_frame_bounds("bin_scatter", bsz, p, nt, chunk)
    if packed and (2 * nt + 1) * p2 + p >= 2 ** 31:
        raise ValueError(f"bin_scatter: packed keys of nt={nt}, P={p} do "
                         f"not fit an int32")
    _check_cuda("bin_scatter", key, torch.int32, counts, torch.int32, bases,
                torch.int32)
    if counts.shape != (bsz, nt + 1) or \
            bases.shape != (bsz, -(-p // _STRETCH), nt + 1):
        raise ValueError(f"bin_scatter: counts {tuple(counts.shape)} and "
                         f"bases {tuple(bases.shape)} are not B9's of keys "
                         f"{tuple(key.shape)} and nt={nt}")
    out = torch.empty((bsz, _slot_frame_size(p, nt, chunk)),
                      dtype=torch.int32 if packed else torch.int64,
                      device=key.device)
    _launch("bin_scatter", key.device, _build.load().dprast_bin_scatter,
            _ptr(key), _ptr(counts), _ptr(bases), _ptr(out), bsz, p, nt,
            chunk, int(min_chunk_per_tile), int(packed), p2)
    LAUNCHES["bin_scatter"] += 1
    return out


def _tile_count_plain(key, nt):
    """The points of each pose in each tile: keys (B, P) int32 in [0, nt]
    -> counts (B, nt + 1) int32, by one histogram of (pose, tile) bins.
    Its range is given, so nothing is read back to the host (`bincount`
    reads its input's), and float64 holds every bin and count exactly.
    `slot_prep`'s kernel counts with integer atomics, the same in any
    order, where torch's `histc` raises under
    ``torch.use_deterministic_algorithms(True)`` on CUDA."""
    bsz = key.shape[0]
    offs = torch.arange(bsz, device=key.device)[:, None] * (nt + 1)
    n_bins = bsz * (nt + 1)
    counts = torch.histc((key.double() + offs).reshape(-1), bins=n_bins,
                         min=-0.5, max=n_bins - 0.5)
    return counts.to(torch.int32).reshape(bsz, nt + 1)


def _frame_planes(locs, weight):
    """The frame's source planes (B, P) and their filler values: the
    encoded coordinates `locs` (fill 0, which decodes outside every
    window), the point weight `weight` (P,) where it is given (fill 0),
    and the point ids (fill P)."""
    bsz, p = locs[0].shape
    planes = list(locs)
    fills = [0.0] * len(locs)
    if weight is not None:
        # the per-row weight plane carries the POINT weight only; the
        # per-pose out_weight is applied after the fold (the splat is
        # linear in it)
        planes.append(weight.to(torch.float32)[None, :].expand(bsz, p))
        fills.append(0.0)
    # the point-id plane rides the sort (packed into the key when the bits
    # fit): unique keys let the sort drop stability, and the pullback
    # unsorts by it
    planes.append(torch.arange(p, dtype=torch.float32, device=locs[0].device)
                  [None, :].expand(bsz, p))
    fills.append(float(p))
    return planes, fills


def _frame_ids(index, p):
    """The source of each frame row from the sort -> int64 (B, s_pad):
    `index` is the sort's int64 permutation, or its packed int32 keys
    (``key * P2 + id``), whose low bits hold the row's id (P for a
    filler)."""
    if index.dtype == torch.int32:
        return (index & (_id_span(p) - 1)).long()
    return index


def _frame_gather_plain(index, locs, weight):
    """Plain twin of `frame_gather`: `_prep_binned`'s gather, with the id
    of each row read off `index` (on both of its paths the point's own
    id, or P for a filler row)."""
    bsz, p = locs[0].shape
    perm = _frame_ids(index, p)
    real = perm < p
    at = torch.where(real, perm, 0)
    sources = list(locs) + ([] if weight is None else [
        weight.to(torch.float32)[None, :].expand(bsz, p)])
    data = [torch.where(real, torch.gather(pl_.expand(bsz, p), 1, at), 0.0)
            for pl_ in sources]
    data.append(torch.where(real, perm, p).to(torch.float32))
    return torch.stack(data, dim=1)


@annotate("dprast.frame_gather")
def frame_gather(index, locs, weight):
    """The multi-tile frame after the sort -> data (B, n_planes, s_pad):
    row ``r`` of pose ``b`` holds point ``j``'s encoded planes `locs`
    (each (B, P)), its weight `weight` (P,) where that is given, and its
    id, or, for ``j >= P``, a filler row (0, 0, P) -- what `_prep_binned`
    writes.  ``j`` comes from `index` (B, s_pad), `_slot_order`'s: the
    packed sorted keys (int32, ``j = key & (P2 - 1)``) where the sort packs
    the ids, else the int64 permutation; either may be a view with a row
    stride.  CPU tensors take the plain twin, CUDA tensors the kernel in
    `csrc/frame_gather.cu`, which reads the planes as B6 writes them on the
    card: 2 or 3 views of one (B, P, L) tensor (`_interleaved`), a point's
    planes in one load."""
    if index.device.type == "cpu":
        return _frame_gather_plain(index, locs, weight)
    f32 = torch.float32
    bsz, s_pad = index.shape
    p = locs[0].shape[1]
    dev = index.device
    if not _on_card(index) or any(pl_.device != dev for pl_ in locs):
        raise ValueError(f"frame_gather: tensors must share one CUDA "
                         f"device; got {[pl_.device for pl_ in locs]} beside "
                         f"{dev}")
    if index.dtype not in (torch.int32, torch.int64) or \
            index.stride(1) != 1 or locs[0].shape[0] != bsz:
        raise ValueError(f"frame_gather: index {tuple(index.shape)} "
                         f"{index.dtype} and planes "
                         f"{[tuple(pl_.shape) for pl_ in locs]} do not form "
                         f"a frame")
    src = _interleaved(locs)
    w = None
    if weight is not None:
        w = weight.to(f32).contiguous()
        _check_cuda("frame_gather", w, f32)
        if w.shape != (p,) or w.device != dev:
            raise ValueError(f"frame_gather: weight {tuple(w.shape)} is not "
                             f"one per point of {p}")
    if not (bsz >= 1 and 1 <= p < 2 ** 24):
        raise ValueError(f"frame_gather: B={bsz}, P={p} exceed the kernel's "
                         f"launch bounds")
    n_planes = len(locs) + (1 if w is None else 2)
    data = torch.empty((bsz, n_planes, s_pad), dtype=f32, device=dev)
    # the packed keys' id bits, or 0 for the int64 permutation
    mask = _id_span(p) - 1 if index.dtype == torch.int32 else 0
    _launch("frame_gather", dev, _build.load().dprast_frame_gather,
            _ptr(index), index.stride(0), mask, _ptr(src), len(locs),
            None if w is None else _ptr(w), _ptr(data), bsz, p, n_planes,
            s_pad)
    LAUNCHES["frame_gather"] += 1
    return data


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


def _flat_rows_3d(iz0, iy0, ts):
    """The four (sz, sy) stencil rows of a 3-D window, flattened as
    ``z * (ty + 1) + y``, in the order (0,0), (0,1), (1,0), (1,1), as f32;
    a row whose z is outside [0, tz] or whose y is outside [0, ty] is -9,
    which matches no window row."""
    tz, ty = ts[0], ts[1]
    rows = []
    for sz in (0, 1):
        for sy in (0, 1):
            z = iz0 + sz
            y = iy0 + sy
            ok = (z >= 0) & (z <= tz) & (y >= 0) & (y <= ty)
            rows.append(torch.where(ok, z * (ty + 1) + y, -9)
                        .to(torch.float32))
    return rows


def _planes_fwd(coord, w):
    """Lane planes (B, L, s_pad) f32 for the splat from the frame's
    encoded coordinate planes ``coord`` (B, n_out, s_pad) and the per-row
    weight plane ``w`` (B, s_pad), or ``w=None`` on the uniform-weight
    path.  2-D: ``[iy0, dly, (w,) dlx, ix0]`` (L = 5 or 4); 3-D:
    ``[iz0, dlz, iy0, dly, (w,) dlx, ix0]`` (L = 7 or 6).  Small integers
    ride as exact f32."""
    f32 = torch.float32
    lane = []
    for i in range(coord.shape[1] - 1):
        r0, dl = _decode_coord(coord[:, i])
        lane += [r0.to(f32), dl]
    ix0, dlx = _decode_coord(coord[:, -1])
    w_rows = [] if w is None else [w]
    return torch.stack(lane + w_rows + [dlx, ix0.to(f32)], dim=1)


def _planes_bwd(coord, ts):
    """Lane planes (B, Mb, s_pad) f32 for the gather from the frame's
    encoded coordinate planes ``coord`` (B, n_out, s_pad).  2-D:
    ``[iy0, dly, ix0, dlx]``; 3-D: ``[r00, r01, r10, r11, dlz, dly, ix0,
    dlx]`` with the flat stencil rows of `_flat_rows_3d`."""
    f32 = torch.float32
    ix0, dlx = _decode_coord(coord[:, -1])
    if coord.shape[1] == 2:
        iy0, dly = _decode_coord(coord[:, 0])
        sub = [iy0.to(f32), dly]
    else:
        iz0, dlz = _decode_coord(coord[:, 0])
        iy0, dly = _decode_coord(coord[:, 1])
        sub = _flat_rows_3d(iz0, iy0, ts) + [dlz, dly]
    return torch.stack(sub + [ix0.to(f32), dlx], dim=1)


# ---------------------------------------------------------------------------
# B1: the forward splat
# ---------------------------------------------------------------------------


def _b1_instance(n_out, terms):
    name = _B1_INSTANCES.get((n_out, terms))
    if name is None:
        raise ValueError(f"fwd_splat: no instance for n_out={n_out}, "
                         f"terms={terms}; terms is 0 or 1")
    return name


def _splat_terms(slot_tile, lane, nt, win, chunk, terms):
    """The terms of B1's sum on lane planes -> ``(shape, pair, live, w,
    terms)``: the windows' shape (B, nt, rows_e, cols_e); the (pose, tile)
    pair ``b * nt + tile`` of each frame row and whether its slot is live
    (B, s_pad); the weight plane or None; and an iterator over the 2^n
    stencil targets of every row, each ``(idx, v)`` of (B, s_pad): the flat
    index into the windows (their size where the target is dropped: a dead
    row, or outside the window on some axis; in 3-D a row ``iy0 = -1``
    must not alias into the z plane below) and the term, ``(hy * w) * cx``
    in 2-D and ``((hz * hy) * w) * cx`` in 3-D in that order of rounding,
    with ``terms=1`` rounded to the nearest bf16 (ties to even, as JAX's
    ``astype(jnp.bfloat16)``)."""
    _b1_instance(len(win), terms)
    bsz, n_lane, s_pad = lane.shape
    dev = lane.device
    n_out = len(win)
    n_slots = s_pad // chunk
    # per axis before x: its first stencil index and its two hat weights
    axes = [(lane[:, 2 * i].long(), (1.0 - lane[:, 2 * i + 1],
                                     lane[:, 2 * i + 1]))
            for i in range(n_out - 1)]
    w = lane[:, 2 * n_out - 2] if n_lane == 2 * n_out + 1 else None
    dlx = lane[:, -2]
    ix0 = lane[:, -1].long()
    cx = [1.0 - dlx, dlx]
    tile = torch.repeat_interleave(slot_tile[:, :n_slots].long(), chunk,
                                   dim=1)
    live = torch.repeat_interleave(
        torch.arange(n_slots, device=dev) < slot_tile[:, n_slots:], chunk,
        dim=1)
    rows_e, cols_e = math.prod(win[:-1]), win[-1]
    total = bsz * nt * rows_e * cols_e
    pair = torch.arange(bsz, device=dev)[:, None] * nt + tile
    base = pair * rows_e * cols_e

    def targets():
        for shifts in itertools.product((0, 1), repeat=n_out - 1):
            ok, r, hw = live, 0, None
            for (r0, h), s, extent in zip(axes, shifts, win[:-1]):
                ok = ok & (r0 + s >= 0) & (r0 + s < extent)
                r = r * extent + r0 + s
                hw = h[s] if hw is None else hw * h[s]
            if w is not None:
                hw = hw * w
            for sx in (0, 1):
                c = ix0 + sx
                ok_c = ok & (c >= 0) & (c < cols_e)
                v = hw * cx[sx]
                if terms == 1:
                    v = v.to(torch.bfloat16).float()
                yield torch.where(ok_c, base + r * cols_e + c, total), v

    return (bsz, nt, rows_e, cols_e), pair, live, w, targets()


def _fwd_splat_plain(slot_tile, lane, nt, win, chunk, terms=0):
    """Plain twin of B1 in fp32, the CPU's path.  `win` is the window's
    shape: ``(rows_e, cols_e)`` in 2-D, ``(nz, ny, cols_e)`` in 3-D, whose
    window rows are the flattened ``z * ny + y``.  Every live frame row
    adds its 2^n multilinear weights (`_splat_terms`) into ``ext[b,
    tile]`` (B, nt, rows_e, cols_e) in fp32, in frame order.  Rows of dead
    slots (past ``slot_tile[b, -1]``) add nothing.  The kernel sums the
    same terms exactly (`_fwd_splat_fixed_plain`)."""
    shape, _, _, _, terms_ = _splat_terms(slot_tile, lane, nt, win, chunk,
                                          terms)
    total = math.prod(shape)
    ext = torch.zeros(total + 1, dtype=torch.float32, device=lane.device)
    for idx, v in terms_:
        ext.index_add_(0, idx.reshape(-1), v.reshape(-1))
    return ext[:total].reshape(shape)


# B1's fixed point: a window entry's bound, ``rows 2^k max|w| <= 2^62``,
# a factor 2 inside int64 (the bf16 rounding may lift a term 2^-8 above
# max|w|); and the largest |k|, for which 2^k and 2^-k are normal floats
_FIXED_BITS = 62
_MAX_SHIFT = 126


def _fixed_shift(rows, wmax):
    """B1's shift k of a (pose, tile) (the kernel's `fixed_shift`): the
    largest with ``rows * wmax * 2^k < 2^62``, where `rows` (int tensor,
    >= 1) counts the rows of the tile's live slots and `wmax` (float32
    tensor) is their largest finite |w|, so that no sum of the tile's
    terms q = round(v 2^k) leaves int64 (a pixel's value is at most the sum
    of |w| over its tile's rows).  ``rows < 2^rb`` and ``wmax <= 2^e``
    give ``k = 62 - rb - e``; e is 0 where `wmax` is 0 or not finite, and
    k is clamped to [-126, 126]."""
    _, rb = torch.frexp(rows.to(torch.float64))
    m, e = torch.frexp(wmax.to(torch.float32))
    e = torch.where(torch.isfinite(wmax) & (wmax > 0),
                    e - (m == 0.5).to(e.dtype), 0)
    return torch.clamp(_FIXED_BITS - rb - e, -_MAX_SHIFT, _MAX_SHIFT)


def _pow2(k):
    """2^k as float32 for integer |k| <= 126, built from its bits."""
    return ((k.to(torch.int32) + 127) << 23).view(torch.float32)


def _fixed_sums(slot_tile, lane, nt, win, chunk, terms=0):
    """B1's sums in fixed point, as the kernel forms them -> ``(sums (B,
    nt, rows_e, cols_e) int64, k (B, nt), bad)``: each finite term `v`
    of `_splat_terms` becomes ``q = round(v 2^k)`` (an exact product, one
    rounding, ties to even) with the shift k of its (pose, tile)
    (`_fixed_shift`; `wmax` is 1 without a weight plane), and the q add up
    exactly, so in any order.  `bad` (same shape, fp32) holds the sum of
    the non-finite terms of each entry, which the kernel adds in fp32 after
    the store: NaN or an infinity where there are any, whatever their
    order."""
    shape, pair, live, w, terms_ = _splat_terms(slot_tile, lane, nt, win,
                                                chunk, terms)
    dev = lane.device
    n_pairs = shape[0] * nt
    at = torch.where(live, pair, n_pairs).reshape(-1)
    rows = torch.zeros(n_pairs + 1, dtype=torch.int64, device=dev) \
        .index_add_(0, at, torch.ones_like(at))[:n_pairs]
    if w is None:
        wmax = torch.ones(n_pairs, dtype=torch.float32, device=dev)
    else:
        a = torch.where(torch.isfinite(w), w.abs(), 0.0).reshape(-1)
        wmax = torch.zeros(n_pairs + 1, dtype=torch.float32, device=dev) \
            .scatter_reduce_(0, at, a, "amax")[:n_pairs]
    k = _fixed_shift(torch.clamp(rows, min=1), wmax)
    scale = _pow2(k)[torch.clamp(pair, max=n_pairs - 1)]
    total = math.prod(shape)
    sums = torch.zeros(total + 1, dtype=torch.int64, device=dev)
    bad = torch.zeros(total + 1, dtype=torch.float32, device=dev)
    for idx, v in terms_:
        fin = torch.isfinite(v)
        q = torch.round(torch.where(fin, v, 0.0) * scale).to(torch.int64)
        sums.index_add_(0, torch.where(fin, idx, total).reshape(-1),
                        q.reshape(-1))
        bad.index_add_(0, torch.where(fin, total, idx).reshape(-1),
                       v.reshape(-1))
    return (sums[:total].reshape(shape), k.reshape(shape[:2]),
            bad[:total].reshape(shape))


def _fwd_splat_fixed_plain(slot_tile, lane, nt, win, chunk, terms=0):
    """B1's function bit for bit, the plain version the kernel is held to
    on the card (and never the card's path): the exact fixed-point sums of
    `_fixed_sums`, each stored as ``float(sum) * 2^-k`` (one rounding),
    plus the entry's non-finite terms."""
    sums, k, bad = _fixed_sums(slot_tile, lane, nt, win, chunk, terms)
    inv = _pow2(-k)[:, :, None, None]
    return sums.to(torch.float32) * inv + bad


def _split_count(device, blocks):
    """Blocks per tile for B4: enough (pose, tile) blocks to give every SM
    two, at most 16 per tile."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(16, -(-2 * n_sm // blocks)))


# B1's thread-block cluster, the blocks that share one (pose, tile): 8 is
# the largest every Hopper card schedules
_MAX_CLUSTER = 8
# B1's blocks per SM that `_cluster_size` aims at where a pose has several
# tiles: more than the one an SM holds (a block's 128 KB window fills it),
# because tiles are uneven (a 0.4-sigma cloud at 128^3 puts 96 of a pose's
# 3,977 slots into the busiest of 342 tiles), but no more than two: each
# rank with slots zeroes, merges and stores a whole window.  On an H100 at
# 128^3 x 10^6 one block per (pose, tile) read 43.5 us, two 49.2, four 92.7
# (`dprast_torch.benchmarks.exp_b1_cluster`)
_B1_BLOCKS_PER_SM = 2


def _cluster_size(bsz, nt, n_sm, held):
    """B1's cluster size from shapes and the card's occupancy alone.
    ``held[c - 1]`` is how many clusters of `c` blocks the card holds at
    once.  A single tile holds every row of its pose, so all blocks are
    equally heavy and a second wave of clusters costs as much as the
    first: the largest size of which the card holds all `bsz` clusters at
    once, 1 if it holds them at no size.  Several tiles are uneven: as
    many blocks per (pose, tile) as give `n_sm` SMs `_B1_BLOCKS_PER_SM`
    blocks each.  Never a size the card cannot hold; 0 if it holds
    none."""
    pairs = bsz * nt
    sizes = [c for c in range(1, _MAX_CLUSTER + 1) if held[c - 1] > 0]
    if not sizes:
        return 0
    if nt == 1:
        most = max([c for c in sizes if held[c - 1] >= pairs], default=1)
    else:
        most = -(-_B1_BLOCKS_PER_SM * n_sm // pairs)
    return max([c for c in sizes if c <= most], default=sizes[0])


_HELD = {}


def _clusters_held(device, win, terms=0, encoded=False):
    """How many of B1's clusters of 1 .. `_MAX_CLUSTER` blocks, for windows
    of shape `win`, the card `device` holds at once
    (`cudaOccupancyMaxActiveClusters`, asked once per card, window and
    instance: the lane and the encoded instances use registers apart) ->
    tuple.  A size the card cannot schedule counts 0."""
    n_out = len(win)
    key = (torch.device(device), tuple(win), terms, encoded)
    if key not in _HELD:
        _b1_instance(n_out, terms)
        entry = _build.load().dprast_fwd_splat
        n_planes = n_out + 1 if encoded else 2 * n_out
        held = []
        for cluster in range(1, _MAX_CLUSTER + 1):
            n = ctypes.c_int(0)
            _launch("fwd_splat", device, entry, None, None, None, 1, 1,
                    n_out, 0, n_planes, 0, 4, win[-2], math.prod(win[:-1]),
                    win[-1], cluster, terms, int(encoded), ctypes.byref(n))
            held.append(n.value)
        _HELD[key] = tuple(held)
    return _HELD[key]


def _b1_cluster(device, bsz, nt, win, terms=0, encoded=False):
    """The cluster size `fwd_splat` (or, with `encoded`, `fwd_splat_enc`)
    runs (B, nt) windows of shape `win` with on the card `device`."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return _cluster_size(bsz, nt, n_sm,
                         _clusters_held(device, win, terms, encoded))


@annotate("dprast.b1.splat")
def fwd_splat(slot_tile, lane, nt, win, chunk, terms=0, *, cluster=None):
    """B1 on lane planes: splat the lane planes of a slot frame into the
    per-tile windows of shape `win` -> ext (B, nt, rows_e, cols_e) f32,
    with `terms` 0 (fp32) or 1 (bf16 products; see `_splat_terms`).
    CPU tensors take the fp32 twin `_fwd_splat_plain`, CUDA tensors the
    kernel in `csrc/fwd_splat.cu`, which finds each tile's slots itself,
    sums each window exactly in 64-bit fixed point (the same bits on every
    run and at every cluster size: `_fwd_splat_fixed_plain` is its function
    bit for bit) and writes every window once: nothing is launched before
    it.  `cluster` forces
    the size of the thread-block cluster that shares one (pose, tile), 1
    to `_MAX_CLUSTER` (the default is `_b1_cluster`'s); only measurements
    and tests pass it, and it changes no bit of the result.  A size the
    card cannot schedule raises.  The main
    path runs `fwd_splat_enc` on the frame itself; this is the harness's
    standalone B1."""
    instance = _b1_instance(len(win), terms)
    if lane.device.type == "cpu":
        return _fwd_splat_plain(slot_tile, lane, nt, win, chunk, terms)
    return _splat(instance, slot_tile, lane, nt, win, chunk, terms, cluster,
                  encoded=False)


def _frame_lanes(data, n_out):
    """The lane planes (`_planes_fwd`) of the frame `data`."""
    w = data[:, n_out] if data.shape[1] == n_out + 2 else None
    return _planes_fwd(data[:, :n_out], w).contiguous()


def _fwd_splat_enc_plain(slot_tile, data, nt, win, chunk, terms=0):
    """Plain version of `fwd_splat_enc`, the CPU's path: the frame's lane
    planes, then B1's fp32 twin."""
    return _fwd_splat_plain(slot_tile, _frame_lanes(data, len(win)), nt,
                            win, chunk, terms)


def _fwd_splat_enc_fixed_plain(slot_tile, data, nt, win, chunk, terms=0):
    """The function of `fwd_splat_enc` on the card bit for bit: the frame's
    lane planes, then `_fwd_splat_fixed_plain`."""
    return _fwd_splat_fixed_plain(slot_tile, _frame_lanes(data, len(win)),
                                  nt, win, chunk, terms)


@annotate("dprast.b1.splat")
def fwd_splat_enc(slot_tile, data, nt, win, chunk, terms=0, *,
                  cluster=None):
    """B1 on the frame: `data` (B, n_planes, s_pad) is the frame
    ``[enc..., (w,) id]`` of `_fwd_prep` (it has a weight plane where
    ``n_planes = n_out + 2``), whose encoded planes the kernel decodes row
    by row -> ext as `fwd_splat` gives it.  CPU tensors take the plain
    version `_fwd_splat_enc_plain` (fp32), CUDA tensors the ``_enc``
    instance of `csrc/fwd_splat.cu`, whose function bit for bit is
    `_fwd_splat_enc_fixed_plain`; `cluster` as in `fwd_splat`."""
    instance = _b1_instance(len(win), terms) + _ENC
    if data.device.type == "cpu":
        return _fwd_splat_enc_plain(slot_tile, data, nt, win, chunk, terms)
    return _splat(instance, slot_tile, data, nt, win, chunk, terms, cluster,
                  encoded=True)


def _splat(instance, slot_tile, planes, nt, win, chunk, terms, cluster,
           encoded):
    """One launch of B1 on CUDA tensors, the lane planes or (`encoded`)
    the frame in `planes` (B, n_planes, s_pad), counted under
    `instance`."""
    _check_cuda("fwd_splat", slot_tile, torch.int32, planes, torch.float32)
    n_out = len(win)
    bsz, n_planes, s_pad = planes.shape
    n_slots = s_pad // chunk
    bare = n_out + 1 if encoded else 2 * n_out
    if n_out not in (2, 3) or n_planes not in (bare, bare + 1) \
            or s_pad != n_slots * chunk or \
            slot_tile.shape != (bsz, n_slots + 1):
        what = "frame" if encoded else "lane"
        raise ValueError(f"fwd_splat: {what} {tuple(planes.shape)}, slot "
                         f"table {tuple(slot_tile.shape)} and window {win} "
                         f"do not form a frame of chunk {chunk}")
    _check_four_rows("fwd_splat", chunk, planes)
    rows_e, cols_e = math.prod(win[:-1]), win[-1]
    if rows_e * cols_e * 8 > _build.MAX_FIXED_WINDOW_BYTES or nt > 65535:
        raise ValueError(f"fwd_splat: window {win}, nt={nt} exceed the "
                         f"kernel's launch bounds")
    if cluster is not None and not 1 <= cluster <= _MAX_CLUSTER:
        raise ValueError(f"fwd_splat: cluster {cluster} is not in 1.."
                         f"{_MAX_CLUSTER}")
    dev = planes.device
    held = _clusters_held(dev, win, terms, encoded)
    if cluster is None:
        cluster = _b1_cluster(dev, bsz, nt, win, terms, encoded)
    if cluster == 0 or held[cluster - 1] < 1:
        raise RuntimeError(f"fwd_splat: {dev} holds no thread-block cluster "
                           f"of {cluster or 1} blocks with a {win} window "
                           f"(cudaOccupancyMaxActiveClusters: {held})")
    ext = torch.empty((bsz, nt, rows_e, cols_e), dtype=torch.float32,
                      device=dev)
    _launch("fwd_splat", dev, _build.load().dprast_fwd_splat, _ptr(planes),
            _ptr(slot_tile), _ptr(ext), bsz, nt, n_out, n_slots, n_planes,
            s_pad, chunk, win[-2], rows_e, cols_e, cluster, terms,
            int(encoded), None)
    LAUNCHES[instance] += 1
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
    out = torch.empty((bsz, gy, gx), dtype=torch.float32, device=ext.device)
    _launch("band_fold", ext.device, _build.load().dprast_band_fold,
            _ptr(ext), _ptr(ow), _ptr(bg), _ptr(out), bsz, gy, gx, t0, t1)
    LAUNCHES["band_fold"] += 1
    return out


# ---------------------------------------------------------------------------
# B3: the band unfold
# ---------------------------------------------------------------------------


def _unfold(x, grid_size, ts):
    """Plain twin of B3 and the exact adjoint of :func:`_fold`: cut the
    per-tile extended windows out of x (B, *grid) -> (B, nt, rows_e,
    cols_e) with ``window[t] = x_pad[t*ts : t*ts + ts + 1]`` per axis,
    zero outside the grid (out-of-grid stencil neighbours gather 0).
    The windows keep the natural (rows, cols) orientation; the JAX
    package's kernel writes them transposed."""
    n = len(grid_size)
    b = x.shape[0]
    nts = [-(-g // t) for g, t in zip(grid_size, ts)]
    pad = []
    for i in reversed(range(n)):
        pad += [0, nts[i] * ts[i] + 1 - grid_size[i]]
    xp = F.pad(x, pad)
    for i in range(n):
        ax = 1 + 2 * i             # spatial axis i's current position
        t, m = ts[i], nts[i]
        body = xp.narrow(ax, 0, m * t)
        body = body.reshape(body.shape[:ax] + (m, t) + body.shape[ax + 1:])
        at_kt = [slice(None)] * xp.dim()
        at_kt[ax] = slice(t, m * t + 1, t)             # positions k*t
        halo_s = xp[tuple(at_kt)]
        halo_s = halo_s.reshape(halo_s.shape[:ax] + (m, 1)
                                + halo_s.shape[ax + 1:])
        xp = torch.cat([body, halo_s], dim=ax + 1)
    perm = [0] + [1 + 2 * i for i in range(n)] + [2 + 2 * i
                                                  for i in range(n)]
    xp = xp.permute(perm)          # (B, m0.., t0+1..)
    rows = math.prod(t + 1 for t in ts[:-1])
    # one tile on every axis but the last is a view of the permuted
    # tensor, not a copy: B4 reads contiguous windows
    return xp.reshape(b, math.prod(nts), rows, ts[-1] + 1).contiguous()


@annotate("dprast.unfold")
def band_unfold(g, grid_size, ts):
    """B3: cut the 2-D cotangent g (B, gy, gx) into the multi-tile
    windows (B, n0*n1, t0+1, t1+1), zero outside the grid.  CPU tensors
    take the plain twin, CUDA tensors the kernel in
    `csrc/band_unfold.cu`, which is written for the 128-column window of
    `tile_shape_for` and raises for another width."""
    if g.device.type == "cpu":
        return _unfold(g, grid_size, ts)
    _check_cuda("band_unfold", g, torch.float32)
    gy, gx = grid_size
    t0, t1 = ts
    n0, n1 = -(-gy // t0), -(-gx // t1)
    bsz = g.shape[0]
    if g.shape != (bsz, gy, gx):
        raise ValueError(f"band_unfold: g {tuple(g.shape)} does not match "
                         f"grid {grid_size}")
    if t1 + 1 != TILE:
        raise ValueError(f"band_unfold: the kernel cuts windows {TILE} "
                         f"columns wide, tiles {ts} give {t1 + 1}")
    if n0 * n1 * (t0 + 1) >= 2 ** 30:
        raise ValueError(f"band_unfold: grid {grid_size} exceeds the "
                         f"kernel's launch bounds")
    win = torch.empty((bsz, n0 * n1, t0 + 1, t1 + 1), dtype=torch.float32,
                      device=g.device)
    _launch("band_unfold", g.device, _build.load().dprast_band_unfold,
            _ptr(g), _ptr(win), bsz, gy, gx, t0, t1)
    LAUNCHES["band_unfold"] += 1
    return win


# ---------------------------------------------------------------------------
# B4: the backward gather
# ---------------------------------------------------------------------------


def _b4_instance(n_out, terms, layout):
    name = _B4_INSTANCES.get((n_out, terms, layout))
    if name is None:
        raise ValueError(f"bwd_gather: no instance for n_out={n_out}, "
                         f"terms={terms}, layout={layout!r}; see "
                         f"_B4_INSTANCES")
    return name


def _split_terms(x, terms):
    """An fp32 tensor as B4 stages it: unchanged (``terms=0``), rounded to
    the nearest bf16 (1), or its two-part bf16 split ``hi = bf16(x)``,
    ``lo = bf16(x - hi)`` added back (2), which is exact in fp32 and so
    what the JAX kernel's two one-hot matmul parts add up to."""
    if terms == 0:
        return x
    hi = x.to(torch.bfloat16).float()
    if terms == 1:
        return hi
    return hi + (x - hi).to(torch.bfloat16).float()


def _staged_window(win, terms, layout):
    """B4's window in the natural layout, as the kernel stages it: a
    transposed window is transposed back, a presplit pair ``(hi, lo)`` is
    ``float(hi) + float(lo)``, and the grid source's cotangent (B, gy,
    gx) is cut into the windows of `_unfold`."""
    if layout == "presplit":
        hi, lo = win
        return (hi.float() + lo.float()).transpose(-1, -2)
    if layout == "grid":
        grid_size = tuple(win.shape[1:])
        win = _unfold(win, grid_size, tile_shape_for(grid_size))
    win = _split_terms(win, terms)
    return win.transpose(-1, -2) if layout == "transposed" else win


def _bwd_gather_plain(slot_tile, lane_b, win, chunk, terms=0,
                      layout="natural"):
    """Plain twin of B4.  In 2-D every live frame row reads the four
    values ``p{sy}{sx} = win[b, tile, iy0 + sy, ix0 + sx]`` (0 outside
    the window) and writes, in this order of rounding,

        a = (1 - dly) * p00 + dly * p10      b = (1 - dly) * p01 + dly * p11
        gw   = a * (1 - dlx) + b * dlx
        du_y = (p10 - p00) * (1 - dlx) + (p11 - p01) * dlx
        du_x = b - a

    -> buf (B, 3, s_pad) ``[du_y, du_x, gw]``.  In 3-D it reads the four
    flat stencil rows ``r{sz}{sy}`` of the lane planes (-9 reads 0) at
    columns ``ix0`` and ``ix0 + 1`` and writes (B, 4, s_pad) ``[du_z,
    du_y, du_x, gw]``, see `_combine_3d`.  Rows of dead slots (past
    ``slot_tile[b, -1]``) are zeros.  `win` is (B, nt, rows_e, cols_e),
    or the whole single-tile grid (B, gy, gx), in the `layout` of
    `_LAYOUTS`; with ``layout="grid"`` it is the 2-D cotangent (B, gy,
    gx) of any tiling.  It is read through `_staged_window`, so
    ``terms=1`` and ``terms=2`` read its bf16 rounding or split."""
    bsz, n_lane, s_pad = lane_b.shape
    _b4_instance({4: 2, 8: 3}.get(n_lane), terms, layout)
    dev = lane_b.device
    n_slots = s_pad // chunk
    win = _staged_window(win, terms, layout)
    win = win.reshape((bsz, -1) + tuple(win.shape[-2:]))
    rows_e, cols_e = win.shape[-2:]
    ix0 = lane_b[:, -2].long()
    dlx = lane_b[:, -1]
    tile = torch.repeat_interleave(slot_tile[:, :n_slots].long(), chunk,
                                   dim=1)
    live = torch.repeat_interleave(
        torch.arange(n_slots, device=dev) < slot_tile[:, n_slots:], chunk,
        dim=1)
    flat = win.reshape(bsz, -1)
    total = flat.shape[1]
    flat = torch.cat([flat, flat.new_zeros((bsz, 1))], dim=1)
    base = tile * (rows_e * cols_e)

    def at(r, c):
        ok = (r >= 0) & (r < rows_e) & (c >= 0) & (c < cols_e)
        return torch.gather(flat, 1, torch.where(ok, base + r * cols_e + c,
                                                 total))

    omx = 1.0 - dlx
    if n_lane == 4:
        iy0 = lane_b[:, 0].long()
        dly = lane_b[:, 1]
        p00, p01 = at(iy0, ix0), at(iy0, ix0 + 1)
        p10, p11 = at(iy0 + 1, ix0), at(iy0 + 1, ix0 + 1)
        omy = 1.0 - dly
        a = omy * p00 + dly * p10
        b = omy * p01 + dly * p11
        rows = [(p10 - p00) * omx + (p11 - p01) * dlx]
    else:
        dlz, dly = lane_b[:, 4], lane_b[:, 5]
        # (v, d/du_z pre-term, d/du_y pre-term) at the columns ix0, ix0+1
        lo, hi = (_combine_3d([at(lane_b[:, i].long(), c) for i in range(4)],
                              dlz, dly) for c in (ix0, ix0 + 1))
        a, b = lo[0], hi[0]
        rows = [lo[1] * omx + hi[1] * dlx, lo[2] * omx + hi[2] * dlx]
    gw = a * omx + b * dlx
    buf = torch.stack(rows + [b - a, gw], dim=1)
    return torch.where(live[:, None, :], buf, 0.0)


def _combine_3d(p, dlz, dly):
    """The 3-D stencil at one x column, from the values ``p = [p00, p01,
    p10, p11]`` of its flat rows ``r{sz}{sy}``, in the JAX kernel's order
    of rounding:

        y0 = (1 - dly) * p00 + dly * p01     y1 = (1 - dly) * p10 + dly * p11
        v  = (1 - dlz) * y0 + dlz * y1
        dz = y1 - y0
        dy = (1 - dlz) * (p01 - p00) + dlz * (p11 - p10)

    -> (v, dz, dy)."""
    p00, p01, p10, p11 = p
    omy, omz = 1.0 - dly, 1.0 - dlz
    y0 = omy * p00 + dly * p01
    y1 = omy * p10 + dly * p11
    return (omz * y0 + dlz * y1, y1 - y0,
            omz * (p01 - p00) + dlz * (p11 - p10))


@annotate("dprast.b4.gather")
def bwd_gather(slot_tile, lane_b, win, chunk, terms=0, layout="natural"):
    """B4 on lane planes: gather the cotangent windows at every frame row
    -> buf (B, n_out + 1, s_pad) ``[du_y, du_x, gw]`` in 2-D, ``[du_z,
    du_y, du_x, gw]`` in 3-D (see `_bwd_gather_plain`).  `terms` and
    `layout` pick one of `_B4_INSTANCES`; a presplit `win` is the pair
    ``(hi, lo)``, a grid-source `win` the 2-D cotangent (B, gy, gx).  CPU
    tensors take the plain twin, CUDA tensors the kernel in
    `csrc/bwd_gather.cu`, which finds each tile's slots itself: nothing is
    launched before it.  The copy engines stage its windows where their
    alignment rules hold (`_b4_staging`); a grid source that cannot take
    the tiled load counts under ``instance + "_ldg"``.  The main path runs
    `bwd_gather_enc` on the frame itself; this is the harness's B4."""
    bsz, n_lane, s_pad = lane_b.shape
    n_out = {4: 2, 8: 3}.get(n_lane)
    instance = _b4_instance(n_out, terms, layout)
    if lane_b.device.type == "cpu":
        return _bwd_gather_plain(slot_tile, lane_b, win, chunk, terms,
                                 layout)
    _check_cuda("bwd_gather", lane_b, torch.float32)
    return _gather(instance, slot_tile, lane_b, n_out, win, chunk, terms,
                   layout, None, encoded=False)


def _bwd_gather_enc_plain(slot_tile, coord, ts, win, chunk, terms=0,
                          layout="natural"):
    """Plain version of `bwd_gather_enc`: the frame's lane planes
    (`_planes_bwd`), then B4's twin."""
    return _bwd_gather_plain(slot_tile, _planes_bwd(coord, ts).contiguous(),
                             win, chunk, terms, layout)


@annotate("dprast.b4.gather")
def bwd_gather_enc(slot_tile, coord, ts, win, chunk, terms=0,
                   layout="natural"):
    """B4 on the frame: `coord` (B, n_out, s_pad) are the frame's encoded
    planes, read in place where they are a view of the frame (``data[:,
    :n_out]``, at its pose stride); `ts` is the grid's body tile, from
    which a 3-D row's flat window rows are made -> buf as `bwd_gather`
    gives it, bit for bit.  CPU tensors take the plain version
    `_bwd_gather_enc_plain`, CUDA tensors the ``_enc`` instance of
    `csrc/bwd_gather.cu`."""
    bsz, n_out, s_pad = coord.shape
    instance = _b4_instance(n_out, terms, layout)
    if (n_out, terms, layout) not in _B4_ENC:
        raise ValueError(f"bwd_gather: no instance on the frame for "
                         f"n_out={n_out}, terms={terms}, layout={layout!r}")
    if coord.device.type == "cpu":
        return _bwd_gather_enc_plain(slot_tile, coord, ts, win, chunk, terms,
                                     layout)
    if not _on_card(coord) or coord.dtype != torch.float32 or \
            coord.stride(2) != 1 or coord.stride(1) != s_pad or \
            coord.stride(0) % 4:
        raise ValueError(f"bwd_gather: expected the encoded planes of a "
                         f"frame, f32 on a CUDA device, rows contiguous and "
                         f"planes {s_pad} apart; got {coord.dtype} on "
                         f"{coord.device}, strides {coord.stride()}")
    ny = None
    if n_out == 3:
        # the flat rows of `_flat_rows_3d`: z in [0, tz], y in [0, ty]
        ny = ts[1] + 1
        if win.shape[-2] != (ts[0] + 1) * ny:
            raise ValueError(f"bwd_gather: a window of {win.shape[-2]} rows "
                             f"is not the (z, y) rows of tiles {ts}")
    return _gather(instance + _ENC, slot_tile, coord, n_out, win, chunk,
                   terms, layout, ny, encoded=True)


def _gather(instance, slot_tile, rows, n_out, win, chunk, terms, layout,
            ny, *, encoded):
    """One launch of B4 on CUDA tensors, counted under `instance` (plus
    ``"_ldg"`` where a grid source stages with plain loads).  `rows` holds
    the lane planes, or (`encoded`) the frame's encoded planes at its pose
    stride; `ny` is a 3-D window's rows per z plane, which the encoded
    instance makes its flat rows with."""
    bsz, _, s_pad = rows.shape
    hi, lo = win if layout == "presplit" else (win, win)
    w_type = torch.bfloat16 if layout == "presplit" else torch.float32
    _check_cuda("bwd_gather", slot_tile, torch.int32, hi, w_type, lo, w_type)
    if rows.device != slot_tile.device:
        raise ValueError(f"bwd_gather: tensors must share one CUDA device; "
                         f"got {rows.device} beside {slot_tile.device}")
    n_slots = s_pad // chunk
    if s_pad != n_slots * chunk or slot_tile.shape != (bsz, n_slots + 1):
        raise ValueError(f"bwd_gather: rows {tuple(rows.shape)} and slot "
                         f"table {tuple(slot_tile.shape)} do not form a "
                         f"frame of chunk {chunk}")
    _check_four_rows("bwd_gather", chunk, rows)
    if hi.dim() not in (3, 4) or hi.shape[0] != bsz or \
            lo.shape != hi.shape:
        raise ValueError(f"bwd_gather: window {tuple(hi.shape)} is neither "
                         f"(B, nt, rows, cols) nor (B, rows, cols) for "
                         f"B={bsz}")
    gy = gx = t0 = t1 = 0
    if layout == "grid":
        if hi.dim() != 3:
            raise ValueError(f"bwd_gather: the grid source is the cotangent "
                             f"(B, gy, gx); got {tuple(hi.shape)}")
        gy, gx = hi.shape[1:]
        t0, t1 = tile_shape_for((gy, gx))
        nt = n_tiles((gy, gx))
        rows_e = cols_e = TILE
    else:
        nt = hi.shape[1] if hi.dim() == 4 else 1
        rows_e, cols_e = hi.shape[-2:]
        if layout != "natural":
            rows_e, cols_e = cols_e, rows_e
    if ny is None:
        ny = rows_e
    elif rows_e % ny:
        raise ValueError(f"bwd_gather: a window of {rows_e} rows holds no "
                         f"whole z planes of {ny} rows")
    if rows_e * cols_e * 4 > _build.MAX_WINDOW_BYTES or nt >= 65535:
        raise ValueError(f"bwd_gather: window {rows_e}x{cols_e}, nt={nt} "
                         f"exceed the kernel's launch bounds")
    dev = rows.device
    staging = _b4_staging(layout, hi, rows_e * cols_e)
    nsplit = _split_count(dev, bsz * nt)
    buf = torch.empty((bsz, n_out + 1, s_pad), dtype=torch.float32,
                      device=dev)
    _launch("bwd_gather", dev, _build.load().dprast_bwd_gather,
            _ptr(rows), _ptr(slot_tile), _ptr(hi), _ptr(lo), _ptr(buf),
            bsz, nt, n_out, n_slots, s_pad, rows.stride(0), chunk, rows_e,
            cols_e, ny, nsplit, terms, _LAYOUTS.index(layout), gy, gx, t0,
            t1, _STAGINGS.index(staging), int(encoded))
    if layout == "grid" and staging == "loads":
        instance += _GRID_LOADS
    LAUNCHES[instance] += 1
    return buf


def _b4_staging(layout, win, n_win):
    """How B4's kernel stages a window of `n_win` fp32 entries out of the
    CUDA tensor `win` (one of `_STAGINGS`): the TMA tiled load for a grid
    source whose rows are multiples of 16 bytes, one bulk copy for a
    contiguous fp32 window whose size is, plain loads otherwise (and for
    the presplit bf16 pair, which is added up on the way)."""
    aligned = win.data_ptr() % 16 == 0
    if layout == "grid":
        return "tensor" if aligned and win.shape[-1] % 4 == 0 else "loads"
    if layout == "presplit":
        return "loads"
    return "bulk" if aligned and n_win % 4 == 0 else "loads"


def _unsort(rows, idx_rows, p):
    """rows (B, k, s_pad) in frame order -> (B, k, p) in point order.
    The point ids are a permutation of the real rows, so one scatter by
    the point-id plane inverts the binning sort; filler rows carry id p
    and land in a sink column that is cut off."""
    bsz, k, s_pad = rows.shape
    ids = idx_rows.long()[:, None, :].expand(bsz, k, s_pad)
    out = rows.new_zeros((bsz, k, p + 1))
    out.scatter_(2, ids, rows)
    return out[:, :, :p]


# ---------------------------------------------------------------------------
# B8: the pullback's epilogue
# ---------------------------------------------------------------------------


# B8's blocks: 256 threads (eight warps of 32).  E1 takes 1,024 frame rows
# a block, rows t + 256 m of them a thread; the single tile's E2 takes
# chunks of 128 points, four consecutive points a lane; E2 on several
# tiles one point a thread
_EPI_THREADS = 256
_EPI_WARPS = _EPI_THREADS // 32
_EPI_ROWS = 4
_EPI_LANE_POINTS = 4
_EPI_CHUNK = 32 * _EPI_LANE_POINTS


def _epilogue_plain(grid_size, buf, idx_rows, points, rotation, out_weight,
                    point_weight, *, pw_uniform=False):
    """Plain version of `pullback_epilogue`, the CPU's path: the unsort
    (`_unsort`; a single tile keeps the order) and torch products, sums
    and einsums -> ``(d_points, d_r, d_t, d_ow, d_pw)`` in fp32."""
    n_out = len(grid_size)
    halo = not _single_tile(grid_size)
    p = points.shape[0]
    f32 = torch.float32
    # back to point order; on the uniform-weight path the weight-gradient
    # plane skips the unsort (its sums are order-free, and every
    # non-point row of the frame is exactly zero)
    if halo:
        n_uns = n_out if pw_uniform else n_out + 1
        per = _unsort(buf[:, :n_uns], idx_rows, p)
    else:
        per = buf[:, :, :p]
    du_pt = per[:, :n_out]                                # (B, n_out, P)

    scale = geometry.axis_values([g / 2 for g in grid_size], f32,
                                 buf.device)
    ow = out_weight.to(f32)
    pw = point_weight.to(f32)
    # scaled_i = du_i * (g_i/2) * ow * pw   (B, n_out, P)
    scaled = (du_pt * scale[None, :, None]
              * (ow[:, None, None] * pw[None, None, :]))

    d_t = torch.sum(scaled, dim=-1)                       # (B, n_out)
    d_r = torch.einsum("bns,si->bni", scaled, points.to(f32))
    d_points = torch.einsum("bns,bni->si", scaled, rotation.to(f32))
    if pw_uniform and halo:
        gw_sums = torch.sum(buf[:, n_out], dim=-1)        # (B,)
        d_ow = gw_sums * pw[0]
        d_pw = (torch.dot(gw_sums, ow) / p).repeat(p)
    else:
        gw_pt = per[:, n_out]                             # (B, P)
        d_ow = torch.einsum("bs,s->b", gw_pt, pw)
        d_pw = torch.einsum("bs,b->s", gw_pt, ow)
    return d_points, d_r, d_t, d_ow, d_pw



def _warp_tree(x):
    """The kernels' sum of the 32 lanes of a warp, over the last axis of
    `x` (..., 32): lane l adds lane l + 16, then + 8, + 4, + 2, + 1 (the
    pairs of `block_sum`'s shuffles and of `warp_scatter`'s halving in
    csrc/epilogue.cu) -> (...)."""
    for h in (16, 8, 4, 2, 1):
        x = x[..., :h] + x[..., h:2 * h]
    return x[..., 0]


def _tree(x):
    """The kernels' sum of the threads of a block, over the last axis of
    `x` (..., 256): `_warp_tree` within each warp of 32, then the eight
    warp sums the same way, + 4, + 2, + 1 (`block_sum` in
    csrc/epilogue.cu) -> (...)."""
    x = _warp_tree(x.reshape(x.shape[:-1] + (_EPI_WARPS, 32)))
    for h in (4, 2, 1):
        x = x[..., :h] + x[..., h:2 * h]
    return x[..., 0]


def _in_order(x):
    """``x[..., 0] + x[..., 1] + ...`` over the last axis, in that order."""
    acc = x[..., 0]
    for m in range(1, x.shape[-1]):
        acc = acc + x[..., m]
    return acc


def _block_sums(x, per_thread):
    """The kernels' blocked sum over the last axis of `x` (..., n) ->
    (..., ceil(n / (256 per_thread))): block q holds elements ``q * 256 *
    per_thread + m * 256 + t``; thread t adds its elements in order of m
    (+0 past n), then `_tree` adds the threads.  The final sums take each
    pose's partials so (one block), and the uniform d_pw's flat
    partials."""
    n = x.shape[-1]
    span = _EPI_THREADS * per_thread
    n_blk = -(-n // span)
    x = F.pad(x, (0, n_blk * span - n))
    x = x.reshape(x.shape[:-1] + (n_blk, per_thread, _EPI_THREADS))
    return _tree(_in_order(x.transpose(-1, -2)))


def _row_sums(x):
    """E1's sums over frame rows, over the last axis of `x` (..., s_pad) ->
    (..., ceil(s_pad / 1024)): block q holds rows ``q * 1024 + m * 256 +
    t``; thread t adds its rows in order of m (+0 past s_pad), each warp
    adds its lanes (`_warp_tree`) and the eight warp sums add in warp
    order."""
    n = x.shape[-1]
    span = _EPI_THREADS * _EPI_ROWS
    n_blk = -(-n // span)
    x = F.pad(x, (0, n_blk * span - n))
    x = x.reshape(x.shape[:-1] + (n_blk, _EPI_ROWS, _EPI_WARPS, 32))
    return _in_order(_warp_tree(_in_order(torch.movedim(x, -3, -1))))


def _pose_groups(bsz):
    """The single tile's pose groups: the largest power of two at most
    min(B, 8)."""
    return min(_EPI_WARPS, 1 << (bsz.bit_length() - 1))


def _chunk_sums(x, groups):
    """The single tile's sums over points of each pose's terms, over the last axis of
    `x` (..., P) -> (..., ceil(P / (128 * 8 / groups))): a chunk of 128
    points is a warp's, lane l adds its points ``4 l .. 4 l + 3`` in order
    (+0 past P) and `_warp_tree` adds the lanes; a block's ``8 / groups``
    chunks add in chunk order."""
    n = x.shape[-1]
    cpb = _EPI_WARPS // groups
    span = cpb * _EPI_CHUNK
    n_blk = -(-n // span)
    x = F.pad(x, (0, n_blk * span - n))
    x = x.reshape(x.shape[:-1] + (n_blk, cpb, 32, _EPI_LANE_POINTS))
    return _in_order(_warp_tree(_in_order(x)))


def _pose_group_sums(t, groups):
    """E2's sums over poses of a point's terms: `t` (B, m, ...) in order
    of (pose, m) -> (...); on several tiles E2 takes one group.  Pose group g takes poses ``[g B / groups, (g +
    1) B / groups)`` and adds its terms in that order; the groups' sums
    add in group order."""
    bsz = t.shape[0]
    sums = []
    for g in range(groups):
        lo, hi = g * bsz // groups, (g + 1) * bsz // groups
        sums.append(_in_order(torch.movedim(t[lo:hi].flatten(0, 1), 0, -1)))
    return _in_order(torch.stack(sums, dim=-1))


def _epilogue_fixed_plain(grid_size, buf, idx_rows, points, rotation,
                          out_weight, point_weight, *, pw_uniform=False):
    """The function of `pullback_epilogue` on the card bit for bit: the
    kernels' products and their order of every sum, in torch (and never
    the card's path).

    Per (pose b, point j) ``s_i = (du_i * (g_i / 2)) * (ow_b * pw_j)`` in
    fp32, as the torch form forms it; every later term is an fp64 product
    of fp32 values, which is exact, and every sum runs in fp64 and is
    rounded to fp32 once.  Each point's ``sum_i s_i * R[b, i, k]`` and
    ``gw * ow_b`` over the poses come from the rows in point order (B4's
    own on a single tile, rows ``[0, P)``; E1's copy on several, `_unsort`
    of them, which the kernel writes with plain stores: every point id is
    in each pose's frame once), in order of (pose, i): in pose groups on a
    single tile (`_pose_group_sums`), all poses as one on several.  Each pose's terms ``[s_i..., s_i * points[j, k]
    (i-major), gw term]`` over the points: on a single tile E2's
    (`_chunk_sums`, gw term ``gw * pw_j``), on several E1's in frame order
    (`_row_sums`, fillers +0; the gw term ``gw`` itself on the uniform
    path); the final sums (`_block_sums`) of their partials give d_t, d_r
    and d_ow (times pw_0 on the uniform path), and the uniform d_pw is the
    flat `_block_sums` of the gw partials times their pose's ow, over
    P."""
    n_out = len(grid_size)
    single = _single_tile(grid_size)
    uniform = pw_uniform and not single
    bsz = buf.shape[0]
    p, n_in = points.shape
    f32 = torch.float32
    dev = buf.device
    scale = geometry.axis_values([g / 2 for g in grid_size], f32, dev)
    ow = out_weight.to(f32)
    pw = point_weight.to(f32)
    rot, ow64, pw64 = rotation.to(f32).double(), ow.double(), pw.double()
    pts = points.to(f32).double()
    groups = _pose_groups(bsz) if single else 1

    def scaled(rows, opw):
        return torch.stack([(rows[:, i] * scale[i]) * opw
                            for i in range(n_out)], dim=1).double()

    # E2: each point's sums over the poses, from the rows in point order
    per = buf[:, :, :p] if single else _unsort(
        buf[:, :n_out if uniform else n_out + 1], idx_rows, p)
    s = scaled(per, ow[:, None] * pw[None, :])            # (B, n_out, P)
    d_points = _pose_group_sums(s[:, :, None, :] * rot[..., None], groups)
    d_points = d_points.T.float().contiguous()            # (P, n_in)
    if not uniform:
        d_pw = _pose_group_sums((per[:, n_out].double()
                                 * ow64[:, None])[:, None], groups).float()

    # each pose's sums over the points: the partials, then the final sums
    if single:
        ids, gw_term = slice(None), per[:, n_out].double() * pw64
        real = torch.ones((bsz, p), dtype=torch.bool, device=dev)
        rows, xs = per, pts.T
    else:
        ids = idx_rows.long()
        real = ids < p
        ids = torch.where(real, ids, 0)
        rows, xs = buf, pts[ids].movedim(-1, 0)           # (n_in, B, s_pad)
        s = scaled(rows, ow[:, None] * pw[ids])
        gw_term = rows[:, n_out].double()
        if not uniform:
            gw_term = gw_term * pw64[ids]
    terms = [s[:, i] for i in range(n_out)] + [
        s[:, i] * xs[k] for i in range(n_out) for k in range(n_in)]
    terms = torch.where(real[:, None], torch.stack(terms + [gw_term], 1),
                        0.0)
    partials = (_chunk_sums(terms, groups) if single
                else _row_sums(terms))                    # (B, kp, n_blk)
    sums = _block_sums(partials, -(-partials.shape[-1] // _EPI_THREADS))
    sums = sums[..., 0]                                   # (B, kp)
    d_t = sums[:, :n_out].float()
    d_r = sums[:, n_out:-1].reshape(bsz, n_out, n_in).float()
    if not uniform:
        return d_points, d_r, d_t, sums[:, -1].float(), d_pw
    d_ow = (sums[:, -1] * pw64[0]).float()
    flat = (partials[:, -1] * ow64[:, None]).reshape(-1)
    total = _block_sums(flat, -(-flat.shape[0] // _EPI_THREADS))
    d_pw = (total / torch.full_like(total, float(p))).float().repeat(p)
    return d_points, d_r, d_t, d_ow, d_pw


@annotate("dprast.b8.epilogue")
def pullback_epilogue(grid_size, buf, idx_rows, points, rotation,
                      out_weight, point_weight, *, pw_uniform=False):
    """B8: the pullback's epilogue from B4's rows `buf` (B, n_out + 1,
    s_pad) in frame order and the frame's float32 point-id plane
    `idx_rows` (B, s_pad), which may be a view at the frame's pose stride
    (on a single tile rows ``[0, P)`` are the points in order and it is
    not read) -> ``(d_points (P, n_in), d_r (B, n_out, n_in), d_t (B,
    n_out), d_ow (B,), d_pw (P,))`` in fp32.  `pw_uniform` is the
    pullback's: on a multi-tile grid d_ow and the sum of d_pw then come
    from the frame's gw sums.

    CPU tensors take the torch form `_epilogue_plain`, CUDA tensors two
    launches of `csrc/epilogue.cu`: on a single tile E2 on B4's rows
    (``"epilogue_tile"``) and the final sums of its partials
    (``"epilogue_poses"``); on several E1 in frame order, the unsort into a
    point-order copy and each pose's partials (``"epilogue_rows"``), then
    E2 on the copy with the final sums (``"epilogue_points"``).  Their
    function bit for bit is `_epilogue_fixed_plain`: every sum in a fixed
    order, so the result repeats, with no float atomic and nothing read
    back to the host.  On several tiles each pose's ids must name every
    point once (fillers carry P), as `_slot_order`'s frames do."""
    if buf.device.type == "cpu":
        return _epilogue_plain(grid_size, buf, idx_rows, points, rotation,
                               out_weight, point_weight,
                               pw_uniform=pw_uniform)
    f32 = torch.float32
    n_out = len(grid_size)
    single = _single_tile(grid_size)
    uniform = pw_uniform and not single
    pts, rot, ow = (x.to(f32).contiguous()
                    for x in (points, rotation, out_weight))
    # a broadcast weight (the uniform path's expanded scalar) is read at
    # stride 0, not copied
    pw = point_weight.to(f32)
    if pw.dim() != 1 or pw.stride(0) != 0:
        pw = pw.contiguous()
    _check_cuda("epilogue", buf, f32, pts, f32, rot, f32, ow, f32)
    bsz, n_rows_b, s_pad = buf.shape
    p = pts.shape[0]
    n_in = pts.shape[1] if pts.dim() == 2 else 0
    if n_out not in (2, 3) or n_rows_b != n_out + 1 or \
            n_in < 1 or s_pad < p or \
            rot.shape != (bsz, n_out, n_in) or ow.shape != (bsz,) or \
            pw.shape != (p,) or pw.device != buf.device or \
            idx_rows.shape != (bsz, s_pad) or idx_rows.dtype != f32 or \
            idx_rows.device != buf.device or idx_rows.stride(1) != 1:
        raise ValueError(
            f"epilogue: rows {tuple(buf.shape)}, ids "
            f"{tuple(idx_rows.shape)} {idx_rows.dtype}, points "
            f"{tuple(pts.shape)}, rotation {tuple(rot.shape)}, weights "
            f"{tuple(ow.shape)}, {tuple(pw.shape)} do not form a pullback "
            f"onto {tuple(grid_size)}")
    if not (bsz >= 1 and 1 <= p < 2 ** 24):
        raise ValueError(f"epilogue: B={bsz}, P={p} exceed the kernels' "
                         f"launch bounds")
    if single and (s_pad % 4 or buf.data_ptr() % 16):
        raise ValueError("epilogue: on a single tile the kernel reads four "
                         "rows at a time: s_pad and the rows must come in "
                         "16-byte units")
    dev = buf.device
    kp = n_out * (1 + n_in) + 1
    scale = [g / 2 for g in grid_size] + [0.0] * (3 - n_out)
    lib = _build.load()
    d_points = torch.empty((p, n_in), dtype=f32, device=dev)
    d_pw = torch.empty(p, dtype=f32, device=dev)
    d_t = torch.empty((bsz, n_out), dtype=f32, device=dev)
    d_r = torch.empty((bsz, n_out, n_in), dtype=f32, device=dev)
    d_ow = torch.empty(bsz, dtype=f32, device=dev)
    if single:
        groups = _pose_groups(bsz)
        n_blk = -(-p // (_EPI_WARPS // groups * _EPI_CHUNK))
        partials = torch.empty((bsz, kp, n_blk), dtype=torch.float64,
                               device=dev)
        _launch("epilogue_tile", dev, lib.dprast_epilogue_tile, _ptr(buf),
                buf.stride(0), s_pad, _ptr(pts), _ptr(rot), _ptr(ow),
                _ptr(pw), pw.stride(0), *scale, _ptr(partials), n_blk, kp,
                _ptr(d_points), _ptr(d_pw), bsz, n_out, n_in, p, groups)
        LAUNCHES["epilogue_tile"] += 1
        _launch("epilogue_poses", dev, lib.dprast_epilogue_poses,
                _ptr(partials), n_blk, kp, _ptr(ow), _ptr(pw), _ptr(d_t),
                _ptr(d_r), _ptr(d_ow), bsz, n_out, n_in, p)
        LAUNCHES["epilogue_poses"] += 1
        return d_points, d_r, d_t, d_ow, d_pw
    # the point-order copy: each point's [du..., gw] (no gw on the uniform
    # path) in one store of 2 floats or 4
    width = 2 if uniform and n_out == 2 else 4
    copy = torch.empty((bsz, p, width), dtype=f32, device=dev)
    n_blk = -(-s_pad // (_EPI_THREADS * _EPI_ROWS))
    partials = torch.empty((bsz, kp, n_blk), dtype=torch.float64, device=dev)
    _launch("epilogue_rows", dev, lib.dprast_epilogue_rows, _ptr(buf),
            _ptr(idx_rows), idx_rows.stride(0), _ptr(pts), _ptr(ow), _ptr(pw),
            pw.stride(0), *scale, _ptr(partials), kp, _ptr(copy), width,
            bsz, n_out, n_in, p, s_pad, int(uniform))
    LAUNCHES["epilogue_rows"] += 1
    _launch("epilogue_points", dev, lib.dprast_epilogue_points, _ptr(copy),
            width, _ptr(rot), _ptr(ow), _ptr(pw), pw.stride(0), *scale,
            _ptr(partials), n_blk, kp, _ptr(d_points), _ptr(d_pw), _ptr(d_t),
            _ptr(d_r), _ptr(d_ow), bsz, n_out, n_in, p, int(uniform))
    LAUNCHES["epilogue_points"] += 1
    return d_points, d_r, d_t, d_ow, d_pw


def _on_card(t):
    """Whether the tensor `t` lies on a CUDA device, where a wrapper
    launches its kernel."""
    return t.device.type == "cuda"


def _check_cuda(name, *pairs):
    """Every tensor on one CUDA device, of its dtype, contiguous."""
    tensors = pairs[0::2]
    dev = tensors[0].device
    for t, dtype in zip(tensors, pairs[1::2]):
        if not _on_card(t) or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device; "
                             f"got {t.device} beside {dev}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dtype} "
                             f"tensor; got {t.dtype}, contiguous="
                             f"{t.is_contiguous()}")


def _check_four_rows(name, chunk, lane):
    """B1 and B4 read the lane planes of four consecutive rows with one
    128-bit load per plane."""
    if chunk % 4 or lane.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads four rows at a time: "
                         f"chunk {chunk} must be a multiple of 4 and the "
                         f"lane planes 16-byte aligned")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _launch(name, device, entry, *args):
    """Call the kernel library's `entry` with `args` and `device`'s current
    stream as its last argument, with `device` current (a tensor on a card
    that is not the current one launches there; the device guard is only
    entered then), and raise on a CUDA error."""
    if device.index == torch.cuda.current_device():
        rc = entry(*args, _stream(device))
    else:
        with torch.cuda.device(device):
            rc = entry(*args, _stream(device))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({_build.error_string(rc)})")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _check_args(grid_size, p):
    if not supported(len(grid_size), grid_size, p):
        raise ValueError(f"binned backend does not support grid="
                         f"{grid_size} P={p}")
    if p == 0:
        raise ValueError("binned backend requires n_points > 0")


def _window(grid_size):
    """The shape of B1's windows: a tile's body + 1 halo voxel per axis, or
    the single tile itself."""
    ts = tile_shape_for(grid_size)
    return tuple(ts) if _single_tile(grid_size) else tuple(t + 1 for t in ts)


def _fwd_frame(grid_size, points, rotation, translation, point_weight,
               pw_uniform, coords=_keys_and_local):
    """The forward's frame and its lane planes, for B1's lane instance
    (the harness's standalone B1) and its twin.  Returns the arguments of
    `fwd_splat`, ``(slot_tile, lane, nt, win, chunk)``, and the frame's
    planes ``data`` (B, n_out + 1 | n_out + 2, s_pad): ``[coords..., (w,)
    point id]``.  `coords` is the coordinate stage.  The main path hands
    the frame to `fwd_splat_enc` and makes no lane planes."""
    n_out = len(grid_size)
    data, slot_tile, nt, chunk = _fwd_prep(grid_size, points, rotation,
                                           translation, point_weight,
                                           pw_uniform, coords)
    w_plane = None if pw_uniform else data[:, n_out]
    lane = _planes_fwd(data[:, :n_out], w_plane).contiguous()
    win = _window(grid_size)
    return (slot_tile.contiguous(), lane, nt, win, chunk), data


def _fwd_prep(grid_size, points, rotation, translation, point_weight,
              pw_uniform, coords=_keys_and_local):
    """The forward's coordinates and sorted frame -> ``(data, slot_tile,
    nt, chunk)``; `data` carries the point weight as a plane unless
    `pw_uniform`.  `coords` is the coordinate stage (B6 or its twin), see
    `_frame`; an empty tile keeps a slot."""
    weight = None if pw_uniform else point_weight
    return _frame(grid_size, points, rotation, translation, weight, True,
                  coords)


def _frame(grid_size, points, rotation, translation, weight,
           min_chunk_per_tile, coords):
    """The slot frame -> ``(data (B, n_planes, s_pad), slot_tile (B,
    n_slots + 1), nt, chunk)``.  ``data[b, :, r]`` is ``[enc..., (w,) point
    id]``: the encoded coordinates, the point weight where `weight` (P,)
    is given, and the point id.  ``min_chunk_per_tile`` gives every tile a
    slot (the forward's frame; the standalone pullback's gives an empty
    tile none).

    On the card, with B6 as the coordinate stage, kernels write the frame:
    B6 itself on a single tile (`direct_frame`: frame and slot table in
    its one launch), `frame_gather` after the binning sort on several.
    With another coordinate stage (`_keys_and_local_plain`), or on the
    CPU, the plain `_prep_direct` / `_prep_binned` write it from the
    stage's planes, to the same bits.

    Every frame carries the point-id plane, a single tile's too, though
    its pullback keeps the point order and never reads the ids: one
    layout for every frame, so `_residual_planes` and the standalone
    pullback read the same places, and the single tile's frame is
    `_prep_direct`'s bit for bit.  It costs B6 one 4-byte store a row."""
    ts = tile_shape_for(grid_size)
    p = points.shape[0]
    chunk = _default_chunk(grid_size, p)
    halo = not _single_tile(grid_size)
    kernels = coords is _keys_and_local and points.device.type != "cpu"
    if kernels and not halo:
        data, slot_tile = direct_frame(grid_size, ts, points, rotation,
                                       translation, weight, chunk)
        return data, slot_tile, n_tiles(grid_size, ts), chunk
    key, locs, nt = coords(grid_size, ts, points, rotation, translation,
                           want_key=halo)
    if kernels:
        perm, sorted_keys, slot_tile = _slot_order(key, nt, chunk,
                                                   min_chunk_per_tile, True)
        index = perm if sorted_keys is None else sorted_keys
        return frame_gather(index, locs, weight), slot_tile, nt, chunk
    planes, fills = _frame_planes(locs, weight)
    if halo:
        data, slot_tile = _prep_binned(key, planes, fills, nt, chunk,
                                       min_chunk_per_tile, pack_idx=True)
    else:
        data, slot_tile = _prep_direct(planes, fills, chunk)
    return data, slot_tile, nt, chunk


def raster_fwd(grid_size, points, rotation, translation, background,
               out_weight, point_weight, *, pw_uniform: bool = False,
               terms: int = 0):
    """Forward rasterisation on canonical batched args -> (B, *grid_size).

    ``pw_uniform=True`` promises that every `point_weight` entry equals
    ``point_weight[0]``: the weight plane is dropped and the scalar factor
    is applied after the fold.  ``terms=1`` is the ``binned_bf16`` fast
    mode (see the module docstring)."""
    out, _ = _fwd_impl(grid_size, points, rotation, translation, background,
                       out_weight, point_weight, pw_uniform=pw_uniform,
                       terms=terms)
    return out


def raster_fwd_res(grid_size, points, rotation, translation, background,
                   out_weight, point_weight, *, pw_uniform: bool = False,
                   terms: int = 0):
    """Forward + the binning residuals ``(data, slot_tile)``: the sorted
    frame carries the point-id plane, so the pullback of the fused
    autograd pair skips the coordinates and the sort."""
    return _fwd_impl(grid_size, points, rotation, translation, background,
                     out_weight, point_weight, pw_uniform=pw_uniform,
                     with_residuals=True, terms=terms)


def _fwd_impl(grid_size, points, rotation, translation, background,
              out_weight, point_weight, *, pw_uniform=False,
              with_residuals=False, terms=0, coords=_keys_and_local,
              splat=fwd_splat_enc, fold=band_fold):
    """`raster_fwd_res` with its three kernel stages as arguments, so a
    measurement can run the same forward through the plain versions
    (``coords=_keys_and_local_plain``, which also builds the frame the
    plain way, ``splat=_fwd_splat_enc_plain``, ``fold=_band_fold_plain``).
    `splat` takes ``(slot_tile, data, nt, win, chunk, terms=)`` as
    `fwd_splat_enc` does.  The `fold` stage serves multi-tile 2-D grids; a
    single tile and every 3-D grid take the plain `_fold` and epilogue, as
    in the JAX package.  Returns ``(out, residuals or None)``."""
    _check_args(grid_size, points.shape[0])
    data, slot_tile, nt, chunk = _fwd_prep(grid_size, points, rotation,
                                           translation, point_weight,
                                           pw_uniform, coords)
    ext = splat(slot_tile, data, nt, _window(grid_size), chunk, terms=terms)

    f32 = torch.float32
    ts = tile_shape_for(grid_size)
    n_out = len(grid_size)
    halo = not _single_tile(grid_size)
    # B2 or the plain fold, with the weights' scale and the background; a
    # single tile's window is its image: only the scale and the background
    # run there
    with annotate("dprast.b2.fold" if halo else "dprast.scale"):
        ow_eff = out_weight.to(f32)
        if pw_uniform:
            # all entries equal by the contract; fold the scalar in
            ow_eff = ow_eff * point_weight.to(f32)[0]
        bg_f = background.to(f32)
        if n_out == 2 and halo:
            out = fold(ext, grid_size, ts, ow_eff.contiguous(),
                       bg_f.contiguous())
        else:
            bcast = (-1,) + (1,) * n_out
            out = (_fold(ext, grid_size, ts, halo) * ow_eff.reshape(bcast)
                   + bg_f.reshape(bcast))
    dtype = torch.promote_types(points.dtype, torch.promote_types(
        rotation.dtype, translation.dtype))
    res = (data, slot_tile) if with_residuals else None
    return out.to(dtype), res


# ---------------------------------------------------------------------------
# pullback
# ---------------------------------------------------------------------------


def _bwd_frame(grid_size, points, rotation, translation,
               coords=_keys_and_local):
    """The standalone pullback's frame: ``(data (B, n_out + 1, s_pad)
    [coords..., point id], slot_tile, chunk)``.  Unlike the forward's, it
    gives an empty tile no slot.  It carries only the encoded coordinates
    (kernel input) and the point id (for the unsort); weights, points and
    rotations enter after the unsort, in point order.  `coords` is the
    coordinate stage (B6 or its twin), see `_frame`."""
    data, slot_tile, _, chunk = _frame(grid_size, points, rotation,
                                       translation, None, False, coords)
    return data, slot_tile, chunk


def raster_pullback(grid_size, points, rotation, translation, background,
                    out_weight, point_weight, ds_dout, *,
                    pw_uniform: bool = False, terms: int = 0,
                    asked=core.ALL_ASKED):
    """Analytic pullback -> `core.PullbackResult` (all six gradients;
    `d_bg`'s sum of the cotangent only where `asked` names it, as in
    `core.raster_pullback`: B8 writes the other five in one launch).

    ``pw_uniform=True`` promises that (a) every `point_weight` entry
    equals ``point_weight[0]`` and (b) the caller observes ``d_pw`` only
    through its sum (autograd's broadcast sums it; so does the API's
    scalar-weight rule).  On a multi-tile grid the weight-gradient plane
    then stays out of the unsort: ``d_ow`` and ``sum(d_pw)`` are per-pose
    sums over the sorted frame, and ``d_pw`` is spread as ``sum / p``.
    ``terms=1`` is the ``binned_bf16`` fast mode."""
    del background
    _check_args(grid_size, points.shape[0])
    data, slot_tile, chunk = _bwd_frame(grid_size, points, rotation,
                                        translation)
    return _pullback_from_frame(
        grid_size, data[:, :-1], data[:, -1], slot_tile, points, rotation,
        out_weight, point_weight, ds_dout, chunk=chunk,
        pw_uniform=pw_uniform, terms=terms, asked=asked)


def _residual_planes(residuals, pw_uniform):
    """The forward's residual frame -> ``(coord, idx_rows, slot_tile)``;
    the point-id plane is the last, after the weight plane, which the
    uniform path leaves out."""
    data, slot_tile = residuals
    n_out = data.shape[1] - (1 if pw_uniform else 2)
    return data[:, :n_out], data[:, -1], slot_tile


def raster_pullback_res(grid_size, residuals, args, ds_dout, *,
                        pw_uniform: bool = False, terms: int = 0,
                        asked=core.ALL_ASKED):
    """Pullback reusing the forward's frame (`raster_fwd_res`).
    ``pw_uniform`` must be the forward's: it fixes the frame's layout.
    `asked` as in `raster_pullback`."""
    points, rotation, _, _, out_weight, point_weight = args
    coord, idx_rows, slot_tile = _residual_planes(residuals, pw_uniform)
    return _pullback_from_frame(
        grid_size, coord, idx_rows, slot_tile, points, rotation, out_weight,
        point_weight, ds_dout, chunk=_default_chunk(grid_size,
                                                    points.shape[0]),
        pw_uniform=pw_uniform, terms=terms, asked=asked)


def _pullback_from_frame(grid_size, coord, idx_rows, slot_tile, points,
                         rotation, out_weight, point_weight, ds_dout, *,
                         chunk, pw_uniform=False, terms=0,
                         asked=core.ALL_ASKED, unfold=None,
                         gather=bwd_gather_enc, epilogue=pullback_epilogue):
    """The pullback from a frame, with its kernel stages as arguments (as
    in `_fwd_impl`).  `coord` are the frame's encoded planes, which the
    `gather` stage reads as `bwd_gather_enc` does, ``(slot_tile, coord,
    ts, win, chunk, terms=, layout=)`` (its plain version:
    `_bwd_gather_enc_plain`).  On a multi-tile 2-D grid the gather reads
    the cotangent itself (``layout="grid"``) and nothing is unfolded; an
    `unfold` stage (`band_unfold`, or its twin `_unfold`) writes the
    windows out first and the gather reads them in the natural layout, as
    a measurement may ask.  3-D grids take the plain `_unfold`, as in the
    JAX package.  The `epilogue` stage takes B4's rows and the id plane
    to five of the six gradients as `pullback_epilogue` does (its torch
    form: `_epilogue_plain`); the sixth, `d_bg`, runs only where `asked`
    names it."""
    n_out = len(grid_size)
    ts = tile_shape_for(grid_size)
    halo = not _single_tile(grid_size)
    bsz = rotation.shape[0]
    f32 = torch.float32
    g_cot = ds_dout.to(f32).contiguous()
    # the single tile's window is the cotangent itself
    layout = "natural"
    if not halo:
        g_in = g_cot
    elif n_out == 3:
        with annotate("dprast.unfold"):
            g_in = _unfold(g_cot, grid_size, ts)
    elif unfold is None:
        g_in, layout = g_cot, "grid"
    else:
        g_in = unfold(g_cot, grid_size, ts)
    buf = gather(slot_tile, coord, ts, g_in, chunk, terms=terms,
                 layout=layout)

    d_points, d_r, d_t, d_ow, d_pw = epilogue(
        grid_size, buf, idx_rows, points, rotation, out_weight, point_weight,
        pw_uniform=pw_uniform)
    d_bg = None
    if core.PullbackResult(*asked).background:
        with annotate("dprast.grad.background"):
            d_bg = torch.sum(g_cot.reshape(bsz, -1), dim=-1)
    core.note_unasked(asked, ("background",))

    dtype = torch.promote_types(torch.promote_types(points.dtype,
                                                    rotation.dtype),
                                ds_dout.dtype)
    return core.PullbackResult(*(None if d is None else d.to(dtype) for d in
                                 (d_points, d_r, d_t, d_bg, d_ow, d_pw)))


