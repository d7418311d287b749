// The slot table and the encoded rows of a frame, as B1 and B4 read them
// inside their kernels.
//
// A pose's table holds the tile of each of its `n_slots` slots in
// non-decreasing order and, as entry `n_slots`, the count of live slots;
// the slots at or past that count are dead and belong to no tile.
//
// A frame row holds one encoded coordinate per axis: the int32
// ``(r0_local + 2) << 23 | round(dl 2^23)`` stored as the bits of an f32
// (`_keys_and_local` of dprast_torch/ops/splat_binned.py), 0 where the
// point overlaps no voxel.

#pragma once

#include <cuda_runtime.h>

// The first index in [0, n) of the non-decreasing a[] whose entry is
// >= x (n if none), found by one whole warp: each step the 32 lanes probe
// evenly spaced entries of the open interval and a ballot keeps the one
// stretch between a "<" and a ">=".  Entries at or past `n_live` count as
// larger than any x, so a caller may pass the live count as it comes from
// memory, and the first probes are on their way before it has arrived.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a,
                                                int n, int x, int n_live) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + lane * step;
    const bool ge = i >= hi || a[i] >= x || i >= n_live;
    const unsigned m = __ballot_sync(0xffffffffu, ge);
    const int k = m ? __ffs(m) - 1 : 32;  // the first lane at or past x
    if (k == 0) {
      hi = lo;
    } else {
      const int top = lo + k * step;
      lo += (k - 1) * step + 1;
      hi = top < hi ? top : hi;
    }
  }
  return lo;
}

// the same over all of a[0 .. n)
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a,
                                                int n, int x) {
  return warp_lower_bound(a, n, x, n);
}

// fraction bits of an encoded coordinate
constexpr int kFix = 23;

// one axis of one frame row: the first stencil index and the delta in
// (0, 1] towards the next
struct Axis {
  int r0;
  float dl;
};

// An encoded coordinate (a frame entry) -> its axis, as `_decode_coord`
// gives it: ``dl = frac 2^-23``, exact since frac < 2^23; a zero fraction
// is ``dl = 1`` with the stencil one voxel down (the carry of a rounded
// dl = 1).  0 decodes to r0 = -3, outside every window.
__device__ __forceinline__ Axis decode(float bits) {
  const int enc = __float_as_int(bits);
  const int i_part = enc >> kFix;
  const int frac = enc - (i_part << kFix);
  const bool zero = frac == 0;
  return {i_part - 2 - (zero ? 1 : 0),
          zero ? 1.0f : __fmul_rn(__int2float_rn(frac), 0x1p-23f)};
}
