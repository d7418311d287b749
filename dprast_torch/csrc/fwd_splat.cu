// B1: the forward splat of the binned backend, 2-D and 3-D grids.
//
// Replaces the TPU kernel `_fwd_kernel` / `_fwd_kernel_live` of
// dprast/ops/splat_binned.py (launched by the `pl.pallas_call` in
// `_fwd_impl`), both its 2-D branch and its 3-D branch, at terms=2 (here
// fp32) and terms=1 (the `binned_bf16` fast mode); also its standalone
// launch `fwd_kernel` in benchmarks/profile_binned.py, whose counterpart
// is dprast_torch/benchmarks/profile_binned.py.  That kernel runs
// one program per (pose, slot), builds a hat-function row matrix (in 3-D
// the separable product of a z hat and a y hat over the flattened (z, y)
// window rows) and two exact x one-hots, and accumulates their bf16-split
// product on the MXU into the tile's window, which stays resident in VMEM
// across consecutive slots of one tile.  The TPU runs those programs in
// order, so its sums have one order and its forward gives the same bits on
// every run.
//
// What bounds it here.  Per frame row the kernel reads 8-12 bytes (2-D)
// or 12-16 bytes (3-D) of the encoded frame and adds four (2-D) or eight
// (3-D) values into a window in shared memory; per (pose, tile) it writes
// one window of up to 128x128 fp32 (64 KB).  Counted in bytes that is
// about 10 us at 128^3 x 10^6 points, 17 us at 128^2 x 64 x 10^5 and 118
// us at 1024^2 (where the 340 MB of windows are most of it), but only at
// 1024^2 do the bytes decide.  The kernel is a scatter, and its limit is
// the shared-memory atomic.  Hopper has no float add on shared memory:
// `atomicAdd(float*)` compiles to a compare-and-swap loop (LDS, FADD,
// ATOMS.CAST.SPIN, retried where another lane got in between), about 2.5
// adds per ns and SM; so does `atomicAdd(unsigned long long*)`
// (ATOMS.CAST.SPIN.64, about 1.5).  A 32-bit integer add is native
// (ATOMS.ADD), about 6.5 pairs of them per ns and SM with the carry below
// (all read on an H100 with `cuobjdump -sass` and a probe kernel).  In 3-D
// the work is also uneven: a tile is a 7 x 15 x 127 voxel slab, a
// 0.4-sigma cloud puts 96 of a pose's 3,977 slots into the busiest of 342
// tiles and one into most.  There is no matrix product: a multilinear
// splat is 2^n multiply-adds per row, so the tensor cores have nothing to
// do.
//
// What the design does about it.
// - The window holds 64-bit fixed point, so the sum of a (pose, tile) is
//   exact and does not depend on the order in which the atomics land, on
//   the cluster size or on the run: the forward gives the same bits every
//   time, as the TPU's does.  Each term `v` (an fp32 product, formed as
//   below) becomes q = round(v 2^k), an exact multiply by a power of two
//   and one rounding; the sum of the q is stored as round(sum) 2^-k, one
//   rounding per output element from an exact sum.
// - The scale 2^k belongs to the (pose, tile): k is the largest shift with
//   rows 2^k max|w| <= 2^62, where `rows` counts the rows of the tile's
//   live slots (rows < 2^bits) and max|w| is the largest finite |w| among
//   them (1 without a weight plane), clamped to [-126, 126] so that 2^k
//   and 2^-k are normal floats (`fixed_shift`; `splat_binned._fixed_shift`
//   is its plain version).  A pixel's value is at most the sum of |w| over
//   its tile's rows, since a row's hat weights are each at most 1, so no
//   entry can overflow.  Every rank of a cluster reads the weights of all
//   the tile's rows first and finds the same k, which therefore depends on
//   the tile's rows alone.  At 128^2 x 10^5 points with uniform weights
//   k = 45: a term is off by at most 2^-46.
// - The window is two 32-bit planes, the low words and the high words.  A
//   term adds its low word with a native 32-bit atomic, detects the carry
//   from the old value that atomic returns (old + lo < old), and adds
//   hi + carry into the high word where that is not 0.  The carries count
//   the low word's wraps exactly in any order, so the pair holds the
//   64-bit sum modulo 2^64.  The window is 128 KB (twice the fp32 one), so
//   one block of 1024 threads holds an SM.
// - A non-finite term (a NaN or infinite weight) gives the same sum in any
//   order: NaN if any term is NaN or both infinities occur, else that
//   infinity.  Such a term skips the window and marks its block; after the
//   window is stored, a marked block walks its rows again and adds its
//   non-finite terms into the output with fp32 global atomics, which
//   turns every pixel they touch into that value whatever the order.
// - Blocks run in no order, so the TPU's "first slot writes, later slots
//   add" becomes: the live slots [first, end) of a (pose, tile) are found
//   by the block itself, two warps searching the pose's sorted slot table
//   (`warp_lower_bound` of slots.cuh, shared with B4) while the others
//   zero the window, so nothing is launched before the kernel.  Dead slots
//   (at or past the live count in the table's last entry) belong to no
//   tile and add nothing.
// - A (pose, tile) is a thread-block cluster of C blocks, 1 to 8 (the
//   launch's cluster dimension; the wrapper picks C from the number of
//   (pose, tile) pairs, the card's SMs and how many clusters of each size
//   the card holds at once).  Rank r splats slots first + r, first + r +
//   C, ... into its own window.  After a cluster-wide barrier rank r adds
//   stripe r of the window over the ranks that held slots, in 64-bit
//   integers, reading the others' windows through distributed shared
//   memory, and stores the stripe with 128-bit stores; a second barrier
//   keeps every window alive until all have read it.  A rank without slots
//   returns at once (the barriers wait only for threads that have not
//   exited, and no rank reads its window), a lone rank with slots stores
//   its window without any barrier, and a tile without live slots is
//   stored as zeros.  So the output is written exactly once and needs no
//   zero-fill.  This is both the cure for few tiles (one tile and 64 poses
//   are 64 blocks on 132 SMs) and for uneven ones (the busiest 3-D slab's
//   slots spread over 4 blocks).  Every rank with slots pays for zeroing,
//   two barriers and the remote reads, so C stays 1 where the tiles alone
//   fill the card (1024^2: 5,184).  The grid is (C, tiles, poses): the
//   pose on z, and past 65,535 poses its high part on x beside the ranks
//   (poses.cuh), so any number of poses runs in the one launch with each
//   cluster's work as before.
// - Each thread takes four consecutive rows of a slot: one 128-bit load
//   per plane it reads, all issued before the first atomic, so the loads of a
//   step are in flight together instead of each waiting behind the
//   atomics of the row before.  A slot's rows are contiguous and the
//   chunk is a multiple of 4, so the loads are aligned.  The 16 (2-D) or
//   32 (3-D) targets of a step follow.
// - The 3-D window is the TPU's: rows are the flattened z * ny + y (ny =
//   16, nz = 8), columns x.  Targets are masked per axis, not by flat
//   row: a row with iy0 = -1 (a point just below the tile's y range)
//   would otherwise alias into row ny - 1 of the z plane below.
// - Weights are formed in plain fp32 as (hy * w) * cx in 2-D and
//   ((hz * hy) * w) * cx in 3-D, the order of the TPU kernel's products;
//   the TPU's 2-term bf16 split is only a way to get near-fp32 products
//   out of the MXU and has no counterpart here.
// - The `binned_bf16` fast mode (kTerms = 1, the TPU kernel's terms=1)
//   rounds each product to the nearest bf16 (ties to even) once, as the
//   TPU kernel rounds its value operand before the one-hot matmul, and
//   adds the widened value.  The TPU's hats relu(1 - |(iy0 - r) + dl|)
//   equal (1 - dl, dl) bit for bit (dl has 23 fraction bits), so the
//   rounded products are the TPU's.  __fmul_rn keeps the product from
//   fusing into anything before it is rounded.  On Hopper the mode saves
//   nothing: there is no matrix product whose work it halves.
// - Filler rows decode to -3 on every axis and every target outside the
//   window is dropped, as the TPU's one-hots never match them.
// - The frame's rows carry one encoded coordinate per axis (31-bit fixed
//   point, `_keys_and_local`), the weight where the frame has one, and the
//   point id.  The TPU kernel reads lane planes decoded outside it
//   (`_planes_fwd`), because a per-row decode on a (C, 1) value wastes 127
//   of 128 VPU lanes; a CUDA thread pays two shifts, a subtract, a compare
//   and an exact multiply by 2^-23 for it.  So the main path's instances
//   (kEnc) read the frame itself, 8-12 bytes a row in place of 16-28, and
//   decode in registers, to the bits `_decode_coord` gives.  The lane-plane
//   instances stay for the standalone launch of the harness.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "poses.cuh"
#include "slots.cuh"

namespace cg = cooperative_groups;

namespace {

// a block's window of up to 128 x 128 64-bit entries (128 KB) leaves no
// room for a second block on its SM
constexpr int kThreads = 1024;
// frame rows per thread and step, read with one load per lane plane (two
// read 7% faster at 1024^2, 13% and 5% slower at 128^2 and 128^3; one is
// slower at all three: `exp_b1_forms`)
constexpr int kRows = 4;
template <int N>
struct Pack;
template <>
struct Pack<1> {
  using T = float;
};
template <>
struct Pack<2> {
  using T = float2;
};
template <>
struct Pack<4> {
  using T = float4;
};
using RowPack = Pack<kRows>::T;
// the largest cluster every Hopper card schedules
constexpr int kMaxCluster = 8;
// a window entry's bound: rows 2^k max|w| <= 2^kFixedBits, a factor 2
// inside int64 (the bf16 rounding may lift a term 2^-8 above max|w|)
constexpr int kFixedBits = 62;
// |k| at most this, so that 2^k and 2^-k are normal floats
constexpr int kMaxShift = 126;

// one weight product as the splat adds it: fp32, or rounded to the
// nearest bf16 in the fast mode
template <int kTerms>
__device__ __forceinline__ float weight(float hw, float cx) {
  const float v = __fmul_rn(hw, cx);
  if constexpr (kTerms == 1)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

// The shift k of a (pose, tile) whose live slots hold `rows` rows and
// whose largest finite |w| has the bits `wmax` (`splat_binned.
// _fixed_shift`): rows < 2^rb and max|w| <= 2^e give rows max|w| 2^k <
// 2^kFixedBits for k = kFixedBits - rb - e.  e is 0 where max|w| is 0 or
// not finite.
__device__ __forceinline__ int fixed_shift(long long rows, unsigned wmax) {
  const int rb = 64 - __clzll(rows);
  const unsigned b = wmax & 0x7fffffffu;
  int e = 0;
  if (b != 0 && b < 0x7f800000u) {
    const int ex = (int)(b >> 23);
    const unsigned m = b & 0x7fffffu;
    // a subnormal m 2^-149 is at most 2^(ceil(log2 m) - 149)
    e = ex == 0 ? 32 - __clz(m - 1) - 149 : ex - 127 + (m != 0 ? 1 : 0);
  }
  return min(max(kFixedBits - rb - e, -kMaxShift), kMaxShift);
}

// 2^k as a float, for |k| <= kMaxShift
__device__ __forceinline__ float pow2(int k) {
  return __int_as_float((127 + k) << 23);
}

// q into entry i of the window of low words `lo` and high words `hi`:
// the low word by a native atomic, whose old value gives the carry (old +
// lo < old), then q's high word and the carry where their sum is not 0
__device__ __forceinline__ void add_fixed(unsigned* lo, int* hi, int i,
                                          long long q) {
  const unsigned l = (unsigned)q;
  const unsigned old = atomicAdd(&lo[i], l);
  const int h = (int)(q >> 32) + (old + l < old ? 1 : 0);
  if (h != 0) atomicAdd(&hi[i], h);
}

// the 64-bit entry of a window's low and high words
__device__ __forceinline__ unsigned long long entry(unsigned lo, int hi) {
  return ((unsigned long long)(unsigned)hi << 32) | lo;
}

// an exact sum as it is stored: one rounding, then 2^-k
__device__ __forceinline__ float stored(unsigned long long sum, float inv) {
  return __fmul_rn(__ll2float_rn((long long)sum), inv);
}

// kRows consecutive frame rows, one RowPack per plane.  The lane planes sit
// at fixed places whatever the frame: [iz0, dlz,] iy0, dly, w, dlx, ix0;
// the encoded frame (kEnc) is [enc_z,] enc_y, enc_x, w.  A frame without a
// weight plane leaves `w` unloaded.
template <int kNOut, bool kEnc>
struct Rows {
  static constexpr int kW = kEnc ? kNOut : 2 * kNOut - 2;
  RowPack v[kEnc ? kNOut + 1 : kW + 3];
  __device__ __forceinline__ void load(const float* __restrict__ lb,
                                       long long s_pad, long long row,
                                       bool with_w) {
    const float* p = lb + row;
#pragma unroll
    for (int i = 0; i < kW; ++i)
      v[i] = *reinterpret_cast<const RowPack*>(p + i * s_pad);
    p += kW * s_pad;
    if (with_w) {
      v[kW] = *reinterpret_cast<const RowPack*>(p);
      p += s_pad;
    }
    if constexpr (!kEnc) {
      v[kW + 1] = *reinterpret_cast<const RowPack*>(p);
      v[kW + 2] = *reinterpret_cast<const RowPack*>(p + s_pad);
    }
  }
  __device__ __forceinline__ float at(int plane, int j) const {
    if constexpr (kRows == 1) {
      return v[plane];
    } else if constexpr (kRows == 2) {
      return j == 0 ? v[plane].x : v[plane].y;
    } else {
      const float4& q = v[plane];
      return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
    }
  }
  // axis i (0 .. kNOut - 1, x last) of row j
  __device__ __forceinline__ Axis axis(int i, int j) const {
    if constexpr (kEnc)
      return decode(at(i, j));
    else if (i == kNOut - 1)
      return {(int)at(kW + 2, j), at(kW + 1, j)};
    else
      return {(int)at(2 * i, j), at(2 * i + 1, j)};
  }
  __device__ __forceinline__ float w(int j) const { return at(kW, j); }
};

// The 2^n targets of one frame row: each one's index in the window, its
// term, and whether it lies in the window.
template <int kNOut>
struct Targets {
  static constexpr int kN = kNOut == 3 ? 8 : 4;
  int idx[kN];
  float v[kN];
  bool ok[kN];
};

// The targets of row j of `rows` (in 3-D a window row is z * ny + y): a
// target is dropped where it leaves the window on any axis.
template <int kNOut, int kTerms, bool kEnc>
__device__ __forceinline__ void row_targets(const Rows<kNOut, kEnc>& rows,
                                            int j, bool with_w, int ny,
                                            int nz, int rows_e, int cols_e,
                                            Targets<kNOut>& out) {
  const Axis ay = rows.axis(kNOut - 2, j);
  const Axis ax = rows.axis(kNOut - 1, j);
  const int iy0 = ay.r0;
  const float dly = ay.dl;
  const float dlx = ax.dl;
  const int ix0 = ax.r0;
  const float cx[2] = {1.0f - dlx, dlx};
  const bool x_ok[2] = {ix0 >= 0 && ix0 < cols_e,
                        ix0 + 1 >= 0 && ix0 + 1 < cols_e};
  // the (z, y) stencil rows in the order (0,0), (0,1), (1,0), (1,1); 2-D
  // has only the two y rows
  constexpr int kStencil = kNOut == 3 ? 4 : 2;
  float h[kStencil];
  int r[kStencil];
  bool ok[kStencil];
  if constexpr (kNOut == 3) {
    const Axis az = rows.axis(0, j);
    const int iz0 = az.r0;
    const float dlz = az.dl;
    const float hz[2] = {1.0f - dlz, dlz};
    const float hy[2] = {1.0f - dly, dly};
#pragma unroll
    for (int sz = 0; sz < 2; ++sz) {
#pragma unroll
      for (int sy = 0; sy < 2; ++sy) {
        const int z = iz0 + sz;
        const int y = iy0 + sy;
        h[2 * sz + sy] = __fmul_rn(hz[sz], hy[sy]);
        r[2 * sz + sy] = z * ny + y;
        ok[2 * sz + sy] = z >= 0 && z < nz && y >= 0 && y < ny;
      }
    }
  } else {
    h[0] = 1.0f - dly;
    h[1] = dly;
#pragma unroll
    for (int sy = 0; sy < 2; ++sy) {
      r[sy] = iy0 + sy;
      ok[sy] = iy0 + sy >= 0 && iy0 + sy < rows_e;
    }
  }
  const float w = with_w ? rows.w(j) : 1.0f;
#pragma unroll
  for (int i = 0; i < kStencil; ++i) {
    const float hw = with_w ? __fmul_rn(h[i], w) : h[i];
#pragma unroll
    for (int sx = 0; sx < 2; ++sx) {
      out.idx[2 * i + sx] = r[i] * cols_e + ix0 + sx;
      out.v[2 * i + sx] = weight<kTerms>(hw, cx[sx]);
      out.ok[2 * i + sx] = ok[i] && x_ok[sx];
    }
  }
}

// The helpers below walk the units [lo, hi) of a window with the whole
// block; a unit is a T, one word or (where the window's size is a
// multiple of 4) four.

template <typename T, typename W>
__device__ __forceinline__ void zero_units(W* dst, int lo, int hi) {
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
    reinterpret_cast<T*>(dst)[i] = T();
}

// Entries [4 lo, 4 hi) (kVec) or [lo, hi) of the windows that
// `window(q)` gives for the ranks q = 0 .. n - 1 (low words, then n_win
// high words), added in 64-bit integers and stored as floats.
template <bool kVec, typename Window>
__device__ __forceinline__ void store_sums(Window window, int n, int n_win,
                                           float* out, int lo, int hi,
                                           float inv) {
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    if constexpr (kVec) {
      unsigned long long s[4] = {0, 0, 0, 0};
      for (int q = 0; q < n; ++q) {
        const unsigned* w = window(q);
        const uint4 l = reinterpret_cast<const uint4*>(w)[i];
        const int4 h = reinterpret_cast<const int4*>(w + n_win)[i];
        s[0] += entry(l.x, h.x);
        s[1] += entry(l.y, h.y);
        s[2] += entry(l.z, h.z);
        s[3] += entry(l.w, h.w);
      }
      // most entries of a sparse tile's window are 0: no conversion there
      float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if ((s[0] | s[1] | s[2] | s[3]) != 0)
        o = make_float4(stored(s[0], inv), stored(s[1], inv),
                        stored(s[2], inv), stored(s[3], inv));
      reinterpret_cast<float4*>(out)[i] = o;
    } else {
      unsigned long long s = 0;
      for (int q = 0; q < n; ++q) {
        const unsigned* w = window(q);
        s += entry(w[i], reinterpret_cast<const int*>(w + n_win)[i]);
      }
      out[i] = stored(s, inv);
    }
  }
}

template <int kNOut, int kTerms, bool kEnc>
__global__ void __launch_bounds__(kThreads, 1)
fwd_splat_kernel(const float* __restrict__ lane,  // (B, L, s_pad) planes
                 const int* __restrict__ slot_tile,  // (B, n_slots + 1)
                 float* __restrict__ ext,  // (B, nt, rows_e, cols_e)
                 int bsz, int nt, int n_slots, long long pose_stride,
                 bool with_w, long long s_pad, int chunk, int ny, int rows_e,
                 int cols_e, int n_ranks) {
  // the window's low words [0, n_win), its high words [n_win, 2 n_win)
  extern __shared__ __align__(16) unsigned win[];
  __shared__ int range[2];
  __shared__ unsigned wmax;
  // the cluster is (n_ranks, 1, 1); the grid's x holds the ranks of each
  // high slab of poses (one slab up to 65,535 poses), z the pose's low part
  const int high =
      gridDim.x == (unsigned)n_ranks ? 0 : (int)blockIdx.x / n_ranks;
  const int rank = (int)blockIdx.x - high * n_ranks;
  const int t = blockIdx.y;
  const int b = pose_of(blockIdx.z, high);
  if (b >= bsz) return;  // past the last pose: the whole cluster
  const int n_win = rows_e * cols_e;
  unsigned* lo = win;
  int* hi = reinterpret_cast<int*>(win + n_win);
  // 128-bit zeroing, merging and storing where the window allows it
  const bool vec = (n_win & 3) == 0;

  // Two warps find the tile's live slots [first, end); the live count and
  // the first probes are loaded together.  Meanwhile the window is zeroed,
  // in vain where the rank turns out to hold no slot.
  const int* st = slot_tile + (long long)b * (n_slots + 1);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int r = warp_lower_bound(st, n_slots, t + warp, st[n_slots]);
    if ((threadIdx.x & 31) == 0) range[warp] = r;
  }
  if (threadIdx.x == 0) wmax = 0;
  const int n_units = vec ? n_win / 4 : n_win;
  if (vec)
    zero_units<uint4>(win, 0, 2 * n_units);
  else
    zero_units<unsigned>(win, 0, 2 * n_units);
  __syncthreads();
  const int first = range[0];
  const int end = range[1];
  // slots s0, s0 + n_ranks, ... < end belong to this rank
  const int s0 = first + rank;
  const int my_slots = s0 < end ? (end - s0 + n_ranks - 1) / n_ranks : 0;
  // ranks 0 .. n_active - 1 hold slots
  const int n_active = min(n_ranks, end - first);
  // groups of kRows rows: group q lies in this rank's slot q / per_slot
  const int per_slot = chunk / kRows;
  const int n_groups = my_slots * per_slot;
  auto row_of = [&](int q) {
    const int slot = q / per_slot;
    return ((long long)s0 + (long long)slot * n_ranks) * chunk +
           (q - slot * per_slot) * kRows;
  };
  const float* lb = lane + (long long)b * pose_stride;
  const int nz = rows_e / ny;

  float* out = ext + ((long long)b * nt + t) * n_win;
  if (n_active <= 0) {
    // a tile without live slots: every rank stores its stripe of zeros
    const int u0 = (int)((long long)rank * n_units / n_ranks);
    const int u1 = (int)((long long)(rank + 1) * n_units / n_ranks);
    if (vec)
      zero_units<float4>(out, u0, u1);
    else
      zero_units<float>(out, u0, u1);
    return;
  }
  // A rank without slots leaves at once: it holds no window, no rank reads
  // it, and the cluster's barriers wait only for threads that have not
  // exited.
  if (rank >= n_active) return;

  // The tile's scale: every rank reads the weights of all the tile's rows
  // (their finite |w| compare as their bits), so all find the same k.
  const long long rows_lo = (long long)first * chunk;
  const long long rows_hi = (long long)end * chunk;
  if (with_w) {
    const float* wp = lb + Rows<kNOut, kEnc>::kW * s_pad;
    unsigned m = 0;
    for (long long i = rows_lo + 4 * threadIdx.x; i < rows_hi;
         i += 4 * blockDim.x) {
      const float4 w4 = *reinterpret_cast<const float4*>(wp + i);
      const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned a = __float_as_uint(ws[j]) & 0x7fffffffu;
        if (a < 0x7f800000u) m = max(m, a);
      }
    }
    m = __reduce_max_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0) atomicMax(&wmax, m);
    __syncthreads();
  }
  const int k = fixed_shift(rows_hi - rows_lo,
                            with_w ? wmax : __float_as_uint(1.0f));
  const float scale = pow2(k);

  Rows<kNOut, kEnc> rows;
  bool nonfinite = false;
  int q = threadIdx.x;
  if (q < n_groups) rows.load(lb, s_pad, row_of(q), with_w);

  while (q < n_groups) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      Targets<kNOut> tg;
      row_targets<kNOut, kTerms>(rows, j, with_w, ny, nz, rows_e, cols_e,
                                 tg);
#pragma unroll
      for (int i = 0; i < Targets<kNOut>::kN; ++i) {
        if (!tg.ok[i]) continue;
        if (isfinite(tg.v[i]))
          add_fixed(lo, hi, tg.idx[i],
                    __float2ll_rn(__fmul_rn(tg.v[i], scale)));
        else
          nonfinite = true;
      }
    }
    q += blockDim.x;
    if (q < n_groups) rows.load(lb, s_pad, row_of(q), with_w);
  }

  const float inv = pow2(-k);
  bool marked;
  if (n_active == 1) {
    // a lone rank stores its window: no cluster barrier, no remote read
    marked = __syncthreads_or(nonfinite);
    auto own = [&](int) -> const unsigned* { return win; };
    if (vec)
      store_sums<true>(own, 1, n_win, out, 0, n_units, inv);
    else
      store_sums<false>(own, 1, n_win, out, 0, n_units, inv);
    if (marked) __syncthreads();
  } else {
    const cg::cluster_group cluster = cg::this_cluster();
    marked = __syncthreads_or(nonfinite);
    // every window is complete before any is read
    cluster.sync();
    const int u0 = (int)((long long)rank * n_units / n_active);
    const int u1 = (int)((long long)(rank + 1) * n_units / n_active);
    auto remote = [&](int r) -> const unsigned* {
      return cluster.map_shared_rank(win, r);
    };
    if (vec)
      store_sums<true>(remote, n_active, n_win, out, u0, u1, inv);
    else
      store_sums<false>(remote, n_active, n_win, out, u0, u1, inv);
    // no block exits, and frees its window, while another still reads it;
    // and every stripe is stored before a marked rank adds to it
    cluster.sync();
  }
  if (!marked) return;
  // The rare path: this rank's non-finite terms, added into the stored
  // output, where each makes its pixel NaN or infinite whatever the order.
  for (q = threadIdx.x; q < n_groups; q += blockDim.x) {
    rows.load(lb, s_pad, row_of(q), with_w);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      Targets<kNOut> tg;
      row_targets<kNOut, kTerms>(rows, j, with_w, ny, nz, rows_e, cols_e,
                                 tg);
#pragma unroll
      for (int i = 0; i < Targets<kNOut>::kN; ++i)
        if (tg.ok[i] && !isfinite(tg.v[i]))
          atomicAdd(&out[tg.idx[i]], tg.v[i]);
    }
  }
}

template <int kNOut, int kTerms, bool kEnc>
int launch(const void* lane, const void* slot_tile, void* ext, int bsz,
           int nt, int n_slots, long long pose_stride, bool with_w,
           long long s_pad, int chunk, int ny, int rows_e, int cols_e,
           int n_ranks, int* clusters_out, void* stream) {
  if (n_ranks < 1 || n_ranks > kMaxCluster) return (int)cudaErrorInvalidValue;
  // the window's low and high words
  const int smem = 2 * rows_e * cols_e * (int)sizeof(unsigned);
  auto* kernel = fwd_splat_kernel<kNOut, kTerms, kEnc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_ranks * pose_high(bsz), nt, pose_low(bsz));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n_ranks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  // the occupancy query: how many such clusters the current card holds at
  // once (the wrapper asks once per window size and picks `n_ranks` from
  // the answers); nothing is launched
  if (clusters_out != nullptr)
    return (int)cudaOccupancyMaxActiveClusters(clusters_out, kernel, &config);
  err = cudaLaunchKernelEx(&config, kernel, (const float*)lane,
                           (const int*)slot_tile, (float*)ext, bsz, nt,
                           n_slots, pose_stride, with_w, s_pad, chunk, ny,
                           rows_e, cols_e, n_ranks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// `lane` holds `n_planes` planes of `s_pad` rows per pose: the lane planes
// [iz0, dlz,] iy0, dly, (w,) dlx, ix0 (2 n_out or 2 n_out + 1 of them), or
// with `encoded` the frame [enc..., (w,) id] (n_out + 1 or n_out + 2), of
// which the kernel reads the encoded planes and the weight.  `slot_tile`
// is the frame's slot table (B, n_slots + 1), whose last entry per pose
// counts the live slots.  `ny` is the window's y extent: the number of its
// rows in 2-D, the rows of one z plane in 3-D (rows_e / ny z planes).
// `n_ranks` is the cluster size, the blocks that share one (pose, tile), 1
// to 8.  `terms` is 0 (fp32) or 1 (the bf16 fast mode).  `chunk` is a
// multiple of 4 and `lane` is 16-byte aligned.  With `clusters_out` not
// null nothing is launched: the entry writes there how many clusters of
// this launch the card holds at once.
extern "C" int dprast_fwd_splat(const void* lane, const void* slot_tile,
                                void* ext, int bsz, int nt, int n_out,
                                int n_slots, int n_planes, long long s_pad,
                                int chunk, int ny, int rows_e, int cols_e,
                                int n_ranks, int terms, int encoded,
                                int* clusters_out, void* stream) {
  const int bare = encoded ? n_out + 1 : 2 * n_out;
  if (n_planes != bare && n_planes != bare + 1)
    return (int)cudaErrorInvalidValue;
  const bool with_w = n_planes == bare + 1;
  const long long pose_stride = (long long)n_planes * s_pad;
#define DPRAST_LAUNCH(N, T, E)                                              \
  if (n_out == N && terms == T && (encoded != 0) == E)                      \
    return launch<N, T, E>(lane, slot_tile, ext, bsz, nt, n_slots,          \
                           pose_stride, with_w, s_pad, chunk, ny, rows_e,   \
                           cols_e, n_ranks, clusters_out, stream);
  DPRAST_LAUNCH(2, 0, false)
  DPRAST_LAUNCH(3, 0, false)
  DPRAST_LAUNCH(2, 1, false)
  DPRAST_LAUNCH(3, 1, false)
  DPRAST_LAUNCH(2, 0, true)
  DPRAST_LAUNCH(3, 0, true)
  DPRAST_LAUNCH(2, 1, true)
  DPRAST_LAUNCH(3, 1, true)
#undef DPRAST_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dprast_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
