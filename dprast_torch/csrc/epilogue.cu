// B8: the pullback's epilogue of the binned backend, 2-D and 3-D grids.
//
// Replaces no Pallas kernel: in dprast/ops/splat_binned.py everything after
// B4's `pallas_call` in `raster_pullback` (:1355-1423) is plain XLA under
// `jit` -- the unsort of B4's rows by the point-id plane, the products
// `scaled = du * (g/2) * (ow * pw)` and the reductions and einsums that
// make the gradients of the translation, rotation, points and weights.
// XLA fuses the products into the reductions.  Eager PyTorch runs them as
// eleven to nineteen launches (a scatter, elementwise products, sums,
// gemms and gemvs: `splat_binned._epilogue_plain`); these kernels are that
// fusion, two launches on every grid.
//
// What it computes.  B4's rows `buf` (B, n_out + 1, s_pad) hold per frame
// row [du_0 .. du_{n_out-1}, gw].  On a multi-tile grid the frame is
// sorted by tile and the float32 id plane names each row's point: every
// point id in [0, P) exactly once per pose (`_slot_order` sorts exactly
// s_pad rows: the no-overlap points land in dead slots, whose rows B4
// zeroes) and filler rows carry id P.  On a single tile rows [0, P) are
// the points in order and no id is read.  With
//   s_i[b, j] = (du_i * (g_i / 2)) * (ow_b * pw_j)      (rounded so)
// the gradients are
//   d_t[b, i]       = sum_j s_i
//   d_r[b, i, k]    = sum_j s_i * points[j, k]
//   d_points[j, k]  = sum_b sum_i s_i * R[b, i, k]
//   d_ow[b]         = sum_j gw * pw_j,   d_pw[j] = sum_b gw * ow_b,
// and on the uniform-weight path of a multi-tile grid (`uniform`)
//   gw_sums[b] = sum_rows gw,  d_ow[b] = gw_sums[b] * pw_0,
//   d_pw[j]    = (sum_b sum_blocks gw_partial * ow_b) / P for every j.
//
// The order of every sum is fixed (no float atomics), so the result
// repeats bit for bit; `splat_binned._epilogue_fixed_plain` is its
// function bit for bit.  `s_i` is rounded in fp32 exactly as above
// (`__fmul_rn`: no FMA contraction); every term of a sum after it is an
// fp64 product of fp32 values, which is exact, so a product and the add
// after it are one `__fma_rn`, and a sum starts from -0 (x + -0 is x for
// every x); the sums run in fp64 with one rounding to fp32 at the end, so
// the gradients are within a rounding of the exact sums of the fp32 `s_i`
// terms.  Products of an fp64 sum and an fp32 weight (the final sums) are
// not exact and stay `__dmul_rn` then `__dadd_rn`.
//
// The kernels, two launches on every grid.  Each point's sums over the
// poses run point-major in E2, each pose's sums over the points where the
// pose's rows are read in order:
// - One tile: `epilogue_tile_kernel` (E2 on B4's rows, read once).  Blocks
//   of eight warps; with G the largest power of two <= min(B, 8), warp w
//   takes pose group g = w % G (poses [g B / G, (g + 1) B / G), in order)
//   and chunk c = w / G of the block's 8 / G chunks of 128 points, lane l
//   the chunk's points 4 l .. 4 l + 3.  A lane stages its rows of a pose,
//   one 16-byte piece per plane, in a ring of kStages poses in shared
//   memory with asynchronous copies (cp.async) a pose ahead.  Per (pose,
//   point) it forms s_i and adds sum_i s_i R[b, i, k] and gw ow_b to the
//   point's sums (R as fp64 in shared memory, converted once a pose), and
//   per pose the lane adds its four points' terms [s_i, s_i points[j, k]
//   (i-major), gw pw_j] in point order and the warp adds its lanes by
//   recursive halving (`warp_scatter`: lane l with l ^ 16, then ^ 8, ..
//   ^ 1; each lane ends with the sum of one term): one partial per (pose,
//   chunk), the 8 / G chunks of a block added in chunk order (G < 8).  The
//   pose groups' point sums add in group order through the ring.
//   `epilogue_poses_kernel` then sums each pose's partials (`poses_body`).
// - Several tiles: `epilogue_rows_kernel` (E1) takes the frame in order,
//   one block per (1,024 rows, pose) (the pose on y, and past 65,535 poses
//   its high part on z: poses.cuh), thread t rows t + 256 m (m < 4),
//   coalesced and streamed (`__ldcs`); all of a thread's loads (ids, du
//   planes, gw, then the gathers of points[id] and pw[id]) are issued
//   before any arithmetic, with fillers (id P) clamped to point 0 and
//   their terms masked to +0.  It stores each real row's [du..., gw] (no
//   gw on the uniform path) at point `id` of the point-order copy (B, P,
//   W) in one store of W = 2 floats (2-D, uniform) or 4: the unsort.  Its
//   terms [s_i, s_i points[j, k], gw term] (`gw pw_j`, or `gw` on the
//   uniform path) add per thread in row order, per warp by `warp_scatter`
//   and over the eight warps in order: one partial per (pose, block).
//   `epilogue_points_kernel` (E2 on the copy: one point a thread, all
//   poses in order, kAhead poses' loads issued before their arithmetic, R
//   and ow staged in shared memory) sums the points; its first blocks sum
//   each pose's E1 partials (`poses_body`) and, on the uniform path, the
//   d_pw every point gets.
// The input axes are unrolled where the main path has them (n_in 2 and 3
// at n_out 2, 3 at n_out 3); every other n_in takes the instance with
// N_IN = 0, which runs one input axis a pass, in the same order of sums.
//
// What bounds it here.  Bytes: B4's rows once (one tile: E2; several: E1,
// with the ids), the point-order copy written by E1 and read by E2, the
// cloud and weights once, the gradients once; the partials are a few per
// cent of that.  On several tiles E1's stores set its pace: they land at
// random points of one pose (the ids of a tile's run ascend, a few hundred
// points apart), one store of 8 or 16 bytes a row within one 32-byte
// sector, and E1 as the unsort alone takes as long as with its gathers and
// sums (`benchmarks/exp_b8_forms.py`).  On one tile E2 issues about 20 fp64
// multiply-adds, four fp32 -> fp64 conversions and a share of the warp's
// halving a (pose, point), with two blocks of eight warps an SM (128
// registers): a deeper ring of copies makes it slower, not faster.
//
// Block counts come from shapes alone and nothing is read back to the
// host.  No buffer needs zeroing: every entry of the copy (each id once a
// pose) and of the partials is written before it is read, in stream order.

#include <cuda_runtime.h>

#include <cstdint>

#include "poses.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// E1: frame rows a thread takes, t + 256 m
constexpr int kRowsPerThread = 4;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;
// E2: points a lane takes, and a warp's chunk of them
constexpr int kLanePoints = 4;
constexpr int kChunk = 32 * kLanePoints;
// E2 with fewer than eight pose groups (B < 8): poses a group has at most
constexpr int kGroupPoses = 2;
// the single tile's E2: poses a warp's ring of asynchronous copies holds,
// and the 16-byte pieces of one pose a lane stages (B4's n_out + 1 planes)
constexpr int kStages = 2;
constexpr int kSlots = 4;
constexpr int kRingBytes = kWarps * kStages * kSlots * 32 * 16;
// E2 on several tiles: poses whose loads a thread issues before their
// arithmetic, and poses whose rotations a block stages at a time
constexpr int kAhead = 2;
constexpr int kPoseChunk = 64;
// the final sums: partials a block reduces, and the partials a thread
// loads before it adds them; points a uniform d_pw fill block writes
constexpr int kSumsPerBlock = 4;
constexpr int kBatch = 2;
constexpr int kFillPoints = kThreads * 16;

// g / 2 of each output axis, rounded to fp32 by the caller
struct Scale {
  float v[3];
};

// Input axes one pass takes: all of them where N_IN is known, else one.
template <int N_IN>
constexpr int kAxesPerPass = N_IN > 0 ? N_IN : 1;

// The block's sum of each thread's v[c] (valid in thread 0): within each
// warp lane l adds lane l + 16, then + 8, + 4, + 2, + 1; then lane w < 8
// of warp 0 holds warp w's sum and adds the same way with + 4, + 2, + 1.
// `_tree` in splat_binned.py is this order.
template <int K>
__device__ __forceinline__ void block_sum(double (&v)[K],
                                          double (*ws)[kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < K; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[c] = __dadd_rn(v[c], __shfl_down_sync(0xffffffffu, v[c], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < K; ++c) ws[c][warp] = v[c];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      v[c] = lane < kWarps ? ws[c][lane] : 0.0;
#pragma unroll
      for (int off = kWarps / 2; off > 0; off >>= 1)
        v[c] = __dadd_rn(v[c], __shfl_down_sync(0xffffffffu, v[c], off));
    }
  }
}

// The warp's sums of N values by recursive halving: at offset OFF a lane
// keeps half of its values (the lower half where its OFF bit is clear),
// adds its partner's (lane ^ OFF) copy of them and sends the other half;
// once one value is left the remaining offsets add it across.  After the
// offsets 16 .. 1 each lane holds the sum of value `scatter_index` over
// the 32 lanes, at a fraction of the shuffles of one tree per value.
// Every sum pairs lanes l and l ^ 16 first, then ^ 8, .. ^ 1:
// `_warp_tree` in splat_binned.py.
template <int N, int OFF>
__device__ __forceinline__ double warp_scatter(const double (&v)[N],
                                               int lane) {
  if constexpr (OFF == 0) {
    return v[0];
  } else if constexpr (N == 1) {
    const double w[1] = {
        __dadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], OFF))};
    return warp_scatter<1, OFF / 2>(w, lane);
  } else {
    constexpr int H = (N + 1) / 2;
    double p[2 * H];
#pragma unroll
    for (int m = 0; m < 2 * H; ++m) p[m] = m < N ? v[m] : 0.0;
    const bool up = (lane & OFF) != 0;
    double w[H];
#pragma unroll
    for (int m = 0; m < H; ++m)
      w[m] = __dadd_rn(up ? p[H + m] : p[m],
                       __shfl_xor_sync(0xffffffffu, up ? p[m] : p[H + m],
                                       OFF));
    return warp_scatter<H, OFF / 2>(w, lane);
  }
}

// The value whose sum `warp_scatter` leaves in `lane`, or N where the lane
// ends with a pad of some level's odd count.
template <int N, int OFF>
__device__ __forceinline__ int scatter_index(int lane) {
  if constexpr (OFF == 0 || N == 1) {
    return 0;
  } else {
    constexpr int H = (N + 1) / 2;
    const int sub = scatter_index<H, OFF / 2>(lane);
    const int i = ((lane & OFF) ? H : 0) + sub;
    return sub < H && i < N ? i : N;
  }
}

// One 16-byte asynchronous copy from device to shared memory; `bytes` 0
// fills the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void copy_async16(void* smem, const void* gmem,
                                             int bytes) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups of copies are in flight.
template <int N>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The final sums' order: thread t adds elements t, t + 256, ... (m <
// ceil(n / 256)) of each of K rows of `at(c, q)` in that order, +0 past n,
// loading kBatch elements a row before it adds them.
template <int K, typename At>
__device__ __forceinline__ void strided_sums(int n, At at,
                                             double (&acc)[K]) {
  const int per = (n + kThreads - 1) / kThreads;
  for (int m0 = 0; m0 < per; m0 += kBatch) {
    double v[kBatch][K];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = (m0 + u) * kThreads + threadIdx.x;
#pragma unroll
      for (int c = 0; c < K; ++c) v[u][c] = q < n ? at(c, q) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (m0 + u < per) {
#pragma unroll
        for (int c = 0; c < K; ++c)
          acc[c] = m0 + u == 0 ? v[u][c] : __dadd_rn(acc[c], v[u][c]);
      }
    }
  }
}

// The final sums, block `blk` of them: blocks (b, vc), b < B, vc <
// ceil(kp / 4), each sum entries [4 vc, 4 vc + 4) of pose b's partials
// (B, kp, n_blk) over its blocks; entry e is d_t[b, e], then d_r[b] flat
// (i-major), then the gw term: d_ow[b], times pw_0 on the uniform path.
// On the uniform path the next ceil(P / 4096) blocks each sum every gw
// partial times its pose's ow, flat in (pose, block) order, over P, and
// write it to their 4,096 points of d_pw.
__device__ __forceinline__ void poses_body(
    const double* __restrict__ partials, int n_blk, int kp, bool uniform,
    const float* __restrict__ ow, const float* __restrict__ pw,
    float* __restrict__ d_t, float* __restrict__ d_r,
    float* __restrict__ d_ow, float* __restrict__ d_pw, int bsz, int n_out,
    int n_in, int n_points, int blk) {
  __shared__ double ws[kSumsPerBlock][kWarps];
  __shared__ float fill;
  const int n_vc = (kp + kSumsPerBlock - 1) / kSumsPerBlock;
  if (blk < (long long)bsz * n_vc) {
    const int b = blk / n_vc;
    const int c0 = blk % n_vc * kSumsPerBlock;
    const double* src = partials + ((long long)b * kp + c0) * n_blk;
    double acc[kSumsPerBlock];
    strided_sums(
        n_blk,
        [&](int c, int q) {
          return c0 + c < kp ? src[(long long)c * n_blk + q] : 0.0;
        },
        acc);
    block_sum(acc, ws);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < kSumsPerBlock; ++c) {
        const int e = c0 + c;
        if (e < n_out)
          d_t[(long long)b * n_out + e] = __double2float_rn(acc[c]);
        else if (e < kp - 1)
          d_r[(long long)b * n_out * n_in + e - n_out] =
              __double2float_rn(acc[c]);
        else if (e == kp - 1)
          d_ow[b] = __double2float_rn(
              uniform ? __dmul_rn(acc[c], (double)pw[0]) : acc[c]);
      }
    }
    return;
  }
  const double* gw = partials + (long long)(kp - 1) * n_blk;
  double sum[1];
  strided_sums(
      bsz * n_blk,
      [&](int, int e) {
        const int b = e / n_blk;
        return __dmul_rn(gw[(long long)b * kp * n_blk + e % n_blk],
                         (double)ow[b]);
      },
      sum);
  block_sum(sum, ws);
  if (threadIdx.x == 0)
    fill = __double2float_rn(__ddiv_rn(sum[0], (double)n_points));
  __syncthreads();
  const long long base = (blk - (long long)bsz * n_vc) * kFillPoints;
  for (int m = 0; m < kFillPoints / kThreads; ++m) {
    const long long j = base + m * kThreads + threadIdx.x;
    if (j < n_points) d_pw[j] = fill;
  }
}

// The partial entry of slot s of an input-axis pass from k0 (E1's and the
// single tile's sums: s_i, s_i points[., k0 + a], the gw term), -1 where
// this pass does not write it.
template <int N_OUT, int KA>
__device__ __forceinline__ int pass_entry(int s, int k0, int n_in, int kp) {
  constexpr int KT = N_OUT * (1 + KA) + 1;
  if (s < N_OUT) return k0 == 0 ? s : -1;
  if (s < KT - 1)
    return N_OUT + (s - N_OUT) / KA * n_in + k0 + (s - N_OUT) % KA;
  return k0 == 0 ? kp - 1 : -1;
}

// The single tile's E2, one block: B4's rows (pose stride, plane stride
// s_pad, point stride 1), the point sums over the poses and the partials
// (B, kp, n_blk) of each pose's sums over the points (entry i sum s_i,
// n_out + i n_in + k sum s_i points[., k], kp - 1 sum gw pw_j).  A lane
// reads back only the ring pieces it copied itself; after the pose loop a
// warp's ring carries its point sums to group 0 of its chunk.
template <int N_OUT, int N_IN>
__global__ void __launch_bounds__(kThreads, 2)
epilogue_tile_kernel(const float* __restrict__ rows, long long pose_stride,
                     long long s_pad, const float* __restrict__ points,
                     const float* __restrict__ rot,
                     const float* __restrict__ ow,
                     const float* __restrict__ pw, long long pw_stride,
                     Scale scale, double* __restrict__ partials, int kp,
                     float* __restrict__ d_points, float* __restrict__ d_pw,
                     int bsz, int n_points, int n_in_rt, int groups) {
  constexpr int KA = kAxesPerPass<N_IN>;
  // a pass's sums over the chunk: s_i, s_i points[j, k0 + a], gw pw_j
  constexpr int KT = N_OUT * (1 + KA) + 1;
  constexpr int NR = N_OUT * KA;
  constexpr int NP = N_OUT + 1;
  static_assert(NP <= kSlots && (KA + 1) * kLanePoints * 32 *
                    sizeof(double) <= kStages * kSlots * 32 * sizeof(float4),
                "a pose's pieces and a warp's point sums fit its ring");
  const int n_in = N_IN > 0 ? N_IN : n_in_rt;
  extern __shared__ float4 ring_all[];  // (kWarps, kStages, kSlots, 32)
  __shared__ double rs[kWarps][NR];
  __shared__ double cs[kWarps][kGroupPoses][KT];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4* ring = ring_all + warp * kStages * kSlots * 32;
  const int cpb = kWarps / groups;
  const int g = warp % groups;
  const int c = warp / groups;
  const long long j0 =
      ((long long)blockIdx.x * cpb + c) * kChunk + kLanePoints * lane;
  const int lo = (int)((long long)g * bsz / groups);
  const int hi = (int)((long long)(g + 1) * bsz / groups);
  const bool readable = j0 < s_pad;
  bool valid[kLanePoints];
  float pwf[kLanePoints];
  double pwd[kLanePoints];
#pragma unroll
  for (int q = 0; q < kLanePoints; ++q) {
    valid[q] = j0 + q < n_points;
    pwf[q] = valid[q] ? pw[(j0 + q) * pw_stride] : 0.0f;
    pwd[q] = (double)pwf[q];
  }

  // stage pose b's rows of the lane's points (one piece a plane) into ring
  // stage st
  auto stage = [&](int b, int st) {
    const float* at = rows + b * pose_stride + j0;
    float4* dst = ring + st * kSlots * 32 + lane;
#pragma unroll
    for (int p = 0; p < NP; ++p)
      copy_async16(dst + p * 32, readable ? at + p * s_pad : rows,
                   readable ? 16 : 0);
  };

  for (int k0 = 0; k0 < n_in; k0 += KA) {
    const bool first_pass = k0 == 0;
    double x[kLanePoints][KA];
#pragma unroll
    for (int q = 0; q < kLanePoints; ++q)
#pragma unroll
      for (int a = 0; a < KA; ++a)
        x[q][a] = valid[q] ? (double)points[(j0 + q) * n_in + k0 + a] : 0.0;
    double accp[kLanePoints][KA];
    double accw[kLanePoints];
#pragma unroll
    for (int q = 0; q < kLanePoints; ++q) {
      accw[q] = -0.0;
#pragma unroll
      for (int a = 0; a < KA; ++a) accp[q][a] = -0.0;
    }
    auto rot_at = [&](int b) {
      return lane < NR ? rot[(long long)b * N_OUT * n_in +
                             (lane / KA) * n_in + k0 + lane % KA]
                       : 0.0f;
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (lo + s < hi) stage(lo + s, s);
      copy_async_commit();
    }
    float rot_next = rot_at(lo);
    float ow_next = ow[lo];
    for (int b = lo; b < hi; ++b) {
      const int st = (b - lo) % kStages;
      if (b + kStages - 1 < hi)
        stage(b + kStages - 1, (st + kStages - 1) % kStages);
      copy_async_commit();
      if (lane < NR) rs[warp][lane] = (double)rot_next;
      const float owf = ow_next;
      if (b + 1 < hi) {
        rot_next = rot_at(b + 1);
        ow_next = ow[b + 1];
      }
      __syncwarp();
      double R[N_OUT][KA];
#pragma unroll
      for (int i = 0; i < N_OUT; ++i)
#pragma unroll
        for (int a = 0; a < KA; ++a) R[i][a] = rs[warp][i * KA + a];
      __syncwarp();  // rs is read before the next pose's stage
      copy_async_wait<kStages - 1>();  // pose b has landed
      float r[NP][kLanePoints];
      const float4* got = ring + st * kSlots * 32 + lane;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float4 f = got[p * 32];
        r[p][0] = f.x;
        r[p][1] = f.y;
        r[p][2] = f.z;
        r[p][3] = f.w;
      }
      const double owd = (double)owf;
      double v[KT];
#pragma unroll
      for (int q = 0; q < kLanePoints; ++q) {
        const float opw = __fmul_rn(owf, pwf[q]);
        double s[N_OUT];
#pragma unroll
        for (int i = 0; i < N_OUT; ++i)
          s[i] = valid[q] ? (double)__fmul_rn(__fmul_rn(r[i][q], scale.v[i]),
                                              opw)
                          : 0.0;
        const double gw = valid[q] ? (double)r[N_OUT][q] : 0.0;
        // the point's sums over the poses
#pragma unroll
        for (int a = 0; a < KA; ++a)
#pragma unroll
          for (int i = 0; i < N_OUT; ++i)
            accp[q][a] = __fma_rn(s[i], R[i][a], accp[q][a]);
        if (first_pass) accw[q] = __fma_rn(gw, owd, accw[q]);
        // the pose's sums over the lane's points
#pragma unroll
        for (int i = 0; i < N_OUT; ++i) {
          v[i] = q == 0 ? s[i] : __dadd_rn(v[i], s[i]);
#pragma unroll
          for (int a = 0; a < KA; ++a) {
            double& t = v[N_OUT + i * KA + a];
            t = q == 0 ? __dmul_rn(s[i], x[q][a])
                       : __fma_rn(s[i], x[q][a], t);
          }
        }
        v[KT - 1] = q == 0 ? __dmul_rn(gw, pwd[q])
                           : __fma_rn(gw, pwd[q], v[KT - 1]);
      }
      const double sum = warp_scatter<KT, 16>(v, lane);
      const int slot = scatter_index<KT, 16>(lane);
      if (slot < KT) {
        if (cpb == 1) {
          const int e = pass_entry<N_OUT, KA>(slot, k0, n_in, kp);
          if (e >= 0)
            partials[((long long)b * kp + e) * gridDim.x + blockIdx.x] = sum;
        } else {
          cs[warp][b - lo][slot] = sum;
        }
      }
    }
    copy_async_wait<0>();
    // pose groups 1.. hand their point sums to group 0 of their chunk,
    // through their own ring
    double* ps = reinterpret_cast<double*>(ring);
    if (g > 0) {
#pragma unroll
      for (int q = 0; q < kLanePoints; ++q) {
#pragma unroll
        for (int a = 0; a < KA; ++a)
          ps[(a * kLanePoints + q) * 32 + lane] = accp[q][a];
        ps[(KA * kLanePoints + q) * 32 + lane] = accw[q];
      }
    }
    __syncthreads();
    // a pose's chunks in the block, in chunk order
    if (cpb > 1 && c == 0 && lane < KT) {
      const int e = pass_entry<N_OUT, KA>(lane, k0, n_in, kp);
      if (e >= 0) {
        for (int b = lo; b < hi; ++b) {
          double t = cs[g][b - lo][lane];
          for (int cc = 1; cc < cpb; ++cc)
            t = __dadd_rn(t, cs[g + groups * cc][b - lo][lane]);
          partials[((long long)b * kp + e) * gridDim.x + blockIdx.x] = t;
        }
      }
    }
    // the point sums, pose groups in order
    if (g == 0) {
#pragma unroll
      for (int q = 0; q < kLanePoints; ++q) {
        if (!valid[q]) continue;
        const long long j = j0 + q;
#pragma unroll
        for (int a = 0; a < KA + 1; ++a) {
          if (a == KA && !first_pass) continue;
          double t = a < KA ? accp[q][a] : accw[q];
          for (int gg = 1; gg < groups; ++gg)
            t = __dadd_rn(
                t, reinterpret_cast<const double*>(
                       ring_all + (warp + gg) * kStages * kSlots * 32)
                       [(a * kLanePoints + q) * 32 + lane]);
          if (a < KA)
            d_points[j * n_in + k0 + a] = __double2float_rn(t);
          else
            d_pw[j] = __double2float_rn(t);
        }
      }
    }
    if (k0 + KA < n_in) __syncthreads();  // shared memory read before reuse
  }
}

// E2 on several tiles, block `blk` of the points: thread t the point blk
// 256 + t of E1's copy (B, P, width) [du..., gw or 0, 0...], each pose in
// order, kAhead poses' loads issued before their arithmetic; the poses'
// rotations and ow staged in shared memory, as fp64, kPoseChunk at a time
// (after the chunk's first loads are issued, so the two latencies
// overlap).
template <int N_OUT, int N_IN>
__device__ __forceinline__ void copy_points_body(
    const float* __restrict__ copy, int width,
    const float* __restrict__ rot, const float* __restrict__ ow,
    const float* __restrict__ pw, long long pw_stride, const Scale& scale,
    float* __restrict__ d_points, float* __restrict__ d_pw, int bsz,
    int n_points, int n_in_rt, bool has_gw, int blk) {
  constexpr int KA = kAxesPerPass<N_IN>;
  constexpr int NR = N_OUT * KA;
  const int n_in = N_IN > 0 ? N_IN : n_in_rt;
  __shared__ double rs[kPoseChunk][NR];
  __shared__ double os[kPoseChunk];
  __shared__ float of[kPoseChunk];
  const long long j = (long long)blk * kThreads + threadIdx.x;
  const bool valid = j < n_points;
  const float pwf = valid ? pw[j * pw_stride] : 0.0f;
  const float* at = copy + (valid ? j : 0) * width;
  const long long pose_stride = (long long)n_points * width;
  // poses b .. b + kAhead - 1 of this point (those below `end`)
  auto load = [&](int b, int end, float (&r)[kAhead][4]) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (b + u >= end) continue;
      const float* src = at + (b + u) * pose_stride;
      if (width == 2) {
        const float2 f = __ldcs(reinterpret_cast<const float2*>(src));
        r[u][0] = f.x;
        r[u][1] = f.y;
        r[u][2] = r[u][3] = 0.0f;
      } else {
        const float4 f = __ldcs(reinterpret_cast<const float4*>(src));
        r[u][0] = f.x;
        r[u][1] = f.y;
        r[u][2] = f.z;
        r[u][3] = f.w;
      }
    }
  };
  for (int k0 = 0; k0 < n_in; k0 += KA) {
    const bool first_pass = k0 == 0;
    double acc[KA];
#pragma unroll
    for (int a = 0; a < KA; ++a) acc[a] = -0.0;
    double accw = -0.0;
    for (int b0 = 0; b0 < bsz; b0 += kPoseChunk) {
      const int nb = min(kPoseChunk, bsz - b0);
      float r[kAhead][4];
      load(b0, b0 + nb, r);
      __syncthreads();  // the last chunk's rotations are read
      for (int e = threadIdx.x; e < nb * NR; e += kThreads) {
        const int bb = e / NR, m = e % NR;
        rs[bb][m] = (double)rot[(long long)(b0 + bb) * N_OUT * n_in +
                                (m / KA) * n_in + k0 + m % KA];
      }
      for (int e = threadIdx.x; e < nb; e += kThreads) {
        of[e] = ow[b0 + e];
        os[e] = (double)of[e];
      }
      __syncthreads();
      for (int bb = 0; bb < nb; bb += kAhead) {
        if (bb > 0) load(b0 + bb, b0 + nb, r);
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (bb + u >= nb) continue;
          const float opw = __fmul_rn(of[bb + u], pwf);
#pragma unroll
          for (int i = 0; i < N_OUT; ++i) {
            const double s =
                (double)__fmul_rn(__fmul_rn(r[u][i], scale.v[i]), opw);
#pragma unroll
            for (int a = 0; a < KA; ++a)
              acc[a] = __fma_rn(s, rs[bb + u][i * KA + a], acc[a]);
          }
          if (first_pass && has_gw)
            accw = __fma_rn((double)r[u][N_OUT], os[bb + u], accw);
        }
      }
    }
    if (valid) {
#pragma unroll
      for (int a = 0; a < KA; ++a)
        d_points[j * n_in + k0 + a] = __double2float_rn(acc[a]);
      if (first_pass && has_gw) d_pw[j] = __double2float_rn(accw);
    }
  }
}

// E1 (several tiles), one block per (1,024 frame rows, pose).  Fillers (id
// P) and rows past s_pad store nothing and add +0.
template <int N_OUT, int N_IN>
__global__ void __launch_bounds__(kThreads)
epilogue_rows_kernel(const float* __restrict__ buf,  // (B, N_OUT + 1, s_pad)
                     const float* __restrict__ ids, long long id_stride,
                     const float* __restrict__ points,  // (P, n_in)
                     const float* __restrict__ ow,      // (B,)
                     const float* __restrict__ pw,      // (P,), stride
                     long long pw_stride, Scale scale,
                     double* __restrict__ partials,  // (B, kp, n_blk)
                     int kp, float* __restrict__ copy,  // (B, P, width)
                     int width, int bsz, int n_points, int n_in_rt,
                     long long s_pad, int uniform) {
  constexpr int KA = kAxesPerPass<N_IN>;
  constexpr int KT = N_OUT * (1 + KA) + 1;
  constexpr int R = kRowsPerThread;
  const int n_in = N_IN > 0 ? N_IN : n_in_rt;
  __shared__ double ws[kWarps][KT];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = pose_of(blockIdx.y, blockIdx.z);
  if (b >= bsz) return;  // past the last pose: the whole block
  const long long base = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x;
  const float* rows = buf + (long long)b * (N_OUT + 1) * s_pad;
  const float* idp = ids + (long long)b * id_stride;
  // every load of the thread's rows before any arithmetic
  int id[R];
  float du[N_OUT][R], gw[R], pwj[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const long long r = base + m * kThreads;
    const bool in = r < s_pad;
    id[m] = in ? (int)__ldcs(idp + r) : n_points;
#pragma unroll
    for (int i = 0; i < N_OUT; ++i)
      du[i][m] = in ? __ldcs(rows + i * s_pad + r) : 0.0f;
    gw[m] = in ? __ldcs(rows + N_OUT * s_pad + r) : 0.0f;
  }
  bool real[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    real[m] = (unsigned)id[m] < (unsigned)n_points;
    pwj[m] = pw[(real[m] ? id[m] : 0) * pw_stride];
  }
  // the unsort
  const long long pose = (long long)b * n_points;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    if (!real[m]) continue;
    if (width == 2) {
      reinterpret_cast<float2*>(copy)[pose + id[m]] =
          make_float2(du[0][m], du[1][m]);
    } else {
      float v[4] = {du[0][m], du[1][m], 0.0f, 0.0f};
      v[N_OUT - 1] = du[N_OUT - 1][m];
      v[N_OUT] = uniform ? 0.0f : gw[m];
      reinterpret_cast<float4*>(copy)[pose + id[m]] =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  const float owb = ow[b];
  for (int k0 = 0; k0 < n_in; k0 += KA) {
    float xg[R][KA];
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int a = 0; a < KA; ++a)
        xg[m][a] = points[(long long)(real[m] ? id[m] : 0) * n_in + k0 + a];
    double v[KT];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const float opw = __fmul_rn(owb, pwj[m]);
      const double g = real[m] ? (double)gw[m] : 0.0;
      const double p = real[m] ? (double)pwj[m] : 0.0;
#pragma unroll
      for (int i = 0; i < N_OUT; ++i) {
        const double s =
            real[m] ? (double)__fmul_rn(__fmul_rn(du[i][m], scale.v[i]), opw)
                    : 0.0;
        v[i] = m == 0 ? s : __dadd_rn(v[i], s);
#pragma unroll
        for (int a = 0; a < KA; ++a) {
          const double x = real[m] ? (double)xg[m][a] : 0.0;
          double& t = v[N_OUT + i * KA + a];
          t = m == 0 ? __dmul_rn(s, x) : __fma_rn(s, x, t);
        }
      }
      double& t = v[KT - 1];
      if (uniform)
        t = m == 0 ? g : __dadd_rn(t, g);
      else
        t = m == 0 ? __dmul_rn(g, p) : __fma_rn(g, p, t);
    }
    const double sum = warp_scatter<KT, 16>(v, lane);
    const int slot = scatter_index<KT, 16>(lane);
    if (slot < KT) ws[warp][slot] = sum;
    __syncthreads();
    if (warp == 0 && lane < KT) {
      const int e = pass_entry<N_OUT, KA>(lane, k0, n_in, kp);
      if (e >= 0) {
        double t = ws[0][lane];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) t = __dadd_rn(t, ws[w][lane]);
        partials[((long long)b * kp + e) * gridDim.x + blockIdx.x] = t;
      }
    }
    if (k0 + KA < n_in) __syncthreads();  // ws is read before reuse
  }
}

// E2 on several tiles: blocks [0, n_fin) the final sums of E1's partials
// (`poses_body`), first, so that their latency hides behind the points;
// the rest the points of E1's copy.
template <int N_OUT, int N_IN>
__global__ void __launch_bounds__(kThreads)
epilogue_points_kernel(const float* __restrict__ copy, int width,
                       const float* __restrict__ rot,
                       const float* __restrict__ ow,
                       const float* __restrict__ pw, long long pw_stride,
                       Scale scale, const double* __restrict__ partials,
                       int n_blk, int kp, float* __restrict__ d_points,
                       float* __restrict__ d_pw, float* __restrict__ d_t,
                       float* __restrict__ d_r, float* __restrict__ d_ow,
                       int bsz, int n_points, int n_in_rt, int uniform,
                       int n_fin) {
  const int n_in = N_IN > 0 ? N_IN : n_in_rt;
  if ((int)blockIdx.x < n_fin) {
    poses_body(partials, n_blk, kp, uniform != 0, ow, pw, d_t, d_r, d_ow,
               d_pw, bsz, N_OUT, n_in, n_points, blockIdx.x);
    return;
  }
  copy_points_body<N_OUT, N_IN>(copy, width, rot, ow, pw, pw_stride, scale,
                                d_points, d_pw, bsz, n_points, n_in_rt,
                                uniform == 0, blockIdx.x - n_fin);
}

// The single tile's final sums of E2's partials.
__global__ void __launch_bounds__(kThreads)
epilogue_poses_kernel(const double* __restrict__ partials, int n_blk,
                      int kp, const float* __restrict__ ow,
                      const float* __restrict__ pw, float* __restrict__ d_t,
                      float* __restrict__ d_r, float* __restrict__ d_ow,
                      int bsz, int n_out, int n_in, int n_points) {
  poses_body(partials, n_blk, kp, false, ow, pw, d_t, d_r, d_ow, nullptr,
             bsz, n_out, n_in, n_points, blockIdx.x);
}

template <int N_OUT, int N_IN>
cudaError_t launch_rows(const float* buf, const float* ids,
                        long long id_stride, const float* points,
                        const float* ow, const float* pw,
                        long long pw_stride, Scale scale, double* partials,
                        int kp, float* copy, int width, int bsz,
                        int n_points, int n_in, long long s_pad, int uniform,
                        cudaStream_t stream) {
  const dim3 grid((unsigned)((s_pad + kRowsPerBlock - 1) / kRowsPerBlock),
                  pose_low(bsz), pose_high(bsz));
  epilogue_rows_kernel<N_OUT, N_IN><<<grid, kThreads, 0, stream>>>(
      buf, ids, id_stride, points, ow, pw, pw_stride, scale, partials, kp,
      copy, width, bsz, n_points, n_in, s_pad, uniform);
  return cudaGetLastError();
}

template <int N_OUT, int N_IN>
cudaError_t launch_tile(const float* buf, long long pose_stride,
                        long long s_pad, const float* points,
                        const float* rot, const float* ow, const float* pw,
                        long long pw_stride, Scale scale, double* partials,
                        int n_blk, int kp, float* d_points, float* d_pw,
                        int bsz, int n_points, int n_in, int groups,
                        cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      epilogue_tile_kernel<N_OUT, N_IN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (err != cudaSuccess) return err;
  epilogue_tile_kernel<N_OUT, N_IN><<<n_blk, kThreads, kRingBytes, stream>>>(
      buf, pose_stride, s_pad, points, rot, ow, pw, pw_stride, scale,
      partials, kp, d_points, d_pw, bsz, n_points, n_in, groups);
  return cudaGetLastError();
}

template <int N_OUT, int N_IN>
cudaError_t launch_points(const float* copy, int width, const float* rot,
                          const float* ow, const float* pw,
                          long long pw_stride, Scale scale,
                          const double* partials, int n_blk, int kp,
                          float* d_points, float* d_pw, float* d_t,
                          float* d_r, float* d_ow, int bsz, int n_points,
                          int n_in, int uniform, int n_fin, int n_grid,
                          cudaStream_t stream) {
  epilogue_points_kernel<N_OUT, N_IN><<<n_grid, kThreads, 0, stream>>>(
      copy, width, rot, ow, pw, pw_stride, scale, partials, n_blk, kp,
      d_points, d_pw, d_t, d_r, d_ow, bsz, n_points, n_in, uniform, n_fin);
  return cudaGetLastError();
}

// (n_out, n_in) -> F<n_out, n_in> where the main path has them unrolled,
// else F<n_out, 0>, which takes n_in at run time
#define DPRAST_EPILOGUE_DISPATCH(F, ...)                                  \
  if (n_out == 2 && n_in == 2) return (int)F<2, 2>(__VA_ARGS__);          \
  if (n_out == 2 && n_in == 3) return (int)F<2, 3>(__VA_ARGS__);          \
  if (n_out == 3 && n_in == 3) return (int)F<3, 3>(__VA_ARGS__);          \
  if (n_out == 2) return (int)F<2, 0>(__VA_ARGS__);                       \
  return (int)F<3, 0>(__VA_ARGS__);

bool bad_shape(int bsz, int n_out, int n_in, int n_points) {
  return bsz < 1 || (n_out != 2 && n_out != 3) || n_in < 1 ||
         n_points < 1 || n_points >= (1 << 24);
}

bool misaligned(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 != 0;
}

// the blocks of the final sums; a grid's x holds at most 2^31 - 1 blocks,
// which no pose count that device memory holds comes near (-1 past it)
int final_blocks(int bsz, int kp, int n_points, int uniform) {
  const long long n =
      (long long)bsz * ((kp + kSumsPerBlock - 1) / kSumsPerBlock) +
      (uniform ? (n_points + kFillPoints - 1) / kFillPoints : 0);
  return n < (1ll << 31) ? (int)n : -1;
}

}  // namespace

// E1 (several tiles).  `buf` (B, n_out + 1, s_pad) contiguous; `ids` the
// float32 id plane (B, s_pad) at pose stride `id_stride`; `points` (P,
// n_in) and `ow` (B,) contiguous; `pw` (P,) at element stride `pw_stride`
// (0 for a broadcast weight).  `partials` (B, kp, ceil(s_pad / 1024))
// float64, kp = n_out (1 + n_in) + 1.  `copy` (B, P, width) float32,
// aligned to its width of 2 floats ([du_0, du_1]: 2-D on the uniform path)
// or 4 ([du..., gw], gw 0 on the uniform path, zeros after).
extern "C" int dprast_epilogue_rows(const void* buf, const void* ids,
                                    long long id_stride, const void* points,
                                    const void* ow, const void* pw,
                                    long long pw_stride, float s0, float s1,
                                    float s2, void* partials, int kp,
                                    void* copy, int width, int bsz,
                                    int n_out, int n_in, int n_points,
                                    long long s_pad, int uniform,
                                    void* stream) {
  if (bad_shape(bsz, n_out, n_in, n_points) || s_pad < n_points ||
      kp != n_out * (1 + n_in) + 1 || misaligned(copy) ||
      (width != 2 && width != 4) || width < n_out + !uniform)
    return (int)cudaErrorInvalidValue;
  const Scale scale{{s0, s1, s2}};
  DPRAST_EPILOGUE_DISPATCH(
      launch_rows, (const float*)buf, (const float*)ids, id_stride,
      (const float*)points, (const float*)ow, (const float*)pw, pw_stride,
      scale, (double*)partials, kp, (float*)copy, width, bsz, n_points,
      n_in, s_pad, uniform, (cudaStream_t)stream)
}

// E2 on a single tile.  `buf` B4's rows (B, n_out + 1, s_pad) at pose
// stride `pose_stride`, s_pad, the stride and the pointer in 16-byte
// units; `points` (P, n_in), `rot` (B, n_out, n_in) and `ow` (B,)
// contiguous; `pw` (P,) at element stride `pw_stride`.  `groups` the pose
// groups (a power of two, at most min(B, 8); below 8, at most two poses a
// group).  Writes `partials` (B, kp, n_blk) float64, n_blk = ceil(P /
// (128 * 8 / groups)), kp = n_out (1 + n_in) + 1, d_points (P, n_in) and
// d_pw (P,).
extern "C" int dprast_epilogue_tile(const void* buf, long long pose_stride,
                                    long long s_pad, const void* points,
                                    const void* rot, const void* ow,
                                    const void* pw, long long pw_stride,
                                    float s0, float s1, float s2,
                                    void* partials, int n_blk, int kp,
                                    void* d_points, void* d_pw, int bsz,
                                    int n_out, int n_in, int n_points,
                                    int groups, void* stream) {
  if (bad_shape(bsz, n_out, n_in, n_points) ||
      (groups != 1 && groups != 2 && groups != 4 && groups != 8) ||
      groups > bsz || (groups < 8 && bsz > groups * kGroupPoses))
    return (int)cudaErrorInvalidValue;
  const int span = kChunk * (kWarps / groups);
  if (kp != n_out * (1 + n_in) + 1 ||
      n_blk != (n_points + span - 1) / span || misaligned(buf) ||
      pose_stride % 4 != 0 || s_pad % 4 != 0 || s_pad < n_points)
    return (int)cudaErrorInvalidValue;
  const Scale scale{{s0, s1, s2}};
  DPRAST_EPILOGUE_DISPATCH(
      launch_tile, (const float*)buf, pose_stride, s_pad,
      (const float*)points, (const float*)rot, (const float*)ow,
      (const float*)pw, pw_stride, scale, (double*)partials, n_blk, kp,
      (float*)d_points, (float*)d_pw, bsz, n_points, n_in, groups,
      (cudaStream_t)stream)
}

// E2 on several tiles.  `copy` E1's (B, P, width); `rot` (B, n_out, n_in)
// and `ow` (B,) contiguous; `pw` (P,) at element stride `pw_stride`;
// `partials` E1's (B, kp, n_blk).  Writes d_points (P, n_in), d_pw (P,),
// d_t (B, n_out), d_r (B, n_out, n_in) and d_ow (B,).
extern "C" int dprast_epilogue_points(const void* copy, int width,
                                      const void* rot, const void* ow,
                                      const void* pw, long long pw_stride,
                                      float s0, float s1, float s2,
                                      const void* partials, int n_blk,
                                      int kp, void* d_points, void* d_pw,
                                      void* d_t, void* d_r, void* d_ow,
                                      int bsz, int n_out, int n_in,
                                      int n_points, int uniform,
                                      void* stream) {
  if (bad_shape(bsz, n_out, n_in, n_points) || n_blk < 1 ||
      kp != n_out * (1 + n_in) + 1 || misaligned(copy) ||
      (width != 2 && width != 4) || width < n_out + !uniform)
    return (int)cudaErrorInvalidValue;
  const Scale scale{{s0, s1, s2}};
  const int n_fin = final_blocks(bsz, kp, n_points, uniform);
  const long long n_grid =
      (long long)n_fin + (n_points + kThreads - 1) / kThreads;
  if (n_fin < 0 || n_grid >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  DPRAST_EPILOGUE_DISPATCH(
      launch_points, (const float*)copy, width, (const float*)rot,
      (const float*)ow, (const float*)pw, pw_stride, scale,
      (const double*)partials, n_blk, kp, (float*)d_points, (float*)d_pw,
      (float*)d_t, (float*)d_r, (float*)d_ow, bsz, n_points, n_in, uniform,
      n_fin, (int)n_grid, (cudaStream_t)stream)
}

// The single tile's final sums.  `partials` its E2's (B, kp, n_blk); `ow`
// (B,) contiguous.  Writes d_t (B, n_out), d_r (B, n_out, n_in) and d_ow
// (B,).
extern "C" int dprast_epilogue_poses(const void* partials, int n_blk,
                                     int kp, const void* ow, const void* pw,
                                     void* d_t, void* d_r, void* d_ow,
                                     int bsz, int n_out, int n_in,
                                     int n_points, void* stream) {
  const int n_fin = final_blocks(bsz, kp, n_points, 0);
  if (bad_shape(bsz, n_out, n_in, n_points) || n_blk < 1 ||
      kp != n_out * (1 + n_in) + 1 || n_fin < 0)
    return (int)cudaErrorInvalidValue;
  epilogue_poses_kernel<<<n_fin, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)partials, n_blk, kp, (const float*)ow, (const float*)pw,
      (float*)d_t, (float*)d_r, (float*)d_ow, bsz, n_out, n_in, n_points);
  return (int)cudaGetLastError();
}
