// B8: the pullback's epilogue of the binned backend, 2-D and 3-D grids.
//
// Replaces no Pallas kernel: in dprast/ops/splat_binned.py everything after
// B4's `pallas_call` in `raster_pullback` (:1355-1423) is plain XLA under
// `jit` -- the unsort of B4's rows by the point-id plane, the products
// `scaled = du * (g/2) * (ow * pw)` and the reductions and einsums that
// make the gradients of the translation, rotation, points and weights.
// XLA fuses the products into the reductions.  Eager PyTorch runs them as
// eleven to nineteen launches (a scatter, elementwise products, sums,
// gemms and gemvs: `splat_binned._epilogue_plain`); these two kernels
// are that fusion.
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
// fp64 product of fp32 values, which is exact, and the sums run in fp64
// (`__dadd_rn`) with one rounding to fp32 at the end, so the gradients
// are within a rounding of the exact sums of the fp32 `s_i` terms.
// - E1 `epilogue_rows_kernel`, one block per (run of 1,024 frame rows,
//   pose): thread t takes rows t, t + 256, t + 512, t + 768 of the run and
//   sums their terms [s_i, s_i * points[j, k], gw term] in that order (a
//   row past the run's end or with id P adds +0), then the block sums its
//   threads (`block_sum`: a pairwise tree inside each warp by shuffles,
//   then over the eight warps) into one partial per (pose, block).  On a
//   multi-tile grid it also stores each row's [du..., gw] (gw only on the
//   per-point path) at point `id` of the point-order copy (B, P, W) in one
//   store of W = 2 floats (2-D, uniform) or 4: a plain store through a
//   permutation, which replaces `_unsort`'s scatter.
// - E2 `epilogue_points_kernel`: blocks [0, B) each reduce one pose's E1
//   partials in block order (thread t takes partials t, t + 256, ..., then
//   `block_sum`) into d_t, d_r and d_ow.  On the uniform path the next
//   ceil(P / 4096) blocks each sum all B x n_blk gw partials times ow_b
//   (flat, in the same order) for the uniform d_pw and write it to their
//   4,096 points.  The remaining blocks take 256 points each, one a
//   thread, and sum each point's terms over the poses in pose order
//   (d_points, and d_pw on the per-point path) from the point-order rows
//   (B4's rows themselves on a single tile).
// The input axes are unrolled where the main path has them (n_in 2 and 3
// at n_out 2, 3 at n_out 3); every other n_in takes the instance with
// N_IN = 0, which runs one input axis a pass, in the same order of sums.
//
// What bounds it here.  Bytes: B4's rows are read once by each kernel on
// a single tile (E2 reads them in point order), once by E1 and the
// point-order copy once by E2 on several tiles, plus the ids, points[id]
// and pw[id] (gathers that hit L2: the cloud is a few MB) and the
// gradients written once.  A few operations a row.  The point-order copy
// is written in frame order, so its stores land at random points of one
// pose: each row's values go out as one store of 8 or 16 bytes (one
// sector where two to four 4-byte stores to as many planes would touch as
// many), and the runs of one pose are in flight together, so its W P
// floats stay in L2 while they fill.
//
// Block counts come from shapes alone and nothing is read back to the
// host.  The partials buffer needs no zeroing: every (pose, block) entry
// is written by E1 before E2 reads it, in stream order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;
// the uniform d_pw: points a fill block writes, 16 a thread
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

// E1.  Each pass sums the terms of input axes [k0, k0 + KA): s_i, s_i *
// points[j, k] and the gw term (the first pass writes s_i and gw).
template <int N_OUT, int N_IN>
__global__ void __launch_bounds__(kThreads)
epilogue_rows_kernel(const float* __restrict__ buf,  // (B, N_OUT + 1, s_pad)
                     const float* __restrict__ ids,  // id plane or null
                     long long id_stride,
                     const float* __restrict__ points,  // (P, n_in)
                     const float* __restrict__ ow,      // (B,)
                     const float* __restrict__ pw,      // (P,), stride
                     long long pw_stride, Scale scale,
                     double* __restrict__ partials,  // (B, n_blk, K)
                     float* __restrict__ rows_out,   // (B, P, width)
                     int width, int n_points, int n_in_rt, long long s_pad,
                     long long n_rows, int uniform) {
  constexpr int KA = kAxesPerPass<N_IN>;
  constexpr int KT = N_OUT * (1 + KA) + 1;
  const int n_in = N_IN > 0 ? N_IN : n_in_rt;
  const int K = N_OUT * (1 + n_in) + 1;
  __shared__ double ws[KT][kWarps];
  const int b = blockIdx.y;
  const long long run = (long long)blockIdx.x * kRowsPerBlock;
  const float* rows = buf + (long long)b * (N_OUT + 1) * s_pad;
  const float owb = ow[b];
  double* out = partials + ((long long)b * gridDim.x + blockIdx.x) * K;
  for (int k0 = 0; k0 < n_in; k0 += KA) {
    double acc[KT];
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
      const long long r = run + m * kThreads + threadIdx.x;
      double c[KT];
#pragma unroll
      for (int q = 0; q < KT; ++q) c[q] = 0.0;
      if (r < n_rows) {
        const int id =
            ids != nullptr ? (int)ids[(long long)b * id_stride + r] : (int)r;
        if ((unsigned)id < (unsigned)n_points) {
          float du[N_OUT];
#pragma unroll
          for (int i = 0; i < N_OUT; ++i) du[i] = rows[i * s_pad + r];
          const float gw = rows[N_OUT * s_pad + r];
          const float pwj = pw[id * pw_stride];
          const float opw = __fmul_rn(owb, pwj);
          const float* x = points + (long long)id * n_in + k0;
#pragma unroll
          for (int i = 0; i < N_OUT; ++i) {
            const double s = __fmul_rn(__fmul_rn(du[i], scale.v[i]), opw);
            c[i] = s;
#pragma unroll
            for (int a = 0; a < KA; ++a)
              c[N_OUT + i * KA + a] = __dmul_rn(s, (double)x[a]);
          }
          c[KT - 1] = uniform ? (double)gw : __dmul_rn(gw, (double)pwj);
          if (rows_out != nullptr && k0 == 0) {
            const long long at = (long long)b * n_points + id;
            if (width == 2) {
              reinterpret_cast<float2*>(rows_out)[at] =
                  make_float2(du[0], du[1]);
            } else {
              float v[4] = {du[0], du[1], 0.0f, 0.0f};
              v[N_OUT - 1] = du[N_OUT - 1];
              v[N_OUT] = uniform ? 0.0f : gw;
              reinterpret_cast<float4*>(rows_out)[at] =
                  make_float4(v[0], v[1], v[2], v[3]);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < KT; ++q)
        acc[q] = m == 0 ? c[q] : __dadd_rn(acc[q], c[q]);
    }
    block_sum(acc, ws);
    if (threadIdx.x == 0) {
      if (k0 == 0) {
#pragma unroll
        for (int i = 0; i < N_OUT; ++i) out[i] = acc[i];
        out[K - 1] = acc[KT - 1];
      }
#pragma unroll
      for (int i = 0; i < N_OUT; ++i) {
#pragma unroll
        for (int a = 0; a < KA; ++a)
          out[N_OUT + i * n_in + k0 + a] = acc[N_OUT + i * KA + a];
      }
    }
    if (k0 + KA < n_in) __syncthreads();  // ws is read before reuse
  }
}

// E2.  Blocks [0, B) the poses' partials, then the fill blocks of the
// uniform d_pw (n_fb of them, 0 on the per-point path), then the points.
template <int N_OUT, int N_IN>
__global__ void __launch_bounds__(kThreads)
epilogue_points_kernel(const float* __restrict__ rows,  // point-order rows
                       long long pose_stride, long long plane_stride,
                       int point_stride,
                       const float* __restrict__ rot,  // (B, N_OUT, n_in)
                       const float* __restrict__ ow,   // (B,)
                       const float* __restrict__ pw,   // (P,), stride
                       long long pw_stride, Scale scale,
                       const double* __restrict__ partials,  // (B, n_blk, K)
                       int n_blk, float* __restrict__ d_points,  // (P, n_in)
                       float* __restrict__ d_pw,                 // (P,)
                       float* __restrict__ d_t,      // (B, N_OUT)
                       float* __restrict__ d_r,      // (B, N_OUT, n_in)
                       float* __restrict__ d_ow,     // (B,)
                       int bsz, int n_points, int n_in_rt, int n_fb,
                       int uniform) {
  constexpr int KA = kAxesPerPass<N_IN>;
  // partials one pass reduces: all K where N_IN is known, else one
  constexpr int KB = N_IN > 0 ? N_OUT * (1 + N_IN) + 1 : 1;
  const int n_in = N_IN > 0 ? N_IN : n_in_rt;
  const int K = N_OUT * (1 + n_in) + 1;
  __shared__ double ws[KB][kWarps];
  __shared__ float fill;
  const int blk = blockIdx.x;
  if (blk < bsz) {
    // one pose's partials, in block order; entry e is d_t[b, e], then
    // d_r[b] flat (i-major, as the partials hold it), then d_ow[b]
    const int b = blk;
    const double* src = partials + (long long)b * n_blk * K;
    const int per = (n_blk + kThreads - 1) / kThreads;
    for (int c0 = 0; c0 < K; c0 += KB) {
      double acc[KB];
      for (int m = 0; m < per; ++m) {
        const int q = m * kThreads + threadIdx.x;
#pragma unroll
        for (int c = 0; c < KB; ++c) {
          const double v = q < n_blk && c0 + c < K
                               ? src[(long long)q * K + c0 + c]
                               : 0.0;
          acc[c] = m == 0 ? v : __dadd_rn(acc[c], v);
        }
      }
      block_sum(acc, ws);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int c = 0; c < KB; ++c) {
          const int e = c0 + c;
          if (e < N_OUT)
            d_t[b * N_OUT + e] = __double2float_rn(acc[c]);
          else if (e < K - 1)
            d_r[(long long)b * N_OUT * n_in + e - N_OUT] =
                __double2float_rn(acc[c]);
          else if (e == K - 1)
            d_ow[b] = __double2float_rn(
                uniform ? __dmul_rn(acc[c], (double)pw[0]) : acc[c]);
        }
      }
      if (c0 + KB < K) __syncthreads();  // ws is read before reuse
    }
    return;
  }
  if (blk < bsz + n_fb) {
    // the uniform d_pw: every gw partial times its pose's ow, flat in
    // (pose, block) order, over P; written to this block's points
    const long long n = (long long)bsz * n_blk;
    const long long per = (n + kThreads - 1) / kThreads;
    double acc[1];
    for (long long m = 0; m < per; ++m) {
      const long long e = m * kThreads + threadIdx.x;
      const double v = e < n ? __dmul_rn(partials[e * K + K - 1],
                                         (double)ow[(int)(e / n_blk)])
                             : 0.0;
      acc[0] = m == 0 ? v : __dadd_rn(acc[0], v);
    }
    block_sum(acc, ws);
    if (threadIdx.x == 0)
      fill = __double2float_rn(__ddiv_rn(acc[0], (double)n_points));
    __syncthreads();
    const long long base = (long long)(blk - bsz) * kFillPoints;
    for (int m = 0; m < kFillPoints / kThreads; ++m) {
      const long long j = base + m * kThreads + threadIdx.x;
      if (j < n_points) d_pw[j] = fill;
    }
    return;
  }
  const int j = (blk - bsz - n_fb) * kThreads + threadIdx.x;
  if (j >= n_points) return;
  const float pwj = pw[j * pw_stride];
  const float* src = rows + (long long)j * point_stride;
  for (int k0 = 0; k0 < n_in; k0 += KA) {
    double acc[KA];
    double acc_pw = 0.0;
#pragma unroll 4
    for (int b = 0; b < bsz; ++b) {
      const float* at = src + b * pose_stride;
      const float owb = ow[b];
      const float opw = __fmul_rn(owb, pwj);
      const float* rb = rot + (long long)b * N_OUT * n_in + k0;
      float s[N_OUT];
#pragma unroll
      for (int i = 0; i < N_OUT; ++i)
        s[i] = __fmul_rn(__fmul_rn(at[i * plane_stride], scale.v[i]), opw);
#pragma unroll
      for (int a = 0; a < KA; ++a) {
        double t = __dmul_rn(s[0], (double)rb[a]);
#pragma unroll
        for (int i = 1; i < N_OUT; ++i)
          t = __dadd_rn(t, __dmul_rn(s[i], (double)rb[i * n_in + a]));
        acc[a] = b == 0 ? t : __dadd_rn(acc[a], t);
      }
      if (!uniform && k0 == 0) {
        const double g =
            __dmul_rn(at[N_OUT * plane_stride], (double)owb);
        acc_pw = b == 0 ? g : __dadd_rn(acc_pw, g);
      }
    }
#pragma unroll
    for (int a = 0; a < KA; ++a)
      d_points[(long long)j * n_in + k0 + a] = __double2float_rn(acc[a]);
    if (!uniform && k0 == 0) d_pw[j] = __double2float_rn(acc_pw);
  }
}

template <int N_OUT, int N_IN>
cudaError_t launch_rows(const float* buf, const float* ids,
                        long long id_stride, const float* points,
                        const float* ow, const float* pw,
                        long long pw_stride, Scale scale, double* partials,
                        float* rows_out, int width, int bsz, int n_points,
                        int n_in, long long s_pad, long long n_rows,
                        int uniform, cudaStream_t stream) {
  const dim3 grid((unsigned)((n_rows + kRowsPerBlock - 1) / kRowsPerBlock),
                  bsz);
  epilogue_rows_kernel<N_OUT, N_IN><<<grid, kThreads, 0, stream>>>(
      buf, ids, id_stride, points, ow, pw, pw_stride, scale, partials,
      rows_out, width, n_points, n_in, s_pad, n_rows, uniform);
  return cudaGetLastError();
}

template <int N_OUT, int N_IN>
cudaError_t launch_points(const float* rows, long long pose_stride,
                          long long plane_stride, int point_stride,
                          const float* rot, const float* ow, const float* pw,
                          long long pw_stride, Scale scale,
                          const double* partials, int n_blk,
                          float* d_points, float* d_pw, float* d_t,
                          float* d_r, float* d_ow, int bsz, int n_points,
                          int n_in, int uniform, cudaStream_t stream) {
  const int n_pb = (n_points + kThreads - 1) / kThreads;
  const int n_fb = uniform ? (n_points + kFillPoints - 1) / kFillPoints : 0;
  epilogue_points_kernel<N_OUT, N_IN>
      <<<bsz + n_fb + n_pb, kThreads, 0, stream>>>(
          rows, pose_stride, plane_stride, point_stride, rot, ow, pw,
          pw_stride, scale, partials, n_blk, d_points, d_pw, d_t, d_r, d_ow,
          bsz, n_points, n_in, n_fb, uniform);
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
  return bsz < 1 || bsz > 65535 || (n_out != 2 && n_out != 3) || n_in < 1 ||
         n_points < 1 || n_points >= (1 << 24);
}

}  // namespace

// E1.  `buf` (B, n_out + 1, s_pad) contiguous; `ids` the float32 id plane
// (B, s_pad) at pose stride `id_stride`, or null on a single tile (row r
// is point r); `points` (P, n_in) and `ow` (B,) contiguous; `pw` (P,) at
// element stride `pw_stride` (0 for a broadcast weight).  Rows [0, n_rows)
// are read: s_pad on a multi-tile grid, P on a single tile.  `partials`
// (B, ceil(n_rows / 1024), K) float64 with K = n_out (1 + n_in) + 1;
// `rows_out` (B, P, width) float32, aligned to its width of 2 floats (2-D
// on the uniform path: [du_0, du_1]) or 4 ([du..., gw], gw 0 on the
// uniform path, zeros after), or null on a single tile.
extern "C" int dprast_epilogue_rows(const void* buf, const void* ids,
                                    long long id_stride, const void* points,
                                    const void* ow, const void* pw,
                                    long long pw_stride, float s0, float s1,
                                    float s2, void* partials, void* rows_out,
                                    int width, int bsz, int n_out, int n_in,
                                    int n_points, long long s_pad,
                                    long long n_rows, int uniform,
                                    void* stream) {
  if (bad_shape(bsz, n_out, n_in, n_points) || n_rows < 1 ||
      n_rows > s_pad || (ids == nullptr) != (rows_out == nullptr) ||
      (rows_out != nullptr &&
       ((width != 2 && width != 4) || width < n_out + !uniform)))
    return (int)cudaErrorInvalidValue;
  const Scale scale{{s0, s1, s2}};
  DPRAST_EPILOGUE_DISPATCH(
      launch_rows, (const float*)buf, (const float*)ids, id_stride,
      (const float*)points, (const float*)ow, (const float*)pw, pw_stride,
      scale, (double*)partials, (float*)rows_out, width, bsz, n_points, n_in,
      s_pad, n_rows, uniform, (cudaStream_t)stream)
}

// E2.  `rows` the point-order rows: B4's rows on a single tile (pose
// stride (n_out + 1) s_pad, plane stride s_pad, point stride 1), E1's
// `rows_out` on several tiles (width P, 1, width); `rot` (B, n_out, n_in)
// contiguous; `partials` E1's, `n_blk` its blocks per pose.  Writes
// d_points (P, n_in), d_pw (P,), d_t (B, n_out), d_r (B, n_out, n_in) and
// d_ow (B,).
extern "C" int dprast_epilogue_points(
    const void* rows, long long pose_stride, long long plane_stride,
    int point_stride, const void* rot, const void* ow, const void* pw,
    long long pw_stride, float s0, float s1, float s2, const void* partials,
    int n_blk, void* d_points, void* d_pw, void* d_t, void* d_r, void* d_ow,
    int bsz, int n_out, int n_in, int n_points, int uniform, void* stream) {
  if (bad_shape(bsz, n_out, n_in, n_points) || n_blk < 1)
    return (int)cudaErrorInvalidValue;
  const Scale scale{{s0, s1, s2}};
  DPRAST_EPILOGUE_DISPATCH(
      launch_points, (const float*)rows, pose_stride, plane_stride,
      point_stride, (const float*)rot, (const float*)ow, (const float*)pw,
      pw_stride, scale, (const double*)partials, n_blk, (float*)d_points,
      (float*)d_pw, (float*)d_t, (float*)d_r, (float*)d_ow, bsz, n_points,
      n_in, uniform, (cudaStream_t)stream)
}
