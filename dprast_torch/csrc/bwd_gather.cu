// B4: the backward gather of the binned backend, 2-D and 3-D grids.
//
// Replaces the TPU kernel `_bwd_kernel` / `_bwd_kernel_live` of
// dprast/ops/splat_binned.py (launched by the `pl.pallas_call` in
// `_pullback_from_frame`), both its 2-D branch and its 3-D branch, at
// terms=2 (here fp32) and terms=1 (the `binned_bf16` fast mode).  It also
// replaces the B4 variants of the TPU harness: the standalone launch
// `bwd_kernel` of benchmarks/profile_binned.py, `_kernel_absums` of
// benchmarks/exp_xsel.py (one tile, transposed cotangent), and
// `_bwd_kernel_orient` / `_bwd_kernel_presplit` of benchmarks/exp_band.py
// (transposed or natural windows; windows split into a bf16 pair before
// the kernel), all at terms=2.  That kernel runs one program per (pose,
// slot), splits the transposed
// cotangent window into two bf16 terms, gathers the stencil rows of every
// frame row (two in 2-D, the four flat (z, y) rows in 3-D) with exact
// one-hot matmuls on the MXU, combines them with the y (and z) weights,
// and reduces over x with masked row sums; dead slots write zeros.
//
// What bounds it here.  Per frame row the kernel reads 16 bytes (2-D) or
// 32 bytes (3-D) of lane planes, makes four or eight window reads and
// writes 12 or 16 bytes of gradient rows; per (pose, tile) it loads one
// window of up to 128x128 fp32 (64 KB).  So it is bound by device-memory
// traffic (the lane and gradient rows, and the window loads: 22 MB for
// one pose at 128^3's 342 tiles), and by the latency of the scattered
// window reads.  In 3-D the work per block is uneven (B1's note: a few
// central slabs hold most rows).  There is no matrix product: the one-hot
// matmuls existed only because the TPU gathers through its MXU.
//
// What the design does about it.
// - One block per (split, tile, pose) stages the tile's window in
//   dynamic shared memory (64 KB, hence the cudaFuncSetAttribute call),
//   so every read of a row hits shared memory, and loops over the tile's
//   live slots, from the [first, end) slot table the wrapper derives with
//   searchsorted (as B1 does).
// - Output rows are disjoint, so a tile's slots can be split over
//   `nsplit` blocks (slot s goes to split (s - first) % nsplit) with no
//   atomics; the wrapper splits where there are too few (pose, tile)
//   blocks to fill the card (the single-tile flagship: 64 of them).
// - Range `nt` of the slot table holds the dead slots (at or past
//   n_live): its blocks write exact zeros into all n_out + 1 planes,
//   because those rows still ride the unsort.  So the output needs no
//   memset.
// - The window reads are plain fp32 loads, exact, where the TPU's
//   two-term bf16 split kept about 16 bits of the cotangent.  The TPU's
//   rounding is a template parameter applied once, while the window is
//   staged into shared memory: kTerms = 1 (the fast mode) stages bf16(g),
//   kTerms = 2 (the harness variants) stages hi + lo with hi = bf16(g) and
//   lo = bf16(g - hi), which is exact in fp32 and so equals the TPU's two
//   one-hot matmul parts added (gathering hi and lo apart and adding later
//   would round differently).  Everything after the staging is the same
//   for every instance.
// - kLayout says how the window lies in device memory: natural (rows_e,
//   cols_e) fp32, which B3 writes; transposed (cols_e, rows_e) fp32, what
//   the TPU's NN contraction reads; or presplit, two transposed bf16
//   windows (hi, lo) staged as hi + lo.  The staging copies the window as
//   it lies (coalesced) and the reads index it in that layout, so the
//   layouts differ only in the read address.
// - 3-D reads the flat rows the lane planes carry; a row outside the
//   window on z or y arrives as -9 and reads 0, so no row aliases into
//   another z plane.
// - Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
//   __fsub_rn) in the plain twin's order, so nvcc contracts nothing into
//   an FMA and the card gives the twin's bits.
// - Out-of-window neighbours (filler rows decode to -3 on every axis)
//   read 0, as the TPU's one-hots match nothing there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// how the window lies in device memory (see the notes above)
enum Layout { kNatural = 0, kTransposed = 1, kPresplit = 2 };

// a * b + c * d, each product and the sum rounded on its own
__device__ __forceinline__ float lerp2(float a, float b, float c, float d) {
  return __fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// a cotangent value as the gather reads it: fp32, or its kTerms-part bf16
// split (round to nearest even) added back, which is exact
template <int kTerms>
__device__ __forceinline__ float split(float v) {
  if constexpr (kTerms == 0) {
    return v;
  } else {
    const float hi = __bfloat162float(__float2bfloat16_rn(v));
    if constexpr (kTerms == 1)
      return hi;
    else
      return __fadd_rn(
          hi, __bfloat162float(__float2bfloat16_rn(__fsub_rn(v, hi))));
  }
}

template <int kNOut, int kTerms, int kLayout>
__global__ void __launch_bounds__(kThreads)
bwd_gather_kernel(const float* __restrict__ lane,   // (B, 4 | 8, s_pad)
                  const int* __restrict__ first,    // (B, nt + 1)
                  const int* __restrict__ end,      // (B, nt + 1)
                  const void* __restrict__ win,     // (B, nt, rows_e, cols_e)
                                                    // or (.., cols_e, rows_e)
                  const void* __restrict__ win_lo,  // presplit: the lo part
                  float* __restrict__ buf,          // (B, n_out + 1, s_pad)
                  int nt, long long s_pad, int chunk, int rows_e,
                  int cols_e, int nsplit) {
  constexpr int kLane = kNOut == 3 ? 8 : 4;
  extern __shared__ float w[];
  const int split_id = blockIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = first[b * (nt + 1) + t] + split_id;
  const int s1 = end[b * (nt + 1) + t];
  // slots s0, s0 + nsplit, ... < s1 belong to this block
  const int my_slots = s0 < s1 ? (s1 - s0 + nsplit - 1) / nsplit : 0;
  if (my_slots == 0) return;  // the same for the whole block
  const long long n_rows = (long long)my_slots * chunk;
  // [du_z,] du_y, du_x, gw
  float* out = buf + (long long)b * (kNOut + 1) * s_pad;

  if (t == nt) {  // dead slots
    for (long long k = threadIdx.x; k < n_rows; k += blockDim.x) {
      const long long row = (s0 + (k / chunk) * nsplit) * chunk + k % chunk;
#pragma unroll
      for (int i = 0; i <= kNOut; ++i) out[i * s_pad + row] = 0.0f;
    }
    return;
  }

  // stage the window as it lies, applying the split once
  const int n_win = rows_e * cols_e;
  const long long off = ((long long)b * nt + t) * n_win;
  if constexpr (kLayout == kPresplit) {
    const __nv_bfloat16* hi = (const __nv_bfloat16*)win + off;
    const __nv_bfloat16* lo = (const __nv_bfloat16*)win_lo + off;
    for (int i = threadIdx.x; i < n_win; i += blockDim.x)
      w[i] = __fadd_rn(__bfloat162float(hi[i]), __bfloat162float(lo[i]));
  } else {
    const float* wb = (const float*)win + off;
    for (int i = threadIdx.x; i < n_win; i += blockDim.x)
      w[i] = split<kTerms>(wb[i]);
  }
  __syncthreads();
  // the staged index of window entry (r, c)
  auto at = [rows_e, cols_e](int r, int c) {
    return kLayout == kNatural ? r * cols_e + c : c * rows_e + r;
  };

  const float* lb = lane + (long long)b * kLane * s_pad;
  for (long long k = threadIdx.x; k < n_rows; k += blockDim.x) {
    const long long row = (s0 + (k / chunk) * nsplit) * chunk + k % chunk;
    const int ix0 = (int)lb[(kLane - 2) * s_pad + row];
    const float dlx = lb[(kLane - 1) * s_pad + row];
    const bool x0 = ix0 >= 0 && ix0 < cols_e;
    const bool x1 = ix0 + 1 >= 0 && ix0 + 1 < cols_e;
    const float omx = __fsub_rn(1.0f, dlx);
    // the value at columns ix0 (a) and ix0 + 1 (c), and the pre-terms of
    // the row-axis derivatives there
    float a, c;
    if constexpr (kNOut == 3) {
      // flat rows r00, r01, r10, r11 (-9 where z or y leaves the window)
      float plo[4], phi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (int)lb[i * s_pad + row];
        const bool rok = r >= 0 && r < rows_e;
        plo[i] = (rok && x0) ? w[at(r, ix0)] : 0.0f;
        phi[i] = (rok && x1) ? w[at(r, ix0 + 1)] : 0.0f;
      }
      const float dlz = lb[4 * s_pad + row];
      const float dly = lb[5 * s_pad + row];
      const float omy = __fsub_rn(1.0f, dly);
      const float omz = __fsub_rn(1.0f, dlz);
      float dz[2], dy[2], v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* p = j == 0 ? plo : phi;
        const float y0 = lerp2(omy, p[0], dly, p[1]);
        const float y1 = lerp2(omy, p[2], dly, p[3]);
        v[j] = lerp2(omz, y0, dlz, y1);
        dz[j] = __fsub_rn(y1, y0);
        dy[j] = lerp2(omz, __fsub_rn(p[1], p[0]), dlz, __fsub_rn(p[3], p[2]));
      }
      a = v[0];
      c = v[1];
      out[row] = lerp2(dz[0], omx, dz[1], dlx);
      out[s_pad + row] = lerp2(dy[0], omx, dy[1], dlx);
    } else {
      const int iy0 = (int)lb[row];
      const float dly = lb[s_pad + row];
      const bool y0 = iy0 >= 0 && iy0 < rows_e;
      const bool y1 = iy0 + 1 >= 0 && iy0 + 1 < rows_e;
      const float p00 = (y0 && x0) ? w[at(iy0, ix0)] : 0.0f;
      const float p01 = (y0 && x1) ? w[at(iy0, ix0 + 1)] : 0.0f;
      const float p10 = (y1 && x0) ? w[at(iy0 + 1, ix0)] : 0.0f;
      const float p11 = (y1 && x1) ? w[at(iy0 + 1, ix0 + 1)] : 0.0f;
      const float omy = __fsub_rn(1.0f, dly);
      a = lerp2(omy, p00, dly, p10);
      c = lerp2(omy, p01, dly, p11);
      out[row] = lerp2(__fsub_rn(p10, p00), omx, __fsub_rn(p11, p01), dlx);
    }
    out[(kNOut - 1) * s_pad + row] = __fsub_rn(c, a);
    out[kNOut * s_pad + row] = lerp2(a, omx, c, dlx);
  }
}

template <int kNOut, int kTerms, int kLayout>
int launch(const void* lane, const void* first, const void* end,
           const void* win, const void* win_lo, void* buf, int bsz, int nt,
           long long s_pad, int chunk, int rows_e, int cols_e, int nsplit,
           void* stream) {
  const int smem = rows_e * cols_e * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_gather_kernel<kNOut, kTerms, kLayout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nsplit, nt + 1, bsz);
  bwd_gather_kernel<kNOut, kTerms, kLayout>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)lane, (const int*)first, (const int*)end, win, win_lo,
      (float*)buf, nt, s_pad, chunk, rows_e, cols_e, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// `rows_e` and `cols_e` are the window's natural extents whatever its
// layout; `terms` is 0 (fp32), 1 (the bf16 fast mode) or 2 (the harness's
// two-part split); `layout` a `Layout`.  `win_lo` is read only by the
// presplit layout.  Only the instances the package uses exist.
extern "C" int dprast_bwd_gather(const void* lane, const void* first,
                                 const void* end, const void* win,
                                 const void* win_lo, void* buf, int bsz,
                                 int nt, int n_out, long long s_pad,
                                 int chunk, int rows_e, int cols_e,
                                 int nsplit, int terms, int layout,
                                 void* stream) {
#define DPRAST_LAUNCH(N, T, L)                                              \
  if (n_out == N && terms == T && layout == L)                              \
    return launch<N, T, L>(lane, first, end, win, win_lo, buf, bsz, nt,     \
                           s_pad, chunk, rows_e, cols_e, nsplit, stream);
  DPRAST_LAUNCH(2, 0, kNatural)
  DPRAST_LAUNCH(3, 0, kNatural)
  DPRAST_LAUNCH(2, 1, kNatural)
  DPRAST_LAUNCH(3, 1, kNatural)
  DPRAST_LAUNCH(2, 2, kNatural)
  DPRAST_LAUNCH(2, 2, kTransposed)
  DPRAST_LAUNCH(2, 2, kPresplit)
#undef DPRAST_LAUNCH
  return (int)cudaErrorInvalidValue;
}
