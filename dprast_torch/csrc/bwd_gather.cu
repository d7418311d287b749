// B4: the backward gather of the binned backend, 2-D grids.
//
// Replaces the TPU kernel `_bwd_kernel` / `_bwd_kernel_live` of
// dprast/ops/splat_binned.py (launched by the `pl.pallas_call` in
// `_pullback_from_frame`).  That kernel runs one program per (pose, slot),
// splits the transposed cotangent window into two bf16 terms, gathers the
// two stencil rows of every frame row with exact one-hot matmuls on the
// MXU, and reduces over x with masked row sums; dead slots write zeros.
//
// What bounds it here.  Per frame row the kernel reads 16 bytes of lane
// planes, makes four window reads and writes 12 bytes of gradient rows;
// per (pose, tile) it loads one window of up to 128x128 fp32 (64 KB).  So
// it is bound by device-memory traffic (the lane and gradient rows, and
// at one tile per pose the window loads are few), and by the latency of
// the scattered window reads.  There is no matrix product: the one-hot
// matmuls existed only because the TPU gathers through its MXU.
//
// What the design does about it.
// - One block per (split, tile, pose) stages the tile's window in
//   dynamic shared memory (64 KB, hence the cudaFuncSetAttribute call),
//   so the four reads of every row hit shared memory, and loops over the
//   tile's live slots, from the [first, end) slot table the wrapper
//   derives with searchsorted (as B1 does).
// - Output rows are disjoint, so a tile's slots can be split over
//   `nsplit` blocks (slot s goes to split (s - first) % nsplit) with no
//   atomics; the wrapper splits where there are too few (pose, tile)
//   blocks to fill the card (the single-tile flagship: 64 of them).
// - Range `nt` of the slot table holds the dead slots (at or past
//   n_live): its blocks write exact zeros, because those rows still ride
//   the unsort.  So the output needs no memset.
// - The window reads are plain fp32 loads, exact, where the TPU's
//   two-term bf16 split kept about 16 bits of the cotangent.
// - Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
//   __fsub_rn) in the plain twin's order, so nvcc contracts nothing into
//   an FMA and the card gives the twin's bits.
// - Out-of-window neighbours (filler rows decode to row/column -3) read 0,
//   as the TPU's one-hots match nothing there.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bwd_gather_kernel(const float* __restrict__ lane,   // (B, 4, s_pad)
                  const int* __restrict__ first,    // (B, nt + 1)
                  const int* __restrict__ end,      // (B, nt + 1)
                  const float* __restrict__ win,    // (B, nt, rows_e, cols_e)
                  float* __restrict__ buf,          // (B, 3, s_pad)
                  int nt, long long s_pad, int chunk, int rows_e,
                  int cols_e, int nsplit) {
  extern __shared__ float w[];
  const int split = blockIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = first[b * (nt + 1) + t] + split;
  const int s1 = end[b * (nt + 1) + t];
  // slots s0, s0 + nsplit, ... < s1 belong to this block
  const int my_slots = s0 < s1 ? (s1 - s0 + nsplit - 1) / nsplit : 0;
  if (my_slots == 0) return;  // the same for the whole block
  const long long n_rows = (long long)my_slots * chunk;
  float* o_dy = buf + (long long)b * 3 * s_pad;
  float* o_dx = o_dy + s_pad;
  float* o_gw = o_dy + 2 * s_pad;

  if (t == nt) {  // dead slots
    for (long long k = threadIdx.x; k < n_rows; k += blockDim.x) {
      const long long row = (s0 + (k / chunk) * nsplit) * chunk + k % chunk;
      o_dy[row] = 0.0f;
      o_dx[row] = 0.0f;
      o_gw[row] = 0.0f;
    }
    return;
  }

  const int n_win = rows_e * cols_e;
  const float* wb = win + ((long long)b * nt + t) * n_win;
  for (int i = threadIdx.x; i < n_win; i += blockDim.x) w[i] = wb[i];
  __syncthreads();

  const float* lb = lane + (long long)b * 4 * s_pad;
  const float* p_iy = lb;
  const float* p_dly = lb + s_pad;
  const float* p_ix = lb + 2 * s_pad;
  const float* p_dlx = lb + 3 * s_pad;
  for (long long k = threadIdx.x; k < n_rows; k += blockDim.x) {
    const long long row = (s0 + (k / chunk) * nsplit) * chunk + k % chunk;
    const int iy0 = (int)p_iy[row];
    const float dly = p_dly[row];
    const int ix0 = (int)p_ix[row];
    const float dlx = p_dlx[row];
    const bool y0 = iy0 >= 0 && iy0 < rows_e;
    const bool y1 = iy0 + 1 >= 0 && iy0 + 1 < rows_e;
    const bool x0 = ix0 >= 0 && ix0 < cols_e;
    const bool x1 = ix0 + 1 >= 0 && ix0 + 1 < cols_e;
    const int r0 = iy0 * cols_e;
    const int r1 = r0 + cols_e;
    const float p00 = (y0 && x0) ? w[r0 + ix0] : 0.0f;
    const float p01 = (y0 && x1) ? w[r0 + ix0 + 1] : 0.0f;
    const float p10 = (y1 && x0) ? w[r1 + ix0] : 0.0f;
    const float p11 = (y1 && x1) ? w[r1 + ix0 + 1] : 0.0f;
    const float omy = __fsub_rn(1.0f, dly);
    const float a = __fadd_rn(__fmul_rn(omy, p00), __fmul_rn(dly, p10));
    const float c = __fadd_rn(__fmul_rn(omy, p01), __fmul_rn(dly, p11));
    const float omx = __fsub_rn(1.0f, dlx);
    o_gw[row] = __fadd_rn(__fmul_rn(a, omx), __fmul_rn(c, dlx));
    o_dy[row] = __fadd_rn(__fmul_rn(__fsub_rn(p10, p00), omx),
                          __fmul_rn(__fsub_rn(p11, p01), dlx));
    o_dx[row] = __fsub_rn(c, a);
  }
}

}  // namespace

extern "C" int dprast_bwd_gather(const void* lane, const void* first,
                                 const void* end, const void* win, void* buf,
                                 int bsz, int nt, long long s_pad, int chunk,
                                 int rows_e, int cols_e, int nsplit,
                                 void* stream) {
  const int smem = rows_e * cols_e * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nsplit, nt + 1, bsz);
  bwd_gather_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)lane, (const int*)first, (const int*)end,
      (const float*)win, (float*)buf, nt, s_pad, chunk, rows_e, cols_e,
      nsplit);
  return (int)cudaGetLastError();
}
