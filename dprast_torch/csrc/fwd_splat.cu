// B1: the forward splat of the binned backend, 2-D grids.
//
// Replaces the TPU kernel `_fwd_kernel` / `_fwd_kernel_live` of
// dprast/ops/splat_binned.py (launched by the `pl.pallas_call` in
// `_fwd_impl`).  That kernel runs one program per (pose, slot), builds a
// hat-function row matrix and two exact x one-hots, and accumulates their
// bf16-split product on the MXU into the tile's window, which stays
// resident in VMEM across consecutive slots of one tile.
//
// What bounds it here.  Per frame row the kernel reads 16-20 bytes of lane
// planes and issues four shared-memory float atomics; per (pose, tile) it
// zeroes and writes out one window of up to 128x128 fp32 (64 KB).  The
// atomics collide where the cloud is dense (a splat's four targets are
// neighbours, and a Gaussian cloud piles onto the centre), and on a
// multi-tile grid the window write-out (B x nt x 64 KB) is most of the
// device-memory traffic.  There is no matrix product: a bilinear splat is
// four multiply-adds per row, so the tensor cores have nothing to do.
//
// What the design does about it.
// - One block per (split, tile, pose) keeps the tile's window in dynamic
//   shared memory (64 KB, above the 48 KB default, hence the
//   cudaFuncSetAttribute call) and accumulates with shared atomics, so
//   no row touches device memory beyond its own lane entries.
// - Blocks run in no order, so the TPU's "first slot writes, later slots
//   add" becomes: a block owns all live slots of its tile, from the
//   [first, end) slot table the wrapper derives with searchsorted.
// - A single-tile grid has only B blocks of work (64 at the flagship size
//   on 132 SMs).  The wrapper therefore splits a tile's slots over
//   `nsplit` blocks (slot s goes to split (s - first) % nsplit), and each
//   split adds its partial window into a zeroed `ext` with one pass of
//   global atomics.  With nsplit == 1 (enough tiles to fill the card) the
//   window is stored directly and `ext` needs no zeroing.  The global
//   atomics were chosen over a second reduction pass because they cost
//   one read-modify-write per window entry and no scratch allocation.
// - Weights are formed in plain fp32 as (hy * w) * cx, the order of the
//   TPU kernel's products; the TPU's 2-term bf16 split is only a way to
//   get near-fp32 products out of the MXU and has no counterpart here.
//   Shared atomics reorder the fp32 sums from run to run.
// - Filler rows decode to row/column -3 and every target outside
//   [0, rows_e) x [0, cols_e) is dropped, as the TPU's one-hots never
//   match them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
fwd_splat_kernel(const float* __restrict__ lane,  // (B, L, s_pad)
                 const int* __restrict__ first,   // (B, nt)
                 const int* __restrict__ end,     // (B, nt)
                 float* __restrict__ ext,         // (B, nt, rows_e, cols_e)
                 int nt, int n_lane, long long s_pad, int chunk,
                 int rows_e, int cols_e, int nsplit) {
  extern __shared__ float win[];
  const int split = blockIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int n_win = rows_e * cols_e;
  for (int i = threadIdx.x; i < n_win; i += blockDim.x) win[i] = 0.0f;
  __syncthreads();

  const int s0 = first[b * nt + t] + split;
  const int s1 = end[b * nt + t];
  // slots s0, s0 + nsplit, ... < s1 belong to this block
  const int my_slots = s0 < s1 ? (s1 - s0 + nsplit - 1) / nsplit : 0;
  const long long n_rows = (long long)my_slots * chunk;
  const float* lb = lane + (long long)b * n_lane * s_pad;
  const float* p_iy = lb;
  const float* p_dly = lb + s_pad;
  const float* p_w = lb + 2 * s_pad;  // read only when n_lane == 5
  const float* p_dlx = lb + (long long)(n_lane - 2) * s_pad;
  const float* p_ix = lb + (long long)(n_lane - 1) * s_pad;
  const bool with_w = n_lane == 5;

  for (long long k = threadIdx.x; k < n_rows; k += blockDim.x) {
    const long long slot = s0 + (k / chunk) * nsplit;
    const long long row = slot * chunk + k % chunk;
    const int iy0 = (int)p_iy[row];
    const float dly = p_dly[row];
    const float dlx = p_dlx[row];
    const int ix0 = (int)p_ix[row];
    float hy0 = 1.0f - dly;
    float hy1 = dly;
    if (with_w) {
      const float w = p_w[row];
      hy0 = __fmul_rn(hy0, w);
      hy1 = __fmul_rn(hy1, w);
    }
    const float cx0 = 1.0f - dlx;
    const float cx1 = dlx;
    const bool y0 = iy0 >= 0 && iy0 < rows_e;
    const bool y1 = iy0 + 1 >= 0 && iy0 + 1 < rows_e;
    const bool x0 = ix0 >= 0 && ix0 < cols_e;
    const bool x1 = ix0 + 1 >= 0 && ix0 + 1 < cols_e;
    const int base = iy0 * cols_e + ix0;
    if (y0 && x0) atomicAdd(&win[base], __fmul_rn(hy0, cx0));
    if (y0 && x1) atomicAdd(&win[base + 1], __fmul_rn(hy0, cx1));
    if (y1 && x0) atomicAdd(&win[base + cols_e], __fmul_rn(hy1, cx0));
    if (y1 && x1) atomicAdd(&win[base + cols_e + 1], __fmul_rn(hy1, cx1));
  }
  __syncthreads();

  float* out = ext + ((long long)b * nt + t) * n_win;
  if (nsplit == 1) {
    for (int i = threadIdx.x; i < n_win; i += blockDim.x) out[i] = win[i];
  } else if (my_slots > 0) {
    for (int i = threadIdx.x; i < n_win; i += blockDim.x) {
      const float v = win[i];
      if (v != 0.0f) atomicAdd(&out[i], v);
    }
  }
}

}  // namespace

extern "C" int dprast_fwd_splat(const void* lane, const void* first,
                                const void* end, void* ext, int bsz, int nt,
                                int n_lane, long long s_pad, int chunk,
                                int rows_e, int cols_e, int nsplit,
                                void* stream) {
  const int smem = rows_e * cols_e * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_splat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nsplit, nt, bsz);
  fwd_splat_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)lane, (const int*)first, (const int*)end, (float*)ext,
      nt, n_lane, s_pad, chunk, rows_e, cols_e, nsplit);
  return (int)cudaGetLastError();
}

extern "C" const char* dprast_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
