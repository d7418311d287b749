// B1: the forward splat of the binned backend, 2-D and 3-D grids.
//
// Replaces the TPU kernel `_fwd_kernel` / `_fwd_kernel_live` of
// dprast/ops/splat_binned.py (launched by the `pl.pallas_call` in
// `_fwd_impl`), both its 2-D branch and its 3-D branch.  That kernel runs
// one program per (pose, slot), builds a hat-function row matrix (in 3-D
// the separable product of a z hat and a y hat over the flattened (z, y)
// window rows) and two exact x one-hots, and accumulates their bf16-split
// product on the MXU into the tile's window, which stays resident in VMEM
// across consecutive slots of one tile.
//
// What bounds it here.  Per frame row the kernel reads 16-20 bytes (2-D)
// or 24-28 bytes (3-D) of lane planes and issues four (2-D) or eight
// (3-D) shared-memory float atomics; per (pose, tile) it zeroes and
// writes out one window of up to 128x128 fp32 (64 KB).  The atomics
// collide where the cloud is dense (a splat's targets are neighbours, and
// a Gaussian cloud piles onto the centre), and on a multi-tile grid the
// window write-out (B x nt x 64 KB, 22 MB for one pose at 128^3) is most
// of the device-memory traffic.  In 3-D the work is uneven: a tile is a
// 7 x 15 x 127 voxel slab, a 0.4-sigma cloud puts ~2.5% of its points in
// each central slab and none in the corner ones, so a few blocks carry
// the kernel's time.  There is no matrix product: a multilinear splat is
// 2^n multiply-adds per row, so the tensor cores have nothing to do.
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
//   global atomics.  With nsplit == 1 (enough tiles to fill the card, as
//   at 128^3's 342 tiles) the window is stored directly and `ext` needs
//   no zeroing.  The global atomics were chosen over a second reduction
//   pass because they cost one read-modify-write per window entry and no
//   scratch allocation.  The uneven 3-D tiles are left as they are.
// - The 3-D window is the TPU's: rows are the flattened z * ny + y (ny =
//   16, nz = 8), columns x.  Targets are masked per axis, not by flat
//   row: a row with iy0 = -1 (a point just below the tile's y range)
//   would otherwise alias into row ny - 1 of the z plane below.
// - Weights are formed in plain fp32 as (hy * w) * cx in 2-D and
//   ((hz * hy) * w) * cx in 3-D, the order of the TPU kernel's products;
//   the TPU's 2-term bf16 split is only a way to get near-fp32 products
//   out of the MXU and has no counterpart here.  Shared atomics reorder
//   the fp32 sums from run to run.
// - Filler rows decode to -3 on every axis and every target outside the
//   window is dropped, as the TPU's one-hots never match them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

template <int kNOut>
__global__ void __launch_bounds__(kThreads)
fwd_splat_kernel(const float* __restrict__ lane,  // (B, L, s_pad)
                 const int* __restrict__ first,   // (B, nt)
                 const int* __restrict__ end,     // (B, nt)
                 float* __restrict__ ext,         // (B, nt, rows_e, cols_e)
                 int nt, int n_lane, long long s_pad, int chunk, int ny,
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
  // [iz0, dlz,] iy0, dly, (w,) dlx, ix0
  const float* p_iz = lb;
  const float* p_dlz = lb + s_pad;
  const float* p_iy = lb + (long long)(2 * kNOut - 4) * s_pad;
  const float* p_dly = p_iy + s_pad;
  const float* p_w = p_dly + s_pad;  // read only with a weight plane
  const float* p_dlx = lb + (long long)(n_lane - 2) * s_pad;
  const float* p_ix = lb + (long long)(n_lane - 1) * s_pad;
  const bool with_w = n_lane == 2 * kNOut + 1;
  const int nz = rows_e / ny;

  for (long long k = threadIdx.x; k < n_rows; k += blockDim.x) {
    const long long slot = s0 + (k / chunk) * nsplit;
    const long long row = slot * chunk + k % chunk;
    const int iy0 = (int)p_iy[row];
    const float dly = p_dly[row];
    const float dlx = p_dlx[row];
    const int ix0 = (int)p_ix[row];
    const float cx0 = 1.0f - dlx;
    const float cx1 = dlx;
    const bool x0 = ix0 >= 0 && ix0 < cols_e;
    const bool x1 = ix0 + 1 >= 0 && ix0 + 1 < cols_e;
    // the (z, y) stencil rows in the order (0,0), (0,1), (1,0), (1,1);
    // 2-D has only the two y rows
    constexpr int kRows = kNOut == 3 ? 4 : 2;
    float h[kRows];
    int r[kRows];
    bool ok[kRows];
    if constexpr (kNOut == 3) {
      const int iz0 = (int)p_iz[row];
      const float dlz = p_dlz[row];
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
    const float w = with_w ? p_w[row] : 1.0f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (!ok[i]) continue;
      const float hw = with_w ? __fmul_rn(h[i], w) : h[i];
      const int base = r[i] * cols_e + ix0;
      if (x0) atomicAdd(&win[base], __fmul_rn(hw, cx0));
      if (x1) atomicAdd(&win[base + 1], __fmul_rn(hw, cx1));
    }
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

template <int kNOut>
int launch(const void* lane, const void* first, const void* end, void* ext,
           int bsz, int nt, int n_lane, long long s_pad, int chunk, int ny,
           int rows_e, int cols_e, int nsplit, void* stream) {
  const int smem = rows_e * cols_e * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_splat_kernel<kNOut>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nsplit, nt, bsz);
  fwd_splat_kernel<kNOut><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)lane, (const int*)first, (const int*)end, (float*)ext,
      nt, n_lane, s_pad, chunk, ny, rows_e, cols_e, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// `ny` is the window's y extent: the number of its rows in 2-D, the rows
// of one z plane in 3-D (rows_e / ny z planes).
extern "C" int dprast_fwd_splat(const void* lane, const void* first,
                                const void* end, void* ext, int bsz, int nt,
                                int n_out, int n_lane, long long s_pad,
                                int chunk, int ny, int rows_e, int cols_e,
                                int nsplit, void* stream) {
  if (n_out == 3)
    return launch<3>(lane, first, end, ext, bsz, nt, n_lane, s_pad, chunk,
                     ny, rows_e, cols_e, nsplit, stream);
  if (n_out == 2)
    return launch<2>(lane, first, end, ext, bsz, nt, n_lane, s_pad, chunk,
                     ny, rows_e, cols_e, nsplit, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dprast_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
