// B3: the band unfold of the binned backend, 2-D multi-tile grids.
//
// Replaces the TPU kernel `kern` inside `_unfold_pl_2d` of
// dprast/ops/splat_binned.py.  That kernel fetches full-width 136-row
// cotangent bands through a four-deep DMA ring, carves the n1 windows of
// each tile row out of a band with static lane slices and `pltpu.roll`,
// masks them to zero outside the grid and writes them transposed for the
// TPU backward kernel.  The ring and the rolls exist only to meet the
// TPU's (8, 128) slice alignment, since windows start at multiples of 127.
//
// What bounds it here.  Device-memory bandwidth: every window entry is
// one copy of a cotangent voxel (or a zero), with no arithmetic.  The
// windows overlap by one voxel per axis, so the output (B x nt x 64 KB,
// 340 MB at 1024^2 x 64 poses) is a little larger than the input.  So
// what counts is how many bytes each SM keeps in flight, and how few
// instructions it spends per byte.
//
// What the design does about it (the band fold's, whose traffic is the
// same bytes the other way).  A window is 128 columns wide, the one width
// `tile_shape_for` gives a 2-D grid, and the kernel is written for it.
// - A thread copies two quads of one window row, each four consecutive
//   columns: it starts the loads of both together, before either is
//   stored, and writes each quad with one 128-bit store (a window row is
//   512 bytes and starts on 16).  Tile tx starts at x = 127 tx of the
//   cotangent row, which is on a 16-byte boundary only for every fourth
//   tile, so the loads stay 4 bytes wide; neighbouring threads read
//   neighbouring 16-byte pieces of the row.
// - A block of 128 threads holds 8 window rows of 16 threads, one block
//   per 8 (tile, window row) pairs of one pose (blockIdx.y, plus 65,535
//   blockIdx.z past 65,535 poses: poses.cuh): the tile, its row and the
//   `y < gy` test are worked out once per row, not per voxel, in 32-bit
//   arithmetic.  A looping grid of a fixed number of blocks per SM, the
//   band fold's, measured slower here the fewer blocks it had: the rows
//   are short, and many small blocks keep more of them in flight.
// - The zero fill past the grid's last row or column is the rare branch:
//   a row past the grid stores zeros without a load, a quad that crosses
//   the grid's last column goes voxel by voxel.
// - The window keeps the natural (rows, cols) orientation, which is what
//   B4 reads here; nothing is transposed.  It is a pure copy, so it is
//   bit-equal to the plain twin.

#include <cuda_runtime.h>

#include "poses.cuh"

namespace {

constexpr int kThreads = 128;
// columns of a window: t1 + 1
constexpr int kCols = 128;
// columns per quad: one 128-bit store
constexpr int kQuad = 4;
// quads per thread, their loads started together
constexpr int kUnroll = 2;
// threads on one window row, and window rows of a block
constexpr int kRowThreads = kCols / kQuad / kUnroll;
constexpr int kRows = kThreads / kRowThreads;

__global__ void __launch_bounds__(kThreads)
band_unfold_kernel(const float* __restrict__ g,  // (B, gy, gx)
                   float* __restrict__ win,      // (B, n0*n1, t0+1, kCols)
                   int bsz, int gy, int gx, int t0, int n1,
                   int n_win_rows) {
  constexpr int t1 = kCols - 1;
  const int re = t0 + 1;
  const int my_row = threadIdx.x / kRowThreads;
  const int my_quad = threadIdx.x - my_row * kRowThreads;
  const int b = pose_of(blockIdx.y, blockIdx.z);
  if (b >= bsz) return;  // past the last pose: the whole block
  const float* gb = g + (long long)b * gy * gx;
  float* wb = win + (long long)b * n_win_rows * kCols;

  // tr = tile * re + r, a window row of the pose
  const int tr = blockIdx.x * kRows + my_row;
  if (tr < n_win_rows) {
    const int t = tr / re;
    const int r = tr - t * re;
    const int ty = t / n1;
    const int tx = t - ty * n1;
    const int y = ty * t0 + r;
    const bool y_in = y < gy;
    // the window row's first voxel; read only where y_in
    const int xb = tx * t1;
    const float* grow = gb + (long long)y * gx + xb;
    float* out = wb + (long long)tr * kCols;

    float v[kUnroll][kQuad];
    bool whole[kUnroll];
    // the loads of every quad that lies inside the grid, started together
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c0 = (my_quad + u * kRowThreads) * kQuad;
      whole[u] = y_in && xb + c0 + kQuad <= gx;
      if (whole[u]) {
#pragma unroll
        for (int j = 0; j < kQuad; ++j) v[u][j] = grow[c0 + j];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c0 = (my_quad + u * kRowThreads) * kQuad;
      if (!whole[u]) {
        // a row past the grid, or a quad across its last column
#pragma unroll
        for (int j = 0; j < kQuad; ++j)
          v[u][j] = (y_in && xb + c0 + j < gx) ? grow[c0 + j] : 0.0f;
      }
      *reinterpret_cast<float4*>(out + c0) =
          make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
    }
  }
}

}  // namespace

// `win` is 16-byte aligned; t1 + 1 == 128 and n0 * n1 * (t0 + 1) < 2^30.
extern "C" int dprast_band_unfold(const void* g, void* win, int bsz, int gy,
                                  int gx, int t0, int t1, void* stream) {
  if (t1 + 1 != kCols) return (int)cudaErrorInvalidValue;
  const int n0 = (gy + t0 - 1) / t0;
  const int n1 = (gx + t1 - 1) / t1;
  const int n_win_rows = n0 * n1 * (t0 + 1);
  const dim3 grid((n_win_rows + kRows - 1) / kRows, pose_low(bsz),
                  pose_high(bsz));
  band_unfold_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (float*)win, bsz, gy, gx, t0, n1, n_win_rows);
  return (int)cudaGetLastError();
}
