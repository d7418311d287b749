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
// 340 MB at 1024^2 x 64 poses) is a little larger than the input.
//
// What the design does about it.  One block per (window row, tile,
// pose), one thread per window column: the reads of a cotangent row and
// the write of a window row are both coalesced.  The window keeps the
// natural (rows, cols) orientation, which is what B4 reads here; nothing
// is transposed.  Entries past the grid's last row or column are written
// as zeros.  It is a pure copy, so it is bit-equal to the plain twin.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
band_unfold_kernel(const float* __restrict__ g,  // (B, gy, gx)
                   float* __restrict__ win,      // (B, n0*n1, t0+1, t1+1)
                   int gy, int gx, int t0, int t1, int n1, int n_win_rows) {
  const int re = t0 + 1;
  const int ce = t1 + 1;
  const int tr = blockIdx.x;  // tile * re + r
  const int b = blockIdx.y;
  const int t = tr / re;
  const int r = tr - t * re;
  const int ty = t / n1;
  const int tx = t - ty * n1;
  const int y = ty * t0 + r;
  const float* grow = g + ((long long)b * gy + y) * gx;
  float* out = win + ((long long)b * n_win_rows + tr) * ce;
  const bool y_in = y < gy;
  for (int c = threadIdx.x; c < ce; c += blockDim.x) {
    const int x = tx * t1 + c;
    out[c] = (y_in && x < gx) ? grow[x] : 0.0f;
  }
}

}  // namespace

extern "C" int dprast_band_unfold(const void* g, void* win, int bsz, int gy,
                                  int gx, int t0, int t1, void* stream) {
  const int n0 = (gy + t0 - 1) / t0;
  const int n1 = (gx + t1 - 1) / t1;
  const int n_win_rows = n0 * n1 * (t0 + 1);
  const dim3 grid(n_win_rows, bsz);
  band_unfold_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (float*)win, gy, gx, t0, t1, n1, n_win_rows);
  return (int)cudaGetLastError();
}
