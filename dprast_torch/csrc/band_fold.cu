// B2: the band fold of the binned backend, 2-D multi-tile grids.
//
// Replaces the TPU kernel `kern` inside `_fold_pl_2d` of
// dprast/ops/splat_binned.py.  That kernel assembles 128-row output bands
// from the overlapping 128x128 tile windows in a VMEM scratch and places
// them with `pltpu.roll`, machinery that exists only to meet the TPU's
// (8, 128) slice alignment, and fuses the per-pose `* ow + bg` epilogue.
//
// What bounds it here.  Device-memory bandwidth: each output voxel reads
// one window entry (up to four on the 1-voxel halo lines) and writes one
// value; there is no reuse to exploit and almost no arithmetic.
//
// What the design does about it.  One thread per output voxel (b, y, x),
// with neighbouring threads on neighbouring x, so the reads of a window
// row and the write of the output row are both coalesced.  The voxel's
// body entry is ext[ty, tx, y - 127 ty, x - 127 tx]; on the first row
// (column) of a body tile it also adds the halo row (column) of the
// previous tile, and the corner where both meet.  The grid is written
// directly at (B, gy, gx): no padded output to slice.  The sums run in
// the order of the plain fold, (body + y halo) + (x halo + corner), and
// the epilogue is rounded multiply then add, so the result is bit-equal
// to the plain twin.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
band_fold_kernel(const float* __restrict__ ext,  // (B, n0*n1, t0+1, t1+1)
                 const float* __restrict__ ow,   // (B,)
                 const float* __restrict__ bg,   // (B,)
                 float* __restrict__ out,        // (B, gy, gx)
                 int gy, int gx, int t0, int t1) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= gx) return;
  const int n0 = (gy + t0 - 1) / t0;
  const int n1 = (gx + t1 - 1) / t1;
  const int re = t0 + 1;
  const int ce = t1 + 1;
  const int ty = y / t0;
  const int ry = y - ty * t0;
  const int tx = x / t1;
  const int rx = x - tx * t1;
  const float* eb = ext + (long long)b * n0 * n1 * re * ce;
  auto at = [&](int ty_, int tx_, int r, int c) {
    return eb[(((long long)ty_ * n1 + tx_) * re + r) * ce + c];
  };
  const bool y_halo = ry == 0 && ty > 0;
  const bool x_halo = rx == 0 && tx > 0;
  const float body = at(ty, tx, ry, rx);
  const float hy = y_halo ? at(ty - 1, tx, t0, rx) : 0.0f;
  const float hx = x_halo ? at(ty, tx - 1, ry, t1) : 0.0f;
  const float hxy = (x_halo && y_halo) ? at(ty - 1, tx - 1, t0, t1) : 0.0f;
  const float s = __fadd_rn(__fadd_rn(body, hy), __fadd_rn(hx, hxy));
  out[((long long)b * gy + y) * gx + x] = __fadd_rn(__fmul_rn(s, ow[b]),
                                                    bg[b]);
}

}  // namespace

extern "C" int dprast_band_fold(const void* ext, const void* ow,
                                const void* bg, void* out, int bsz, int gy,
                                int gx, int t0, int t1, void* stream) {
  const dim3 grid((gx + kThreads - 1) / kThreads, gy, bsz);
  band_fold_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ext, (const float*)ow, (const float*)bg, (float*)out, gy,
      gx, t0, t1);
  return (int)cudaGetLastError();
}
