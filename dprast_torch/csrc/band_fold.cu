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
// value; there is no reuse to exploit and almost no arithmetic.  So what
// counts is how many bytes each SM keeps in flight.
//
// What the design does about it.
// - A thread produces two quads of one output row, each four consecutive
//   x: it starts its eight body loads together, before any is used, and
//   writes each quad with one 128-bit store where gx is a multiple of 4
//   (every row then starts on 16 bytes); otherwise with scalar stores.
//   The body of tile tx starts at x = 127 tx, which is on a 16-byte
//   boundary of its window row only for every fourth tile, so the loads
//   stay 4 bytes wide (two aligned 128-bit loads and a shift measured
//   slower); neighbouring threads read neighbouring 16-byte pieces of a
//   window row.
// - A block of 128 threads is cut into `rows_per_block` output rows by
//   128 / rows_per_block threads (one row of 256 quads at gx = 1024, more
//   rows on a narrow grid), and a fixed number of such blocks per SM loop
//   over all (pose, row) pairs: the pose, the tile row and the y halo
//   test are worked out once per row, not per voxel.
// - The halo row, the halo column and their corner are rare branches: a
//   row takes the y halo on the first row of a body tile (1 in 127), a
//   quad that holds a tile's first column or straddles two tiles takes
//   the per-voxel path (about 1 quad in 16).
// - The grid is written directly at (B, gy, gx): no padded output to
//   slice.  The sums run in the order of the plain fold, (body + y halo)
//   + (x halo + corner), and the epilogue is rounded multiply then add
//   (__fmul_rn, __fadd_rn), so the result is bit-equal to the plain twin.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// x per quad: one 128-bit store
constexpr int kQuad = 4;
// quads per thread and step, their loads started together
constexpr int kUnroll = 2;
// blocks per SM of the looping grid
constexpr int kWaves = 64;

__global__ void __launch_bounds__(kThreads)
band_fold_kernel(const float* __restrict__ ext,  // (B, n0*n1, t0+1, t1+1)
                 const float* __restrict__ ow,   // (B,)
                 const float* __restrict__ bg,   // (B,)
                 float* __restrict__ out,        // (B, gy, gx)
                 int bsz, int gy, int gx, int t0, int t1,
                 int rows_per_block) {
  const int n0 = (gy + t0 - 1) / t0;
  const int n1 = (gx + t1 - 1) / t1;
  const int re = t0 + 1;
  const int ce = t1 + 1;
  const long long tile = (long long)re * ce;
  const int quads = (gx + kQuad - 1) / kQuad;
  const int quads_per_block = kThreads / rows_per_block;
  const int my_row = threadIdx.x / quads_per_block;
  const int my_quad = threadIdx.x - my_row * quads_per_block;
  const bool vec = gx % kQuad == 0;
  const long long n_rows = (long long)bsz * gy;

  for (long long row = (long long)blockIdx.x * rows_per_block + my_row;
       row < n_rows; row += (long long)gridDim.x * rows_per_block) {
    const int b = (int)(row / gy);
    const int y = (int)(row - (long long)b * gy);
    const int ty = y / t0;
    const int ry = y - ty * t0;
    const bool y_halo = ry == 0 && ty > 0;
    const float owb = ow[b];
    const float bgb = bg[b];
    // window row ry of tile row ty, and the halo row of the tile row above
    const float* body_row =
        ext + ((long long)b * n0 * n1 + (long long)ty * n1) * tile +
        (long long)ry * ce;
    const float* halo_row = body_row - (long long)n1 * tile +
                            (long long)(t0 - ry) * ce;
    float* out_row = out + row * gx;

    for (int q0 = my_quad; q0 < quads; q0 += quads_per_block * kUnroll) {
      float s[kUnroll][kQuad];
      bool plain[kUnroll];
      // the body loads of every quad that lies in one tile and holds
      // none of its halo column, started together
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int x0 = (q0 + u * quads_per_block) * kQuad;
        const int tx = x0 / t1;
        const int rx = x0 - tx * t1;
        plain[u] = (rx > 0 || tx == 0) && rx + kQuad <= t1 &&
                   x0 + kQuad <= gx;
        if (plain[u]) {
          const float* p = body_row + tx * tile + rx;
#pragma unroll
          for (int j = 0; j < kQuad; ++j) s[u][j] = p[j];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int x0 = (q0 + u * quads_per_block) * kQuad;
        if (x0 >= gx) continue;
        const int tx = x0 / t1;
        const int rx = x0 - tx * t1;
        if (plain[u]) {
          if (y_halo) {
            const float* h = halo_row + tx * tile + rx;
            float hy[kQuad];
#pragma unroll
            for (int j = 0; j < kQuad; ++j) hy[j] = h[j];
#pragma unroll
            for (int j = 0; j < kQuad; ++j)
              s[u][j] = __fadd_rn(__fadd_rn(s[u][j], hy[j]), 0.0f);
          }
        } else {
          // a tile's first column, two tiles, or the grid's edge: voxel
          // by voxel
#pragma unroll
          for (int j = 0; j < kQuad; ++j) {
            const int x = x0 + j;
            s[u][j] = 0.0f;
            if (x < gx) {
              const int txj = x / t1;
              const int rxj = x - txj * t1;
              const bool x_halo = rxj == 0 && txj > 0;
              const float body = body_row[txj * tile + rxj];
              const float hy = y_halo ? halo_row[txj * tile + rxj] : 0.0f;
              const float hx =
                  x_halo ? body_row[(txj - 1) * tile + t1] : 0.0f;
              const float hxy = (x_halo && y_halo)
                                    ? halo_row[(txj - 1) * tile + t1] : 0.0f;
              s[u][j] = __fadd_rn(__fadd_rn(body, hy), __fadd_rn(hx, hxy));
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kQuad; ++j)
          s[u][j] = __fadd_rn(__fmul_rn(s[u][j], owb), bgb);
        if (vec) {
          *reinterpret_cast<float4*>(out_row + x0) =
              make_float4(s[u][0], s[u][1], s[u][2], s[u][3]);
        } else {
#pragma unroll
          for (int j = 0; j < kQuad; ++j)
            if (x0 + j < gx) out_row[x0 + j] = s[u][j];
        }
      }
    }
  }
}

}  // namespace

// `out` is 16-byte aligned.
extern "C" int dprast_band_fold(const void* ext, const void* ow,
                                const void* bg, void* out, int bsz, int gy,
                                int gx, int t0, int t1, void* stream) {
  // rows of a block: as many as keep its threads on quads of the row
  const int quads = (gx + kQuad - 1) / kQuad;
  int rows_per_block = 1;
  while (rows_per_block < 8 &&
         kThreads / (2 * rows_per_block) * kUnroll >= quads)
    rows_per_block *= 2;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long n_rows = (long long)bsz * gy;
  const long long want = (n_rows + rows_per_block - 1) / rows_per_block;
  const long long most = (long long)n_sm * kWaves;
  const int blocks = (int)(want < most ? want : most);
  band_fold_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ext, (const float*)ow, (const float*)bg, (float*)out,
      bsz, gy, gx, t0, t1, rows_per_block);
  return (int)cudaGetLastError();
}
