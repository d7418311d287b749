// What B9 (slot_prep.cu) and B10 (bin_scatter.cu) share: the stretch of
// a pose's keys that one block of B9's count and of B10's scatter takes,
// and a block-wide exclusive prefix sum.

#pragma once

#include <cuda_runtime.h>

// keys per stretch: B9 counts each stretch of a pose's keys apart, and B10
// scatters it from those counts' prefix (`splat_binned._STRETCH`)
constexpr int kStretch = 4096;

// The exclusive prefix of each thread's `v` over the block's threads in
// the order of threadIdx.x, and in `*total` the sum over the block.
// `warp_sums` holds a word for each warp of the block in shared memory.
// Every thread of the block calls it; the shared words may be reused when
// it returns.
template <int kThreads>
__device__ __forceinline__ int block_exclusive(int v, int* warp_sums,
                                               int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = incl - v, sum = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    sum += s;
  }
  __syncthreads();
  *total = sum;
  return before;
}

// A tile's rows in the frame: its count rounded up to whole slots of
// `chunk` rows, and to one slot where `min_chunk` gives every tile one.
__device__ __forceinline__ int padded_rows(int count, int chunk,
                                           bool min_chunk) {
  const int padded = (count + chunk - 1) / chunk * chunk;
  return min_chunk && padded < chunk ? chunk : padded;
}
