// The shared-memory atomics B1 could add its window with, on one Hopper
// card: a standalone program (`exp_shared_atomics.py` builds and runs it).
// Each block adds the four targets of a bilinear splat at random places
// into a 128 x 128 window in shared memory, `iters` times per thread, by
// one of three forms: an fp32 `atomicAdd` (B1 before its fixed-point
// window), a 64-bit integer `atomicAdd` of q = round(v 2^45), and the pair
// of 32-bit planes with a carry that B1 keeps (csrc/fwd_splat.cu
// `add_fixed`).  It prints per form the time and the adds per ns and SM.
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned hash(unsigned x) {
  x ^= x >> 16; x *= 0x7feb352dU; x ^= x >> 15; x *= 0x846ca68bU; x ^= x >> 16;
  return x;
}

template <int kVar>
__global__ void splat(float* out, int iters, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* wf = reinterpret_cast<float*>(smem);
  unsigned long long* w64 = reinterpret_cast<unsigned long long*>(smem);
  unsigned* lo = reinterpret_cast<unsigned*>(smem);
  int* hi = reinterpret_cast<int*>(smem) + 16384;
  const int n_words = kVar == 0 ? 16384 : 32768;
  for (int i = threadIdx.x; i < n_words; i += blockDim.x)
    reinterpret_cast<unsigned*>(smem)[i] = 0;
  __syncthreads();
  unsigned s = hash(blockIdx.x * 4096 + threadIdx.x);
  for (int it = 0; it < iters; ++it) {
    s = hash(s);
    const int y = s & 126, x = (s >> 8) & 126;
    const float dy = ((s >> 16) & 255) * (1.0f / 256);
    const float dx = ((s >> 24) & 255) * (1.0f / 256);
    const float v[4] = {(1 - dy) * (1 - dx), (1 - dy) * dx, dy * (1 - dx),
                        dy * dx};
    const int idx[4] = {y * 128 + x, y * 128 + x + 1, (y + 1) * 128 + x,
                        (y + 1) * 128 + x + 1};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (kVar == 0) {
        atomicAdd(&wf[idx[k]], v[k]);
      } else if constexpr (kVar == 1) {
        const long long q = __float2ll_rn(v[k] * scale);
        atomicAdd(&w64[idx[k]], (unsigned long long)q);
      } else {
        const long long q = __float2ll_rn(v[k] * scale);
        const unsigned l = (unsigned)q;
        const int h = (int)(q >> 32);
        const unsigned old = atomicAdd(&lo[idx[k]], l);
        const int c = h + (old + l < old ? 1 : 0);
        if (c != 0) atomicAdd(&hi[idx[k]], c);
      }
    }
  }
  __syncthreads();
  float acc = 0;
  for (int i = threadIdx.x; i < 16384; i += blockDim.x) {
    if constexpr (kVar == 0) acc += wf[i];
    else if constexpr (kVar == 1) acc += __ll2float_rn((long long)w64[i]);
    else acc += __ll2float_rn(((long long)hi[i] << 32) + lo[i]);
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

template <int kVar>
void run(int threads, int blocks_per_sm, const char* name) {
  auto* k = splat<kVar>;
  const int smem = kVar == 0 ? 65536 : 131072;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int occ = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, threads, smem);
  const int blocks = 132 * blocks_per_sm;
  const int iters = 2000;
  float* out;
  cudaMalloc(&out, (size_t)blocks * threads * 4);
  k<<<blocks, threads, smem>>>(out, iters, 0x1p45f);
  cudaEvent_t a, b;
  cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int r = 0; r < 5; ++r) k<<<blocks, threads, smem>>>(out, iters, 0x1p45f);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  ms /= 5;
  const double adds = 4.0 * iters * threads * blocks;
  printf("%s threads %d blocks/SM %d (occupancy %d): %.3f ms, "
         "%.3f adds/ns/SM err=%s\n",
         name, threads, blocks_per_sm, occ, ms, adds / (ms * 1e6) / 132,
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  run<0>(512, 3, "float CAS  ");
  run<0>(1024, 2, "float CAS  ");
  run<1>(512, 1, "u64 atomic ");
  run<1>(1024, 1, "u64 atomic ");
  run<2>(512, 1, "u32 pair   ");
  run<2>(1024, 1, "u32 pair   ");
  return 0;
}
