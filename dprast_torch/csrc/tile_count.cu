// The tile count of the binning sort: how many of each pose's points fall
// into each tile, from the tile keys (B, P) int32 -> counts (B, nt + 1)
// int32, where key nt marks a point that overlaps no tile.
//
// Replaces no Pallas kernel: the JAX package counts inside `_prep_binned`
// (dprast/ops/splat_binned.py:279-311) with a compare-and-sum over the
// tiles (nt <= 128) or a product of two 0/1 one-hots on the MXU, both
// exact, both left to XLA.  The port's plain version,
// `splat_binned._tile_count_plain`, is a `torch.histc`
// over (pose, tile) bins with its range given, which torch has in no
// deterministic form on CUDA: under `torch.use_deterministic_algorithms`
// it raises.  The counts are integers, and integer additions give the same
// sum in any order, so this kernel is deterministic by construction.
//
// What bounds it: one read of the keys and one write of the counts, 25.6
// MB at 1024^2 x 64 poses x 10^5 points (7.6 us at 3.35 TB/s).  The adds
// land on few addresses (82 bins at 1024^2, 343 at 128^3), so each block
// first counts its stretch of one pose's keys in a histogram in shared
// memory with native 32-bit atomics (ATOMS.ADD), then adds each non-zero
// bin into the zeroed global counts with one integer atomic: a few hundred
// global atomics per block in place of one per key.  Nothing is read back
// to the host.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// keys per block: 16 per thread
constexpr int kKeysPerBlock = 4096;

__global__ void __launch_bounds__(kThreads)
tile_count_kernel(const int* __restrict__ keys, int* __restrict__ counts,
                  int p, int nt) {
  extern __shared__ int hist[];  // nt + 1 bins
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i <= nt; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const int* kb = keys + (long long)b * p;
  const int lo = blockIdx.x * kKeysPerBlock;
  const int hi = min(p, lo + kKeysPerBlock);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int k = kb[i];
    // keys lie in [0, nt] (B6 writes no other); one outside is counted
    // nowhere rather than in another pose's bins
    if ((unsigned)k <= (unsigned)nt) atomicAdd(&hist[k], 1);
  }
  __syncthreads();
  int* cb = counts + (long long)b * (nt + 1);
  for (int i = threadIdx.x; i <= nt; i += blockDim.x)
    if (hist[i] != 0) atomicAdd(&cb[i], hist[i]);
}

}  // namespace

// `keys` (B, P) int32, `counts` (B, nt + 1) int32 zeroed by the caller.
extern "C" int dprast_tile_count(const void* keys, void* counts, int bsz,
                                 int p, int nt, void* stream) {
  if (bsz < 1 || bsz > 65535 || p < 1 || nt < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = (nt + 1) * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      tile_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p + kKeysPerBlock - 1) / kKeysPerBlock, bsz);
  tile_count_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)keys, (int*)counts, p, nt);
  return (int)cudaGetLastError();
}
