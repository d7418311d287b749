// The binned frame gather: the multi-tile frame written once after the
// sort.
//
// Replaces the per-plane `jnp.take_along_axis` of the concatenated planes
// and fills, and the stack, in `_prep_binned` of
// dprast/ops/splat_binned.py.  Those are no Pallas kernel: XLA fuses them
// under `jit` into device code that writes the frame once.  Eager PyTorch
// runs a `cat` and a `gather` per plane and a `stack` (some nine launches,
// and each plane written three times); this kernel is that fusion.
//
// What it computes, per pose b and frame row r < s_pad, with j the sorted
// position's source (j < P is point j, j >= P a filler row):
//   data[b, i, r] = src[b, j, i] or 0 for the n_src source planes (the
//                   encoded coordinates; fill 0 decodes outside every
//                   window),
//   data[b, n_src, r] = weight[j] or 0, where the frame has a weight plane,
//   data[b, last, r] = j or P as f32, the point id.
// j comes from the sort.  Where the id rides inside the sort key (key * P2
// + id, unique keys), the sorted key's low bits are the id of the row the
// sort put there, j or the filler's P: `mask` = P2 - 1 and the index is
// the int32 keys.  Where it rides as the payload of a stable sort, the
// index is the int64 permutation (`mask` 0), whose entry at a filler row
// is P or above.
//
// What bounds it here.  Bytes: per row a 4-byte key (8-byte index where
// the ids do not pack) and n_planes 4-byte stores, per point its source
// values read once.  No arithmetic.  But the source reads come in the
// sort's order: within a tile's run of rows the ids ascend with gaps of
// tens of points, so every read is a sector of its own, and the L2's rate
// of random sectors sets the pace.  In PR 10's form (8-byte index, one
// 4-byte read a plane from (n_src, B, P) planes) it took 92 us at 1024^2 x
// 64 x 10^5 and 23 us at 128^3 x 1 x 10^6 on an H100, where the same
// kernel with no source reads takes 44 and 6
// (`dprast_torch/benchmarks/exp_gather_forms.py`).
//
// What the design does about it.  B6 writes a point's planes side by side,
// (B, P, L) with L = 2 in 2-D and 4 in 3-D (a pad lane), so a row reads
// its point's planes with one 8- or 16-byte load: one sector a row in
// place of n_src.  The row's id is the packed key's low bits where the
// sort packs the ids: 4 bytes in place of 8.  One thread per (pose, row),
// a block's rows of one pose (blockIdx.y, plus 65,535 blockIdx.z past
// 65,535 poses: poses.cuh): the index load and the stores are coalesced.
// Values move as 32-bit integers, so the bits of every entry (encoded
// coordinates are small integers read as f32) are copied unchanged.

#include <cuda_runtime.h>

#include "poses.cuh"

namespace {

constexpr int kThreads = 256;

// the row's source: the packed key's id bits, or the permutation's entry
__device__ __forceinline__ long long row_source(const int* index, int mask) {
  return *index & mask;
}
__device__ __forceinline__ long long row_source(const long long* index,
                                                int) {
  return *index;
}

template <typename Index, int N_SRC>
__global__ void __launch_bounds__(kThreads)
frame_gather_kernel(const Index* __restrict__ index,  // (B, >= s_pad)
                    long long index_stride, int mask,
                    const int* __restrict__ src,  // (B, P, L)
                    const float* __restrict__ weight,  // (P,) or null
                    int* __restrict__ data,  // (B, n_planes, s_pad)
                    int bsz, int n_points, int n_planes, long long s_pad) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int b = pose_of(blockIdx.y, blockIdx.z);
  if (row >= s_pad || b >= bsz) return;
  const long long j =
      row_source(index + (long long)b * index_stride + row, mask);
  const bool real = j < n_points;
  const long long at = (long long)b * n_points + j;
  int v[N_SRC];
  if constexpr (N_SRC == 2) {
    const int2 w = real ? __ldg(reinterpret_cast<const int2*>(src) + at)
                        : make_int2(0, 0);
    v[0] = w.x;
    v[1] = w.y;
  } else {
    const int4 w = real ? __ldg(reinterpret_cast<const int4*>(src) + at)
                        : make_int4(0, 0, 0, 0);
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
  }
  int* out = data + (long long)b * n_planes * s_pad + row;
#pragma unroll
  for (int i = 0; i < N_SRC; ++i) out[i * s_pad] = v[i];
  if (weight != nullptr)
    out[N_SRC * s_pad] = real ? __float_as_int(weight[j]) : 0;
  out[(n_planes - 1) * s_pad] =
      __float_as_int(real ? (float)j : (float)n_points);
}

}  // namespace

// `index` (B, >= s_pad) with row stride `index_stride`: the sort's packed
// int32 keys where `mask` (P2 - 1) is not 0, else its int64 permutation;
// `src` B6's interleaved planes (B, P, L), L = 2 where n_src is 2 and 4
// where it is 3; `weight` (P,) or null.  `data` is the frame (B, n_planes,
// s_pad) with n_planes = n_src + 2 where `weight` is given, else n_src + 1.
extern "C" int dprast_frame_gather(const void* index, long long index_stride,
                                   int mask, const void* src, int n_src,
                                   const void* weight, void* data, int bsz,
                                   int n_points, int n_planes,
                                   long long s_pad, void* stream) {
  if ((n_src != 2 && n_src != 3) || bsz < 1 || n_points < 1 ||
      s_pad < 1 || index_stride < s_pad || mask < 0 ||
      (mask != 0 && (mask < n_points || (mask & (mask + 1)) != 0)) ||
      n_planes != n_src + (weight != nullptr ? 2 : 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((s_pad + kThreads - 1) / kThreads),
                  pose_low(bsz), pose_high(bsz));
  const cudaStream_t s = (cudaStream_t)stream;
#define DPRAST_LAUNCH(T, N)                                                 \
  frame_gather_kernel<T, N><<<grid, kThreads, 0, s>>>(                       \
      (const T*)index, index_stride, mask, (const int*)src,                  \
      (const float*)weight, (int*)data, bsz, n_points, n_planes, s_pad)
  if (mask != 0) {
    if (n_src == 2) DPRAST_LAUNCH(int, 2); else DPRAST_LAUNCH(int, 3);
  } else {
    if (n_src == 2) DPRAST_LAUNCH(long long, 2);
    else DPRAST_LAUNCH(long long, 3);
  }
#undef DPRAST_LAUNCH
  return (int)cudaGetLastError();
}
