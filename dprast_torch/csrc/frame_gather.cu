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
// What it computes, per pose b and frame row r < s_pad, with j = perm[b,
// r] the sorted position's source (`torch.sort` of the binning keys; j < P
// is point j, j >= P a filler row):
//   data[b, i, r] = src_i[b, j] or 0 for the n_src source planes (the
//                   encoded coordinates; fill 0 decodes outside every
//                   window),
//   data[b, n_src, r] = weight[j] or 0, where the frame has a weight plane,
//   data[b, last, r] = j or P as f32, the point id.
// The id is the same on both of `_prep_binned`'s paths: where the id rides
// inside the sort key (key * P2 + id, unique keys), `sorted_key % P2` is
// the id of the row the sort put there, which is j or the filler's P; where
// it rides as the payload of a stable sort, the payload gathered at j is
// j or P.  So the kernel reads `perm` alone and not the sorted keys.
//
// What bounds it here.  Bytes: per row an 8-byte index read and n_planes
// 4-byte stores, per point its source values read once (in random order,
// from L2 where the planes fit it).  No arithmetic.
//
// What the design does about it.  One thread per (pose, row): the index
// load and the stores are coalesced; the source reads are a gather, as in
// the plain version.  Values move as 32-bit integers, so the bits of every
// entry (encoded coordinates are small integers read as f32) are copied
// unchanged.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
frame_gather_kernel(const long long* __restrict__ perm,  // (B, >= s_pad)
                    long long perm_stride,
                    const int* __restrict__ src0,  // (B, P) each
                    const int* __restrict__ src1,
                    const int* __restrict__ src2, int n_src,
                    const float* __restrict__ weight,  // (P,) or null
                    int* __restrict__ data,  // (B, n_planes, s_pad)
                    int n_points, int n_planes, long long s_pad) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (row >= s_pad) return;
  const long long j = perm[b * perm_stride + row];
  const bool real = j < n_points;
  int* out = data + (long long)b * n_planes * s_pad + row;
  const long long at = (long long)b * n_points + j;
  const int* src[3] = {src0, src1, src2};
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (i < n_src) out[i * s_pad] = real ? src[i][at] : 0;
  if (weight != nullptr)
    out[n_src * s_pad] = real ? __float_as_int(weight[j]) : 0;
  out[(n_planes - 1) * s_pad] =
      __float_as_int(real ? (float)j : (float)n_points);
}

}  // namespace

// `perm` is the sort's int64 permutation (B, >= s_pad) with row stride
// `perm_stride`; `src0` .. `src2` the first `n_src` (1 to 3) source planes,
// each (B, P) contiguous; `weight` (P,) or null.  `data` is the frame (B,
// n_planes, s_pad) with n_planes = n_src + 2 where `weight` is given, else
// n_src + 1.
extern "C" int dprast_frame_gather(const void* perm, long long perm_stride,
                                   const void* src0, const void* src1,
                                   const void* src2, int n_src,
                                   const void* weight, void* data, int bsz,
                                   int n_points, int n_planes,
                                   long long s_pad, void* stream) {
  if (n_src < 1 || n_src > 3 || bsz < 1 || bsz > 65535 || n_points < 1 ||
      s_pad < 1 || perm_stride < s_pad ||
      n_planes != n_src + (weight != nullptr ? 2 : 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((s_pad + kThreads - 1) / kThreads), bsz);
  frame_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)perm, perm_stride, (const int*)src0,
      (const int*)src1, (const int*)src2, n_src, (const float*)weight,
      (int*)data, n_points, n_planes, s_pad);
  return (int)cudaGetLastError();
}
