// B1: the forward splat of the binned backend, 2-D and 3-D grids.
//
// Replaces the TPU kernel `_fwd_kernel` / `_fwd_kernel_live` of
// dprast/ops/splat_binned.py (launched by the `pl.pallas_call` in
// `_fwd_impl`), both its 2-D branch and its 3-D branch, at terms=2 (here
// fp32) and terms=1 (the `binned_bf16` fast mode); also its standalone
// launch `fwd_kernel` in benchmarks/profile_binned.py, whose counterpart
// is dprast_torch/benchmarks/profile_binned.py.  That kernel runs
// one program per (pose, slot), builds a hat-function row matrix (in 3-D
// the separable product of a z hat and a y hat over the flattened (z, y)
// window rows) and two exact x one-hots, and accumulates their bf16-split
// product on the MXU into the tile's window, which stays resident in VMEM
// across consecutive slots of one tile.
//
// What bounds it here.  Per frame row the kernel reads 8-12 bytes (2-D)
// or 12-16 bytes (3-D) of the encoded frame and adds four (2-D) or eight
// (3-D) floats into a window in shared memory; per (pose, tile) it writes
// one window of up to 128x128 fp32 (64 KB).  Counted in bytes that is
// about 10 us at 128^3 x 10^6 points, 17 us at 128^2 x 64 x 10^5 and 118
// us at 1024^2 (where the 340 MB of windows are most of it; from the lane
// planes 14, 32 and 135 us), but only at 1024^2 do the bytes decide.  The kernel is a scatter, and Hopper has no float
// add on shared memory: `atomicAdd(float*)` on a shared address compiles
// to a loop of LDS, FADD and ATOMS.CAST.SPIN (a compare-and-swap, retried
// where another lane got in between; read from the SASS with `cuobjdump`),
// so one add is two dependent trips through the shared-memory pipe, more
// where the lanes of a warp meet on a bank (random pixels of a 128-wide
// window do) or on an address (a dense cloud's centre).  On an H100 the
// kernel sustains about 2.3 such adds per nanosecond and SM at 128^2
// (25.6 M adds in 83 us on 132 SMs); that rate, not the memory, is the
// limit of a scatter design.  In 3-D the work is also uneven: a tile is a
// 7 x 15 x 127 voxel slab, a 0.4-sigma cloud puts 96 of a pose's 3,977
// slots into the busiest of 342 tiles and one into most.  There is no
// matrix product: a multilinear splat is 2^n multiply-adds per row, so
// the tensor cores have nothing to do.
//
// What the design does about it.
// - A block keeps a window in dynamic shared memory (64 KB, above the
//   48 KB default, hence the cudaFuncSetAttribute call) and accumulates
//   with shared atomics, so no row touches device memory beyond its own
//   lane entries.  Three blocks of 512 threads share an SM (40 registers
//   a thread).
// - Blocks run in no order, so the TPU's "first slot writes, later slots
//   add" becomes: the live slots [first, end) of a (pose, tile) are found
//   by the block itself, two warps searching the pose's sorted slot table
//   (`warp_lower_bound` of slots.cuh, shared with B4) while the others
//   zero the window, so nothing is launched before the kernel.  Dead slots
//   (at or past the live count in the table's last entry) belong to no
//   tile and add nothing.
// - A (pose, tile) is a thread-block cluster of C blocks, 1 to 8 (the
//   launch's cluster dimension; the wrapper picks C from the number of
//   (pose, tile) pairs, the card's SMs and how many clusters of each size
//   the card holds at once: an H100 holds 69 clusters of 5 such blocks and
//   only 62 of 6, so 64 poses of 6 run in two waves).  Rank r splats slots first + r, first + r + C, ...
//   into its own window.  After a cluster-wide barrier rank r adds stripe
//   r of the window over the ranks that held slots, in rank order, reading
//   the others' windows through distributed shared memory, and stores the
//   stripe with 128-bit stores; a second barrier keeps every window alive
//   until all have read it.  A rank without slots returns at once (the
//   barriers wait only for threads that have not exited, and no rank reads
//   its window), a lone rank with slots stores its window without any
//   barrier, and a tile without live slots is stored as zeros.  So the
//   output is written exactly once, needs no zero-fill and no global
//   atomics, and the merge has a fixed order.  This is both the cure for
//   few tiles (one tile and 64 poses are 64 blocks on 132 SMs) and for
//   uneven ones (the busiest 3-D slab's slots spread over 4 blocks).  Every
//   rank with slots pays for zeroing, two barriers and the remote reads,
//   so C stays 1 where the tiles alone fill the card (1024^2: 5,184).
// - The merge that was weighed against this one had no cluster: each rank
//   with slots added its whole window into a zero-filled output with
//   `red.global.add.v4.f32`.  It placed blocks freely (6 per tile fit one
//   wave) and was 10% faster on the card at 128^2, its zero-fill included,
//   but cost a second launch, left the merge's order to chance, and was no
//   faster as a call, so it is not kept.
// - Each thread takes four consecutive rows of a slot: one 128-bit load
//   per plane it reads, all issued before the first atomic, so the loads of a
//   step are in flight together instead of each waiting behind the
//   atomics of the row before.  A slot's rows are contiguous and the
//   chunk is a multiple of 4, so the loads are aligned.  The 16 (2-D) or
//   32 (3-D) atomics of a step follow.
// - The 3-D window is the TPU's: rows are the flattened z * ny + y (ny =
//   16, nz = 8), columns x.  Targets are masked per axis, not by flat
//   row: a row with iy0 = -1 (a point just below the tile's y range)
//   would otherwise alias into row ny - 1 of the z plane below.
// - Weights are formed in plain fp32 as (hy * w) * cx in 2-D and
//   ((hz * hy) * w) * cx in 3-D, the order of the TPU kernel's products;
//   the TPU's 2-term bf16 split is only a way to get near-fp32 products
//   out of the MXU and has no counterpart here.  The shared atomics of one
//   block still reorder its fp32 sums from run to run.
// - The `binned_bf16` fast mode (kTerms = 1, the TPU kernel's terms=1)
//   rounds each product to the nearest bf16 (ties to even) once, as the
//   TPU kernel rounds its value operand before the one-hot matmul, and
//   adds the widened value.  The TPU's hats relu(1 - |(iy0 - r) + dl|)
//   equal (1 - dl, dl) bit for bit (dl has 23 fraction bits), so the
//   rounded products are the TPU's and only the order of the fp32 sums
//   differs.  __fmul_rn keeps the product from fusing into anything
//   before it is rounded.  On Hopper the mode saves nothing: there is no
//   matrix product whose work it halves.
// - Filler rows decode to -3 on every axis and every target outside the
//   window is dropped, as the TPU's one-hots never match them.
// - The frame's rows carry one encoded coordinate per axis (31-bit fixed
//   point, `_keys_and_local`), the weight where the frame has one, and the
//   point id.  The TPU kernel reads lane planes decoded outside it
//   (`_planes_fwd`), because a per-row decode on a (C, 1) value wastes 127
//   of 128 VPU lanes; a CUDA thread pays two shifts, a subtract, a compare
//   and an exact multiply by 2^-23 for it.  So the main path's instances
//   (kEnc) read the frame itself, 8-12 bytes a row in place of 16-28, and
//   decode in registers, to the bits `_decode_coord` gives.  The lane-plane
//   instances stay for the standalone launch of the harness.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "slots.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
// frame rows per thread and step: one 128-bit load per lane plane
constexpr int kRows = 4;
// the largest cluster every Hopper card schedules
constexpr int kMaxCluster = 8;

// one weight product as the splat adds it: fp32, or rounded to the
// nearest bf16 in the fast mode
template <int kTerms>
__device__ __forceinline__ float weight(float hw, float cx) {
  const float v = __fmul_rn(hw, cx);
  if constexpr (kTerms == 1)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

// kRows consecutive frame rows, one float4 per plane.  The lane planes sit
// at fixed places whatever the frame: [iz0, dlz,] iy0, dly, w, dlx, ix0;
// the encoded frame (kEnc) is [enc_z,] enc_y, enc_x, w.  A frame without a
// weight plane leaves `w` unloaded.
template <int kNOut, bool kEnc>
struct Rows {
  static constexpr int kW = kEnc ? kNOut : 2 * kNOut - 2;
  float4 v[kEnc ? kNOut + 1 : kW + 3];
  __device__ __forceinline__ void load(const float* __restrict__ lb,
                                       long long s_pad, long long row,
                                       bool with_w) {
    const float* p = lb + row;
#pragma unroll
    for (int i = 0; i < kW; ++i)
      v[i] = *reinterpret_cast<const float4*>(p + i * s_pad);
    p += kW * s_pad;
    if (with_w) {
      v[kW] = *reinterpret_cast<const float4*>(p);
      p += s_pad;
    }
    if constexpr (!kEnc) {
      v[kW + 1] = *reinterpret_cast<const float4*>(p);
      v[kW + 2] = *reinterpret_cast<const float4*>(p + s_pad);
    }
  }
  __device__ __forceinline__ float at(int plane, int j) const {
    const float4& q = v[plane];
    return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
  }
  // axis i (0 .. kNOut - 1, x last) of row j
  __device__ __forceinline__ Axis axis(int i, int j) const {
    if constexpr (kEnc)
      return decode(at(i, j));
    else if (i == kNOut - 1)
      return {(int)at(kW + 2, j), at(kW + 1, j)};
    else
      return {(int)at(2 * i, j), at(2 * i + 1, j)};
  }
  __device__ __forceinline__ float w(int j) const { return at(kW, j); }
};

__device__ __forceinline__ void add(float& a, const float& b) {
  a = __fadd_rn(a, b);
}

__device__ __forceinline__ void add(float4& a, const float4& b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
}

// The helpers below walk the units [lo, hi) of a window with the whole
// block; a unit is a T, one float or (where the window's size is a
// multiple of 4) four.

template <typename T>
__device__ __forceinline__ void zero_units(float* dst, int lo, int hi) {
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
    reinterpret_cast<T*>(dst)[i] = T();
}

template <typename T>
__device__ __forceinline__ void copy_units(const float* src, float* dst,
                                           int lo, int hi) {
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
    reinterpret_cast<T*>(dst)[i] = reinterpret_cast<const T*>(src)[i];
}

// the windows of ranks 0 .. n_active - 1 added in rank order and stored
template <typename T>
__device__ __forceinline__ void merge_units(const cg::cluster_group& cluster,
                                            float* win, float* out, int lo,
                                            int hi, int n_active) {
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    T acc = reinterpret_cast<const T*>(cluster.map_shared_rank(win, 0))[i];
    for (int q = 1; q < n_active; ++q)
      add(acc, reinterpret_cast<const T*>(cluster.map_shared_rank(win, q))[i]);
    reinterpret_cast<T*>(out)[i] = acc;
  }
}

template <int kNOut, int kTerms, bool kEnc>
__global__ void __launch_bounds__(kThreads, 3)
fwd_splat_kernel(const float* __restrict__ lane,  // (B, L, s_pad) planes
                 const int* __restrict__ slot_tile,  // (B, n_slots + 1)
                 float* __restrict__ ext,  // (B, nt, rows_e, cols_e)
                 int nt, int n_slots, long long pose_stride, bool with_w,
                 long long s_pad, int chunk, int ny, int rows_e, int cols_e,
                 int n_ranks) {
  extern __shared__ __align__(16) float win[];
  __shared__ int range[2];
  // the cluster is (n_ranks, 1, 1) and so is the grid's x
  const int rank = blockIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int n_win = rows_e * cols_e;
  // 128-bit zeroing, merging and storing where the window allows it
  const bool vec = (n_win & 3) == 0;

  // Two warps find the tile's live slots [first, end); the live count and
  // the first probes are loaded together.  Meanwhile the window is zeroed,
  // in vain where the rank turns out to hold no slot.
  const int* st = slot_tile + (long long)b * (n_slots + 1);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int r = warp_lower_bound(st, n_slots, t + warp, st[n_slots]);
    if ((threadIdx.x & 31) == 0) range[warp] = r;
  }
  const int n_units = vec ? n_win / 4 : n_win;
  if (vec)
    zero_units<float4>(win, 0, n_units);
  else
    zero_units<float>(win, 0, n_units);
  __syncthreads();
  const int first = range[0];
  const int end = range[1];
  // slots s0, s0 + n_ranks, ... < end belong to this rank
  const int s0 = first + rank;
  const int my_slots = s0 < end ? (end - s0 + n_ranks - 1) / n_ranks : 0;
  // ranks 0 .. n_active - 1 hold slots
  const int n_active = min(n_ranks, end - first);
  // groups of kRows rows: group q lies in this rank's slot q / per_slot
  const int per_slot = chunk / kRows;
  const int n_groups = my_slots * per_slot;
  auto row_of = [&](int q) {
    const int slot = q / per_slot;
    return ((long long)s0 + (long long)slot * n_ranks) * chunk +
           (q - slot * per_slot) * kRows;
  };
  const float* lb = lane + (long long)b * pose_stride;
  const int nz = rows_e / ny;

  float* out = ext + ((long long)b * nt + t) * n_win;
  if (n_active <= 0) {
    // a tile without live slots: every rank stores its stripe of zeros
    const int lo = (int)((long long)rank * n_units / n_ranks);
    const int hi = (int)((long long)(rank + 1) * n_units / n_ranks);
    if (vec)
      zero_units<float4>(out, lo, hi);
    else
      zero_units<float>(out, lo, hi);
    return;
  }
  // A rank without slots leaves at once: it holds no window, no rank reads
  // it, and the cluster's barriers wait only for threads that have not
  // exited.
  if (rank >= n_active) return;

  Rows<kNOut, kEnc> rows;
  int q = threadIdx.x;
  if (q < n_groups) rows.load(lb, s_pad, row_of(q), with_w);

  while (q < n_groups) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const Axis ay = rows.axis(kNOut - 2, j);
      const Axis ax = rows.axis(kNOut - 1, j);
      const int iy0 = ay.r0;
      const float dly = ay.dl;
      const float dlx = ax.dl;
      const int ix0 = ax.r0;
      const float cx0 = 1.0f - dlx;
      const float cx1 = dlx;
      const bool x0 = ix0 >= 0 && ix0 < cols_e;
      const bool x1 = ix0 + 1 >= 0 && ix0 + 1 < cols_e;
      // the (z, y) stencil rows in the order (0,0), (0,1), (1,0), (1,1);
      // 2-D has only the two y rows
      constexpr int kStencil = kNOut == 3 ? 4 : 2;
      float h[kStencil];
      int r[kStencil];
      bool ok[kStencil];
      if constexpr (kNOut == 3) {
        const Axis az = rows.axis(0, j);
        const int iz0 = az.r0;
        const float dlz = az.dl;
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
      const float w = with_w ? rows.w(j) : 1.0f;
#pragma unroll
      for (int i = 0; i < kStencil; ++i) {
        if (!ok[i]) continue;
        const float hw = with_w ? __fmul_rn(h[i], w) : h[i];
        const int base = r[i] * cols_e + ix0;
        if (x0) atomicAdd(&win[base], weight<kTerms>(hw, cx0));
        if (x1) atomicAdd(&win[base + 1], weight<kTerms>(hw, cx1));
      }
    }
    q += blockDim.x;
    if (q < n_groups) rows.load(lb, s_pad, row_of(q), with_w);
  }

  if (n_active == 1) {
    // a lone rank stores its window: no cluster barrier, no remote read
    __syncthreads();
    if (vec)
      copy_units<float4>(win, out, 0, n_units);
    else
      copy_units<float>(win, out, 0, n_units);
    return;
  }
  const cg::cluster_group cluster = cg::this_cluster();
  // every window is complete before any is read
  cluster.sync();
  const int lo = (int)((long long)rank * n_units / n_active);
  const int hi = (int)((long long)(rank + 1) * n_units / n_active);
  if (vec)
    merge_units<float4>(cluster, win, out, lo, hi, n_active);
  else
    merge_units<float>(cluster, win, out, lo, hi, n_active);
  // no block exits, and frees its window, while another still reads it
  cluster.sync();
}

template <int kNOut, int kTerms, bool kEnc>
int launch(const void* lane, const void* slot_tile, void* ext, int bsz,
           int nt, int n_slots, long long pose_stride, bool with_w,
           long long s_pad, int chunk, int ny, int rows_e, int cols_e,
           int n_ranks, int* clusters_out, void* stream) {
  if (n_ranks < 1 || n_ranks > kMaxCluster) return (int)cudaErrorInvalidValue;
  const int smem = rows_e * cols_e * (int)sizeof(float);
  auto* kernel = fwd_splat_kernel<kNOut, kTerms, kEnc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_ranks, nt, bsz);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n_ranks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  // the occupancy query: how many such clusters the current card holds at
  // once (the wrapper asks once per window size and picks `n_ranks` from
  // the answers); nothing is launched
  if (clusters_out != nullptr)
    return (int)cudaOccupancyMaxActiveClusters(clusters_out, kernel, &config);
  err = cudaLaunchKernelEx(&config, kernel, (const float*)lane,
                           (const int*)slot_tile, (float*)ext, nt, n_slots,
                           pose_stride, with_w, s_pad, chunk, ny, rows_e,
                           cols_e, n_ranks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// `lane` holds `n_planes` planes of `s_pad` rows per pose: the lane planes
// [iz0, dlz,] iy0, dly, (w,) dlx, ix0 (2 n_out or 2 n_out + 1 of them), or
// with `encoded` the frame [enc..., (w,) id] (n_out + 1 or n_out + 2), of
// which the kernel reads the encoded planes and the weight.  `slot_tile`
// is the frame's slot table (B, n_slots + 1), whose last entry per pose
// counts the live slots.  `ny` is the window's y extent: the number of its
// rows in 2-D, the rows of one z plane in 3-D (rows_e / ny z planes).
// `n_ranks` is the cluster size, the blocks that share one (pose, tile), 1
// to 8.  `terms` is 0 (fp32) or 1 (the bf16 fast mode).  `chunk` is a
// multiple of 4 and `lane` is 16-byte aligned.  With `clusters_out` not
// null nothing is launched: the entry writes there how many clusters of
// this launch the card holds at once.
extern "C" int dprast_fwd_splat(const void* lane, const void* slot_tile,
                                void* ext, int bsz, int nt, int n_out,
                                int n_slots, int n_planes, long long s_pad,
                                int chunk, int ny, int rows_e, int cols_e,
                                int n_ranks, int terms, int encoded,
                                int* clusters_out, void* stream) {
  const int bare = encoded ? n_out + 1 : 2 * n_out;
  if (n_planes != bare && n_planes != bare + 1)
    return (int)cudaErrorInvalidValue;
  const bool with_w = n_planes == bare + 1;
  const long long pose_stride = (long long)n_planes * s_pad;
#define DPRAST_LAUNCH(N, T, E)                                              \
  if (n_out == N && terms == T && (encoded != 0) == E)                      \
    return launch<N, T, E>(lane, slot_tile, ext, bsz, nt, n_slots,          \
                           pose_stride, with_w, s_pad, chunk, ny, rows_e,   \
                           cols_e, n_ranks, clusters_out, stream);
  DPRAST_LAUNCH(2, 0, false)
  DPRAST_LAUNCH(3, 0, false)
  DPRAST_LAUNCH(2, 1, false)
  DPRAST_LAUNCH(3, 1, false)
  DPRAST_LAUNCH(2, 0, true)
  DPRAST_LAUNCH(3, 0, true)
  DPRAST_LAUNCH(2, 1, true)
  DPRAST_LAUNCH(3, 1, true)
#undef DPRAST_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dprast_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
