// B4: the backward gather of the binned backend, 2-D and 3-D grids.
//
// Replaces the TPU kernel `_bwd_kernel` / `_bwd_kernel_live` of
// dprast/ops/splat_binned.py (launched by the `pl.pallas_call` in
// `_pullback_from_frame`), both its 2-D branch and its 3-D branch, at
// terms=2 (here fp32) and terms=1 (the `binned_bf16` fast mode).  It also
// replaces the B4 variants of the TPU harness: the standalone launch
// `bwd_kernel` of benchmarks/profile_binned.py, `_kernel_absums` of
// benchmarks/exp_xsel.py (one tile, transposed cotangent), and
// `_bwd_kernel_orient` / `_bwd_kernel_presplit` of benchmarks/exp_band.py
// (transposed or natural windows; windows split into a bf16 pair before
// the kernel), all at terms=2.  That kernel runs one program per (pose,
// slot), splits the transposed
// cotangent window into two bf16 terms, gathers the stencil rows of every
// frame row (two in 2-D, the four flat (z, y) rows in 3-D) with exact
// one-hot matmuls on the MXU, combines them with the y (and z) weights,
// and reduces over x with masked row sums; dead slots write zeros.
//
// What bounds it here.  Per frame row the kernel reads 8 bytes (2-D) or
// 12 bytes (3-D) of encoded planes, makes four or eight window reads and
// writes 12 or 16 bytes of gradient rows; per (pose, tile) it loads one
// window of up to 128x128 fp32 (64 KB).  So it is bound by device-memory
// traffic: the lane and gradient rows, and the windows.  On a multi-tile
// 2-D grid the windows are cut straight out of the cotangent (the grid
// source), so they cost one read of the cotangent (the 1-voxel halos are
// re-read from L2) and no unfold kernel writes them first.  There is no
// matrix product: the one-hot matmuls existed only because the TPU
// gathers through its MXU.
//
// What the design does about it.
// - One block per (split, tile, pose) stages the tile's window in
//   dynamic shared memory (64 KB, hence the cudaFuncSetAttribute call),
//   so every read of a row hits shared memory, and loops over the tile's
//   live slots.  The grid is (splits, tiles + 1, poses): the pose on z,
//   and past 65,535 poses its high part on x beside the splits
//   (poses.cuh), so any number of poses runs in the one launch.
// - The block finds its slots itself: two warps search the pose's sorted
//   slot table for the tile's [first, end) (`warp_lower_bound` of
//   slots.cuh, which B1 shares: each step 32 lanes probe
//   evenly spaced entries and a ballot picks the interval: two steps at
//   472 slots), so the wrapper launches nothing before the kernel.
// - The copy engines stage the window.  The grid source starts one TMA
//   tiled load of a box of g[b] that holds the 128x128 window whose corner
//   is (t0 ty, t1 tx): the hardware fills what lies past the grid with
//   zeros, which is B3's mask, and signals an mbarrier.  A box must start
//   on 16 bytes along x (the card raises an illegal instruction
//   otherwise) and 127 tx seldom does, so the box is 132 wide, starts at
//   the multiple of 4 at or below the corner, and the reads add the 0-3
//   columns of shift.  A natural or transposed fp32 window is
//   one contiguous run, copied by one bulk copy onto the same barrier.
//   One thread starts the copy; meanwhile every thread loads the lane
//   planes of its first rows, and only then waits.  Where the copy
//   engines' alignment rules do not hold (a grid row that is no multiple
//   of 16 bytes, a window whose size is not) and for the presplit bf16
//   pair, the block stages with plain loads and the same mask.
// - Each thread handles four consecutive frame rows: one 128-bit load per
//   plane it reads and one 128-bit store per output plane (a slot's rows are
//   contiguous and the chunk is a multiple of 4, so these are aligned).
//   512 threads and 64 KB a block let three blocks share an SM in 2-D
//   (two in 3-D, whose eight lane planes need more registers).
// - Output rows are disjoint, so a tile's slots can be split over
//   `nsplit` blocks (slot s goes to split (s - first) % nsplit) with no
//   atomics; the wrapper splits where there are too few (pose, tile)
//   blocks to fill the card (the single-tile flagship: 64 of them).
// - Range `nt` holds the dead slots (at or past n_live): its blocks write
//   exact zeros into all n_out + 1 planes, because those rows still ride
//   the unsort.  So the output needs no memset.
// - The window reads are plain fp32 loads, exact, where the TPU's
//   two-term bf16 split kept about 16 bits of the cotangent.  The TPU's
//   rounding is a template parameter applied once to the staged window:
//   kTerms = 1 (the fast mode) keeps bf16(g), kTerms = 2 (the harness
//   variants) hi + lo with hi = bf16(g) and lo = bf16(g - hi), which is
//   exact in fp32 and so equals the TPU's two one-hot matmul parts added
//   (gathering hi and lo apart and adding later would round differently).
//   Everything after the staging is the same for every instance.
// - kLayout says where the window comes from: natural (rows_e, cols_e)
//   fp32, which B3 writes; transposed (cols_e, rows_e) fp32, what the
//   TPU's NN contraction reads; presplit, two transposed bf16 windows
//   (hi, lo) staged as hi + lo; or grid, the cotangent (B, gy, gx) itself.
//   The staging copies the window as it lies and the reads index it in
//   that layout, so the layouts differ only in the read address.
// - 3-D reads the flat rows the lane planes carry; a row outside the
//   window on z or y arrives as -9 and reads 0, so no row aliases into
//   another z plane.
// - The main path's instances (kEnc) read the frame's encoded planes in
//   place of lane planes: n_out of them (8 or 12 bytes a row, not 16 or
//   32), straight out of the frame (B, n_planes, s_pad) at its pose stride,
//   with no copy.  Each row is decoded in registers as `_decode_coord`
//   does, and in 3-D its four flat rows are made as `_flat_rows_3d` makes
//   them (-9 where z or y leaves the window), so the values that reach the
//   arithmetic are the lane planes' and the output is their bits.  The
//   TPU decodes outside its kernel only because a per-row op on a (C, 1)
//   value idles 127 of its 128 lanes.  The harness instances keep lanes.
// - Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
//   __fsub_rn) in the plain twin's order, so nvcc contracts nothing into
//   an FMA and the card gives the twin's bits.
// - Out-of-window neighbours (filler rows decode to -3 on every axis)
//   read 0, as the TPU's one-hots match nothing there.

#include <cuda.h>  // CUtensorMap and its enums; nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "poses.cuh"
#include "slots.cuh"

namespace {

constexpr int kThreads = 512;
// frame rows per thread and step: one 128-bit access per plane
constexpr int kRows = 4;
// the grid source's window: a 127-voxel body and a 1-voxel halo per axis
constexpr int kTile = 128;
// the columns of the TMA box that holds it from an x that is a multiple
// of 4 (16 bytes)
constexpr int kBoxCols = kTile + 4;

// where the window comes from (see the notes above)
enum Layout { kNatural = 0, kTransposed = 1, kPresplit = 2, kGrid = 3 };
// how a block stages it: plain loads, one bulk copy, or one TMA tiled load
enum Staging { kLoads = 0, kBulk = 1, kTensor = 2 };

// a * b + c * d, each product and the sum rounded on its own
__device__ __forceinline__ float lerp2(float a, float b, float c, float d) {
  return __fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// a cotangent value as the gather reads it: fp32, or its kTerms-part bf16
// split (round to nearest even) added back, which is exact
template <int kTerms>
__device__ __forceinline__ float split(float v) {
  if constexpr (kTerms == 0) {
    return v;
  } else {
    const float hi = __bfloat162float(__float2bfloat16_rn(v));
    if constexpr (kTerms == 1)
      return hi;
    else
      return __fadd_rn(
          hi, __bfloat162float(__float2bfloat16_rn(__fsub_rn(v, hi))));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// spin until the mbarrier's phase `parity` has completed
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// kRows consecutive frame rows, one float4 per plane: the lane planes
// [iy0, dly, ix0, dlx] (2-D) or [r00, r01, r10, r11, dlz, dly, ix0, dlx]
// (3-D), or the encoded planes (kEnc) [enc_z,] enc_y, enc_x
template <int kNOut, bool kEnc>
struct Rows {
  static constexpr int kPlanes = kEnc ? kNOut : (kNOut == 3 ? 8 : 4);
  float4 v[kPlanes];
  __device__ __forceinline__ void load(const float* __restrict__ lb,
                                       long long s_pad, long long row) {
#pragma unroll
    for (int i = 0; i < kPlanes; ++i)
      v[i] = *reinterpret_cast<const float4*>(lb + i * s_pad + row);
  }
  __device__ __forceinline__ float at(int plane, int j) const {
    const float4& q = v[plane];
    return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
  }
  // the x axis of row j
  __device__ __forceinline__ Axis x(int j) const {
    if constexpr (kEnc)
      return decode(at(kNOut - 1, j));
    else
      return {(int)at(kPlanes - 2, j), at(kPlanes - 1, j)};
  }
  // 2-D: the y axis of row j
  __device__ __forceinline__ Axis y(int j) const {
    if constexpr (kEnc)
      return decode(at(0, j));
    else
      return {(int)at(0, j), at(1, j)};
  }
  // 3-D: the flat window rows r00, r01, r10, r11 of row j (-9 where z or y
  // leaves the window of nz x ny rows) and its deltas dlz, dly
  __device__ __forceinline__ void flat(int j, int ny, int nz, int (&r)[4],
                                       float& dlz, float& dly) const {
    if constexpr (kEnc) {
      const Axis az = decode(at(0, j));
      const Axis ay = decode(at(1, j));
#pragma unroll
      for (int sz = 0; sz < 2; ++sz) {
#pragma unroll
        for (int sy = 0; sy < 2; ++sy) {
          const int z = az.r0 + sz;
          const int y = ay.r0 + sy;
          const bool ok = z >= 0 && z < nz && y >= 0 && y < ny;
          r[2 * sz + sy] = ok ? z * ny + y : -9;
        }
      }
      dlz = az.dl;
      dly = ay.dl;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = (int)at(i, j);
      dlz = at(4, j);
      dly = at(5, j);
    }
  }
};

__device__ __forceinline__ void put(float4& q, int j, float x) {
  if (j == 0) q.x = x;
  else if (j == 1) q.y = x;
  else if (j == 2) q.z = x;
  else q.w = x;
}

template <int kNOut, int kTerms, int kLayout, bool kEnc>
__global__ void __launch_bounds__(kThreads, kNOut == 3 ? 2 : 3)
bwd_gather_kernel(const float* __restrict__ lane,  // see `Rows`
                  const int* __restrict__ slot_tile,  // (B, n_slots + 1)
                  const void* __restrict__ win,  // (B, nt, rows_e, cols_e),
                                                 // (.., cols_e, rows_e), or
                                                 // the grid (B, gy, gx)
                  const void* __restrict__ win_lo,  // presplit: the lo part
                  float* __restrict__ buf,          // (B, n_out + 1, s_pad)
                  __grid_constant__ const CUtensorMap g_map,  // kTensor: g
                  int bsz, int nt, int n_slots, long long s_pad,
                  long long pose_stride, int chunk, int rows_e, int cols_e,
                  int ny, int nsplit, int gy, int gx, int t0, int t1, int n1,
                  int staging, int bar_offset) {
  // the window, then the mbarrier (8 bytes) and the slot range (2 ints)
  extern __shared__ __align__(128) float w[];
  unsigned long long* bar_p =
      reinterpret_cast<unsigned long long*>(w + bar_offset);
  int* range = reinterpret_cast<int*>(bar_p + 1);
  const uint32_t bar = smem_addr(bar_p);
  // the grid's x holds the splits of each high slab of poses (one slab up
  // to 65,535 poses), z the pose's low part
  const int high =
      gridDim.x == (unsigned)nsplit ? 0 : (int)blockIdx.x / nsplit;
  const int split_id = (int)blockIdx.x - high * nsplit;
  const int t = blockIdx.y;
  const int b = pose_of(blockIdx.z, high);
  if (b >= bsz) return;  // past the last pose: the whole block

  // the tile's live slots [first, end), or the dead ones [n_live, n_slots)
  const int* st = slot_tile + (long long)b * (n_slots + 1);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int n_live = st[n_slots];
    const int r = t == nt ? (warp == 0 ? n_live : n_slots)
                          : warp_lower_bound(st, n_live, t + warp);
    if ((threadIdx.x & 31) == 0) range[warp] = r;
  }
  if (threadIdx.x == 0 && staging != kLoads) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  const int s0 = range[0] + split_id;
  const int s1 = range[1];
  // slots s0, s0 + nsplit, ... < s1 belong to this block
  const int my_slots = s0 < s1 ? (s1 - s0 + nsplit - 1) / nsplit : 0;
  if (my_slots == 0) return;  // the same for the whole block
  // groups of kRows rows: group q lies in this block's slot q / per_slot
  const int per_slot = chunk / kRows;
  const int n_groups = my_slots * per_slot;
  auto row_of = [&](int q) {
    const int slot = q / per_slot;
    return ((long long)s0 + (long long)slot * nsplit) * chunk +
           (q - slot * per_slot) * kRows;
  };
  // [du_z,] du_y, du_x, gw
  float* out = buf + (long long)b * (kNOut + 1) * s_pad;

  if (t == nt) {  // dead slots
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = threadIdx.x; q < n_groups; q += blockDim.x) {
      const long long row = row_of(q);
#pragma unroll
      for (int i = 0; i <= kNOut; ++i)
        *reinterpret_cast<float4*>(out + i * s_pad + row) = zero;
    }
    return;
  }

  const int n_win = rows_e * cols_e;
  // the staged window's row pitch, and the column at which it starts
  int pitch = cols_e, shift = 0;
  if (kLayout == kGrid && staging == kTensor) {
    pitch = kBoxCols;
    shift = ((t % n1) * t1) & 3;
  }
  const float* lb = lane + (long long)b * pose_stride;
  const int nz = rows_e / ny;
  Rows<kNOut, kEnc> rows;
  int q = threadIdx.x;

  if (staging == kLoads) {
    // plain loads, the split applied on the way
    if constexpr (kLayout == kGrid) {
      const int y0 = (t / n1) * t0;
      const int x0 = (t % n1) * t1;
      const float* gb = (const float*)win + (long long)b * gy * gx;
      for (int i = threadIdx.x; i < n_win; i += blockDim.x) {
        const int y = y0 + i / kTile;
        const int x = x0 + i % kTile;
        w[i] = (y < gy && x < gx)
                   ? split<kTerms>(gb[(long long)y * gx + x]) : 0.0f;
      }
    } else {
      const long long off = ((long long)b * nt + t) * n_win;
      if constexpr (kLayout == kPresplit) {
        const __nv_bfloat16* hi = (const __nv_bfloat16*)win + off;
        const __nv_bfloat16* lo = (const __nv_bfloat16*)win_lo + off;
        for (int i = threadIdx.x; i < n_win; i += blockDim.x)
          w[i] = __fadd_rn(__bfloat162float(hi[i]), __bfloat162float(lo[i]));
      } else {
        const float* wb = (const float*)win + off;
        for (int i = threadIdx.x; i < n_win; i += blockDim.x)
          w[i] = split<kTerms>(wb[i]);
      }
    }
    if (q < n_groups) rows.load(lb, s_pad, row_of(q));
    __syncthreads();
  } else {
    // one thread hands the copy to the copy engine; every thread loads
    // its first lane rows while the window is on its way
    if (threadIdx.x == 0) {
      const uint32_t bytes =
          (uint32_t)(rows_e * pitch) * (uint32_t)sizeof(float);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(bytes)
          : "memory");
      if constexpr (kLayout == kGrid) {
        asm volatile(
            "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
            "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
                smem_addr(w)),
            "l"(reinterpret_cast<uint64_t>(&g_map)), "r"(bar),
            "r"((t % n1) * t1 - shift), "r"((t / n1) * t0), "r"(b)
            : "memory");
      } else {
        const float* wb =
            (const float*)win + ((long long)b * nt + t) * n_win;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(w)),
            "l"(wb), "r"(bytes), "r"(bar)
            : "memory");
      }
    }
    if (q < n_groups) rows.load(lb, s_pad, row_of(q));
    mbarrier_wait(bar, 0);
    if constexpr (kTerms != 0) {
      for (int i = threadIdx.x; i < rows_e * pitch; i += blockDim.x)
        w[i] = split<kTerms>(w[i]);
      __syncthreads();
    }
  }
  // the staged index of window entry (r, c)
  auto at = [rows_e, pitch, shift](int r, int c) {
    return (kLayout == kNatural || kLayout == kGrid) ? r * pitch + c + shift
                                                     : c * rows_e + r;
  };

  while (q < n_groups) {
    const long long row = row_of(q);
    float4 o[kNOut + 1];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const Axis ax = rows.x(j);
      const int ix0 = ax.r0;
      const float dlx = ax.dl;
      const bool x0 = ix0 >= 0 && ix0 < cols_e;
      const bool x1 = ix0 + 1 >= 0 && ix0 + 1 < cols_e;
      const float omx = __fsub_rn(1.0f, dlx);
      // the value at columns ix0 (a) and ix0 + 1 (c), and the pre-terms of
      // the row-axis derivatives there
      float a, c;
      if constexpr (kNOut == 3) {
        // flat rows r00, r01, r10, r11 (-9 where z or y leaves the window)
        int fr[4];
        float dlz, dly;
        rows.flat(j, ny, nz, fr, dlz, dly);
        float plo[4], phi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = fr[i];
          const bool rok = r >= 0 && r < rows_e;
          plo[i] = (rok && x0) ? w[at(r, ix0)] : 0.0f;
          phi[i] = (rok && x1) ? w[at(r, ix0 + 1)] : 0.0f;
        }
        const float omy = __fsub_rn(1.0f, dly);
        const float omz = __fsub_rn(1.0f, dlz);
        float dz[2], dy[2], v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* p = h == 0 ? plo : phi;
          const float y0 = lerp2(omy, p[0], dly, p[1]);
          const float y1 = lerp2(omy, p[2], dly, p[3]);
          v[h] = lerp2(omz, y0, dlz, y1);
          dz[h] = __fsub_rn(y1, y0);
          dy[h] =
              lerp2(omz, __fsub_rn(p[1], p[0]), dlz, __fsub_rn(p[3], p[2]));
        }
        a = v[0];
        c = v[1];
        put(o[0], j, lerp2(dz[0], omx, dz[1], dlx));
        put(o[1], j, lerp2(dy[0], omx, dy[1], dlx));
      } else {
        const Axis ay = rows.y(j);
        const int iy0 = ay.r0;
        const float dly = ay.dl;
        const bool y0 = iy0 >= 0 && iy0 < rows_e;
        const bool y1 = iy0 + 1 >= 0 && iy0 + 1 < rows_e;
        const float p00 = (y0 && x0) ? w[at(iy0, ix0)] : 0.0f;
        const float p01 = (y0 && x1) ? w[at(iy0, ix0 + 1)] : 0.0f;
        const float p10 = (y1 && x0) ? w[at(iy0 + 1, ix0)] : 0.0f;
        const float p11 = (y1 && x1) ? w[at(iy0 + 1, ix0 + 1)] : 0.0f;
        const float omy = __fsub_rn(1.0f, dly);
        a = lerp2(omy, p00, dly, p10);
        c = lerp2(omy, p01, dly, p11);
        put(o[0], j,
            lerp2(__fsub_rn(p10, p00), omx, __fsub_rn(p11, p01), dlx));
      }
      put(o[kNOut - 1], j, __fsub_rn(c, a));
      put(o[kNOut], j, lerp2(a, omx, c, dlx));
    }
#pragma unroll
    for (int i = 0; i <= kNOut; ++i)
      *reinterpret_cast<float4*>(out + i * s_pad + row) = o[i];
    q += blockDim.x;
    if (q < n_groups) rows.load(lb, s_pad, row_of(q));
  }
}

// cuTensorMapEncodeTiled, asked of the runtime so that the library links
// against no libcuda; null where libcuda has none
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    const bool ok = err == cudaSuccess && found == cudaDriverEntryPointSuccess;
    return ok ? (EncodeTiled)p : (EncodeTiled) nullptr;
  }();
  return fn;
}

// the cotangent (B, gy, gx) as a 3-D tensor of fp32 with boxes of 132 x
// 128 x 1; what a box holds past the grid reads as zero
int encode_grid(CUtensorMap* map, const void* g, int bsz, int gy, int gx) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)gx, (cuuint64_t)gy,
                              (cuuint64_t)bsz};
  const cuuint64_t strides[2] = {(cuuint64_t)gx * sizeof(float),
                                 (cuuint64_t)gx * gy * sizeof(float)};
  const cuuint32_t box[3] = {kBoxCols, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(g), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int kNOut, int kTerms, int kLayout, bool kEnc>
int launch(const void* lane, const void* slot_tile, const void* win,
           const void* win_lo, void* buf, int bsz, int nt, int n_slots,
           long long s_pad, long long pose_stride, int chunk, int rows_e,
           int cols_e, int ny, int nsplit, int gy, int gx, int t0, int t1,
           int staging, void* stream) {
  // the copy each layout can take: a grid no bulk copy, a window no
  // tiled load, a bf16 pair neither
  if (staging != kLoads &&
      (kLayout == kPresplit || (kLayout == kGrid) != (staging == kTensor)))
    return (int)cudaErrorInvalidValue;
  if (ny < 1 || rows_e % ny != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap g_map = {};
  if (staging == kTensor) {
    const int rc = encode_grid(&g_map, win, bsz, gy, gx);
    if (rc != 0) return rc;
  }
  // the window (the whole box of a tiled load) rounded up to 16 bytes,
  // the mbarrier, the slot range
  const int staged = staging == kTensor ? kTile * kBoxCols : rows_e * cols_e;
  const int bar_offset = (staged + 3) / 4 * 4;
  const int smem = bar_offset * (int)sizeof(float) + 16;
  auto* kernel = bwd_gather_kernel<kNOut, kTerms, kLayout, kEnc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n1 = kLayout == kGrid ? (gx + t1 - 1) / t1 : 1;
  const dim3 grid(nsplit * pose_high(bsz), nt + 1, pose_low(bsz));
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)lane, (const int*)slot_tile, win, win_lo, (float*)buf,
      g_map, bsz, nt, n_slots, s_pad, pose_stride, chunk, rows_e, cols_e, ny,
      nsplit, gy, gx, t0, t1, n1, staging, bar_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// `lane` holds, per pose at `pose_stride` floats from the last, the lane
// planes (4 in 2-D, 8 in 3-D) or with `encoded` the frame's n_out encoded
// planes, `s_pad` floats apart.  `rows_e` and `cols_e` are the window's
// natural extents whatever its layout, `ny` its rows per z plane in 3-D
// (the encoded instances make the flat rows of an (rows_e / ny) x ny
// window; 2-D passes rows_e); `terms` is 0 (fp32), 1 (the bf16 fast mode)
// or 2 (the harness's two-part split); `layout` a `Layout`, `staging` a
// `Staging` (the caller picks one the window's alignment allows).
// `win_lo` is read only by the presplit layout; `gy`, `gx` and the body
// tile `t0`, `t1` only by the grid layout, whose `win` is the cotangent
// (B, gy, gx).  `chunk` is a multiple of 4, `pose_stride` too, and `lane`
// and `buf` are 16-byte aligned.  Only the instances the package uses
// exist.
extern "C" int dprast_bwd_gather(const void* lane, const void* slot_tile,
                                 const void* win, const void* win_lo,
                                 void* buf, int bsz, int nt, int n_out,
                                 int n_slots, long long s_pad,
                                 long long pose_stride, int chunk,
                                 int rows_e, int cols_e, int ny, int nsplit,
                                 int terms, int layout, int gy, int gx,
                                 int t0, int t1, int staging, int encoded,
                                 void* stream) {
#define DPRAST_LAUNCH(N, T, L, E)                                           \
  if (n_out == N && terms == T && layout == L && (encoded != 0) == E)       \
    return launch<N, T, L, E>(lane, slot_tile, win, win_lo, buf, bsz, nt,   \
                              n_slots, s_pad, pose_stride, chunk, rows_e,   \
                              cols_e, ny, nsplit, gy, gx, t0, t1, staging,  \
                              stream);
  DPRAST_LAUNCH(2, 0, kNatural, false)
  DPRAST_LAUNCH(3, 0, kNatural, false)
  DPRAST_LAUNCH(2, 1, kNatural, false)
  DPRAST_LAUNCH(3, 1, kNatural, false)
  DPRAST_LAUNCH(2, 2, kNatural, false)
  DPRAST_LAUNCH(2, 2, kTransposed, false)
  DPRAST_LAUNCH(2, 2, kPresplit, false)
  DPRAST_LAUNCH(2, 0, kGrid, false)
  DPRAST_LAUNCH(2, 1, kGrid, false)
  DPRAST_LAUNCH(2, 0, kNatural, true)
  DPRAST_LAUNCH(3, 0, kNatural, true)
  DPRAST_LAUNCH(2, 1, kNatural, true)
  DPRAST_LAUNCH(3, 1, kNatural, true)
  DPRAST_LAUNCH(2, 0, kGrid, true)
  DPRAST_LAUNCH(2, 1, kGrid, true)
#undef DPRAST_LAUNCH
  return (int)cudaErrorInvalidValue;
}
