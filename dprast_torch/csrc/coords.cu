// B6: the coordinate stage of the binned backend, 2-D and 3-D grids.
//
// Replaces `_keys_and_local` of dprast/ops/splat_binned.py with
// `grid_coords_2f` and `reference_voxel_and_deltas_2f` of
// dprast/ops/geometry.py.  Those are no Pallas kernel: they run under
// `jit`, and XLA fuses their elementwise operators into a few TPU
// kernels.  Eager PyTorch runs each operator as its own launch over a
// (B, P, n_out) tensor, 174 launches from 3 to 2 axes; this kernel is the
// fusion, written by hand because the arithmetic is only right if it is
// NOT simplified.
//
// What it computes, per (pose b, point p) and output axis i:
//   1. u = (R[b] p + t[b] + 1) * g/2 - 1/2 as a double-float32 pair
//      (hi, lo): per input axis a Dekker TwoProd (Veltkamp splits) and a
//      Knuth TwoSum; then + 1, * scale, - 1/2, and a renormalising TwoSum;
//   2. r0 = ceil(hi) - 1, dl = (hi - r0) + lo, and one fix-up step that
//      keeps dl in (0, 1];
//   3. overlap &= -1 <= r0 <= g - 1 (running over the axes), the tile index
//      ti = clamp(r0, 0, g - 1) / t, key = key * nts + ti, and the encoded
//      coordinate ((r0 - ti t + 2) << 23) + rint(dl 2^23), 0 where the
//      running overlap is false;
//   4. key = nt where the final overlap is false.
//
// What bounds it here.  Arithmetic, not bytes: a (pose, point) reads 12
// bytes of the cloud (from L2 for all poses but the first) and writes 12
// (2-D) or 16 (3-D), and does a few hundred dependent fp32 operations, none
// of which may fuse.
//
// What the design does about it.
// - Every +, - and * of steps 1 and 2 is an `__f*_rn` intrinsic, in the
//   order of the plain twin, parentheses included (the double-float32
//   helpers of twofloat.cuh, which X1 of xla_path.cu shares).  nvcc never contracts
//   these into an FMA and never re-associates them, so `c - (c - a)` of the
//   split survives -O3 and the result is the twin's bit for bit (each
//   operator of the twin is its own kernel, rounded on its own).  TwoProd
//   is Dekker's, literally: its partial products underflow where an
//   FMA's residual would not, and the twin's bits are the contract.
// - One thread per (pose, point); a block's points are of one pose
//   (blockIdx.y, plus 65,535 blockIdx.z past 65,535 poses: poses.cuh), so
//   its rotation and translation loads are broadcasts.  The loop runs over
//   the input axes outside and the output axes inside: a point's coordinate is
//   loaded and split once and feeds every output axis' own chain.
// - What is the same for every thread of a block is worked out once: the
//   splits of the pose's rotation entries and of the scales by the block's
//   first threads, into shared memory, which every thread then reads as a
//   broadcast; the tile counts and, in place of the two integer divisions
//   per axis (some twenty instructions each), a multiplier for `__umulhi`
//   on the host.  Instruction slots are what the kernel runs out of: with
//   the splits and divisions in every thread it took 93 us at 64 poses x
//   10^5 points, 3 -> 2, on an H100, and takes 74 without them.
// - The planes are written interleaved per point, as (B, P, L) with L = 2
//   in 2-D and L = 4 in 3-D (the fourth lane 0): one coalesced 8- or
//   16-byte store a point, so that the frame gather, which reads a point's
//   planes at a random id after the sort, reads them in one load (one L2
//   sector) in place of one a plane.  It costs this kernel nothing: 75.1
//   -> 72.4 us at 1024^2 x 64 x 10^5 and 19.1 -> 18.5 at 128^3 x 1 x 10^6
//   in turns with the (n_out, B, P) planes on an H100.  The key store is
//   left out for a caller that does not bin (one tile).
// - A single tile bins nothing, so its frame is the planes in point order
//   (`_prep_direct` of dprast/ops/splat_binned.py, there a pad and a stack
//   per plane).  In that mode the kernel writes the padded frame (B,
//   n_planes, p_pad) itself: the encoded planes, the point weight where
//   the frame has a weight plane, the point id as f32, and the filler rows
//   p .. p_pad - 1 (encoded 0, weight 0, id p), one store per plane at
//   `pose_stride * b + plane_stride * i + p`; the filler rows are threads
//   past the last point.  Its first threads also write the slot table
//   (every slot live, all of tile 0), so the frame costs no launch beyond
//   this one.
// - Instances for n_in = 2, 3 unroll the input loop; n_in = 0 is the same
//   code with the count read at run time, for any other width (it splits
//   the rotation entries per thread).

#include <cuda_runtime.h>

#include "poses.cuh"
#include "twofloat.cuh"

namespace {

constexpr int kThreads = 256;
// fraction bits of an encoded coordinate
constexpr int kFix = 23;

struct Axes {
  int g[3];         // grid size per output axis
  int t[3];         // tile body per output axis
  int nts[3];       // tiles per output axis, ceil(g / t)
  unsigned inv[3];  // floor(2^32 / t) + 1, or 0 where t == 1
  float s[3];       // g / 2 as fp32
};

// Where the planes go.  The (B, P, L) interleaved planes: n_rows = P, no id
// plane (-1), the strides unused.  The single tile's frame (B, n_planes,
// p_pad): plane i of pose b at `pose_stride * b + plane_stride * i`, strides
// n_planes p_pad and p_pad, n_rows = p_pad, the id plane last (and the
// weight plane at n_out where `weight` is given).
struct Layout {
  long long pose_stride;
  long long plane_stride;
  int n_rows;
  int id_plane;
  int n_slots;  // the frame's slots, whose table the kernel writes too
};

// kFrame: the single tile's frame (`Layout`), else the (B, P, L) planes;
// an instance apiece, so that the planes' instance carries no frame code
// (one instance for both took 34 registers in place of 31 at 3 -> 2, so
// six blocks of 256 threads per SM in place of eight, and 81 us in place
// of 74 at 64 x 10^5 points on an H100)
template <int N_OUT, int N_IN, bool kFrame>
__global__ void __launch_bounds__(kThreads)
coords_kernel(const float* __restrict__ points,  // (P, n_in)
              const float* __restrict__ rot,     // (B, N_OUT, n_in)
              const float* __restrict__ tr,      // (B, N_OUT)
              int* __restrict__ key,             // (B, P) or null
              int* __restrict__ planes,          // see `Layout`
              const float* __restrict__ weight,  // (P,) or null
              int* __restrict__ slots,  // (B, n_slots + 1) or null
              int bsz, int n_points, Layout lay, int n_in_rt, Axes ax) {
  const int n_in = N_IN > 0 ? N_IN : n_in_rt;
  const int pt = blockIdx.x * kThreads + threadIdx.x;
  const int b = pose_of(blockIdx.y, blockIdx.z);
  if (b >= bsz) return;  // past the last pose: the whole block
  const float* r = rot + (long long)b * N_OUT * n_in;

  // the block's own constants: each rotation entry and each scale with its
  // split, as (value, hi, lo)
  constexpr int kEntries = N_IN > 0 ? N_OUT * N_IN : 1;
  __shared__ float r_split[kEntries][3];
  __shared__ float s_split[N_OUT][3];
  {
    const int k = threadIdx.x;
    if (N_IN > 0 && k < kEntries) {
      const float v = r[k];
      r_split[k][0] = v;
      split(v, r_split[k][1], r_split[k][2]);
    } else if (k >= kEntries && k < kEntries + N_OUT) {
      const float v = ax.s[k - kEntries];
      s_split[k - kEntries][0] = v;
      split(v, s_split[k - kEntries][1], s_split[k - kEntries][2]);
    }
  }
  __syncthreads();
  if constexpr (kFrame) {
    // the single tile's slot table: every slot holds tile 0 and is live
    if (pt <= lay.n_slots)
      slots[(long long)b * (lay.n_slots + 1) + pt] =
          pt == lay.n_slots ? lay.n_slots : 0;
  }
  if (pt >= lay.n_rows) return;
  int* out = planes + (long long)b * lay.pose_stride + pt;
  if (kFrame && pt >= n_points) {
    // a filler row of the single tile's frame: inert everywhere
#pragma unroll
    for (int i = 0; i < N_OUT; ++i) out[i * lay.plane_stride] = 0;
    if (weight != nullptr) out[N_OUT * lay.plane_stride] = 0;
    out[lay.id_plane * lay.plane_stride] = __float_as_int((float)n_points);
    return;
  }
  const float* x = points + (long long)pt * n_in;

  // 1. q = R p + t as (hi, lo)
  float hi[N_OUT], lo[N_OUT];
#pragma unroll
  for (int i = 0; i < N_OUT; ++i) {
    hi[i] = tr[(long long)b * N_OUT + i];
    lo[i] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < n_in; ++j) {
    const float xj = x[j];
    float xh, xl;
    split(xj, xh, xl);
#pragma unroll
    for (int i = 0; i < N_OUT; ++i) {
      float rij, rh, rl;
      if (N_IN > 0) {
        rij = r_split[i * N_IN + j][0];
        rh = r_split[i * N_IN + j][1];
        rl = r_split[i * N_IN + j][2];
      } else {
        rij = r[i * n_in + j];
        split(rij, rh, rl);
      }
      add_product_2f(hi[i], lo[i], rij, rh, rl, xj, xh, xl);
    }
  }

  unsigned tile_key = 0u;
  int nt = 1;
  bool overlap = true;
  int enc_out[N_OUT];
#pragma unroll
  for (int i = 0; i < N_OUT; ++i) {
    // u = (q + 1) * scale - 1/2, renormalised; 2. (r0, dl) with dl in
    // (0, 1] (`voxel_and_delta_2f`, twofloat.cuh)
    int r0;
    float dl;
    voxel_and_delta_2f(hi[i], lo[i], s_split[i][0], s_split[i][1],
                       s_split[i][2], r0, dl);

    // 3. tile index, key, and the encoded coordinate; the integer
    //    arithmetic wraps as int32 tensors do (unsigned here)
    const int g = ax.g[i], t = ax.t[i];
    overlap = overlap && r0 >= -1 && r0 <= g - 1;
    const int ti = tile_of(min(max(r0, 0), g - 1), ax.inv[i]);
    tile_key = tile_key * (unsigned)ax.nts[i] + (unsigned)ti;
    nt *= ax.nts[i];
    const unsigned r_loc = (unsigned)r0 - (unsigned)(ti * t);
    const int frac = __float2int_rz(rintf(__fmul_rn(dl, (float)(1 << kFix))));
    const unsigned enc = ((r_loc + 2u) << kFix) + (unsigned)frac;
    enc_out[i] = overlap ? (int)enc : 0;
  }
  if constexpr (kFrame) {
#pragma unroll
    for (int i = 0; i < N_OUT; ++i) out[i * lay.plane_stride] = enc_out[i];
  } else if constexpr (N_OUT == 2) {
    reinterpret_cast<int2*>(planes)[(long long)b * n_points + pt] =
        make_int2(enc_out[0], enc_out[1]);
  } else {
    reinterpret_cast<int4*>(planes)[(long long)b * n_points + pt] =
        make_int4(enc_out[0], enc_out[1], enc_out[2], 0);
  }
  // 4. the sentinel key of a point that overlaps no voxel of the grid
  if (key != nullptr)
    key[(long long)b * n_points + pt] = overlap ? (int)tile_key : nt;
  if constexpr (kFrame) {
    // the frame's weight (its bits) and point-id planes
    if (weight != nullptr)
      out[N_OUT * lay.plane_stride] = __float_as_int(weight[pt]);
    out[lay.id_plane * lay.plane_stride] = __float_as_int((float)pt);
  }
}

template <int N_OUT>
cudaError_t launch(const float* points, const float* rot, const float* tr,
                   int* key, int* planes, const float* weight,
                   int* slots, int bsz, int n_points, const Layout& lay,
                   int n_in, const Axes& ax, cudaStream_t stream) {
  const bool frame = lay.id_plane >= 0;
  const int n_table = frame ? lay.n_slots + 1 : 0;
  const int n_threads = lay.n_rows > n_table ? lay.n_rows : n_table;
  const dim3 grid((n_threads + kThreads - 1) / kThreads, pose_low(bsz),
                  pose_high(bsz));
#define DPRAST_LAUNCH(N_IN, FRAME)                                           \
  coords_kernel<N_OUT, N_IN, FRAME><<<grid, kThreads, 0, stream>>>(          \
      points, rot, tr, key, planes, weight, slots, bsz, n_points, lay, n_in, \
      ax)
  if (n_in == 2) {
    if (frame) DPRAST_LAUNCH(2, true); else DPRAST_LAUNCH(2, false);
  } else if (n_in == 3) {
    if (frame) DPRAST_LAUNCH(3, true); else DPRAST_LAUNCH(3, false);
  } else {
    if (frame) DPRAST_LAUNCH(0, true); else DPRAST_LAUNCH(0, false);
  }
#undef DPRAST_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// `key` may be null: the store of the keys is then left out.  With
// `id_plane` < 0 `planes` is (B, P, L), L = 2 where n_out is 2 and 4 where
// it is 3 (lane 3 written 0), and `weight` and `slots` are
// null.  With `id_plane` >= 0 `planes` is the single tile's frame (B,
// id_plane + 1, n_rows), n_rows >= P, whose plane n_out holds `weight`
// where that is not null, and `slots` its slot table (B, n_slots + 1),
// n_slots <= n_rows.  n_out is 2 or 3, n_in >= 1, B >= 1, P >= 1,
// and on every axis g >= 1, t >= 1 and g t < 2^32.
extern "C" int dprast_coords(const void* points, const void* rot,
                             const void* tr, void* key, void* planes,
                             const void* weight, void* slots, int bsz,
                             int n_points, int n_rows, int id_plane,
                             int n_slots, int n_in, int n_out, int g0, int g1,
                             int g2, int t0, int t1, int t2, float s0,
                             float s1, float s2, void* stream) {
  if ((n_out != 2 && n_out != 3) || n_in < 1 || bsz < 1 || n_points < 1)
    return (int)cudaErrorInvalidValue;
  const bool frame = id_plane >= 0;
  if (frame ? (n_rows < n_points || slots == nullptr || n_slots < 1 ||
               n_slots > n_rows ||
               id_plane != n_out + (weight != nullptr ? 1 : 0))
            : (n_rows != n_points || weight != nullptr || slots != nullptr))
    return (int)cudaErrorInvalidValue;
  Layout lay;
  lay.pose_stride = frame ? (long long)(id_plane + 1) * n_rows : 0;
  lay.plane_stride = frame ? n_rows : 0;
  lay.n_rows = n_rows;
  lay.id_plane = id_plane;
  lay.n_slots = n_slots;
  Axes ax = {{g0, g1, g2}, {t0, t1, t2}, {1, 1, 1}, {0u, 0u, 0u},
             {s0, s1, s2}};
  for (int i = 0; i < n_out; ++i) {
    const long long g = ax.g[i], t = ax.t[i];
    if (g < 1 || t < 1 || g * t >= (1ll << 32))
      return (int)cudaErrorInvalidValue;
    ax.nts[i] = (int)((g + t - 1) / t);
    ax.inv[i] = t == 1 ? 0u : (unsigned)((1ll << 32) / t + 1);
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      n_out == 2
          ? launch<2>((const float*)points, (const float*)rot,
                      (const float*)tr, (int*)key, (int*)planes,
                      (const float*)weight, (int*)slots, bsz, n_points, lay,
                      n_in, ax, s)
          : launch<3>((const float*)points, (const float*)rot,
                      (const float*)tr, (int*)key, (int*)planes,
                      (const float*)weight, (int*)slots, bsz, n_points, lay,
                      n_in, ax, s);
  return (int)err;
}
