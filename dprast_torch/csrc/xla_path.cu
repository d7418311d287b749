// The `xla` backend's path on the card: X1, X2 and X3.
//
// Replaces the device code that XLA compiles `dprast/ops/core.py` into
// under `jit`: no `pl.pallas_call`, a handful of fused loops.
//
// X1 `xla_neighbours` (`_neighbour_data`, core.py:44-70, and the scatter's
//    operand, :103): one thread per (pose b, point p).  The pose's voxel
//    and deltas (`geometry.pose_voxel_and_deltas`: the double-float32
//    transform of twofloat.cuh for fp32, the plain transform for fp64),
//    then for each of the 2^N shifts s (bit i of s is axis i's shift) the
//    neighbour's flat index with the out-of-grid test, the hat weight
//    W_s = prod_i (s_i ? dl_i : 1 - dl_i) multiplied left to right, and the
//    term W_s ow[b] pw[p].  It writes what its caller asks for (a null
//    pointer is a store left out): the scatter's sort keys, b * total +
//    flat (B * total for an out-of-grid term, which sorts last and is
//    never stored; int32 or int64), its term values, and the residuals of
//    the fused pair: the voxel r0 (B, P, N) int32 and the deltas dl (B, P,
//    N), from which X3 makes each neighbour's index and weight again.
//
// X2 `xla_scatter` (the scatter-add into `jnp.full`, core.py:103-112):
//    the volume filled with each pose's background (its own filler, 16
//    bytes a store), then, on the keys sorted stably (`torch.sort`), each
//    run of equal keys added onto its voxel in the sort's order, one add
//    at a time: out[k] = (((bg + v0) + v1) + ...).  That is the order of
//    `index_add_` on the CPU, so the card's forward has the CPU's bits.
//    One writer per voxel, no atomics.
//
// X3 `xla_gather` (the gather with `mode="fill"` and the products of
//    `_pullback_impl`, core.py:160-193): one thread per (pose, point)
//    makes its 2^N neighbours' indices and hat weights from r0 and dl as
//    X1 does, reads the 2^N cotangent values in place (an out-of-grid
//    neighbour reads 0) and writes gw = sum_s g_s W_s and
//    scaled_i = (sum_s g_s ow pw dW_s/ddl_i) * g_i / 2, each sum over s in
//    increasing s.  The contractions over poses and points that follow
//    stay small torch products, as JAX computes them outside any kernel.
//
// What bounds them.  Bytes, and the sectors of random accesses: X1 writes
// 2^N x (key + term) + N x (r0 + dl) bytes a (pose, point) and reads 4 to
// 8 x (n_in + N) more; X3 reads N x (r0 + dl) bytes and 2^N scattered
// cotangent values (a 32-byte sector apiece, where the two neighbours along
// the last axis share one); X2 reads a key, an index and a term a sorted
// position (the term through the sort's permutation: a sector apiece) and
// writes each voxel it adds to (a sector apiece).  None of them is near its
// bound by arithmetic.
//
// What the design does about it.
// - Every + and * is an `__f*_rn` / `__d*_rn` intrinsic in the order of the
//   plain versions (`core._xla_neighbours_plain`, `_xla_gather_plain`),
//   which nvcc never contracts into an FMA, so X1 and X3 give their bits.
// - Rows of a (pose, point) lie side by side, (B, P, M).  X1 stages each
//   output through shared memory and a block copies its rows out in order
//   (`stage_out`), so a warp's stores cover whole lines where each
//   thread's own 2^N stores at a stride of 2^N touched a sector apiece.
// - The residuals are the voxel and the deltas, N x 8 bytes a (pose,
//   point) where the expanded ones (`_neighbour_data`'s index and weight
//   of each neighbour) were 2^N x 12 more: X1 stores and X3 reads 24 in
//   place of 120 bytes a point in 3-D, at a stride of 12 bytes (a warp's
//   three loads of a row fall on the same lines).  X3 issues all 2^N
//   cotangent reads of a point (ranks 1-4) before the first product uses
//   one, and no thread waits for another.
// - X2's run kernel: a block stages 1,024 sorted positions, their keys and
//   their terms gathered through the permutation (all of a thread's loads
//   issued before one is used), in shared memory.  The head of each run
//   adds it there onto the pose's background `bg[b]` (the value the fill
//   wrote, so the voxel is never read), four positions in one step and,
//   past them, to the run's end found by a galloping search, and stores
//   it once.  The one run that goes on past the block is finished by the
//   block: its warps 1-7 load the next 448 terms while thread 0 adds the
//   448 before, so a run of 10^6 terms costs its adds, not 10^6 / 32
//   rounds of loads.
// - N_OUT 1-4 is unrolled; any other rank (up to kMaxAxes) runs the same
//   code with the rank read at run time.

#include <cuda_runtime.h>

#include <type_traits>

#include "poses.cuh"
#include "twofloat.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAxes = 16;

struct Grid {
  int n;                     // output axes
  int g[kMaxAxes];           // grid size per axis
  long long st[kMaxAxes];    // row-major stride per axis
  double s[kMaxAxes];        // g / 2
  long long total;           // voxels a pose
};

template <typename T>
__device__ __forceinline__ T add_rn(T a, T b) {
  if constexpr (std::is_same<T, float>::value) return __fadd_rn(a, b);
  else return __dadd_rn(a, b);
}
template <typename T>
__device__ __forceinline__ T sub_rn(T a, T b) {
  if constexpr (std::is_same<T, float>::value) return __fsub_rn(a, b);
  else return __dsub_rn(a, b);
}
template <typename T>
__device__ __forceinline__ T mul_rn(T a, T b) {
  if constexpr (std::is_same<T, float>::value) return __fmul_rn(a, b);
  else return __dmul_rn(a, b);
}

// The hat weight and flat index of shift s (bit i: axis i's shift) of a
// point at voxel r0 with deltas dl (om = 1 - dl): W_s multiplied left to
// right; the index -1 out of grid.  The index wraps as an int32 tensor's
// sum does.
template <typename T, int kAx>
__device__ __forceinline__ void neighbour(int s, int n, const int* r0,
                                          const T* dl, const T* om,
                                          const Grid& gr, T& w,
                                          long long& flat) {
  bool inb = true;
  flat = 0;
  w = T(0);
#pragma unroll
  for (int i = 0; i < kAx; ++i) {
    if (i < n) {
      const int bit = (s >> i) & 1;
      const T sel = bit ? dl[i] : om[i];
      w = i == 0 ? sel : mul_rn(w, sel);
      const int ix = (int)((unsigned)r0[i] + (unsigned)bit);
      inb = inb && ix >= 0 && ix < gr.g[i];
      flat += (long long)ix * gr.st[i];
    }
  }
  if (!inb) flat = -1;
}

// A block's stores of M values a row, `value(m)` of its thread's row, to
// out[(row0 + t) M + m] for its `count` rows, through shared memory: each
// thread writes its values at a stride that is odd (no bank conflict),
// then the block copies the rows out in order, so a warp's stores cover
// whole lines where each thread's own M strided stores would touch a
// sector apiece.  Every thread of the block calls it.
template <int M, typename V, typename F>
__device__ __forceinline__ void stage_out(V* __restrict__ out, long long row0,
                                          int count, bool live, F value,
                                          long long* smem) {
  constexpr int kStride = M % 2 ? M : M + 1;
  V* buf = reinterpret_cast<V*>(smem);
  __syncthreads();
  if (live) {
#pragma unroll
    for (int m = 0; m < M; ++m) buf[threadIdx.x * kStride + m] = value(m);
  }
  __syncthreads();
  V* dst = out + row0 * M;
  for (int k = threadIdx.x; k < count * M; k += kThreads)
    dst[k] = buf[(k / M) * kStride + k % M];
}

// X1.  `keys` is int64 where `key64`, else int32.
template <typename T, int N_OUT>
__global__ void __launch_bounds__(kThreads)
xla_neighbours_kernel(const T* __restrict__ points,  // (P, n_in)
                      const T* __restrict__ rot,     // (B, n, n_in)
                      const T* __restrict__ tr,      // (B, n)
                      const T* __restrict__ ow, long long ow_stride,
                      const T* __restrict__ pw, long long pw_stride,
                      void* __restrict__ keys, int key64,
                      T* __restrict__ vals,            // (B, P, S) or null
                      int* __restrict__ r0_out,        // (B, P, n) or null
                      T* __restrict__ dl_out,          // (B, P, n) or null
                      int bsz, int n_points, int n_in, Grid gr) {
  const int n = N_OUT > 0 ? N_OUT : gr.n;
  constexpr int kAx = N_OUT > 0 ? N_OUT : kMaxAxes;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int b = pose_of(blockIdx.y, blockIdx.z);
  if (b >= bsz) return;  // past the last pose: the whole block
  // rows past the cloud take part in the staged stores (N_OUT > 0) only
  const bool live = p < n_points;
  if (N_OUT == 0 && !live) return;
  const T* r = rot + (long long)b * n * n_in;
  const T* x = points + (long long)(live ? p : 0) * n_in;

  int r0[kAx];
  T dl[kAx];
  if constexpr (std::is_same<T, float>::value) {
    // q = R p + t as (hi, lo), then u, r0 and dl (twofloat.cuh), as B6
    float hi[kAx], lo[kAx];
#pragma unroll
    for (int i = 0; i < kAx; ++i) {
      if (i < n) {
        hi[i] = tr[(long long)b * n + i];
        lo[i] = 0.0f;
      }
    }
    for (int j = 0; j < n_in; ++j) {
      const float xj = x[j];
      float xh, xl;
      split(xj, xh, xl);
#pragma unroll
      for (int i = 0; i < kAx; ++i) {
        if (i < n) {
          const float rij = r[(long long)i * n_in + j];
          float rh, rl;
          split(rij, rh, rl);
          add_product_2f(hi[i], lo[i], rij, rh, rl, xj, xh, xl);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kAx; ++i) {
      if (i < n) {
        const float sc = (float)gr.s[i];
        float sh, sl;
        split(sc, sh, sl);
        voxel_and_delta_2f(hi[i], lo[i], sc, sh, sl, r0[i], dl[i]);
      }
    }
  } else {
    // q = ((R[:, 0] p0 + R[:, 1] p1) + ...) + t; u = (q + 1) s - 1/2;
    // r0 = ceil(u) - 1, dl = u - r0
#pragma unroll
    for (int i = 0; i < kAx; ++i) {
      if (i < n) {
        const T* ri = r + (long long)i * n_in;
        double q = __dmul_rn(ri[0], x[0]);
        for (int j = 1; j < n_in; ++j) q = __dadd_rn(q, __dmul_rn(ri[j], x[j]));
        q = __dadd_rn(q, tr[(long long)b * n + i]);
        const double u = __dsub_rn(__dmul_rn(__dadd_rn(q, 1.0), gr.s[i]), 0.5);
        const double r0f = __dsub_rn(ceil(u), 1.0);
        dl[i] = __dsub_rn(u, r0f);
        r0[i] = __double2int_rz(r0f);
      }
    }
  }

  T om[kAx];
#pragma unroll
  for (int i = 0; i < kAx; ++i)
    if (i < n) om[i] = sub_rn(T(1), dl[i]);
  const T c_ow = ow[(long long)b * ow_stride];
  const T c_pw = live ? pw[(long long)p * pw_stride] : T(0);
  const long long total = gr.total;
  const long long sink = (long long)bsz * total;

  if constexpr (N_OUT > 0) {
    constexpr int S = 1 << N_OUT;
    __shared__ long long smem[kThreads * (S + 1)];
    T w[S];
    long long flat[S];
#pragma unroll
    for (int s = 0; s < S; ++s)
      neighbour<T, N_OUT>(s, N_OUT, r0, dl, om, gr, w[s], flat[s]);
    const int first = blockIdx.x * kThreads;
    const long long row0 = (long long)b * n_points + first;
    const int count = min(kThreads, n_points - first);
    if (vals != nullptr)
      stage_out<S>(vals, row0, count, live,
                   [&](int s) { return mul_rn(mul_rn(w[s], c_ow), c_pw); },
                   smem);
    if (keys != nullptr) {
      const auto key = [&](int s) {
        return flat[s] >= 0 ? (long long)b * total + flat[s] : sink;
      };
      if (key64)
        stage_out<S>(static_cast<long long*>(keys), row0, count, live, key,
                     smem);
      else
        stage_out<S>(static_cast<int*>(keys), row0, count, live,
                     [&](int s) { return (int)key(s); }, smem);
    }
    if (r0_out != nullptr)
      stage_out<N_OUT>(r0_out, row0, count, live,
                       [&](int i) { return r0[i]; }, smem);
    if (dl_out != nullptr)
      stage_out<N_OUT>(dl_out, row0, count, live,
                       [&](int i) { return dl[i]; }, smem);
  } else {
    const long long row = (long long)b * n_points + p;
    for (int i = 0; i < n; ++i) {
      if (r0_out != nullptr) r0_out[row * n + i] = r0[i];
      if (dl_out != nullptr) dl_out[row * n + i] = dl[i];
    }
    const int n_s = keys != nullptr || vals != nullptr ? 1 << n : 0;
    for (int s = 0; s < n_s; ++s) {
      T w;
      long long flat;
      neighbour<T, kAx>(s, n, r0, dl, om, gr, w, flat);
      const long long e = row * n_s + s;
      if (vals != nullptr) vals[e] = mul_rn(mul_rn(w, c_ow), c_pw);
      if (keys != nullptr) {
        const long long k = flat >= 0 ? (long long)b * total + flat : sink;
        if (key64) static_cast<long long*>(keys)[e] = k;
        else static_cast<int*>(keys)[e] = (int)k;
      }
    }
  }
}

// X2's filler: out (B, total) <- bg[b], one pose on y (z past 65,535
// poses), the pose's voxels grid-stride on x, 16 bytes a store where
// `vec` (total a multiple of the vector and `out` 16-byte aligned).
template <typename T>
__global__ void __launch_bounds__(kThreads)
xla_fill_kernel(T* __restrict__ out, const T* __restrict__ bg,
                long long bg_stride, long long total, int bsz, int vec) {
  const int b = pose_of(blockIdx.y, blockIdx.z);
  if (b >= bsz) return;
  const T v = bg[(long long)b * bg_stride];
  T* o = out + (long long)b * total;
  const long long step = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (vec) {
    using V = typename std::conditional<std::is_same<T, float>::value,
                                        float4, double2>::type;
    constexpr int kVec = sizeof(V) / sizeof(T);
    V vv;
    T* lanes = reinterpret_cast<T*>(&vv);
#pragma unroll
    for (int k = 0; k < kVec; ++k) lanes[k] = v;
    V* ov = reinterpret_cast<V*>(o);
    for (long long i = first; i < total / kVec; i += step) ov[i] = vv;
  } else {
    for (long long i = first; i < total; i += step) o[i] = v;
  }
}

// X2's run kernel: a thread's sorted positions, a block's, the threads
// that load the open run's next terms (warps 1-7), its positions a round
constexpr int kRunsPer = 4;
constexpr int kRunTile = kThreads * kRunsPer;
constexpr int kLoaders = kThreads - 32;
constexpr int kCarryPer = 2;
constexpr int kCarry = kLoaders * kCarryPer;
static_assert(2 * kCarry <= kRunTile, "the carry's two halves fit the tile");

// acc + v[from] + v[from + 1] + ... + v[to - 1], one add at a time in that
// order, unrolled by eight (the loads of eight terms ahead of their adds)
template <typename T>
__device__ __forceinline__ T add_terms(T acc, const T* v, int from, int to) {
#pragma unroll 8
  for (int q = from; q < to; ++q) acc = add_rn(acc, v[q]);
  return acc;
}

// X2.  `keys` (n,) sorted, `perm` (n,) the sort's permutation of the
// terms `vals`; `out` the flat (B * total) volume, which the fill has set
// to each pose's background `bg` (element stride `bg_stride`).  Keys at or
// past `limit` (B * total) are out of grid and skipped.
template <typename T, typename K>
__global__ void __launch_bounds__(kThreads)
xla_scatter_kernel(T* __restrict__ out, const K* __restrict__ keys,
                   const long long* __restrict__ perm,
                   const T* __restrict__ vals, const T* __restrict__ bg,
                   long long bg_stride, long long n, long long total,
                   long long limit) {
  __shared__ K s_key[kRunTile];
  __shared__ T s_val[kRunTile];
  __shared__ K s_edge[2];  // the keys just before and just after the block's
  __shared__ T s_acc;      // the open run's sum at the block's end
  __shared__ int s_open;   // whether a run headed here goes on past it
  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * kRunTile;
  const int cnt = (int)min((long long)kRunTile, n - t0);
  // no live key equals `limit`: it marks a position past the keys
  const K none = (K)limit;

  // the block's keys and terms into shared memory, every load of a thread
  // issued before one is used
  K kr[kRunsPer];
  long long pr[kRunsPer];
  T vr[kRunsPer];
#pragma unroll
  for (int r = 0; r < kRunsPer; ++r) {
    const int j = r * kThreads + tid;
    kr[r] = j < cnt ? keys[t0 + j] : none;
    pr[r] = j < cnt ? perm[t0 + j] : 0;
  }
#pragma unroll
  for (int r = 0; r < kRunsPer; ++r)
    vr[r] = (long long)kr[r] < limit ? vals[pr[r]] : T(0);
#pragma unroll
  for (int r = 0; r < kRunsPer; ++r) {
    s_key[r * kThreads + tid] = kr[r];
    s_val[r * kThreads + tid] = vr[r];
  }
  if (tid == 0) {
    s_edge[0] = t0 > 0 ? keys[t0 - 1] : none;
    s_edge[1] = t0 + cnt < n ? keys[t0 + cnt] : none;
    s_open = 0;
  }
  __syncthreads();

  // each head adds its run here onto the pose's background: its first
  // four positions in one step; past them the run's end by a galloping
  // search, then a binary one, and its terms eight loads ahead
  const bool one_pose = total >= limit;
#pragma unroll
  for (int r = 0; r < kRunsPer; ++r) {
    const int j = r * kThreads + tid;
    const K key = kr[r];
    if ((long long)key >= limit) continue;
    if ((j > 0 ? s_key[j - 1] : s_edge[0]) == key) continue;
    const long long b = one_pose ? 0 : (long long)key / total;
    T acc = bg[b * bg_stride];
    K kq[4];
    T vq[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = j + u < kRunTile;
      kq[u] = in ? s_key[j + u] : none;
      vq[u] = in ? s_val[j + u] : T(0);
    }
    int e = j;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (kq[u] != key) break;
      acc = add_rn(acc, vq[u]);
      ++e;
    }
    if (e == j + 4) {
      int lo = e - 1, d = 1;
      while (lo + d < kRunTile && s_key[lo + d] == key) {
        lo += d;
        d <<= 1;
      }
      int hi = min(lo + d, kRunTile);
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_key[mid] == key) lo = mid;
        else hi = mid;
      }
      acc = add_terms(acc, s_val, e, hi);
      e = hi;
    }
    if (e == cnt && s_edge[1] == key) {
      s_acc = acc;
      s_open = 1;
    } else {
      out[key] = acc;
    }
  }
  __syncthreads();
  if (!s_open) return;

  // the run open at the block's end goes on past it: each round the
  // loaders put its next kCarry terms into one half of s_val while thread
  // 0 adds those of the other half, in order; the loaders hold the keys
  // and indices of the round after in registers
  const K run = s_edge[1];
  T acc = s_acc;
  const int q0 = tid - 32;
  const bool loader = tid >= 32;
  const long long base = t0 + cnt;
  K kc[kCarryPer];
  long long pc[kCarryPer];
  const auto load_keys = [&](long long start) {
#pragma unroll
    for (int r = 0; r < kCarryPer; ++r) {
      const long long j = start + q0 + r * kLoaders;
      const bool in = loader && j < n;
      kc[r] = in ? keys[j] : none;
      pc[r] = in ? perm[j] : 0;
    }
  };
  const auto count = [&](const bool* m) {
    int c = 0;
#pragma unroll
    for (int r = 0; r < kCarryPer; ++r) c += __syncthreads_count(m[r]);
    return c;
  };
  bool m[kCarryPer];
  load_keys(base);
#pragma unroll
  for (int r = 0; r < kCarryPer; ++r) {
    m[r] = kc[r] == run;
    if (m[r]) s_val[q0 + r * kLoaders] = vals[pc[r]];
  }
  load_keys(base + kCarry);
  int len = count(m);
  for (long long c = 0;; ++c) {
    const bool go_on = len == kCarry;
    T x[kCarryPer];
#pragma unroll
    for (int r = 0; r < kCarryPer; ++r) {
      m[r] = go_on && kc[r] == run;
      x[r] = m[r] ? vals[pc[r]] : T(0);
    }
    if (go_on) load_keys(base + (c + 2) * kCarry);
    if (tid == 0) acc = add_terms(acc, s_val + (c & 1) * kCarry, 0, len);
    T* next = s_val + ((c + 1) & 1) * kCarry;
#pragma unroll
    for (int r = 0; r < kCarryPer; ++r)
      if (m[r]) next[q0 + r * kLoaders] = x[r];
    const int more = count(m);
    if (!go_on) break;
    len = more;
  }
  if (tid == 0) out[run] = acc;
}

// X3.
template <typename T, int N_OUT>
__global__ void __launch_bounds__(kThreads)
xla_gather_kernel(const T* __restrict__ g,          // (B * total)
                  const int* __restrict__ r0_in,    // (B, P, n)
                  const T* __restrict__ dl_in,      // (B, P, n)
                  const T* __restrict__ ow, long long ow_stride,
                  const T* __restrict__ pw, long long pw_stride,
                  T* __restrict__ scaled,           // (B, P, n)
                  T* __restrict__ gw_out,           // (B, P)
                  int bsz, int n_points, Grid gr) {
  const int n = N_OUT > 0 ? N_OUT : gr.n;
  constexpr int kAx = N_OUT > 0 ? N_OUT : kMaxAxes;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int b = pose_of(blockIdx.y, blockIdx.z);
  if (b >= bsz || p >= n_points) return;
  const long long row = (long long)b * n_points + p;
  const T* gb = g + (long long)b * gr.total;
  int r0[kAx];
  T dl[kAx], om[kAx], acc[kAx];
#pragma unroll
  for (int i = 0; i < kAx; ++i) {
    if (i < n) {
      r0[i] = r0_in[row * n + i];
      dl[i] = dl_in[row * n + i];
    }
  }
#pragma unroll
  for (int i = 0; i < kAx; ++i) {
    if (i < n) {
      om[i] = sub_rn(T(1), dl[i]);
      acc[i] = T(0);
    }
  }
  const T c = mul_rn(ow[(long long)b * ow_stride],
                     pw[(long long)p * pw_stride]);
  T gw = T(0);
  // the products of shift s, in the plain version's order
  const auto add_shift = [&](int s, T gv, T w) {
    const T t = mul_rn(gv, w);
    gw = s == 0 ? t : add_rn(gw, t);
    const T f = mul_rn(gv, c);
#pragma unroll
    for (int i = 0; i < kAx; ++i) {
      if (i < n) {
        // dW_s / ddl_i = (s_i ? +1 : -1) prod_{j != i} (s_j ? dl_j : 1 - dl_j)
        T d = T(1);
        bool lead = true;
#pragma unroll
        for (int j = 0; j < kAx; ++j) {
          if (j < n && j != i) {
            const T sel = (s >> j) & 1 ? dl[j] : om[j];
            d = lead ? sel : mul_rn(d, sel);
            lead = false;
          }
        }
        d = mul_rn((s >> i) & 1 ? T(1) : T(-1), d);
        const T term = mul_rn(f, d);
        acc[i] = s == 0 ? term : add_rn(acc[i], term);
      }
    }
  };
  if constexpr (N_OUT > 0) {
    // every neighbour's index and weight, then all 2^N reads, then the
    // products
    constexpr int S = 1 << N_OUT;
    T w[S], gv[S];
    long long flat[S];
#pragma unroll
    for (int s = 0; s < S; ++s)
      neighbour<T, N_OUT>(s, N_OUT, r0, dl, om, gr, w[s], flat[s]);
#pragma unroll
    for (int s = 0; s < S; ++s) gv[s] = flat[s] >= 0 ? gb[flat[s]] : T(0);
#pragma unroll
    for (int s = 0; s < S; ++s) add_shift(s, gv[s], w[s]);
  } else {
    const int n_s = 1 << n;
    for (int s = 0; s < n_s; ++s) {
      T w;
      long long flat;
      neighbour<T, kAx>(s, n, r0, dl, om, gr, w, flat);
      add_shift(s, flat >= 0 ? gb[flat] : T(0), w);
    }
  }
#pragma unroll
  for (int i = 0; i < kAx; ++i)
    if (i < n) scaled[row * n + i] = mul_rn(acc[i], (T)gr.s[i]);
  gw_out[row] = gw;
}

bool make_grid(int n_out, const int* sizes, Grid& gr) {
  if (n_out < 1 || n_out > kMaxAxes) return false;
  gr.n = n_out;
  long long total = 1;
  for (int i = n_out - 1; i >= 0; --i) {
    if (sizes[i] < 1) return false;
    gr.g[i] = sizes[i];
    gr.st[i] = total;
    gr.s[i] = sizes[i] / 2.0;
    total *= sizes[i];
  }
  gr.total = total;
  return true;
}

dim3 pose_grid(int bsz, int n_points) {
  return dim3((n_points + kThreads - 1) / kThreads, pose_low(bsz),
              pose_high(bsz));
}

}  // namespace

// X1.  points (P, n_in), rot (B, n_out, n_in), tr (B, n_out), ow and pw
// with element strides (0 for a broadcast value); fp32 where `f64` is 0,
// else fp64.  Any of keys, vals (B, P, 2^n_out), r0 (int32) and dl (B,
// P, n_out) may be null (that output is not written); keys are int64 where
// `key64`, else int32 (then B * total < 2^31).  n_out 1-16, n_in >= 1,
// B >= 1, P >= 1.
extern "C" int dprast_xla_neighbours(
    const void* points, const void* rot, const void* tr, const void* ow,
    long long ow_stride, const void* pw, long long pw_stride, void* keys,
    int key64, void* vals, void* r0, void* dl, int bsz,
    int n_points, int n_in, int n_out, const int* sizes, int f64,
    void* stream) {
  Grid gr;
  if (!make_grid(n_out, sizes, gr) || n_in < 1 || bsz < 1 || n_points < 1 ||
      (keys != nullptr && !key64 && (long long)bsz * gr.total >= (1ll << 31)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = pose_grid(bsz, n_points);
  const cudaStream_t s = (cudaStream_t)stream;
#define DPRAST_LAUNCH(T, N)                                                  \
  xla_neighbours_kernel<T, N><<<grid, kThreads, 0, s>>>(                     \
      (const T*)points, (const T*)rot, (const T*)tr, (const T*)ow,           \
      ow_stride, (const T*)pw, pw_stride, keys, key64, (T*)vals,             \
      (int*)r0, (T*)dl, bsz, n_points, n_in, gr)
#define DPRAST_RANKS(T)                                                      \
  switch (n_out) {                                                           \
    case 1: DPRAST_LAUNCH(T, 1); break;                                      \
    case 2: DPRAST_LAUNCH(T, 2); break;                                      \
    case 3: DPRAST_LAUNCH(T, 3); break;                                      \
    case 4: DPRAST_LAUNCH(T, 4); break;                                      \
    default: DPRAST_LAUNCH(T, 0);                                            \
  }
  if (f64) {
    DPRAST_RANKS(double)
  } else {
    DPRAST_RANKS(float)
  }
#undef DPRAST_LAUNCH
  return (int)cudaGetLastError();
}

// X2.  out (B * total) <- bg[b] (bg with an element stride), then each
// voxel's run of terms added from bg[b]: keys (n,) sorted stably, int64
// where `key64` else int32; perm (n,) int64; vals the unsorted terms.
// Keys >= B * total are skipped.
extern "C" int dprast_xla_scatter(void* out, const void* bg,
                                  long long bg_stride, const void* keys,
                                  int key64, const void* perm,
                                  const void* vals, long long n, int bsz,
                                  long long total, int f64, void* stream) {
  if (bg == nullptr || n < 0 || bsz < 1 || total < 1)
    return (int)cudaErrorInvalidValue;
  const long long limit = (long long)bsz * total;
  if (!key64 && limit >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  {
    const int per = f64 ? 2 : 4;
    const int vec = total % per == 0 && (unsigned long long)out % 16 == 0;
    const long long units = vec ? total / per : total;
    // about 8,192 blocks in all: a pose's share, at least one
    long long bx = (units + kThreads - 1) / kThreads;
    const long long cap = 8192 / bsz > 1 ? 8192 / bsz : 1;
    if (bx > cap) bx = cap;
    const dim3 grid((unsigned)bx, pose_low(bsz), pose_high(bsz));
    if (f64)
      xla_fill_kernel<double><<<grid, kThreads, 0, s>>>(
          (double*)out, (const double*)bg, bg_stride, total, bsz, vec);
    else
      xla_fill_kernel<float><<<grid, kThreads, 0, s>>>(
          (float*)out, (const float*)bg, bg_stride, total, bsz, vec);
  }
  if (n == 0) return (int)cudaGetLastError();
  const long long blocks = (n + kRunTile - 1) / kRunTile;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
#define DPRAST_LAUNCH(T, K)                                                  \
  xla_scatter_kernel<T, K><<<(unsigned)blocks, kThreads, 0, s>>>(            \
      (T*)out, (const K*)keys, (const long long*)perm, (const T*)vals,       \
      (const T*)bg, bg_stride, n, total, limit)
  if (f64) {
    if (key64) DPRAST_LAUNCH(double, long long);
    else DPRAST_LAUNCH(double, int);
  } else {
    if (key64) DPRAST_LAUNCH(float, long long);
    else DPRAST_LAUNCH(float, int);
  }
#undef DPRAST_LAUNCH
  return (int)cudaGetLastError();
}

// X3.  g the cotangent (B, *grid) in place; r0 (int32) and dl (B, P,
// n_out) the residuals of X1; ow, pw with element strides -> scaled (B, P,
// n_out) and gw (B, P).
extern "C" int dprast_xla_gather(const void* g, const void* r0,
                                 const void* dl,
                                 const void* ow, long long ow_stride,
                                 const void* pw, long long pw_stride,
                                 void* scaled, void* gw, int bsz,
                                 int n_points, int n_out, const int* sizes,
                                 int f64, void* stream) {
  Grid gr;
  if (!make_grid(n_out, sizes, gr) || bsz < 1 || n_points < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid = pose_grid(bsz, n_points);
  const cudaStream_t s = (cudaStream_t)stream;
#define DPRAST_LAUNCH(T, N)                                                  \
  xla_gather_kernel<T, N><<<grid, kThreads, 0, s>>>(                         \
      (const T*)g, (const int*)r0, (const T*)dl,                             \
      (const T*)ow, ow_stride, (const T*)pw, pw_stride, (T*)scaled, (T*)gw,  \
      bsz, n_points, gr)
  if (f64) {
    DPRAST_RANKS(double)
  } else {
    DPRAST_RANKS(float)
  }
#undef DPRAST_RANKS
#undef DPRAST_LAUNCH
  return (int)cudaGetLastError();
}
