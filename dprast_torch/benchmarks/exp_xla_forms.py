"""The `xla` path's X2 run kernel and X3 in other forms, on one CUDA card:
what each redesign moved, in turns against the form before it.

Forms of X3 (`core.xla_gather`), each a kernel on float32 at ranks 1-4:

- ``parent``: X3 before its redesign: one thread a (pose, point) reads
  `_neighbour_data`'s expanded residuals (the int64 index and the hat
  weight of each of its 2^N neighbours, and the deltas) at a stride of
  2^N, each cotangent read in the loop that uses it;
- ``staged``: the same expanded residuals, copied by the block into
  shared memory with coalesced loads (`stage_in`), all 2^N cotangent
  reads issued before the first product, `scaled` stored through shared
  memory;
- ``compact staged``: the residuals the fused pair now saves, each (pose,
  point)'s voxel and deltas (24 bytes a point in 3-D where the expanded
  ones take 120), staged in by the block as in ``staged``; the indices
  and weights made again as X1 makes them;
- ``compact``: the package's X3 (`csrc/xla_path.cu`) on those residuals,
  each thread loading its own row (12 bytes apart: a warp's loads fall on
  the same lines) and waiting for no other.

Forms of X2's run kernel (`core.xla_scatter`, after its fill), on the
volume the package's fill wrote:

- ``parent``: before its redesign: a warp's 32 sorted positions
  broadcast by shuffles, each run's head lane reads its voxel back and
  adds, a run past the warp finished 32 terms a round;
- ``walk``: the first redesign: a block's 1,024 positions staged in
  shared memory, each run's head walks it four positions a step from the
  pose's background and stores its voxel;
- ``sector``: one thread owns each 32-byte sector the terms reach, adds
  each of its runs from their backgrounds and stores the whole sector (no
  store is a part of a sector);
- ``package``: ``walk`` whose heads, past a run's first four positions,
  find its end by a galloping search and add the rest unrolled by eight
  (``package fill``: the fill it follows);
- ``one pass``: the fill and the runs together, not on the filled volume:
  a block owns 4,096 voxels, finds their sorted positions by a search of
  the keys, adds their runs onto the background in shared memory and
  writes each voxel once (one pose).

All but ``package`` and ``compact`` are built from the source in this
file.  Each form is held bit for bit to `_xla_gather_plain` (X3) or to
the CPU's `index_add_` order (`_xla_scatter_plain`, X2) and timed in
turns (forms in order, then back) by the device microseconds of a launch
from `torch.profiler` (the traced time over the launches the trace holds:
a trace can lose rows); X3 beside its library yardstick, one
`torch.gather` of the cotangent padded with a zero at the expanded
indices.

The rows: 1024^3 x 1 x 10^5 and 512^3 x 1 x 10^6 (`chip_smoke.py`'s timed
`xla` rows, per-point weights), and for X2 also the long run (64,) x 1 x
1.2 x 10^6 (two runs of 1.2 x 10^6 terms) and (4096,) x 1 x 10^6 (runs of
~500).  Last, the host microseconds of one `xla_gather` call at the
first row, and of each of its parts.

Usage, from the root of the repository:

    python3 -m dprast_torch.benchmarks.exp_xla_forms
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "exp_xla_forms"

SOURCE = r"""
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAxes = 16;
constexpr unsigned kFull = 0xffffffffu;

struct Grid {
  int n;
  int g[kMaxAxes];
  long long st[kMaxAxes];
  double s[kMaxAxes];
  long long total;
};

// X2's run kernel before its redesign, as it was
template <typename K>
__global__ void __launch_bounds__(kThreads)
x2_parent(float* __restrict__ out, const K* __restrict__ keys,
          const long long* __restrict__ perm,
          const float* __restrict__ vals, long long n, long long limit) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const long long warp_end = i - lane + 32;
  const bool mine = i < n;
  const K key = mine ? keys[i] : (K)limit;
  K before = __shfl_up_sync(kFull, key, 1);
  if (lane == 0) before = (i > 0 && mine) ? keys[i - 1] : (K)limit;
  const bool live = mine && (long long)key < limit;
  const bool head = live && (i == 0 || before != key);
  const float v = live ? vals[perm[i]] : 0.0f;
  float acc = head ? out[key] : 0.0f;
  bool open = head;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const K kk = __shfl_sync(kFull, key, k);
    const float vk = __shfl_sync(kFull, v, k);
    if (open && k >= lane) {
      if (kk == key) acc = __fadd_rn(acc, vk);
      else open = false;
    }
  }
  const unsigned go_on = __ballot_sync(kFull, open);
  if (go_on != 0u) {
    const int src = __ffs(go_on) - 1;
    const K run = __shfl_sync(kFull, key, src);
    for (long long base = warp_end;; base += 32) {
      const long long j = base + lane;
      const bool m = j < n && keys[j] == run;
      const float vj = m ? vals[perm[j]] : 0.0f;
      const int cnt = __popc(__ballot_sync(kFull, m));
      for (int k = 0; k < cnt; ++k) {
        const float vk = __shfl_sync(kFull, vj, k);
        if (lane == src) acc = __fadd_rn(acc, vk);
      }
      if (cnt < 32) break;
    }
  }
  if (head) out[key] = acc;
}

constexpr int kRunsPer = 4;
constexpr int kRunTile = kThreads * kRunsPer;
constexpr int kLoaders = kThreads - 32;
constexpr int kCarryPer = 2;
constexpr int kCarry = kLoaders * kCarryPer;

// X2's run kernel of the first redesign ("walk"): each run's head walks
// it in shared memory and stores its voxel alone
template <typename K>
__global__ void __launch_bounds__(kThreads)
x2_walk(float* __restrict__ out, const K* __restrict__ keys,
                   const long long* __restrict__ perm,
                   const float* __restrict__ vals, const float* __restrict__ bg,
                   long long bg_stride, long long n, long long total,
                   long long limit) {
  __shared__ K s_key[kRunTile];
  __shared__ float s_val[kRunTile];
  __shared__ K s_edge[2];  // the keys just before and just after the block's
  __shared__ float s_acc;      // the open run's sum at the block's end
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
  float vr[kRunsPer];
#pragma unroll
  for (int r = 0; r < kRunsPer; ++r) {
    const int j = r * kThreads + tid;
    kr[r] = j < cnt ? keys[t0 + j] : none;
    pr[r] = j < cnt ? perm[t0 + j] : 0;
  }
#pragma unroll
  for (int r = 0; r < kRunsPer; ++r)
    vr[r] = (long long)kr[r] < limit ? vals[pr[r]] : float(0);
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

  // each head walks its run here, from the pose's background, four
  // positions a step
  const bool one_pose = total >= limit;
#pragma unroll
  for (int r = 0; r < kRunsPer; ++r) {
    const int j = r * kThreads + tid;
    const K key = kr[r];
    if ((long long)key >= limit) continue;
    if ((j > 0 ? s_key[j - 1] : s_edge[0]) == key) continue;
    const long long b = one_pose ? 0 : (long long)key / total;
    float acc = bg[b * bg_stride];
    int e = j;
    for (;;) {
      K kq[4];
      float vq[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool in = e + u < kRunTile;
        kq[u] = in ? s_key[e + u] : none;
        vq[u] = in ? s_val[e + u] : float(0);
      }
      int m = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (kq[u] != key) break;
        acc = __fadd_rn(acc, vq[u]);
        ++m;
      }
      e += m;
      if (m < 4) break;
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
  float acc = s_acc;
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
    float v[kCarryPer];
#pragma unroll
    for (int r = 0; r < kCarryPer; ++r) {
      m[r] = go_on && kc[r] == run;
      v[r] = m[r] ? vals[pc[r]] : float(0);
    }
    if (go_on) load_keys(base + (c + 2) * kCarry);
    if (tid == 0) {
      const float* h = s_val + (c & 1) * kCarry;
#pragma unroll 8
      for (int q = 0; q < len; ++q) acc = __fadd_rn(acc, h[q]);
    }
    float* next = s_val + ((c + 1) & 1) * kCarry;
#pragma unroll
    for (int r = 0; r < kCarryPer; ++r)
      if (m[r]) next[q0 + r * kLoaders] = v[r];
    const int more = count(m);
    if (!go_on) break;
    len = more;
  }
  if (tid == 0) out[run] = acc;
}


// X3's products of shift s, in the plain version's order
template <int N>
__device__ __forceinline__ void add_shift(int s, float gv, float w, float c,
                                          const float* dl, const float* om,
                                          float& gw, float* acc) {
  const float t = __fmul_rn(gv, w);
  gw = s == 0 ? t : __fadd_rn(gw, t);
  const float f = __fmul_rn(gv, c);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float d = 1.0f;
    bool lead = true;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j != i) {
        const float sel = (s >> j) & 1 ? dl[j] : om[j];
        d = lead ? sel : __fmul_rn(d, sel);
        lead = false;
      }
    }
    d = __fmul_rn((s >> i) & 1 ? 1.0f : -1.0f, d);
    const float term = __fmul_rn(f, d);
    acc[i] = s == 0 ? term : __fadd_rn(acc[i], term);
  }
}

// form parent: each thread reads its row of the expanded residuals, a
// cotangent read in the loop that uses it
template <int N>
__global__ void __launch_bounds__(kThreads)
x3_parent(const float* __restrict__ g, const long long* __restrict__ idx,
          const float* __restrict__ ws, const float* __restrict__ dl_in,
          const float* __restrict__ ow, long long ow_stride,
          const float* __restrict__ pw, long long pw_stride,
          float* __restrict__ scaled, float* __restrict__ gw_out,
          int n_points, Grid gr) {
  constexpr int S = 1 << N;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= n_points) return;
  const long long row = (long long)b * n_points + p;
  const float* gb = g + (long long)b * gr.total;
  float dl[N], om[N], acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    dl[i] = dl_in[row * N + i];
    om[i] = __fsub_rn(1.0f, dl[i]);
    acc[i] = 0.0f;
  }
  const float c = __fmul_rn(ow[(long long)b * ow_stride],
                            pw[(long long)p * pw_stride]);
  float gw = 0.0f;
  for (int s = 0; s < S; ++s) {
    const long long e = row * S + s;
    const long long ix = idx[e];
    const float gv = (unsigned long long)ix < (unsigned long long)gr.total
                         ? gb[ix] : 0.0f;
    add_shift<N>(s, gv, ws[e], c, dl, om, gw, acc);
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    scaled[row * N + i] = __fmul_rn(acc[i], (float)gr.s[i]);
  gw_out[row] = gw;
}

// the block's rows of M values into shared memory in order, then each
// thread's row from there at an odd stride
template <int M, typename V>
__device__ __forceinline__ void stage_in(const V* __restrict__ in,
                                         long long row0, int count, bool live,
                                         V* row, long long* smem) {
  constexpr int kStride = M % 2 ? M : M + 1;
  V* buf = reinterpret_cast<V*>(smem);
  const V* src = in + row0 * M;
  __syncthreads();
  for (int k = threadIdx.x; k < count * M; k += kThreads)
    buf[(k / M) * kStride + k % M] = src[k];
  __syncthreads();
  if (live) {
#pragma unroll
    for (int m = 0; m < M; ++m) row[m] = buf[threadIdx.x * kStride + m];
  }
}

// form staged: the expanded residuals staged in, all 2^N reads first,
// `scaled` staged out
template <int N>
__global__ void __launch_bounds__(kThreads)
x3_staged(const float* __restrict__ g, const long long* __restrict__ idx,
          const float* __restrict__ ws, const float* __restrict__ dl_in,
          const float* __restrict__ ow, long long ow_stride,
          const float* __restrict__ pw, long long pw_stride,
          float* __restrict__ scaled, float* __restrict__ gw_out,
          int n_points, Grid gr) {
  constexpr int S = 1 << N;
  __shared__ long long smem[kThreads * (S + 1)];
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const bool live = p < n_points;
  const int first = blockIdx.x * kThreads;
  const long long row0 = (long long)b * n_points + first;
  const int count = min(kThreads, n_points - first);
  const float* gb = g + (long long)b * gr.total;
  long long ix[S];
  float w[S], dl[N], om[N], acc[N], gv[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    ix[s] = gr.total;
    w[s] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) dl[i] = 0.0f;
  stage_in<S>(idx, row0, count, live, ix, smem);
  stage_in<S>(ws, row0, count, live, w, smem);
  stage_in<N>(dl_in, row0, count, live, dl, smem);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    om[i] = __fsub_rn(1.0f, dl[i]);
    acc[i] = 0.0f;
  }
  const float c = live ? __fmul_rn(ow[(long long)b * ow_stride],
                                   pw[(long long)p * pw_stride]) : 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s)
    gv[s] = live && (unsigned long long)ix[s] < (unsigned long long)gr.total
                ? gb[ix[s]] : 0.0f;
  float gw = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) add_shift<N>(s, gv[s], w[s], c, dl, om, gw, acc);
  __syncthreads();
  float* buf = reinterpret_cast<float*>(smem);
  constexpr int kStride = N % 2 ? N : N + 1;
  if (live) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      buf[threadIdx.x * kStride + i] = __fmul_rn(acc[i], (float)gr.s[i]);
    gw_out[row0 + threadIdx.x] = gw;
  }
  __syncthreads();
  float* dst = scaled + row0 * N;
  for (int k = threadIdx.x; k < count * N; k += kThreads)
    dst[k] = buf[(k / N) * kStride + k % N];
}

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

// The loads' mirror of `stage_out`, for two arrays of M values a row: the
// block copies its `count` rows of each from a[(row0 + t) M + m] and
// b[...] into shared memory in order (a warp's loads cover whole lines,
// and the loads of both are in flight together), then each thread takes
// its row's values there, at an odd stride, into `row_a` and `row_b`.
// `smem` holds kThreads x (M + 1) x 16 bytes.  Every thread of the block
// calls it.
template <int M, typename A, typename B>
__device__ __forceinline__ void stage_in2(const A* __restrict__ a,
                                         const B* __restrict__ b,
                                         long long row0, int count, bool live,
                                         A* row_a, B* row_b,
                                         long long* smem) {
  constexpr int kStride = M % 2 ? M : M + 1;
  A* buf_a = reinterpret_cast<A*>(smem);
  B* buf_b = reinterpret_cast<B*>(smem + kThreads * kStride);
  const A* src_a = a + row0 * M;
  const B* src_b = b + row0 * M;
  __syncthreads();
  for (int k = threadIdx.x; k < count * M; k += kThreads) {
    const int at = (k / M) * kStride + k % M;
    buf_a[at] = src_a[k];
    buf_b[at] = src_b[k];
  }
  __syncthreads();
  if (live) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      row_a[m] = buf_a[threadIdx.x * kStride + m];
      row_b[m] = buf_b[threadIdx.x * kStride + m];
    }
  }
}

// X3 on the voxel and deltas, staged in by the block ("compact staged")
template <typename T, int N_OUT>
__global__ void __launch_bounds__(kThreads)
x3_compact_staged(const T* __restrict__ g,          // (B * total)
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
  const int b = (int)blockIdx.y;
  if (b >= bsz) return;  // past the last pose: the whole block
  // rows past the cloud take part in the staged loads and stores
  // (N_OUT > 0) only
  const bool live = p < n_points;
  if (N_OUT == 0 && !live) return;
  const long long row = (long long)b * n_points + p;
  const T* gb = g + (long long)b * gr.total;
  int r0[kAx];
  T dl[kAx], om[kAx], acc[kAx];
#pragma unroll
  for (int i = 0; i < kAx; ++i) {
    r0[i] = 0;
    dl[i] = T(0);
  }
  const int first = blockIdx.x * kThreads;
  const long long row0 = (long long)b * n_points + first;
  const int count = min(kThreads, n_points - first);
  __shared__ long long smem[kThreads * (N_OUT + 1) * 2];
  if constexpr (N_OUT > 0) {
    stage_in2<N_OUT>(r0_in, dl_in, row0, count, live, r0, dl, smem);
  } else {
#pragma unroll
    for (int i = 0; i < kAx; ++i) {
      if (i < n) {
        r0[i] = r0_in[row * n + i];
        dl[i] = dl_in[row * n + i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kAx; ++i) {
    if (i < n) {
      om[i] = sub_rn(T(1), dl[i]);
      acc[i] = T(0);
    }
  }
  const T c = live ? mul_rn(ow[(long long)b * ow_stride],
                            pw[(long long)p * pw_stride])
                   : T(0);
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
    for (int s = 0; s < S; ++s)
      gv[s] = live && flat[s] >= 0 ? gb[flat[s]] : T(0);
#pragma unroll
    for (int s = 0; s < S; ++s) add_shift(s, gv[s], w[s]);
    stage_out<N_OUT>(scaled, row0, count, live,
                     [&](int i) { return mul_rn(acc[i], (T)gr.s[i]); },
                     smem);
  } else {
    const int n_s = 1 << n;
    for (int s = 0; s < n_s; ++s) {
      T w;
      long long flat;
      neighbour<T, kAx>(s, n, r0, dl, om, gr, w, flat);
      add_shift(s, flat >= 0 ? gb[flat] : T(0), w);
    }
#pragma unroll
    for (int i = 0; i < kAx; ++i)
      if (i < n) scaled[row * n + i] = mul_rn(acc[i], (T)gr.s[i]);
  }
  if (live) gw_out[row] = gw;
}

// X2's run kernel with sector owners ("sector"): one thread owns each
// 32-byte sector whose first sorted position it holds, adds each of the
// sector's runs from its background and stores the whole sector
// v[u] for a u known at run time, and v[u] <- x, by unrolled selects, so
// that v stays in registers
template <int N, typename T>
__device__ __forceinline__ T pick(const T* v, int u) {
  T r = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k)
    if (u == k) r = v[k];
  return r;
}
template <int N, typename T>
__device__ __forceinline__ void place(T* v, int u, T x) {
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (u == k) v[k] = x;
}

// The values of one 32-byte sector of the volume: from `base` (a multiple
// of the sector's kSec values) on, each voxel's pose's background.
template <typename T>
__device__ __forceinline__ void sector_background(T* v, long long base,
                                                  const T* __restrict__ bg,
                                                  long long bg_stride,
                                                  long long total,
                                                  long long limit) {
  constexpr int kSec = 32 / sizeof(T);
  if (total >= limit) {
    const T b0 = bg[0];
#pragma unroll
    for (int u = 0; u < kSec; ++u) v[u] = b0;
  } else {
#pragma unroll
    for (int u = 0; u < kSec; ++u) {
      const long long at = min(base + u, limit - 1);
      v[u] = bg[(at / total) * bg_stride];
    }
  }
}

// One sector's stores: the whole 32 bytes in two 16-byte stores where
// `vec` (the volume 32-byte aligned) and the sector lies in the volume,
// else each value in the volume on its own.
template <typename T>
__device__ __forceinline__ void store_sector(T* __restrict__ out,
                                             long long base, const T* v,
                                             long long limit, int vec) {
  constexpr int kSec = 32 / sizeof(T);
  if (vec && base + kSec <= limit) {
    if constexpr (std::is_same<T, float>::value) {
      float4* o = reinterpret_cast<float4*>(out + base);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      double2* o = reinterpret_cast<double2*>(out + base);
      o[0] = make_double2(v[0], v[1]);
      o[1] = make_double2(v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kSec; ++u)
      if (base + u < limit) out[base + u] = v[u];
  }
}

template <typename T, typename K>
__global__ void __launch_bounds__(kThreads)
x2_sector(T* __restrict__ out, const K* __restrict__ keys,
                   const long long* __restrict__ perm,
                   const T* __restrict__ vals, const T* __restrict__ bg,
                   long long bg_stride, long long n, long long total,
                   long long limit, int vec) {
  constexpr int kSec = 32 / sizeof(T);
  __shared__ K s_key[kRunTile];
  __shared__ T s_val[kRunTile];
  __shared__ K s_edge[2];  // the keys just before and just after the block's
  __shared__ T s_sec[kSec];  // the open sector's values at the block's end,
  __shared__ K s_cur;        // its voxel then
  __shared__ T s_acc;        // and that voxel's sum so far
  __shared__ int s_open;     // whether a sector owned here goes on past it
  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * kRunTile;
  const int cnt = (int)min((long long)kRunTile, n - t0);
  // no live key equals `limit`: it marks a position past the keys
  const K none = (K)limit;
  const auto sector = [](K k) { return (long long)k / kSec; };
  const auto lane_of = [](K k) { return (int)((long long)k % kSec); };

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

  // each sector's owner walks its terms here, four positions a step, each
  // voxel's run from its background
#pragma unroll
  for (int r = 0; r < kRunsPer; ++r) {
    const int j = r * kThreads + tid;
    const K key = kr[r];
    if ((long long)key >= limit) continue;
    const long long sec = sector(key);
    if ((j > 0 || t0 > 0) && sector(j > 0 ? s_key[j - 1] : s_edge[0]) == sec)
      continue;
    T v[kSec];
    sector_background(v, sec * kSec, bg, bg_stride, total, limit);
    K cur = key;
    T acc = pick<kSec>(v, lane_of(key));
    int e = j;
    for (;;) {
      K kq[4];
      T vq[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool in = e + u < kRunTile;
        kq[u] = in ? s_key[e + u] : none;
        vq[u] = in ? s_val[e + u] : T(0);
      }
      int m = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if ((long long)kq[u] >= limit || sector(kq[u]) != sec) break;
        if (kq[u] != cur) {
          place<kSec>(v, lane_of(cur), acc);
          cur = kq[u];
          acc = pick<kSec>(v, lane_of(cur));
        }
        acc = add_rn<T>(acc, vq[u]);
        ++m;
      }
      e += m;
      if (m < 4) break;
    }
    const K next = s_edge[1];
    if (e == cnt && (long long)next < limit && sector(next) == sec) {
#pragma unroll
      for (int u = 0; u < kSec; ++u) s_sec[u] = v[u];
      s_cur = cur;
      s_acc = acc;
      s_open = 1;
    } else {
      place<kSec>(v, lane_of(cur), acc);
      store_sector(out, sec * kSec, v, limit, vec);
    }
  }
  __syncthreads();
  if (!s_open) return;

  // the sector open at the block's end goes on past it: each round the
  // loaders put its next kCarry keys and terms into one half of s_key and
  // s_val while thread 0 adds those of the other half, in order; the
  // loaders hold the keys and indices of the round after in registers
  const long long sec = sector(s_edge[1]);
  T v[kSec];
#pragma unroll
  for (int u = 0; u < kSec; ++u) v[u] = s_sec[u];
  K cur = s_cur;
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
  const auto mine = [&](K k) {
    return (long long)k < limit && sector(k) == sec;
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
    m[r] = mine(kc[r]);
    if (m[r]) {
      s_key[q0 + r * kLoaders] = kc[r];
      s_val[q0 + r * kLoaders] = vals[pc[r]];
    }
  }
  load_keys(base + kCarry);
  int len = count(m);
  for (long long c = 0;; ++c) {
    const bool go_on = len == kCarry;
    K k[kCarryPer];
    T x[kCarryPer];
#pragma unroll
    for (int r = 0; r < kCarryPer; ++r) {
      m[r] = go_on && mine(kc[r]);
      k[r] = kc[r];
      x[r] = m[r] ? vals[pc[r]] : T(0);
    }
    if (go_on) load_keys(base + (c + 2) * kCarry);
    if (tid == 0) {
      const K* hk = s_key + (c & 1) * kCarry;
      const T* hv = s_val + (c & 1) * kCarry;
#pragma unroll 8
      for (int q = 0; q < len; ++q) {
        const K kq = hk[q];
        if (kq != cur) {
          place<kSec>(v, lane_of(cur), acc);
          cur = kq;
          acc = pick<kSec>(v, lane_of(cur));
        }
        acc = add_rn<T>(acc, hv[q]);
      }
    }
    const int half = (int)((c + 1) & 1) * kCarry;
#pragma unroll
    for (int r = 0; r < kCarryPer; ++r) {
      if (m[r]) {
        s_key[half + q0 + r * kLoaders] = k[r];
        s_val[half + q0 + r * kLoaders] = x[r];
      }
    }
    const int more = count(m);
    if (!go_on) break;
    len = more;
  }
  if (tid == 0) {
    place<kSec>(v, lane_of(cur), acc);
    store_sector(out, sec * kSec, v, limit, vec);
  }
}

// X2 as one pass ("one pass"): a block owns kChunk voxels of the volume,
// finds the sorted positions of its voxels (a search of the keys, 256
// probes a step), sets its voxels to the background in shared memory,
// adds each run there in sorted order (a tile of 1,024 positions at a
// time, a run across tiles going on from its voxel's value) and writes
// its voxels once, 16 bytes a store: the fill and the runs in one write
// of the volume.  One pose, float32.
constexpr int kChunk = 4096;

template <typename K>
__global__ void __launch_bounds__(kThreads)
x2_one_pass(float* __restrict__ out, const K* __restrict__ keys,
            const long long* __restrict__ perm,
            const float* __restrict__ vals, const float* __restrict__ bg,
            long long n, long long limit) {
  __shared__ float s_out[kChunk];
  __shared__ K s_key[kRunTile];
  __shared__ float s_val[kRunTile];
  const int tid = threadIdx.x;
  const long long c0 = (long long)blockIdx.x * kChunk;
  const int width = (int)min((long long)kChunk, limit - c0);
  const float b0 = bg[0];
  for (int v = tid; v < width; v += kThreads) s_out[v] = b0;
  // the first positions at or past c0 and c0 + width: lower bounds
  long long lo[2] = {0, 0}, hi[2] = {n, n};
  const long long target[2] = {c0, c0 + width};
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
    long long probe[2];
    int below[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      probe[h] = lo[h] + (hi[h] - lo[h]) * (tid + 1) / (kThreads + 1);
      below[h] = lo[h] < hi[h] && (long long)keys[probe[h]] < target[h];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cnt = __syncthreads_count(below[h]);
      if (lo[h] < hi[h]) {
        const long long span = hi[h] - lo[h];
        const long long last = lo[h] + span * cnt / (kThreads + 1);
        const long long first = lo[h] + span * (cnt + 1) / (kThreads + 1);
        const long long nlo = cnt > 0 ? last + 1 : lo[h];
        hi[h] = cnt < kThreads ? first : hi[h];
        lo[h] = nlo;
      }
    }
  }
  __syncthreads();
  const long long end = lo[1];
  for (long long base = lo[0]; base < end; base += kRunTile) {
    const int cnt = (int)min((long long)kRunTile, end - base);
    K kr[kRunsPer];
    long long pr[kRunsPer];
#pragma unroll
    for (int r = 0; r < kRunsPer; ++r) {
      const int j = r * kThreads + tid;
      kr[r] = j < cnt ? keys[base + j] : (K)limit;
      pr[r] = j < cnt ? perm[base + j] : 0;
    }
#pragma unroll
    for (int r = 0; r < kRunsPer; ++r) {
      const int j = r * kThreads + tid;
      s_key[j] = kr[r];
      s_val[j] = j < cnt ? vals[pr[r]] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRunsPer; ++r) {
      const int j = r * kThreads + tid;
      if (j >= cnt || (j > 0 && s_key[j - 1] == kr[r])) continue;
      const K key = kr[r];
      int e = j;
      float acc = s_out[key - c0];
      while (e < cnt && s_key[e] == key) acc = __fadd_rn(acc, s_val[e++]);
      s_out[key - c0] = acc;
    }
    __syncthreads();
  }
  if (width == kChunk && (unsigned long long)out % 16 == 0) {
    float4* o = reinterpret_cast<float4*>(out + c0);
    for (int v = tid; v < kChunk / 4; v += kThreads)
      o[v] = make_float4(s_out[4 * v], s_out[4 * v + 1], s_out[4 * v + 2],
                         s_out[4 * v + 3]);
  } else {
    for (int v = tid; v < width; v += kThreads) out[c0 + v] = s_out[v];
  }
}

}  // namespace

// X2 as one pass: `out` (total) of one pose written whole from bg[0] and
// the sorted terms; float32
extern "C" int exp_x2_one_pass(void* out, const void* keys, int key64,
                               const void* perm, const void* vals,
                               const void* bg, long long n, long long total,
                               void* stream) {
  if (n < 1 || total < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (total + kChunk - 1) / kChunk;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (key64)
    x2_one_pass<long long><<<(unsigned)blocks, kThreads, 0, s>>>(
        (float*)out, (const long long*)keys, (const long long*)perm,
        (const float*)vals, (const float*)bg, n, total);
  else
    x2_one_pass<int><<<(unsigned)blocks, kThreads, 0, s>>>(
        (float*)out, (const int*)keys, (const long long*)perm,
        (const float*)vals, (const float*)bg, n, total);
  return (int)cudaGetLastError();
}

// form 0 parent, 1 staged; float32, n_out 1-4, B <= 65,535
extern "C" int exp_x3(int form, const void* g, const void* idx,
                      const void* ws, const void* dl, const void* ow,
                      long long ow_stride, const void* pw, long long pw_stride,
                      void* scaled, void* gw, int bsz, int n_points,
                      int n_out, const int* sizes, void* stream) {
  if (n_out < 1 || n_out > 4 || bsz < 1 || bsz > 65535 || n_points < 1)
    return (int)cudaErrorInvalidValue;
  Grid gr;
  gr.n = n_out;
  long long total = 1;
  for (int i = n_out - 1; i >= 0; --i) {
    gr.g[i] = sizes[i];
    gr.st[i] = total;
    gr.s[i] = sizes[i] / 2.0;
    total *= sizes[i];
  }
  gr.total = total;
  const dim3 grid((n_points + kThreads - 1) / kThreads, bsz);
  const cudaStream_t s = (cudaStream_t)stream;
#define EXP_LAUNCH(N)                                                        \
  if (form == 0)                                                             \
    x3_parent<N><<<grid, kThreads, 0, s>>>(                                  \
        (const float*)g, (const long long*)idx, (const float*)ws,            \
        (const float*)dl, (const float*)ow, ow_stride, (const float*)pw,     \
        pw_stride, (float*)scaled, (float*)gw, n_points, gr);                \
  else                                                                       \
    x3_staged<N><<<grid, kThreads, 0, s>>>(                                  \
        (const float*)g, (const long long*)idx, (const float*)ws,            \
        (const float*)dl, (const float*)ow, ow_stride, (const float*)pw,     \
        pw_stride, (float*)scaled, (float*)gw, n_points, gr);
  switch (n_out) {
    case 1: EXP_LAUNCH(1) break;
    case 2: EXP_LAUNCH(2) break;
    case 3: EXP_LAUNCH(3) break;
    default: EXP_LAUNCH(4) break;
  }
#undef EXP_LAUNCH
  return (int)cudaGetLastError();
}

// X2's run kernel of the first redesign onto `out`, which holds the
// backgrounds bg (B,) of poses of `total` voxels; float32
extern "C" int exp_x2_walk(void* out, const void* keys, int key64,
                           const void* perm, const void* vals, const void* bg,
                           long long n, long long total, long long limit,
                           void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kRunTile - 1) / kRunTile;
  const cudaStream_t s = (cudaStream_t)stream;
  if (key64)
    x2_walk<long long><<<(unsigned)blocks, kThreads, 0, s>>>(
        (float*)out, (const long long*)keys, (const long long*)perm,
        (const float*)vals, (const float*)bg, 1, n, total, limit);
  else
    x2_walk<int><<<(unsigned)blocks, kThreads, 0, s>>>(
        (float*)out, (const int*)keys, (const long long*)perm,
        (const float*)vals, (const float*)bg, 1, n, total, limit);
  return (int)cudaGetLastError();
}

// X3 on the voxel and deltas, staged in by the block; float32, n_out 1-4,
// B <= 65,535
extern "C" int exp_x3_compact_staged(const void* g, const void* r0,
                                     const void* dl, const void* ow,
                                     long long ow_stride, const void* pw,
                                     long long pw_stride, void* scaled,
                                     void* gw, int bsz, int n_points,
                                     int n_out, const int* sizes,
                                     void* stream) {
  if (n_out < 1 || n_out > 4 || bsz < 1 || bsz > 65535 || n_points < 1)
    return (int)cudaErrorInvalidValue;
  Grid gr;
  gr.n = n_out;
  long long total = 1;
  for (int i = n_out - 1; i >= 0; --i) {
    gr.g[i] = sizes[i];
    gr.st[i] = total;
    gr.s[i] = sizes[i] / 2.0;
    total *= sizes[i];
  }
  gr.total = total;
  const dim3 grid((n_points + kThreads - 1) / kThreads, bsz);
  const cudaStream_t s = (cudaStream_t)stream;
#define EXP_LAUNCH(N)                                                        \
  x3_compact_staged<float, N><<<grid, kThreads, 0, s>>>(                     \
      (const float*)g, (const int*)r0, (const float*)dl, (const float*)ow,   \
      ow_stride, (const float*)pw, pw_stride, (float*)scaled, (float*)gw,    \
      bsz, n_points, gr);
  switch (n_out) {
    case 1: EXP_LAUNCH(1) break;
    case 2: EXP_LAUNCH(2) break;
    case 3: EXP_LAUNCH(3) break;
    default: EXP_LAUNCH(4) break;
  }
#undef EXP_LAUNCH
  return (int)cudaGetLastError();
}

// X2's run kernel with sector owners onto `out`, which holds the
// backgrounds bg (B,) of poses of `total` voxels; float32
extern "C" int exp_x2_sector(void* out, const void* keys, int key64,
                             const void* perm, const void* vals,
                             const void* bg, long long n, long long total,
                             long long limit, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kRunTile - 1) / kRunTile;
  const int whole = (unsigned long long)out % 32 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (key64)
    x2_sector<float, long long><<<(unsigned)blocks, kThreads, 0, s>>>(
        (float*)out, (const long long*)keys, (const long long*)perm,
        (const float*)vals, (const float*)bg, 1, n, total, limit, whole);
  else
    x2_sector<float, int><<<(unsigned)blocks, kThreads, 0, s>>>(
        (float*)out, (const int*)keys, (const long long*)perm,
        (const float*)vals, (const float*)bg, 1, n, total, limit, whole);
  return (int)cudaGetLastError();
}

// X2's parent run kernel onto `out`, which holds the backgrounds; float32
extern "C" int exp_x2_parent(void* out, const void* keys, int key64,
                             const void* perm, const void* vals, long long n,
                             long long limit, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = (cudaStream_t)stream;
  if (key64)
    x2_parent<long long><<<(unsigned)blocks, kThreads, 0, s>>>(
        (float*)out, (const long long*)keys, (const long long*)perm,
        (const float*)vals, n, limit);
  else
    x2_parent<int><<<(unsigned)blocks, kThreads, 0, s>>>(
        (float*)out, (const int*)keys, (const long long*)perm,
        (const float*)vals, n, limit);
  return (int)cudaGetLastError();
}
"""

X3_FORMS = ("parent", "staged", "compact staged", "compact")
X3_KERNELS = {"parent": "x3_parent", "staged": "x3_staged",
              "compact staged": "x3_compact_staged",
              "compact": "xla_gather_kernel"}
X2_KERNELS = {"package": "xla_scatter_kernel",
              "package fill": "xla_fill_kernel", "walk": "x2_walk",
              "sector": "x2_sector", "parent": "x2_parent",
              "one pass": "x2_one_pass"}
# (name, grid, poses, points) of the timed rows; X2 also on the long run and
# the 1-D cloud
ROWS = (("1024cube_1e5", (1024, 1024, 1024), 1, 100_000),
        ("512cube_1e6", (512, 512, 512), 1, 1_000_000))
X2_ROWS = ROWS + (("(4096,) x 1e6", (4096,), 1, 1_000_000),)
LONG_RUN = ((64,), 1_200_000)

_lib = None


def build():
    """Compile `SOURCE` into a library of its own -> ctypes handle."""
    global _lib
    if _lib is not None:
        return _lib
    from dprast_torch.ops import _build
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / "forms.cu", OUT / "libforms.so"
    cu.write_text(SOURCE)
    subprocess.run([_build._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(so),
                    str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.exp_x3.argtypes = [i32, vp, vp, vp, vp, vp, i64, vp, i64, vp, vp,
                           i32, i32, i32, ctypes.POINTER(ctypes.c_int), vp]
    lib.exp_x2_parent.argtypes = [vp, vp, i32, vp, vp, i64, i64, vp]
    lib.exp_x2_walk.argtypes = [vp, vp, i32, vp, vp, vp, i64, i64, i64, vp]
    lib.exp_x2_sector.argtypes = [vp, vp, i32, vp, vp, vp, i64, i64, i64,
                                  vp]
    lib.exp_x2_one_pass.argtypes = [vp, vp, i32, vp, vp, vp, i64, i64, vp]
    lib.exp_x3_compact_staged.argtypes = [vp, vp, vp, vp, i64, vp, i64, vp,
                                          vp, i32, i32, i32,
                                          ctypes.POINTER(ctypes.c_int), vp]
    _lib = lib
    return lib


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def x3_form(form, grid, g, expanded, ow, pw):
    """X3's form `form` ("parent" or "staged") on the expanded residuals
    -> (scaled, gw)."""
    idx, ws, dl = expanded
    bsz, p, n = dl.shape
    scaled = torch.empty_like(dl)
    gw = torch.empty((bsz, p), dtype=dl.dtype, device=dl.device)
    rc = build().exp_x3(X3_FORMS.index(form), _ptr(g), _ptr(idx), _ptr(ws),
                        _ptr(dl), _ptr(ow), ow.stride(0), _ptr(pw),
                        pw.stride(0), _ptr(scaled), _ptr(gw), bsz, p, n,
                        (ctypes.c_int * n)(*grid), _stream())
    if rc != 0:
        raise RuntimeError(f"exp_x3 {form}: CUDA error {rc}")
    return scaled, gw


def x2_parent(filled, keys, perm, vals):
    """X2's parent run kernel: the sorted terms added onto `filled` (the
    backgrounds' volume, changed in place) -> `filled`."""
    rc = build().exp_x2_parent(_ptr(filled), _ptr(keys),
                               int(keys.dtype == torch.int64), _ptr(perm),
                               _ptr(vals), keys.numel(), filled.numel(),
                               _stream())
    if rc != 0:
        raise RuntimeError(f"exp_x2_parent: CUDA error {rc}")
    return filled


def x3_compact_staged(grid, g, res, ow, pw):
    """X3 on the voxel and deltas with the block's rows of both staged
    through shared memory -> (scaled, gw)."""
    r0, dl = res
    bsz, p, n = dl.shape
    scaled = torch.empty_like(dl)
    gw = torch.empty((bsz, p), dtype=dl.dtype, device=dl.device)
    rc = build().exp_x3_compact_staged(
        _ptr(g), _ptr(r0), _ptr(dl), _ptr(ow), ow.stride(0), _ptr(pw),
        pw.stride(0), _ptr(scaled), _ptr(gw), bsz, p, n,
        (ctypes.c_int * n)(*grid), _stream())
    if rc != 0:
        raise RuntimeError(f"exp_x3_compact_staged: CUDA error {rc}")
    return scaled, gw


def x2_sector(filled, bg, keys, perm, vals):
    """X2's run kernel with sector owners (each 32-byte sector the terms
    reach stored whole by one thread): the sorted terms added onto
    `filled` (changed in place) -> `filled`."""
    total = filled[0].numel()
    rc = build().exp_x2_sector(_ptr(filled), _ptr(keys),
                               int(keys.dtype == torch.int64), _ptr(perm),
                               _ptr(vals), _ptr(bg), keys.numel(), total,
                               filled.numel(), _stream())
    if rc != 0:
        raise RuntimeError(f"exp_x2_sector: CUDA error {rc}")
    return filled


def x2_one_pass(bg, grid, keys, perm, vals):
    """X2 as one pass over the volume of one pose: each block's voxels set
    to the background and their runs added in shared memory, then written
    once -> the volume (1, *grid)."""
    out = torch.empty((1,) + tuple(grid), dtype=vals.dtype,
                      device=vals.device)
    rc = build().exp_x2_one_pass(_ptr(out), _ptr(keys),
                                 int(keys.dtype == torch.int64), _ptr(perm),
                                 _ptr(vals), _ptr(bg), keys.numel(),
                                 out.numel(), _stream())
    if rc != 0:
        raise RuntimeError(f"exp_x2_one_pass: CUDA error {rc}")
    return out


def x2_walk(filled, bg, keys, perm, vals):
    """X2's run kernel of the first redesign (each run's head walks it and
    stores its voxel alone): the sorted terms added onto `filled` (the
    backgrounds `bg`' volume, changed in place) -> `filled`."""
    total = filled[0].numel()
    rc = build().exp_x2_walk(_ptr(filled), _ptr(keys),
                             int(keys.dtype == torch.int64), _ptr(perm),
                             _ptr(vals), _ptr(bg), keys.numel(), total,
                             filled.numel(), _stream())
    if rc != 0:
        raise RuntimeError(f"exp_x2_walk: CUDA error {rc}")
    return filled


def long_run_inputs(dev):
    """The long run's X2 arguments: a 1-D cloud of 1.2 x 10^6 points in one
    voxel's span of a (64,) grid, so two voxels take a run of 1.2 x 10^6
    terms each -> (bg, grid, sorted keys, perm, terms)."""
    from dprast_torch.ops import core
    grid, p = LONG_RUN
    gen = torch.Generator(device=dev).manual_seed(3)
    pts = 0.1 + 1e-4 * torch.rand((p, 1), generator=gen, device=dev)
    pw = 0.5 + torch.rand(p, generator=gen, device=dev)
    rot = torch.ones((1, 1, 1), device=dev)
    tr, bg, ow = (torch.zeros((1, 1), device=dev),
                  torch.zeros(1, device=dev), torch.ones(1, device=dev))
    keys, vals, _ = core.xla_neighbours(grid, pts, rot, tr, ow, pw,
                                        residuals=False)
    order, perm = torch.sort(keys.reshape(-1), stable=True)
    return bg, grid, order, perm, vals.reshape(-1)


def _filled(bg, grid):
    return bg.reshape((bg.shape[0],) + (1,) * len(grid)).expand(
        (bg.shape[0],) + tuple(grid)).contiguous()


def _same(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def _in_turns(fns, kernels, calls=10):
    """Device microseconds of a launch of each form's kernel, in the order
    of `fns` and back -> {form: [us, us]}."""
    from dprast_torch.utils import profiling
    us = {form: [] for form in fns}
    for form in (*fns, *reversed(list(fns))):
        t = profiling.launch_us(fns[form], kernels[form], calls=calls)
        us[form].append(None if t is None else round(t, 2))
    return us


def x3_rows(dev, card):
    from dprast_torch.benchmarks.exp_xla_scatter import row_inputs
    from dprast_torch.ops import core
    for name, grid, n_poses, n_points in ROWS:
        (pts, rot, tr, _, ow, pw), g = row_inputs(grid, n_poses, n_points,
                                                  dev)
        _, _, res = core.xla_neighbours(grid, pts, rot, tr, ow, pw,
                                        terms=False)
        expanded = core.expand_residuals(grid, res)
        want = core._xla_gather_plain(grid, g, res, ow, pw)
        fns = {"parent": lambda: x3_form("parent", grid, g, expanded, ow, pw),
               "staged": lambda: x3_form("staged", grid, g, expanded, ow, pw),
               "compact staged": lambda: x3_compact_staged(grid, g, res, ow,
                                                           pw),
               "compact": lambda: core.xla_gather(grid, g, res, ow, pw)}
        same = {form: _same(fn(), want) for form, fn in fns.items()}
        b = g.shape[0]
        g_pad = torch.cat([g.reshape(b, -1), g.new_zeros((b, 1))], dim=1)
        index = expanded[0].reshape(b, -1)
        fns["torch.gather"] = lambda: torch.gather(g_pad, 1, index)
        us = _in_turns(fns, {**X3_KERNELS, "torch.gather": "gather"})
        print(json.dumps({"x3": name, "card": card, "us_in_turns": us,
                          "bit_equal": same}), flush=True)
        if not all(same.values()):
            raise SystemExit(f"X3 at {name}: a form is not bit-equal to "
                             f"_xla_gather_plain: {same}")
        del expanded, res, g, g_pad, index
        torch.cuda.empty_cache()


def x2_case(dev, name, args):
    """X2's run kernel, the package's and the parent's, on one row's sorted
    terms: each against `_xla_scatter_plain` (the CPU's `index_add_` order)
    bit for bit, then in turns."""
    from dprast_torch.ops import core
    bg, grid, order, perm, vals = args
    want = core._xla_scatter_plain(bg.cpu(), grid, order.cpu(), perm.cpu(),
                                   vals.cpu())
    filled = _filled(bg, grid)
    fns = {"package": lambda: core.xla_scatter(bg, grid, order, perm, vals),
           "walk": lambda: x2_walk(filled, bg, order, perm, vals),
           "sector": lambda: x2_sector(filled, bg, order, perm, vals),
           "parent": lambda: x2_parent(filled, order, perm, vals),
           "one pass": lambda: x2_one_pass(bg, grid, order, perm, vals)}
    same = {"package": _same((fns["package"]().cpu(),), (want,)),
            "one pass": _same((fns["one pass"]().cpu(),), (want,))}
    fns["package fill"] = fns["package"]
    for form, fn in (("walk", x2_walk), ("sector", x2_sector)):
        same[form] = _same((fn(filled.clone(), bg, order, perm,
                               vals).cpu(),), (want,))
    same["parent"] = _same((x2_parent(filled.clone(), order, perm,
                                      vals).cpu(),), (want,))
    us = _in_turns(fns, X2_KERNELS, calls=3 if name == "long run" else 10)
    runs = torch.unique_consecutive(order, return_counts=True)[1]
    print(json.dumps({"x2 runs": name, "us_in_turns": us, "bit_equal": same,
                      "terms": order.numel(),
                      "longest run": int(runs.max())}), flush=True)
    if not all(same.values()):
        raise SystemExit(f"X2 at {name}: not the CPU's index_add_: {same}")


def x2_rows(dev):
    from dprast_torch.benchmarks.exp_xla_scatter import row_inputs
    from dprast_torch.ops import core
    for name, grid, n_poses, n_points in X2_ROWS:
        (pts, rot, tr, bg, ow, pw), _ = row_inputs(grid, n_poses, n_points,
                                                   dev)
        keys, vals, _ = core.xla_neighbours(grid, pts, rot, tr, ow, pw,
                                            residuals=False)
        order, perm = torch.sort(keys.reshape(-1), stable=True)
        x2_case(dev, name, (bg, grid, order, perm, vals.reshape(-1)))
        torch.cuda.empty_cache()
    x2_case(dev, "long run", long_run_inputs(dev))


def _device_context(dev):
    with torch.cuda.device(dev):
        pass


def wrapper_host_us(dev, reps=2000):
    """Host microseconds of one `xla_gather` call at the first row and of
    its parts, each the mean of `reps` calls (the card runs behind)."""
    from dprast_torch.benchmarks.exp_xla_scatter import row_inputs
    from dprast_torch.ops import _build, core, splat_binned as sb
    name, grid, n_poses, n_points = ROWS[0]
    (pts, rot, tr, _, ow, pw), g = row_inputs(grid, n_poses, n_points, dev)
    _, _, res = core.xla_neighbours(grid, pts, rot, tr, ow, pw, terms=False)
    r0, dl = res
    scaled = torch.empty_like(dl)
    gw = torch.empty(dl.shape[:2], device=dev)
    lib = _build.load()
    sizes = core._sizes(grid)
    args = [sb._ptr(x) for x in (g, r0, dl, ow)] + [ow.stride(0), sb._ptr(pw),
                                                    pw.stride(0)] + [
        sb._ptr(scaled), sb._ptr(gw), n_poses, n_points, len(grid), sizes, 0]
    parts = {
        "the whole wrapper": lambda: core.xla_gather(grid, g, res, ow, pw),
        "g.to(dtype).contiguous()": lambda: g.to(dl.dtype).contiguous(),
        "_check_cuda of three tensors": lambda: sb._check_cuda(
            "x", g, dl.dtype, r0, torch.int32, dl, dl.dtype),
        "two _weight": lambda: (core._weight("x", ow, dl.dtype, 1, dev),
                                core._weight("x", pw, dl.dtype, n_points,
                                             dev)),
        "two torch.empty": lambda: (torch.empty_like(dl),
                                    torch.empty(dl.shape[:2], device=dev)),
        "_sizes": lambda: core._sizes(grid),
        "eight _ptr": lambda: [sb._ptr(x) for x in (g, r0, dl, ow, pw,
                                                    scaled, gw, g)],
        "_stream": lambda: sb._stream(dev),
        "with torch.cuda.device": lambda: _device_context(dev),
        "_launch (device, stream, C call)": lambda: sb._launch(
            "x", dev, lib.dprast_xla_gather, *args),
        "the C call alone": lambda: lib.dprast_xla_gather(
            *args, sb._stream(dev)),
    }
    out = {}
    for what, fn in parts.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[what] = round((time.perf_counter() - t0) / reps * 1e6, 2)
        torch.cuda.synchronize()
    print(json.dumps({"xla_gather host us a call": out, "row": name}),
          flush=True)
    return out


def main():
    from dprast_torch.utils import profiling
    if not torch.cuda.is_available():
        raise SystemExit("exp_xla_forms: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    card = profiling.card(0)
    print(card, flush=True)
    build()
    x3_rows(dev, card)
    x2_rows(dev)
    wrapper_host_us(dev)


if __name__ == "__main__":
    main()
