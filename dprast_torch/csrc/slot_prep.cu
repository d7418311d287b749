// B9, the binning sort's preparation: from the tile keys (B, P) int32 in
// [0, nt] (nt: a point that overlaps no tile) the per-tile counts, the
// slot table and the place in the frame where each stretch of a pose's
// keys starts each tile, in two launches.  B10 (bin_scatter.cu) writes
// the sorted frame keys from them.
//
// Replaces no Pallas kernel: the JAX package computes all of it inside the
// one jit-compiled `_prep_binned` (dprast/ops/splat_binned.py:279-333 and
// :348-353: the count, the padded offsets, the filler keys, the packed
// keys and the slot table), which XLA fuses.  Eager PyTorch ran it as some
// 39 launches (`splat_binned._slot_prep_plain`: a count, then elementwise
// ops, `cat`, `cumsum`, `searchsorted` and copies of `expand`s, each
// reading what the one before wrote), and sorted what it wrote with
// `torch.sort`.
//
// What it computes, per pose b, with counts[b, t] = #{i : key[b, i] = t}
// for t in [0, nt] (the sentinel bin nt kept), padded[t] = ceil(counts[t]
// / chunk) chunk (raised to chunk where `min_chunk`), poffs[0] = 0 and
// poffs[t + 1] = padded[0] + .. + padded[t]; and with stretch j the keys
// [j kStretch, (j + 1) kStretch) of the pose (bins.cuh):
//   bases[b, j, t] = poffs[t] + #{i < j kStretch : key[b, i] = t}
//                    (t in [0, nt]: the frame row of the stretch's first
//                    point of tile t, as the stable sort puts it),
//   slot_tile[b, s] = min(#{t < nt : poffs[t + 1] <= s chunk}, nt - 1),
//   slot_tile[b, n_slots] = poffs[nt] / chunk   (the live slots).
// Every value is an integer, so the result is the same in any order, and
// both kernels run under `torch.use_deterministic_algorithms(True)`.
//
// What bounds it: bytes.  The keys read once, the slot table, the counts
// and the bases written once: 26.3 MB at 1024^2 x 64 poses x 10^5 points
// (7.8 us at 3.35 TB/s), 4.4 MB at 128^3 x 1 x 10^6 (1.3 us).
//
// The design.  Pass 1 (`slot_count_kernel`, grid (stretches, B); the
// pose is blockIdx.y, plus 65,535 blockIdx.z past 65,535 poses:
// poses.cuh) streams one stretch of a pose's keys with 16-byte loads and
// counts them in a shared histogram, one shared atomic a key; it writes
// the histogram whole as the stretch's row of `bases` and adds each
// non-zero bin into `counts` with one integer atomic (the entry point
// zeroes `counts` with a `cudaMemsetAsync` on the same stream first).
// The keys of a dense cloud land in a few hot bins, where same-address
// atomics serialise inside a warp; yet on an H100 the plain atomics cost
// nothing over the loads and stores at 1024^2 (18.4 us against 18.3 with
// no count) and 1.4 us at 128^3 (5.1 against 3.7), where grouping a
// warp's equal keys first (`__match_any_sync`, one atomic a group) takes
// 43.3 and 10.6 us, and one or two rounds of a leader's ballot 20.0-22.8
// and 6.8-8.3 (`dprast_torch/benchmarks/exp_slot_prep_forms.py`, which
// edits `count_key`; measured when pass 1 also wrote the sort's input).
// The keys are read with plain loads, so that B10, which reads them next,
// finds some in the L2.  Pass 2 (`slot_scan_kernel`, grid (blocks, B))
// loads its pose's counts, scans the padded counts in shared memory, and
// does two things: a block of 32 tiles turns their columns of stretch
// counts into bases in place (each warp sums its eighth of the stretches,
// then writes the running sums from poffs[t] on), and a block of 1,024
// slots writes its share of the slot table, each slot by a binary search
// of s chunk in the shared offsets.  Nothing is read back to the host.

#include <cuda_runtime.h>

#include "bins.cuh"
#include "poses.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// pass 1: keys per block, 16 a thread in four 16-byte loads
constexpr int kKeysPerBlock = kStretch;
// pass 2: slot table entries per block
constexpr int kSlotsPerBlock = 1024;
// the `binned` path's bound on the tiles of a grid
constexpr int kMaxTiles = 4096;

struct Prep {
  int bsz;        // poses
  int p;          // points per pose
  int nt;         // tiles; key nt is the no-tile sentinel
  int chunk;      // rows per slot
  int n_slots;    // frame rows / chunk
  int min_chunk;
  int n_stretch;  // stretches per pose: ceil(P / kStretch)
};

// One key into the shared histogram.  `ok` is false for a lane with no
// key (past the end) or with a key outside [0, nt], which is counted
// nowhere.  Every lane of the warp calls it together, so that the forms of
// `exp_slot_prep_forms` may put warp-wide votes here.
__device__ __forceinline__ void count_key(int* hist, int k, bool ok) {
  if (ok) atomicAdd(&hist[k], 1);
}

__global__ void __launch_bounds__(kThreads)
slot_count_kernel(const int* __restrict__ keys,  // (B, P)
                  int* __restrict__ bases,       // (B, n_stretch, nt + 1)
                  int* __restrict__ counts,      // (B, nt + 1), zeroed
                  Prep a) {
  __shared__ int hist[kMaxTiles + 1];
  const int b = pose_of(blockIdx.y, blockIdx.z);
  if (b >= a.bsz) return;  // past the last pose: the whole block
  for (int i = threadIdx.x; i <= a.nt; i += kThreads) hist[i] = 0;
  __syncthreads();
  const int* kb = keys + (long long)b * a.p;
  const int lo = blockIdx.x * kKeysPerBlock;
  const int hi = min(a.p, lo + kKeysPerBlock);
  const unsigned top = (unsigned)a.nt;
  if ((a.p & 3) == 0) {
    // a pose's keys start on 16 bytes
#pragma unroll
    for (int r = 0; r < kKeysPerBlock / (4 * kThreads); ++r) {
      const int i = lo + 4 * (r * kThreads + threadIdx.x);
      const bool in = i < hi;
      int4 k = make_int4(-1, -1, -1, -1);
      if (in) k = __ldg(reinterpret_cast<const int4*>(kb + i));
      count_key(hist, k.x, in && (unsigned)k.x <= top);
      count_key(hist, k.y, in && (unsigned)k.y <= top);
      count_key(hist, k.z, in && (unsigned)k.z <= top);
      count_key(hist, k.w, in && (unsigned)k.w <= top);
    }
  } else {
    for (int r = 0; r < kKeysPerBlock / kThreads; ++r) {
      const int i = lo + r * kThreads + threadIdx.x;
      const bool in = i < hi;
      const int k = in ? __ldg(kb + i) : -1;
      count_key(hist, k, in && (unsigned)k <= top);
    }
  }
  __syncthreads();
  int* cb = counts + (long long)b * (a.nt + 1);
  int* sb = bases + ((long long)b * a.n_stretch + blockIdx.x) * (a.nt + 1);
  for (int i = threadIdx.x; i <= a.nt; i += kThreads) {
    const int h = hist[i];
    sb[i] = h;
    if (h != 0) atomicAdd(&cb[i], h);
  }
}

__global__ void __launch_bounds__(kThreads)
slot_scan_kernel(const int* __restrict__ counts,  // (B, nt + 1)
                 int* __restrict__ bases,         // (B, n_stretch, nt + 1)
                 int* __restrict__ slot_tile,     // (B, n_slots + 1)
                 Prep a) {
  // offs[t] = poffs[t + 1]
  __shared__ int offs[kMaxTiles];
  __shared__ int warp_sums[kWarps];
  __shared__ int part[kWarps][32];
  const int b = pose_of(blockIdx.y, blockIdx.z);
  if (b >= a.bsz) return;  // past the last pose: the whole block
  const int nt = a.nt, chunk = a.chunk;
  const int* cb = counts + (long long)b * (nt + 1);
  // each thread scans a run of `per` consecutive tiles
  const int per = (nt + kThreads - 1) / kThreads;
  const int t0 = min(threadIdx.x * per, nt), t1 = min(t0 + per, nt);
  int run = 0;
  for (int t = t0; t < t1; ++t) {
    offs[t] = padded_rows(cb[t], chunk, a.min_chunk);
    run += offs[t];
  }
  int total;
  int before = block_exclusive<kThreads>(run, warp_sums, &total);
  for (int t = t0; t < t1; ++t) {
    before += offs[t];
    offs[t] = before;
  }
  __syncthreads();

  // the bases of the 32 tiles [32 x, 32 x + 32): warp w takes the
  // stretches [w seg, (w + 1) seg) of each, a lane a tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (blockIdx.x * 32 <= nt) {
    const int c = blockIdx.x * 32 + lane;
    const bool live = c <= nt;
    const int seg = (a.n_stretch + kWarps - 1) / kWarps;
    const int j0 = min(a.n_stretch, warp * seg);
    const int j1 = min(a.n_stretch, j0 + seg);
    const long long step = nt + 1;
    int* col = bases + (long long)b * a.n_stretch * step + c;
    int sum = 0;
    if (live) {
#pragma unroll 4
      for (int j = j0; j < j1; ++j) sum += col[j * step];
    }
    part[warp][lane] = sum;
    __syncthreads();
    if (live) {
      int at = c == 0 ? 0 : offs[c - 1];  // poffs[c]
      for (int w = 0; w < warp; ++w) at += part[w][lane];
#pragma unroll 4
      for (int j = j0; j < j1; ++j) {
        const int v = col[j * step];
        col[j * step] = at;
        at += v;
      }
    }
  }

  // the slot table: this block's share of its n_slots + 1 entries
  const int s_lo = blockIdx.x * kSlotsPerBlock;
  const int s_hi = min(a.n_slots + 1, s_lo + kSlotsPerBlock);
  int* sb = slot_tile + (long long)b * (a.n_slots + 1);
  for (int s = s_lo + threadIdx.x; s < s_hi; s += kThreads) {
    if (s == a.n_slots) {
      sb[s] = offs[nt - 1] / chunk;
      continue;
    }
    // the tiles whose end is at or before the slot's first row: the
    // upper bound of s chunk in the non-decreasing offs[0 .. nt)
    const int x = s * chunk;
    int l = 0, h = nt;
    while (l < h) {
      const int m = (l + h) >> 1;
      if (offs[m] <= x) l = m + 1; else h = m;
    }
    sb[s] = min(l, nt - 1);
  }
}

}  // namespace

// `keys` (B, P) int32; `bases` (B, ceil(P / 4096), nt + 1), `slot_tile`
// (B, n_slots + 1) and `counts` (B, nt + 1) int32, all written here
// (`counts` zeroed first).  1 <= nt <= 4096, s_pad = ceil(P / chunk)
// chunk + nt chunk < 2^31, n_slots = s_pad / chunk, chunk a multiple of 4.
extern "C" int dprast_slot_prep(const void* keys, void* bases,
                                void* slot_tile, void* counts, int bsz,
                                int p, int nt, int chunk, int min_chunk,
                                void* stream) {
  if (bsz < 1 || p < 1 || nt < 1 || nt > kMaxTiles ||
      chunk < 4 || chunk % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const long long p_pad = ((long long)p + chunk - 1) / chunk * chunk;
  const long long s_pad = p_pad + (long long)nt * chunk;
  if (s_pad >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  Prep a;
  a.bsz = bsz;
  a.p = p;
  a.nt = nt;
  a.chunk = chunk;
  a.n_slots = (int)(s_pad / chunk);
  a.min_chunk = min_chunk != 0;
  a.n_stretch = (p + kStretch - 1) / kStretch;
  const int tile_blocks = (nt + 1 + 31) / 32;
  const int slot_blocks = (a.n_slots + kSlotsPerBlock) / kSlotsPerBlock;
  const int scan_blocks =
      tile_blocks > slot_blocks ? tile_blocks : slot_blocks;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      counts, 0, (size_t)bsz * (nt + 1) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  slot_count_kernel<<<dim3(a.n_stretch, pose_low(bsz), pose_high(bsz)),
                      kThreads, 0, s>>>((const int*)keys, (int*)bases,
                                        (int*)counts, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  slot_scan_kernel<<<dim3(scan_blocks, pose_low(bsz), pose_high(bsz)),
                     kThreads, 0, s>>>((const int*)counts, (int*)bases,
                                       (int*)slot_tile, a);
  return (int)cudaGetLastError();
}
