// B9, the binning sort's preparation: from the tile keys (B, P) int32 in
// [0, nt] (nt: a point that overlaps no tile) the sort's input keys, the
// slot table and the per-tile counts, in two launches.
//
// Replaces no Pallas kernel: the JAX package computes all of it inside the
// one jit-compiled `_prep_binned` (dprast/ops/splat_binned.py:279-333 and
// :348-353: the count, the padded offsets, the filler keys, the packed
// keys and the slot table), which XLA fuses.  Eager PyTorch ran it as some
// 39 launches (`splat_binned._slot_prep_plain`: a count, then elementwise
// ops, `cat`, `cumsum`, `searchsorted` and copies of `expand`s, each
// reading what the one before wrote).
//
// What it computes, per pose b, with counts[b, t] = #{i : key[b, i] = t}
// for t in [0, nt] (the sentinel bin nt kept), padded[t] = ceil(counts[t]
// / chunk) chunk (raised to chunk where `min_chunk`), poffs[0] = 0 and
// poffs[t + 1] = padded[0] + .. + padded[t]:
//   keys2[b, i] = 2 key[b, i]                        (i < P, real rows)
//   keys2[b, P + t chunk + k] = 2t + 1 if k < padded[t] - counts[t]
//                               else 2nt + 1         (filler rows)
//   keys2[b, P + nt chunk + ..] = 2nt + 1            (the tail to s_pad)
// each times p2 plus the row's id (i for a real row, P for the others)
// where `packed`; and the slot table
//   slot_tile[b, s] = min(#{t < nt : poffs[t + 1] <= s chunk}, nt - 1),
//   slot_tile[b, n_slots] = poffs[nt] / chunk   (the live slots).
// Every value is an integer, so the result is the same in any order, and
// both kernels run under `torch.use_deterministic_algorithms(True)`.
//
// What bounds it: bytes.  The keys read once, keys2, the slot table and
// the counts written once: 56.7 MB at 1024^2 x 64 poses x 10^5 points
// (16.9 us at 3.35 TB/s), 8.4 MB at 128^3 x 1 x 10^6 (2.5 us).
//
// The design.  Pass 1 (`slot_count_kernel`, grid (blocks of 4,096 keys,
// B)) streams a stretch of one pose's keys with 16-byte loads, writes the
// real rows of keys2 from the same registers with 16-byte stores, and
// counts them in a shared histogram, one shared atomic a key.  The keys
// of a dense cloud land in a few hot bins, where same-address atomics
// serialise inside a warp; yet on an H100 the plain atomics cost nothing
// over the loads and stores at 1024^2 (18.4 us against 18.3 with no
// count) and 1.4 us at 128^3 (5.1 against 3.7), where grouping a warp's
// equal keys first (`__match_any_sync`, one atomic a group) takes 43.3
// and 10.6 us, and one or two rounds of a leader's ballot 20.0-22.8 and
// 6.8-8.3 (`dprast_torch/benchmarks/exp_slot_prep_forms.py`, which edits
// `count_key`).  Each non-zero bin then goes into `counts` with one
// integer atomic; the entry point zeroes `counts` with a `cudaMemsetAsync`
// on the same stream first.  Pass 2 (`slot_fill_kernel`, grid (blocks,
// B)) loads its pose's counts into shared memory, scans the padded counts
// there, and writes its share of the filler and tail keys and of the slot
// table, each slot by a binary search of s chunk in the shared offsets.
// Nothing is read back to the host.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// pass 1: keys per block, 16 a thread in four 16-byte loads
constexpr int kKeysPerBlock = 4096;
// pass 2: filler rows per block
constexpr int kFillPerBlock = 2048;
// the `binned` path's bound on the tiles of a grid
constexpr int kMaxTiles = 4096;

struct Prep {
  int p;        // points per pose
  int nt;       // tiles; key nt is the no-tile sentinel
  int chunk;    // rows per slot
  int s_pad;    // frame rows: ceil(P / chunk) chunk + nt chunk
  int n_slots;  // s_pad / chunk
  int min_chunk;
  int packed;   // the point id rides in the key: key * p2 + id
  int p2;       // the power of two above every id and the filler id P
  int fill_blocks;  // pass 2's blocks per pose
};

// The sort key of row `id` whose binning key is `k2` (2t or 2t + 1), with
// int32 tensors' wrapping arithmetic.
__device__ __forceinline__ int sort_key(int k2, int id, const Prep& a) {
  return a.packed ? (int)((unsigned)k2 * (unsigned)a.p2 + (unsigned)id)
                  : k2;
}

// One key into the shared histogram.  `ok` is false for a lane with no
// key (past the end) or with a key outside [0, nt], which is counted
// nowhere.  Every lane of the warp calls it together, so that the forms of
// `exp_slot_prep_forms` may put warp-wide votes here.
__device__ __forceinline__ void count_key(int* hist, int k, bool ok) {
  if (ok) atomicAdd(&hist[k], 1);
}

__global__ void __launch_bounds__(kThreads)
slot_count_kernel(const int* __restrict__ keys,  // (B, P)
                  int* __restrict__ keys2,       // (B, s_pad)
                  int* __restrict__ counts,      // (B, nt + 1), zeroed
                  Prep a) {
  __shared__ int hist[kMaxTiles + 1];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i <= a.nt; i += kThreads) hist[i] = 0;
  __syncthreads();
  const int* kb = keys + (long long)b * a.p;
  int* ob = keys2 + (long long)b * a.s_pad;
  const int lo = blockIdx.x * kKeysPerBlock;
  const int hi = min(a.p, lo + kKeysPerBlock);
  const unsigned top = (unsigned)a.nt;
  if ((a.p & 3) == 0) {
    // a pose's keys start on 16 bytes, and so does its row of keys2
    // (s_pad is a multiple of chunk, a multiple of 4)
#pragma unroll
    for (int r = 0; r < kKeysPerBlock / (4 * kThreads); ++r) {
      const int i = lo + 4 * (r * kThreads + threadIdx.x);
      const bool in = i < hi;
      int4 k = make_int4(-1, -1, -1, -1);
      if (in) {
        k = __ldcs(reinterpret_cast<const int4*>(kb + i));
        int4 o;
        o.x = sort_key(2 * k.x, i, a);
        o.y = sort_key(2 * k.y, i + 1, a);
        o.z = sort_key(2 * k.z, i + 2, a);
        o.w = sort_key(2 * k.w, i + 3, a);
        *reinterpret_cast<int4*>(ob + i) = o;
      }
      count_key(hist, k.x, in && (unsigned)k.x <= top);
      count_key(hist, k.y, in && (unsigned)k.y <= top);
      count_key(hist, k.z, in && (unsigned)k.z <= top);
      count_key(hist, k.w, in && (unsigned)k.w <= top);
    }
  } else {
    for (int r = 0; r < kKeysPerBlock / kThreads; ++r) {
      const int i = lo + r * kThreads + threadIdx.x;
      const bool in = i < hi;
      int k = -1;
      if (in) {
        k = __ldcs(kb + i);
        ob[i] = sort_key(2 * k, i, a);
      }
      count_key(hist, k, in && (unsigned)k <= top);
    }
  }
  __syncthreads();
  int* cb = counts + (long long)b * (a.nt + 1);
  for (int i = threadIdx.x; i <= a.nt; i += kThreads)
    if (hist[i] != 0) atomicAdd(&cb[i], hist[i]);
}

__global__ void __launch_bounds__(kThreads)
slot_fill_kernel(const int* __restrict__ counts,  // (B, nt + 1)
                 int* __restrict__ keys2,         // (B, s_pad)
                 int* __restrict__ slot_tile,     // (B, n_slots + 1)
                 Prep a) {
  // need[t] = padded[t] - counts[t], the filler rows of tile t;
  // offs[t] = poffs[t + 1]
  __shared__ int need[kMaxTiles];
  __shared__ int offs[kMaxTiles];
  __shared__ int warp_sums[kWarps];
  const int b = blockIdx.y;
  const int nt = a.nt, chunk = a.chunk;
  const int* cb = counts + (long long)b * (nt + 1);
  // each thread scans a run of `per` consecutive tiles
  const int per = (nt + kThreads - 1) / kThreads;
  const int t0 = min(threadIdx.x * per, nt), t1 = min(t0 + per, nt);
  int run = 0;
  for (int t = t0; t < t1; ++t) {
    const int c = cb[t];
    int padded = (c + chunk - 1) / chunk * chunk;
    if (a.min_chunk && padded < chunk) padded = chunk;
    need[t] = padded - c;
    offs[t] = padded;
    run += padded;
  }
  // the block's exclusive prefix of the runs' sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = incl - run;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  for (int t = t0; t < t1; ++t) {
    before += offs[t];
    offs[t] = before;
  }
  __syncthreads();

  // the filler and tail rows, [P, s_pad)
  int* ob = keys2 + (long long)b * a.s_pad + a.p;
  const int n_fill = a.s_pad - a.p;
  const int tail = 2 * nt + 1;
  const int f_lo = blockIdx.x * kFillPerBlock;
  const int f_hi = min(n_fill, f_lo + kFillPerBlock);
  for (int q = f_lo + threadIdx.x; q < f_hi; q += kThreads) {
    int k2 = tail;
    if (q < nt * chunk) {
      const int t = q / chunk;
      if (q - t * chunk < need[t]) k2 = 2 * t + 1;
    }
    ob[q] = sort_key(k2, a.p, a);
  }
  // the slot table: this block's share of its n_slots + 1 entries
  const int per_block = (a.n_slots + 1 + a.fill_blocks - 1) / a.fill_blocks;
  const int s_lo = blockIdx.x * per_block;
  const int s_hi = min(a.n_slots + 1, s_lo + per_block);
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

// `keys` (B, P) int32; `keys2` (B, s_pad), `slot_tile` (B, n_slots + 1) and
// `counts` (B, nt + 1) int32, all written here (`counts` zeroed first).
// 1 <= nt <= 4096, s_pad = ceil(P / chunk) chunk + nt chunk < 2^31,
// n_slots = s_pad / chunk, chunk a multiple of 4; where `packed`, p2 is a
// power of two above P and (2nt + 1) p2 + P < 2^31.
extern "C" int dprast_slot_prep(const void* keys, void* keys2,
                                void* slot_tile, void* counts, int bsz,
                                int p, int nt, int chunk, int min_chunk,
                                int packed, int p2, void* stream) {
  if (bsz < 1 || bsz > 65535 || p < 1 || nt < 1 || nt > kMaxTiles ||
      chunk < 4 || chunk % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const long long p_pad = ((long long)p + chunk - 1) / chunk * chunk;
  const long long s_pad = p_pad + (long long)nt * chunk;
  if (s_pad >= (1ll << 31) ||
      (packed && (p2 <= p || (p2 & (p2 - 1)) != 0 ||
                  (2ll * nt + 1) * p2 + p >= (1ll << 31))))
    return (int)cudaErrorInvalidValue;
  Prep a;
  a.p = p;
  a.nt = nt;
  a.chunk = chunk;
  a.s_pad = (int)s_pad;
  a.n_slots = (int)(s_pad / chunk);
  a.min_chunk = min_chunk != 0;
  a.packed = packed != 0;
  a.p2 = p2;
  a.fill_blocks = (int)((s_pad - p + kFillPerBlock - 1) / kFillPerBlock);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      counts, 0, (size_t)bsz * (nt + 1) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  slot_count_kernel<<<dim3((p + kKeysPerBlock - 1) / kKeysPerBlock, bsz),
                      kThreads, 0, s>>>((const int*)keys, (int*)keys2,
                                        (int*)counts, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  slot_fill_kernel<<<dim3(a.fill_blocks, bsz), kThreads, 0, s>>>(
      (const int*)counts, (int*)keys2, (int*)slot_tile, a);
  return (int)cudaGetLastError();
}
