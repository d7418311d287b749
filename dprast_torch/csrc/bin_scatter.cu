// B10, the binning sort: the frame keys (B, s_pad) in the order that a
// stable sort of B9's sort keys gives, written straight to their places
// from B9's counts and bases (slot_prep.cu), by one counting scatter over
// the tile bits.  It is no general sort: every row's place follows from
// the counts, since the tiles are few (nt + 1 <= 4,097 bins) and the
// point id already ascends within the keys.
//
// Replaces no Pallas kernel: the JAX package sorts the frame with
// `jax.lax.sort` inside `_prep_binned` (dprast/ops/splat_binned.py:322-
// 333), and the port ran `torch.sort` on B9's keys: a segmented sort, on
// the card an index fill, two CUB radix sorts, a post-processing pass, a
// copy and memsets of its input (602 us of 3,064 in a 1024^2 fit step).
//
// What it writes, per pose b, with B9's counts[t], padded[t] and poffs[t]
// (slot_prep.cu), and rank(i) the points of pose b and of i's tile t <= nt
// with a smaller id:
//   row poffs[t] + rank(i)              point i of tile t < nt;
//   rows poffs[t] + counts[t] ..
//        poffs[t + 1] - 1               tile t's need[t] = padded[t] -
//                                       counts[t] filler rows;
//   row poffs[nt] + rank(i)             point i with no tile (key nt);
//   rows poffs[nt] + counts[nt] ..      the other fillers: for each tile t
//        s_pad - 1                      in turn its chunk - need[t] unused
//                                       filler rows, then the rows that
//                                       top the frame up to s_pad.
// Where `packed` a row holds the sort key (2t + (1 for a filler)) p2 +
// the id (P for a filler), the keys of a pose unique up to equal fillers,
// so the rows are those of any sort; else (int64 rows) the index that
// `torch.sort(stable=True)` gives the row of B9's plain sort input
// (`splat_binned._slot_prep_plain`): the point's id, or P + f for that
// input's filler f (f = t chunk + k for tile t's k-th, nt chunk + e for
// the e-th topping row).  Integer arithmetic throughout and no atomics: it
// runs under `torch.use_deterministic_algorithms(True)`.
//
// What bounds it: bytes.  The keys read once and the frame keys written
// once: 56.5 MB at 1024^2 x 64 poses x 10^5 points (16.9 us at 3.35
// TB/s; B9's bases, 0.5 MB, besides), 8.4 MB at 128^3 x 1 x 10^6 (2.5 us).
//
// The design.  One launch, grid (stretches + filler blocks, B), the pose
// as poses.cuh has it.  A stretch block takes one stretch of kStretch
// keys of its pose (bins.cuh), as B9 counted it, so that its places start
// at B9's bases for that stretch: no block waits for another.  Its 8 warps
// take 512 consecutive keys each, 32 a round in lane order, so id order
// is (warp, round, lane).  A lane finds the lanes of its round with its
// tile by one ballot per tile bit (its peers), and its rank among the
// warp's keys of that tile is the warp's running count of the tile, in
// shared memory, plus its peers in lower lanes; the lowest peer moves the
// count on.  Then one prefix over (tile, warp) in shared memory gives each
// warp's first place of each tile within the block, the keys are staged
// there in shared memory in frame order, and the block writes them out in
// index order: a tile's keys of the stretch are one contiguous run of the
// frame, so the stores go out in runs and not one sector a key.  A filler
// block scans the pose's padded counts (as B9's pass 2 does) and writes
// 2,048 consecutive filler rows of B9's sort input at their places, which
// are runs too.  Nothing is read back to the host.
//
// Measured on an H100 at 1024^2 x 64 poses x 10^5 points (packed), the
// kernel's device time: 47.3 us with a key's tile and rank in two
// registers (80 registers a thread, 3 blocks an SM), 43.7-44.5 with them
// in one (the form here); the peers by `__match_any_sync` in place of the
// ballots 55.5-55.8 against 47.3; launch bounds of 4, 5 or 6 blocks an SM
// 43.6, 44.8 and 45.4-48.5, so the SM's blocks are not what paces it.
// torch.sort took 603 us of device time in 21 launches there.

#include <cuda_runtime.h>

#include "bins.cuh"
#include "poses.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// a warp's consecutive keys of the stretch, and its rounds of 32
constexpr int kKeysPerWarp = kStretch / kWarps;
constexpr int kRounds = kKeysPerWarp / 32;
// a key's rank among its warp's keys of its tile: fewer than 2^9
constexpr int kRankBits = 9;
static_assert(kKeysPerWarp <= 1 << kRankBits, "a rank fits its bits");
// filler rows per filler block
constexpr int kFillPerBlock = 2048;
// the `binned` path's bound on the tiles of a grid
constexpr int kMaxTiles = 4096;

struct Scatter {
  int bsz;        // poses
  int p;          // points per pose
  int nt;         // tiles; key nt is the no-tile sentinel
  int chunk;      // rows per slot
  int s_pad;      // frame rows: ceil(P / chunk) chunk + nt chunk
  int min_chunk;
  int packed;     // the point id rides in the key: key * p2 + id
  int p2;         // the power of two above every id and the filler id P
  int n_stretch;  // stretch blocks per pose: ceil(P / kStretch)
  int nbits;      // bits of nt: every key in [0, nt] fits them
};

// The row of frame key `k2` (2t or 2t + 1) and point id `id`: the packed
// sort key, with int32 tensors' wrapping arithmetic, or the id.
__device__ __forceinline__ int row_value(int k2, int id, const Scatter& a) {
  return a.packed ? (int)((unsigned)k2 * (unsigned)a.p2 + (unsigned)id)
                  : id;
}

// The lanes of the warp whose key is `t`, for a lane with `ok`: one
// ballot per bit of [0, nt].  Every lane of the warp calls it together.
__device__ __forceinline__ unsigned peers_of(int t, bool ok, int nbits) {
  unsigned peers = __ballot_sync(0xffffffffu, ok);
  for (int k = 0; k < nbits; ++k) {
    const bool bit = (t >> k) & 1;
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// The shared memory of a block, in words: a stretch block's warp sums,
// per-warp tile counts, tile shifts and staged places and values; a
// filler block's warp sums and three words a tile.
__host__ __device__ inline int stretch_words(int nt) {
  return kWarps + (kWarps + 1) * (nt + 1) + 2 * kStretch;
}
__host__ __device__ inline int filler_words(int nt) {
  return kWarps + 3 * nt;
}

template <typename Out>
__device__ void scatter_stretch(const int* __restrict__ keys,
                                const int* __restrict__ bases,
                                Out* __restrict__ ob, int b, int j,
                                const Scatter& a, int* smem) {
  const int nt1 = a.nt + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* warp_sums = smem;
  int* cnt = warp_sums + kWarps;   // [kWarps][nt1]: counts, then places
  int* shift = cnt + kWarps * nt1;  // [nt1]: frame place - block place
  int* sdest = shift + nt1;         // [kStretch]: staged frame places
  int* sval = sdest + kStretch;     // [kStretch]: staged row values
  const int* bj = bases + ((long long)b * a.n_stretch + j) * nt1;
  for (int c = threadIdx.x; c < kWarps * nt1; c += kThreads) cnt[c] = 0;
  for (int c = threadIdx.x; c < nt1; c += kThreads) shift[c] = bj[c];
  // the warp's keys, all loads in flight at once
  const int lo = j * kStretch + warp * kKeysPerWarp;
  const int* kb = keys + (long long)b * a.p;
  int tk[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = lo + r * 32 + lane;
    tk[r] = i < a.p ? __ldg(kb + i) : -1;
  }
  __syncthreads();

  // each key's rank among the warp's keys of its tile, kept beside its
  // tile in the key's register as (t << kRankBits) + rank, -1 for none
  int* cw = cnt + warp * nt1;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int t = tk[r];
    const bool ok = (unsigned)t <= (unsigned)a.nt;
    const unsigned peers = peers_of(t, ok, a.nbits);
    const int seen = ok ? cw[t] : 0;
    tk[r] = ok ? (t << kRankBits) + seen + __popc(peers & below) : -1;
    __syncwarp();
    if (ok && (peers & below) == 0u) cw[t] = seen + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // each warp's first place of each tile in the block, tiles in order
  // and warps in order; `shift` takes the tile's block place off
  const int per = (nt1 + kThreads - 1) / kThreads;
  const int c0 = min(threadIdx.x * per, nt1), c1 = min(c0 + per, nt1);
  int run = 0;
  for (int c = c0; c < c1; ++c)
    for (int w = 0; w < kWarps; ++w) run += cnt[w * nt1 + c];
  int total;
  int at = block_exclusive<kThreads>(run, warp_sums, &total);
  for (int c = c0; c < c1; ++c) {
    shift[c] -= at;
    for (int w = 0; w < kWarps; ++w) {
      const int v = cnt[w * nt1 + c];
      cnt[w * nt1 + c] = at;
      at += v;
    }
  }
  __syncthreads();

  // stage the keys in frame order, then write them out in runs
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (tk[r] >= 0) {
      const int t = tk[r] >> kRankBits;
      const int q = cw[t] + (tk[r] & ((1 << kRankBits) - 1));
      sdest[q] = shift[t] + q;
      sval[q] = row_value(2 * t, lo + r * 32 + lane, a);
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < total; q += kThreads)
    ob[sdest[q]] = (Out)sval[q];
}

template <typename Out>
__device__ void scatter_fillers(const int* __restrict__ counts,
                                Out* __restrict__ ob, int b, int x,
                                const Scatter& a, int* smem) {
  const int nt = a.nt, chunk = a.chunk;
  int* warp_sums = smem;
  int* need = warp_sums + kWarps;  // [nt]: padded - counts
  int* first = need + nt;          // [nt]: the first filler place
  int* tail = first + nt;          // [nt]: an unused filler's place - f
  const int* cb = counts + (long long)b * (nt + 1);
  // each thread takes a run of `per` consecutive tiles
  const int per = (nt + kThreads - 1) / kThreads;
  const int t0 = min(threadIdx.x * per, nt), t1 = min(t0 + per, nt);
  int run_pad = 0, run_need = 0;
  for (int t = t0; t < t1; ++t) {
    const int c = cb[t];
    const int padded = padded_rows(c, chunk, a.min_chunk);
    need[t] = padded - c;
    run_pad += padded;
    run_need += padded - c;
  }
  int pad_total, need_total;
  int poffs = block_exclusive<kThreads>(run_pad, warp_sums, &pad_total);
  int needs = block_exclusive<kThreads>(run_need, warp_sums, &need_total);
  (void)need_total;
  // the unused fillers start after the points with no tile
  const int t_zero = pad_total + cb[nt];
  for (int t = t0; t < t1; ++t) {
    const int c = cb[t];
    first[t] = poffs + c;
    poffs += need[t] + c;
    needs += need[t];
    tail[t] = t_zero - needs;
  }
  __syncthreads();

  // filler f of the plain sort input: tile t's k-th, k < chunk, for
  // f < nt chunk, else a topping row, placed as tile nt - 1's unused
  const int n_fill = a.s_pad - a.p;
  const int f_lo = x * kFillPerBlock;
  const int f_hi = min(n_fill, f_lo + kFillPerBlock);
  const int spare = 2 * nt + 1;
  for (int f = f_lo + threadIdx.x; f < f_hi; f += kThreads) {
    const int t = min(f / chunk, nt - 1);
    const int k = f - t * chunk;
    const bool used = k < need[t];
    const int q = used ? first[t] + k : tail[t] + f;
    ob[q] = (Out)(a.packed ? row_value(used ? 2 * t + 1 : spare, a.p, a)
                           : a.p + f);
  }
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
bin_scatter_kernel(const int* __restrict__ keys,    // (B, P)
                   const int* __restrict__ counts,  // (B, nt + 1)
                   const int* __restrict__ bases,   // (B, n_stretch, nt+1)
                   Out* __restrict__ out,           // (B, s_pad)
                   Scatter a) {
  extern __shared__ int smem[];
  const int b = pose_of(blockIdx.y, blockIdx.z);
  if (b >= a.bsz) return;  // past the last pose: the whole block
  Out* ob = out + (long long)b * a.s_pad;
  if ((int)blockIdx.x < a.n_stretch)
    scatter_stretch(keys, bases, ob, b, blockIdx.x, a, smem);
  else
    scatter_fillers(counts, ob, b, blockIdx.x - a.n_stretch, a, smem);
}

template <typename Out>
int launch(const void* keys, const void* counts, const void* bases,
           void* out, const Scatter& a, int fill_blocks, cudaStream_t s) {
  const int words = stretch_words(a.nt) > filler_words(a.nt)
                        ? stretch_words(a.nt) : filler_words(a.nt);
  const size_t smem = sizeof(int) * (size_t)words;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bin_scatter_kernel<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  bin_scatter_kernel<Out>
      <<<dim3(a.n_stretch + fill_blocks, pose_low(a.bsz), pose_high(a.bsz)),
         kThreads, smem, s>>>((const int*)keys, (const int*)counts,
                              (const int*)bases, (Out*)out, a);
  return (int)cudaGetLastError();
}

}  // namespace

// `keys` (B, P) int32 in [0, nt]; `counts` (B, nt + 1) and `bases` (B,
// ceil(P / 4096), nt + 1) int32 as B9 (`dprast_slot_prep`) wrote them from
// these keys with the same chunk and min_chunk; `out` (B, s_pad), int32
// where `packed` and int64 else, written here.  1 <= nt <= 4096, s_pad =
// ceil(P / chunk) chunk + nt chunk < 2^31, chunk a multiple of 4; where
// `packed`, p2 is a power of two above P and (2nt + 1) p2 + P < 2^31.
extern "C" int dprast_bin_scatter(const void* keys, const void* counts,
                                  const void* bases, void* out, int bsz,
                                  int p, int nt, int chunk, int min_chunk,
                                  int packed, int p2, void* stream) {
  if (bsz < 1 || p < 1 || nt < 1 || nt > kMaxTiles ||
      chunk < 4 || chunk % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const long long p_pad = ((long long)p + chunk - 1) / chunk * chunk;
  const long long s_pad = p_pad + (long long)nt * chunk;
  if (s_pad >= (1ll << 31) ||
      (packed && (p2 <= p || (p2 & (p2 - 1)) != 0 ||
                  (2ll * nt + 1) * p2 + p >= (1ll << 31))))
    return (int)cudaErrorInvalidValue;
  Scatter a;
  a.bsz = bsz;
  a.p = p;
  a.nt = nt;
  a.chunk = chunk;
  a.s_pad = (int)s_pad;
  a.min_chunk = min_chunk != 0;
  a.packed = packed != 0;
  a.p2 = p2;
  a.n_stretch = (p + kStretch - 1) / kStretch;
  a.nbits = 32 - __builtin_clz((unsigned)nt);
  const int fill_blocks =
      (int)((s_pad - p + kFillPerBlock - 1) / kFillPerBlock);
  const cudaStream_t s = (cudaStream_t)stream;
  return a.packed ? launch<int>(keys, counts, bases, out, a, fill_blocks, s)
                  : launch<long long>(keys, counts, bases, out, a,
                                      fill_blocks, s);
}
