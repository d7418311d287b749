"""The frame gather in other forms, on one CUDA card: where its time goes
and what would close the gap to its bound.

The frame gather writes the multi-tile frame after the binning sort:
frame row r of pose b holds the encoded planes of the point the sort put
there (a random read per plane) and its id.  Its forms, each a kernel of
one library built here from the source in this file:

- ``a``: the kernel before B9 (`frame_gather.cu` of PR 10): the row's
  source from the sort's int64 permutation, one row a thread, one 4-byte
  read per source plane;
- ``b``: the row's id from the packed sorted keys, ``key & (p2 - 1)``
  (``id == P`` a filler): 4 bytes in place of 8;
- ``c``: (b) with no source reads: the floor that the index and the stores
  set (computes something else);
- ``d``: (b) with the sources read at the row's own position, coalesced:
  what the random reads cost (computes something else);
- ``e``: (b) with the sources interleaved per point as (B, P, 4) int32,
  one 16-byte load a row; ``e2`` the same as (B, P, 2), 8 bytes, where
  two planes are read (2-D);
- ``f``: (b) with 4 rows a thread and 16-byte stores per plane;
- ``ef``: (e) with 4 rows a thread (the interleaved width that fits:
  (B, P, 2) in 2-D, (B, P, 4) in 3-D).

The planar and interleaved copies are made outside the timed launches.
Beside them the package's own `frame_gather` (``kernel``) on what the
main path hands it: the packed keys and B6's planes, which B6 writes
interleaved since B9.  At the main path's two multi-tile shapes (1024^2 x
64 poses x 10^5 points, 128^3 x 1 x 10^6: the flagship cloud and
BASELINE config 4, uniform weights) each form is held to
`_frame_gather_plain` bit for bit (except c and d) and timed in turns
(forms in order, then back), by its device microseconds from
`torch.profiler`.

Usage, from the root of the repository:

    python3 -m dprast_torch.benchmarks.exp_gather_forms
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "exp_gather_forms"

SOURCE = r"""
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// form a: the kernel before B9, as it was
__global__ void __launch_bounds__(kThreads)
gather_a(const long long* __restrict__ perm, long long perm_stride,
         const int* __restrict__ src0, const int* __restrict__ src1,
         const int* __restrict__ src2, int n_src,
         const float* __restrict__ weight, int* __restrict__ data,
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

struct Args {
  const int* keys;   // (B, s_pad) packed sorted keys
  const int* src[3]; // planar sources (B, P) each
  const int* inter;  // interleaved (B, P, VEC)
  int* data;         // (B, n_src + 1, s_pad)
  int p;
  int mask;          // p2 - 1
  long long s_pad;
};

// MODE 0: the gather; 1: no source reads; 2: sources at the row's own
// position.  VEC 1: planar sources; 2, 4: interleaved.  ROWS rows a thread.
template <int N_SRC, int VEC, int ROWS, int MODE>
__global__ void __launch_bounds__(kThreads) gather_form(Args a) {
  const long long row0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * ROWS;
  const int b = blockIdx.y;
  if (row0 >= a.s_pad) return;
  int id[ROWS];
  if constexpr (ROWS == 4) {
    const int4 k = *reinterpret_cast<const int4*>(a.keys + b * a.s_pad + row0);
    id[0] = k.x & a.mask; id[1] = k.y & a.mask;
    id[2] = k.z & a.mask; id[3] = k.w & a.mask;
  } else {
    id[0] = a.keys[b * a.s_pad + row0] & a.mask;
  }
  int v[ROWS][N_SRC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const bool real = id[r] < a.p;
    long long at = (long long)b * a.p + (real ? id[r] : 0);
    if (MODE == 2) at = (long long)b * a.p + (row0 + r) % a.p;
    if (MODE == 1) {
#pragma unroll
      for (int i = 0; i < N_SRC; ++i) v[r][i] = real ? id[r] + i : 0;
    } else if (VEC == 4) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(a.inter) + at);
      v[r][0] = w.x; v[r][1] = w.y;
      if (N_SRC > 2) v[r][N_SRC - 1] = w.z;
    } else if (VEC == 2) {
      const int2 w = __ldg(reinterpret_cast<const int2*>(a.inter) + at);
      v[r][0] = w.x; v[r][N_SRC - 1] = w.y;
    } else {
#pragma unroll
      for (int i = 0; i < N_SRC; ++i) v[r][i] = __ldg(a.src[i] + at);
    }
    if (!real) {
#pragma unroll
      for (int i = 0; i < N_SRC; ++i) v[r][i] = 0;
    }
  }
  int* out = a.data + (long long)b * (N_SRC + 1) * a.s_pad + row0;
  if constexpr (ROWS == 4) {
#pragma unroll
    for (int i = 0; i < N_SRC; ++i)
      *reinterpret_cast<int4*>(out + i * a.s_pad) =
          make_int4(v[0][i], v[1][i], v[2][i], v[3][i]);
    int4 ids;
    ids.x = __float_as_int((float)min(id[0], a.p));
    ids.y = __float_as_int((float)min(id[1], a.p));
    ids.z = __float_as_int((float)min(id[2], a.p));
    ids.w = __float_as_int((float)min(id[3], a.p));
    *reinterpret_cast<int4*>(out + N_SRC * a.s_pad) = ids;
  } else {
#pragma unroll
    for (int i = 0; i < N_SRC; ++i) out[i * a.s_pad] = v[0][i];
    out[N_SRC * a.s_pad] = __float_as_int((float)min(id[0], a.p));
  }
}

template <int N_SRC, int VEC, int ROWS, int MODE>
void run(const Args& a, int bsz, cudaStream_t s) {
  const long long threads = (a.s_pad + ROWS - 1) / ROWS;
  gather_form<N_SRC, VEC, ROWS, MODE>
      <<<dim3((unsigned)((threads + kThreads - 1) / kThreads), bsz),
         kThreads, 0, s>>>(a);
}

}  // namespace

// form: 1 b, 2 c, 3 d, 4 e, 5 e2, 6 f, 7 ef (2-D: e2 with 4 rows)
extern "C" int exp_gather_form(int form, const void* keys, const void* src0,
                               const void* src1, const void* src2,
                               const void* inter, void* data, int bsz, int p,
                               int n_src, int p2, long long s_pad,
                               void* stream) {
  Args a = {(const int*)keys, {(const int*)src0, (const int*)src1,
                               (const int*)src2},
            (const int*)inter, (int*)data, p, p2 - 1, s_pad};
  const cudaStream_t s = (cudaStream_t)stream;
  if (s_pad % 4 != 0 || (n_src != 2 && n_src != 3))
    return (int)cudaErrorInvalidValue;
#define FORMS(N)                                                  \
  switch (form) {                                                 \
    case 1: run<N, 1, 1, 0>(a, bsz, s); break;                    \
    case 2: run<N, 1, 1, 1>(a, bsz, s); break;                    \
    case 3: run<N, 1, 1, 2>(a, bsz, s); break;                    \
    case 4: run<N, 4, 1, 0>(a, bsz, s); break;                    \
    case 5: if (N != 2) return (int)cudaErrorInvalidValue;        \
            run<N, 2, 1, 0>(a, bsz, s); break;                    \
    case 6: run<N, 1, 4, 0>(a, bsz, s); break;                    \
    case 7: run<N, (N == 2 ? 2 : 4), 4, 0>(a, bsz, s); break;     \
    default: return (int)cudaErrorInvalidValue;                   \
  }
  if (n_src == 2) { FORMS(2) } else { FORMS(3) }
#undef FORMS
  return (int)cudaGetLastError();
}

extern "C" int exp_gather_a(const void* perm, long long perm_stride,
                            const void* src0, const void* src1,
                            const void* src2, int n_src, void* data,
                            int bsz, int p, long long s_pad, void* stream) {
  gather_a<<<dim3((unsigned)((s_pad + kThreads - 1) / kThreads), bsz),
             kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)perm, perm_stride, (const int*)src0,
      (const int*)src1, (const int*)src2, n_src, nullptr, (int*)data, p,
      n_src + 1, s_pad);
  return (int)cudaGetLastError();
}
"""

# form -> (code of exp_gather_form, or 0 for form a, and its kernel's name
# in the profiler)
FORMS = {"a": 0, "b": 1, "c": 2, "d": 3, "e": 4, "e2": 5, "f": 6, "ef": 7}
SAME_BITS = ("a", "b", "e", "e2", "f", "ef", "kernel")


def build():
    """Compile `SOURCE` into a library of its own -> ctypes handle."""
    from dprast_torch.ops import _build
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / "forms.cu", OUT / "libforms.so"
    cu.write_text(SOURCE)
    subprocess.run([_build._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared",
                    "-Xptxas", "-v", "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.exp_gather_form.argtypes = [i32, vp, vp, vp, vp, vp, vp, i32, i32,
                                    i32, i32, i64, vp]
    lib.exp_gather_a.argtypes = [vp, i64, vp, vp, vp, i32, vp, i32, i32,
                                 i64, vp]
    return lib


def inputs(grid, n_poses, n_points, dev):
    """B6's planes and the sort of the main path at this shape -> (perm,
    sorted packed keys, p2, locs)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from dprast_torch.ops import splat_binned as sb
    pts, rot, tr = cs.main_inputs(grid, n_poses, n_points, dev)[:3]
    key, locs, nt = sb._keys_and_local(grid, sb.tile_shape_for(grid), pts,
                                       rot, tr)
    chunk = sb._default_chunk(grid, n_points)
    keys2 = sb._slot_prep_plain(key, nt, chunk, True, True)[0]
    sorted_keys, perm = torch.sort(keys2, dim=1, stable=False)
    return perm, sorted_keys, sb._id_span(n_points), locs


def main():
    from dprast_torch.ops import splat_binned as sb
    from dprast_torch.utils import profiling
    dev = torch.device("cuda", 0)
    print(profiling.card(0))
    lib = build()
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    for grid, n_poses, n_points in (((1024, 1024), 64, 100_000),
                                    ((128, 128, 128), 1, 1_000_000)):
        perm, skeys, p2, locs = inputs(grid, n_poses, n_points, dev)
        n_src, (bsz, s_pad) = len(locs), perm.shape
        # the planar forms read (B, P) planes of their own; B6 writes the
        # planes interleaved
        planar = [x.contiguous() for x in locs]
        pad = [torch.zeros_like(planar[0])] * (4 - n_src)
        inter4 = torch.stack(planar + pad, dim=-1).contiguous()
        inter2 = torch.stack(planar, dim=-1).contiguous() if n_src == 2 \
            else None
        srcs = [ptr(x) for x in planar] + [None] * (3 - n_src)
        want = sb._frame_gather_plain(perm, locs, None)

        def call(form):
            data = torch.empty((bsz, n_src + 1, s_pad), dtype=torch.float32,
                               device=dev)
            if form == "kernel":
                return sb.frame_gather(skeys, locs, None)
            if form == "a":
                rc = lib.exp_gather_a(ptr(perm), perm.stride(0), *srcs,
                                      n_src, ptr(data), bsz, n_points,
                                      s_pad, stream())
            else:
                inter = inter2 if (form == "e2" or (
                    form == "ef" and n_src == 2)) else inter4
                rc = lib.exp_gather_form(FORMS[form], ptr(skeys), *srcs,
                                         ptr(inter), ptr(data), bsz,
                                         n_points, n_src, p2, s_pad,
                                         stream())
            if rc != 0:
                raise RuntimeError(f"form {form}: CUDA error {rc}")
            return data

        names = [f for f in FORMS if not (f == "e2" and n_src != 2)]
        names.append("kernel")
        same = {}
        for form in names:
            got = call(form)
            torch.cuda.synchronize()
            same[form] = torch.equal(got.view(torch.int32),
                                     want.view(torch.int32))
        us = {form: [] for form in names}
        for form in names + names[::-1]:
            kname = "frame_gather_kernel" if form == "kernel" else (
                "gather_a" if form == "a" else "gather_form")
            us[form].append(round(profiling.kernel_device_us(
                lambda: call(form), kname, calls=20), 2))
        tag = f"{'x'.join(map(str, grid))} x {n_poses} x {n_points}"
        print(json.dumps({"shape": tag, "us_in_turns": us,
                          "bit_equal": same}), flush=True)
        for form in names:
            print(f"[gather forms] {tag} {form}: device us "
                  f"{' / '.join(f'{x:.2f}' for x in us[form])}"
                  + (f"; bit-equal to _frame_gather_plain {same[form]}"
                     if form in SAME_BITS else " (computes something else)"))
            if form in SAME_BITS and not same[form]:
                raise SystemExit(f"form {form} at {tag} is not the frame")


if __name__ == "__main__":
    main()
