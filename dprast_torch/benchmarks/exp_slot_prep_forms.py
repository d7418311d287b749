"""B9 (`slot_prep`, the binning sort's preparation) in other forms of its
count, on one CUDA card: what the shared histogram's atomics cost where
the keys of a dense cloud land in a few hot bins.

Each form is an edited copy of `csrc/slot_prep.cu` built alone into a
library of its own under ``build/exp_slot_prep_forms/`` (its C entry
point only) and called with the arguments the wrapper passes:

- ``kernel``: the source as it is (one shared atomic a key);
- ``match``: each warp groups its equal keys (`__match_any_sync`) and
  one lane a group adds the group's size;
- ``lead1``: the warp's lanes that hold the first live lane's key add
  once, the others one atomic each;
- ``lead2``: the same two rounds deep;
- ``no_count``: no atomics: the floor that the loads and the stores of
  pass 1 set (computes something else).

At the main path's two multi-tile shapes (1024^2 x 64 poses x 10^5
points, 128^3 x 1 x 10^6: the flagship cloud and BASELINE config 4), on
the keys B6 writes there and on random keys spread over [0, nt], every
form is held to `_slot_prep_plain` and `_bases_plain` bit for bit
(except ``no_count``) and timed in turns (forms in order, then back): the
device microseconds of pass 1 (`slot_count_kernel`) and pass 2
(`slot_scan_kernel`) from `torch.profiler`.

Usage, from the root of the repository:

    python3 -m dprast_torch.benchmarks.exp_slot_prep_forms
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "exp_slot_prep_forms"
SOURCE = ROOT / "dprast_torch" / "csrc" / "slot_prep.cu"

# the body of `count_key`, which every form replaces
_BODY_START = ("__device__ __forceinline__ void count_key(int* hist, int k, "
               "bool ok) {\n")
_BODY_END = "\n}\n\n__global__"
_LEAD = """  const unsigned full = 0xffffffffu;
  bool left = ok;
  for (int round = 0; round < ROUNDS; ++round) {
    const unsigned live = __ballot_sync(full, left);
    if (live == 0u) return;
    const int first = __ffs(live) - 1;
    const int k0 = __shfl_sync(full, k, first);
    const unsigned same = __ballot_sync(full, left && k == k0);
    if ((threadIdx.x & 31) == first) atomicAdd(&hist[k0], __popc(same));
    left = left && k != k0;
  }
  if (left) atomicAdd(&hist[k], 1);"""
BODIES = {
    "match": """  const unsigned peers = __match_any_sync(0xffffffffu, ok ? k : -1);
  if (ok && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[k], __popc(peers));""",
    "lead1": _LEAD.replace("ROUNDS", "1"),
    "lead2": _LEAD.replace("ROUNDS", "2"),
    "no_count": "  if (ok && k == -7) atomicAdd(&hist[0], 1);",
}
FORMS = ("kernel", *BODIES)


def form_source(name: str) -> str:
    text = SOURCE.read_text()
    if name == "kernel":
        return text
    a = text.index(_BODY_START) + len(_BODY_START)
    b = text.index(_BODY_END, a)
    return text[:a] + BODIES[name] + text[b:]


def build(name: str):
    """The form's library -> its `dprast_slot_prep`, with the argument
    types of the package's own."""
    from dprast_torch.ops import _build
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(form_source(name))
    subprocess.run([_build._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared",
                    "-o", str(so), str(cu)], check=True)
    fn = ctypes.CDLL(str(so)).dprast_slot_prep
    ref = _build.load().dprast_slot_prep
    fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return fn


def main():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from dprast_torch.ops import splat_binned as sb
    from dprast_torch.utils import profiling
    dev = torch.device("cuda", 0)
    print(profiling.card(0))
    entries = {name: build(name) for name in FORMS}
    for grid, n_poses, n_points in cs.SLOT_PREP_CASES:
        pts, rot, tr = cs.main_inputs(grid, n_poses, n_points, dev)[:3]
        key, _, nt = sb._keys_and_local(grid, sb.tile_shape_for(grid), pts,
                                        rot, tr)
        chunk = sb._default_chunk(grid, n_points)
        wild = torch.randint(0, nt + 1, key.shape, dtype=torch.int32,
                             device=dev)
        for keys, label in ((key, "B6's keys"), (wild, "random keys")):
            _, slot_tile, counts = sb._slot_prep_plain(keys, nt, chunk,
                                                       True, False)
            want = (sb._bases_plain(keys, counts, nt, chunk, True),
                    slot_tile, counts)

            def call(name):
                out = tuple(torch.empty_like(t) for t in want)
                rc = entries[name](*(sb._ptr(t) for t in (keys, *out)),
                                   n_poses, n_points, nt, chunk, 1,
                                   sb._stream(dev))
                if rc != 0:
                    raise RuntimeError(f"form {name}: CUDA error {rc}")
                return out

            same = {}
            for name in FORMS:
                got = call(name)
                torch.cuda.synchronize()
                same[name] = all(torch.equal(a, b) for a, b in zip(got, want))
            us = {name: [] for name in FORMS}
            for name in FORMS + FORMS[::-1]:
                fn = lambda: call(name)
                us[name].append((
                    round(profiling.kernel_device_us(fn, "slot_count_kernel",
                                                     calls=20), 2),
                    round(profiling.kernel_device_us(fn, "slot_scan_kernel",
                                                     calls=20), 2)))
            tag = (f"{'x'.join(map(str, grid))} x {n_poses} x {n_points}, "
                   f"{label}")
            print(json.dumps({"case": tag, "count_scan_us_in_turns": us,
                              "bit_equal": same}), flush=True)
            for name in FORMS:
                print(f"[slot_prep forms] {tag} {name}: pass 1 "
                      + " / ".join(f"{c:.2f}" for c, _ in us[name])
                      + " us, pass 2 "
                      + " / ".join(f"{f:.2f}" for _, f in us[name]) + " us"
                      + ("" if name == "no_count" else
                         f"; bit-equal to the plain versions {same[name]}"))
                if name != "no_count" and not same[name]:
                    raise SystemExit(f"form {name} ({tag}) is not B9's "
                                     f"function")


if __name__ == "__main__":
    main()
