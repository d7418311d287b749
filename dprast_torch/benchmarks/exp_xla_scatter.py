"""The `xla` backend's scatter on one CUDA card, in three forms:
`index_add_` (float atomics; the backend's earlier forward on the card);
`index_put_(..., accumulate=True)` (a stable sort by index, then
each voxel's terms added in input order); and "sorted runs" (the terms
sorted by index, each run of equal indices summed in order by
`index_put_` into a buffer of one entry a term, then each run's sum added
into the volume once by `index_add_`, whose other terms are zeros).

With torch's deterministic mode off, for each of the three rows that
`auto` sends to `xla` on the card -- ``1024cube_1e5`` (1024^3, one pose,
10^5 points: the `xla` row of `BENCHMARKS_h100.jsonl`), a 1-D grid
(4096,) and a rank-4 grid 16^4, four poses of 10^4 points each -- it runs
the forward and the fused step (`core.raster_fwd_res`, then
`core.raster_pullback_res` on its residuals) of each form twice and says
whether the two runs give the same bits.  At ``1024cube_1e5`` it then
times the forward and the fused step of each form with CUDA events, in
the order add, put, put, add, and reads the peak device memory of one
fused step of each and, from `torch.profiler`, what one forward keeps
the card busy with, kernel by kernel.  The inputs are
`dprast_torch.benchmarks.run`'s (`_args_for`, `_cotangent`).

Usage, from the root of the repository:

    python3 -m dprast_torch.benchmarks.exp_xla_scatter
"""

from __future__ import annotations

import contextlib
import tempfile

import torch
from torch.autograd import DeviceType

from dprast_torch.benchmarks.run import _args_for, _cotangent
from dprast_torch.ops import core
from dprast_torch.utils import profiling

# (name, grid, poses, points)
ROWS = (("1024cube_1e5", (1024, 1024, 1024), 1, 100_000),
        ("(4096,) x 4 x 1e4", (4096,), 4, 10_000),
        ("16^4 x 4 x 1e4", (16, 16, 16, 16), 4, 10_000))


def sorted_runs(flat, idx, w):
    """``flat[idx[i]] += w[i]``: each run of equal indices, in input order
    (a stable sort), summed by `index_put_` into a buffer of one entry a
    term at the run's first position, then added once into `flat`."""
    s, perm = torch.sort(idx, stable=True)
    start = torch.ones_like(s, dtype=torch.bool)
    start[1:] = s[1:] != s[:-1]
    pos = torch.arange(s.numel(), device=s.device)
    first = torch.cummax(torch.where(start, pos, 0), 0).values
    runs = torch.zeros_like(w).index_put_((first,), w[perm], accumulate=True)
    return flat.index_add_(0, s, torch.where(start, runs, 0.0))


FORMS = {"index_add_": lambda flat, idx, w: flat.index_add_(0, idx, w),
         "index_put_": lambda flat, idx, w: flat.index_put_(
             (idx,), w, accumulate=True),
         "sorted runs": sorted_runs}


@contextlib.contextmanager
def scatter(form):
    """`core._scatter_add` is the form `form` while open."""
    keep = core._scatter_add
    core._scatter_add = FORMS[form]
    try:
        yield
    finally:
        core._scatter_add = keep


def row_inputs(grid, n_poses, n_points, dev):
    """The row's canonical six inputs and cotangent on `dev`."""
    arrays = _args_for(n_points, n_poses, grid, max(3, len(grid)))
    return (tuple(torch.from_numpy(a).to(dev) for a in arrays),
            _cotangent(n_poses, grid, dev))


def calls(grid, args, g):
    """The forward and the fused step of the `xla` backend -> {name: fn}."""
    def step():
        out, res = core.raster_fwd_res(grid, *args)
        return (out, *core.raster_pullback_res(grid, res, args, g))

    return {"forward": lambda: core.raster_fwd(grid, *args),
            "fused step": step}


def same_bits(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def by_kernel(fn, calls=3):
    """What one call of `fn` keeps the card busy with -> [(kernel, us,
    launches)] by falling time."""
    fn()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            for _ in range(calls):
                fn()
    return sorted(((e.key, e.device_time_total / calls, e.count / calls)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda row: -row[1])


def main():
    if not torch.cuda.is_available():
        raise SystemExit("exp_xla_scatter: torch.cuda.is_available() is "
                         "False")
    torch.use_deterministic_algorithms(False)
    dev = torch.device("cuda", 0)
    card = profiling.card()
    for name, grid, n_poses, n_points in ROWS:
        args, g = row_inputs(grid, n_poses, n_points, dev)
        for form in FORMS:
            with scatter(form):
                got = []
                for what, fn in calls(grid, args, g).items():
                    same = same_bits(fn(), fn())
                    torch.cuda.synchronize()
                    got.append(f"{what} bit-equal on two runs {same}")
            print(f"{card} | {name}, {form}: " + "; ".join(got), flush=True)
        if name != "1024cube_1e5":
            continue
        fns = calls(grid, args, g)
        order = (*FORMS, *reversed(FORMS))
        for what, fn in fns.items():
            ms = {}
            for form in order:
                with scatter(form):
                    ms.setdefault(form, []).append(
                        profiling.time_fn(fn, "cuda")[0])
            print(f"{card} | {name} {what} ms in turns ("
                  + ", ".join(order) + "): "
                  + "; ".join(f"{f} " + ", ".join(f"{t:.4f}" for t in v)
                              for f, v in ms.items()), flush=True)
        for form in FORMS:
            with scatter(form):
                rows = by_kernel(fns["forward"])
            print(f"{card} | {name} forward, {form}, by kernel (us, "
                  f"launches): " + "; ".join(
                      f"{k[:70]} {us:.1f} x{n:.0f}" for k, us, n in rows),
                  flush=True)
        for form in FORMS:
            with scatter(form):
                fns["fused step"]()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                fns["fused step"]()
                torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            print(f"{card} | {name} fused step, {form}: peak device memory "
                  f"{peak:.2f} GB", flush=True)


if __name__ == "__main__":
    main()
