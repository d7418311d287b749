"""The `xla` backend's scatter on one CUDA card, in three forms:
`xla_scatter` (kernel X2, `csrc/xla_path.cu`: each run of the stably
sorted keys added onto its voxel in input order, one writer a voxel; the
backend's forward on the card); `index_put_(..., accumulate=True)`
(torch's sorted path: a stable sort by index, then each voxel's terms
added in input order; the card's forward before X2); and `index_add_`
(float atomics; the card's forward before that).  The two torch forms
take the sorted keys and terms that X1 and the sort hand X2, into a
buffer of the volume plus one entry that absorbs the out-of-grid terms.

With torch's deterministic mode off, for each of the three rows that
`auto` sends to `xla` on the card -- ``1024cube_1e5`` (1024^3, one pose,
10^5 points: the `xla` row of `BENCHMARKS_h100.jsonl`), a 1-D grid
(4096,) and a rank-4 grid 16^4, four poses of 10^4 points each -- it runs
the forward and the fused step (`core.raster_fwd_res`, then
`core.raster_pullback_res` on its residuals) of each form twice and says
whether the two runs give the same bits.  At ``1024cube_1e5`` it then
times the forward and the fused step of each form with CUDA events, in
the order of the forms and back, and reads the peak device memory of one
fused step of each and, from `torch.profiler`, what one forward keeps
the card busy with, kernel by kernel.  The inputs are
`dprast_torch.benchmarks.run`'s (`_args_for`, `_cotangent`).

Usage, from the root of the repository:

    python3 -m dprast_torch.benchmarks.exp_xla_scatter
"""

from __future__ import annotations

import contextlib
import math
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


def _into_sink(torch_form):
    """A torch form of X2 on its arguments: the terms added into the
    backgrounds' volume with one more entry, which absorbs the out-of-grid
    keys."""
    def scatter(background, grid, keys, perm, vals):
        b, total = background.shape[0], math.prod(grid)
        flat = background[:, None].expand(b, total).reshape(-1)
        buf = torch.cat([flat, flat.new_zeros(1)])
        torch_form(buf, keys, vals[perm])
        return buf[:-1].view((b,) + tuple(grid))
    return scatter


FORMS = {"xla_scatter": core.xla_scatter,
         "index_put_": _into_sink(lambda buf, idx, w: buf.index_put_(
             (idx,), w, accumulate=True)),
         "index_add_": _into_sink(lambda buf, idx, w: buf.index_add_(
             0, idx, w))}


@contextlib.contextmanager
def scatter(form):
    """`core.xla_scatter` is the form `form` while open."""
    keep = core.xla_scatter
    core.xla_scatter = FORMS[form]
    try:
        yield
    finally:
        core.xla_scatter = keep


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
