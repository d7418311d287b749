"""What the port's stage spans cost the host (`profiling.annotate`).

Without `--step`: host µs of one span's enter and exit, the best
of 5 rounds of 10^4, for the forms a span could take -- an ungated
``torch.profiler.record_function``, `torch._C._profiler.
_RecordFunctionFast` ungated, each gated on
``torch.autograd._profiler_enabled()``, and `annotate` as a block and as
a decorator (less the bare call) -- with no profiler running, under the
device's own capture (CUDA activity alone, as a traced run's first
capture) and under an attributing one (CPU and CUDA).

`--step`: host µs to enqueue one fit step of `BENCHMARK.json`'s
`proj1024_fit` shape (10^5 points, 64 orthographic poses, 1024^2, `auto`:
the binned path), each step after a synchronize so that no launch waits
for a full queue: `raster`, the mean squared error against a zero target,
`torch.autograd.grad` of points, rotations and translations.  Steps of
each package named in `--packages` take turns in one process (who goes
first alternates), so that a shared host's drift falls on all alike: the
median and the mean of each over 300 steps (`--steps`) after 30 of
warm-up, and the mean and quartiles of the paired differences to the
first package.  `--profile device` runs the steps under the device's own
capture (CUDA activity), `--profile attributing` under an attributing one
(CPU and CUDA), whose ranges every span then opens; ``<package>:nospans``
is the package with its spans' check reading False during its steps, so
that ``--packages dprast_torch:nospans,dprast_torch --profile
attributing`` isolates what the open spans cost.  Another checkout's
package compares under another name, its imports renamed:

    git archive <commit> dprast_torch | tar -x -C <dir>
    mv <dir>/dprast_torch <dir>/dprast_torch_parent
    grep -rl dprast_torch <dir>/dprast_torch_parent \\
        | xargs sed -i 's/dprast_torch/dprast_torch_parent/g'
    PYTHONPATH=<dir> python3 -m dprast_torch.benchmarks.exp_span_cost \\
        --step --packages dprast_torch_parent,dprast_torch

One JSON line each, with the card and its power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import statistics
import time
import timeit

import torch

ROUNDS, NUMBER = 5, 10_000
STEP_WARMUP, STEPS = 30, 300


def _forms():
    from dprast_torch.utils import profiling

    fast = torch._C._profiler._RecordFunctionFast
    recording = torch.autograd._profiler_enabled

    def record_function():
        with torch.profiler.record_function("exp.span"):
            pass

    def record_function_fast():
        with fast("exp.span"):
            pass

    def gated_record_function():
        if recording():
            with torch.profiler.record_function("exp.span"):
                pass

    def gated_record_function_fast():
        if recording():
            with fast("exp.span"):
                pass

    def annotate_block():
        with profiling.annotate("exp.span"):
            pass

    def bare(x):
        return x

    decorated = profiling.annotate("exp.span")(bare)
    return {"record_function": record_function,
            "_RecordFunctionFast": record_function_fast,
            "gated record_function": gated_record_function,
            "gated _RecordFunctionFast": gated_record_function_fast,
            "annotate block": annotate_block,
            "annotate decorator": lambda: decorated(0),
            "bare call": lambda: bare(0)}


def _us(fn):
    return min(timeit.repeat(fn, number=NUMBER, repeat=ROUNDS)) / NUMBER * 1e6


def spans(device):
    forms = _forms()
    activity = torch.profiler.ProfilerActivity
    states = {"off": None, "device capture": [activity.CUDA],
              "attributing capture": [activity.CPU, activity.CUDA]}
    out = {}
    for state, activities in states.items():
        if activities is None:
            out[state] = {name: _us(fn) for name, fn in forms.items()}
            continue
        with torch.profiler.profile(activities=activities):
            torch.ones(1, device=device).sum()
            out[state] = {name: _us(fn) for name, fn in forms.items()}
    for got in out.values():
        got["annotate decorator"] -= got["bare call"]
    return {"us_per_span": out, "number": NUMBER, "rounds": ROUNDS}


def _fit_step(raster, device):
    """One fit step of `proj1024_fit`'s shape through `raster` -> fn()."""
    gen = torch.Generator(device=device).manual_seed(1)
    n, poses, grid = 100_000, 64, (1024, 1024)
    points = (torch.randn((n, 3), generator=gen, device=device) * 0.4
              ).requires_grad_()
    ang = torch.arange(poses, device=device) * (2 * math.pi / poses)
    rot = torch.zeros((poses, 2, 3), device=device)
    rot[:, 0, 0], rot[:, 0, 2] = torch.cos(ang), -torch.sin(ang)
    rot[:, 1, 1] = 1.0
    rot.requires_grad_()
    tr = (torch.randn((poses, 2), generator=gen, device=device) * 0.1
          ).requires_grad_()
    target = torch.zeros((poses,) + grid, device=device)

    def one():
        pred = raster(grid, points, rot, tr)
        loss = torch.mean((pred - target) ** 2)
        return torch.autograd.grad(loss, (points, rot, tr))

    return one


def step(device, packages, profile=None, steps=STEPS):
    """`packages`: module names, each with ``:nospans`` where its spans'
    check is to read False during its steps (the same program with its
    spans shut, beside itself); `profile`: None, or the capture the steps
    run under, "device" (CUDA activity) or "attributing" (CPU and
    CUDA)."""
    arms = {}
    for arm in packages:
        name, _, mode = arm.partition(":")
        module = importlib.import_module(name)
        arms[arm] = (_fit_step(module.raster, device), module, mode)
    times = {arm: [] for arm in packages}
    activity = torch.profiler.ProfilerActivity
    activities = {"device": [activity.CUDA],
                  "attributing": [activity.CPU, activity.CUDA]}
    with (torch.profiler.profile(activities=activities[profile])
          if profile else contextlib.nullcontext()):
        for k in range(STEP_WARMUP + steps):
            order = packages if k % 2 == 0 else packages[::-1]
            for arm in order:
                fn, module, mode = arms[arm]
                spans = importlib.import_module(
                    module.__name__ + ".utils.profiling")
                if mode == "nospans":
                    gate, spans._recording = spans._recording, _never
                torch.cuda.synchronize(device)
                t = time.perf_counter()
                fn()
                took = time.perf_counter() - t
                if mode == "nospans":
                    spans._recording = gate
                if k >= STEP_WARMUP:
                    times[arm].append(took * 1e6)
            torch.cuda.synchronize(device)
    first = times[packages[0]]
    out = {}
    for arm, got in times.items():
        diff = [b - a for a, b in zip(first, got)]
        out[arm] = {"median": statistics.median(got),
                    "mean": statistics.fmean(got),
                    "diff_mean": statistics.fmean(diff),
                    "diff_quartiles": statistics.quantiles(diff, n=4),
                    "program": arms[arm][1].__file__}
    return {"host_us_per_step": out, "steps": steps, "profiled": profile}


def _never():
    return False


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--step", action="store_true")
    parser.add_argument("--packages", default="dprast_torch")
    parser.add_argument("--profile", choices=("device", "attributing"))
    parser.add_argument("--steps", type=int, default=STEPS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_span_cost: torch.cuda.is_available() is False")
    from dprast_torch.utils import profiling

    device = torch.device("cuda", 0)
    result = step(device, args.packages.split(","), args.profile,
                  args.steps) if args.step else spans(device)
    result.update(card=profiling.card(0), torch=torch.__version__)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
