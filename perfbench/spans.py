"""The program's own spans in the attributing capture of a traced run.

The port runs each stage inside a span named ``dprast.<stage>``
(`dprast_torch.utils.profiling.annotate`): the outermost are
``dprast.raster[<forward>/<backward>]`` around a call of `raster` and
``dprast.pullback[<backward>]`` around a pullback, which autograd runs
on a thread of its own; the stages inside them are listed in PERF.md §3.
A device operation belongs to a span when the call that launched it lies
inside the span on the span's own thread (`perfbench.trace`).

A capture of a program that emits no span (a checkout from before them)
reads None, so that a metric of spans is left out there and not read as
0.  `python3 -m perfbench.spans --workload <cell> --seed <n>` runs a
traced run of the cell and prints, from its attributing capture, the
device time a step or call by the innermost program span that launched
it, the share of the outermost spans' device time that a stage span
holds, the operations outside any stage span by kernel, and the idle gaps
by the program span whose launch ended them, as one JSON object.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from pathlib import Path

PREFIX = "dprast."
OUTERMOST = ("dprast.raster[", "dprast.pullback[")


def has_program_spans(t) -> bool:
    """Whether the capture `t` (a `perfbench.trace.Trace`) holds one of
    the program's outermost spans inside its window."""
    return any(h[3].startswith(OUTERMOST) and t.t0 <= h[1] <= t.t1
               for h in t.host)


def fit_step_us(ctx, names):
    """Device µs a step launched inside the program's spans named `names`
    (each on its own thread) in the attributing capture of a traced fit
    run; None where the capture holds no device operation or the program
    emits no span."""
    t = ctx.attributed
    if t is None or ctx.kind != "fit" or not t.launches() \
            or not ctx.batches or not has_program_spans(t):
        return None
    return t.device_s_in(t.ranges(tuple(names))) * 1e6 / len(ctx.batches)


def _innermost(spans, at):
    """The innermost of `spans` ((start, end, name) sorted by start, on
    one thread, nested) that holds the time `at`, or None."""
    k = bisect.bisect_right(spans, (at, float("inf"), "")) - 1
    while k >= 0:
        ts, end, name = spans[k]
        if end >= at:
            return name
        k -= 1
    return None


def _outermost(spans, at):
    """The outermost of `spans` (as in `_innermost`) that holds `at`."""
    for ts, end, name in spans:
        if ts > at:
            break
        if end >= at:
            return name
    return None


def stage_table(t, steps, top=12):
    """The attributing capture `t` of `steps` steps or calls, read by the
    program's spans -> dict (device µs a step; names cut to 120 chars):
    by the innermost program span that launched it, and by kernel within
    each span.
    `coverage` is the share of the device time launched inside the
    outermost spans (`dprast.raster[…]`, `dprast.pullback[…]`) that a
    stage span inside them holds."""
    by_tid = {}
    for tid, ts, end, name in sorted(t.host, key=lambda h: h[1]):
        if name.startswith(PREFIX) and t.t0 <= ts <= t.t1:
            by_tid.setdefault(tid, []).append((ts, end, name))
    per_span, kernels, outside, uncovered = {}, {}, {}, {}
    inner_us = stage_us = 0.0
    for ts, end, name, launch in t.ops:
        us = (end - ts) / steps
        spans = by_tid.get(launch[0], []) if launch else []
        span = _innermost(spans, launch[1]) if spans else None
        if span is None:
            where = t._host_at(launch) if launch else "unknown"
            outside[where] = outside.get(where, 0.0) + us
            continue
        per_span[span] = per_span.get(span, 0.0) + us
        mine = kernels.setdefault(span, {})
        mine[name[:120]] = mine.get(name[:120], 0.0) + us
        if not (_outermost(spans, launch[1]) or "").startswith(OUTERMOST):
            continue
        inner_us += us
        if span.startswith(OUTERMOST):
            uncovered[name[:120]] = uncovered.get(name[:120], 0.0) + us
        else:
            stage_us += us
    gaps, prev_end = {}, t.t0
    for ts, end, name, launch in t.ops:
        if ts > prev_end:
            span = _innermost(by_tid.get(launch[0], []), launch[1]) \
                if launch else None
            span = span or (t._host_at(launch) if launch else "unknown")
            gaps[span] = gaps.get(span, 0.0) + (ts - prev_end) / steps
        prev_end = max(prev_end, end)
    if t.t1 > prev_end:
        gaps["window end"] = (t.t1 - prev_end) / steps

    def top_of(d):
        return dict(sorted(((k[:120], v) for k, v in d.items()),
                           key=lambda kv: -kv[1])[:top])

    return {"steps": steps, "wall_us": t.window_s * 1e6 / steps,
            "busy_us": t.busy_s() * 1e6 / steps,
            "device_us": t.device_s() * 1e6 / steps,
            "in_program_spans_us": inner_us,
            "coverage": stage_us / inner_us if inner_us else None,
            "by_span": dict(sorted(per_span.items(), key=lambda kv: -kv[1])),
            "kernels_by_span": {k: top_of(v) for k, v in kernels.items()},
            "outside_stage_spans": top_of(uncovered),
            "outside_program_spans": top_of(outside),
            "idle_gaps": top_of(gaps)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    from perfbench import run, trace
    from perfbench.spec import Spec

    root = Path.cwd().resolve()
    captures = []
    capture = trace.capture

    def keeping(fn, device, host=True):
        captures.append(capture(fn, device, host=host))
        return captures[-1]

    trace.capture = keeping
    try:
        result = run.run_cell(root, args.workload, args.seed, 0.0,
                              trace=True, device=args.device,
                              log=lambda *a: None)
    finally:
        trace.capture = capture
    table = stage_table(captures[-1], run.ATTRIBUTION_STEPS)
    # the same capture's sort by kernel name, as `sort_us.project` reads it
    patterns = Spec(root).reader("sort_us.project").PATTERNS
    table["sort_by_kernel_name_us"] = captures[-1].device_s(patterns) \
        * 1e6 / run.ATTRIBUTION_STEPS
    table["correct"] = result["correct"]
    table["metrics"] = {k: v["value"] for k, v in result["metrics"].items()}
    table["device"] = result["device"]
    print(json.dumps(table), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
