"""program_host_pct.fit: the share of a fit step's host time that the
program's own calls take, in the attributing capture of a traced fit run
(`perfbench/trace.py`).  The step's host time is the union of the
benchmark's ranges around `raster` and `torch.autograd.grad`
(`perfbench.raster`, `perfbench.grad`, on the caller's thread); the
program's is the union, over every thread, of its spans (`dprast.<...>`,
`perfbench/spans.py`) within those ranges: `dprast.normalise` and
`dprast.raster[...]` on the caller's thread, `dprast.pullback[...]` on
autograd's, which runs while the caller waits inside `perfbench.grad`.
Both are read on the host's one clock in the same capture, so the share
splits the same steps: the rest is autograd's engine, its handoffs
between threads and the loss's backward nodes, which a graph of the
program's calls alone would leave, and a graph of the whole step would
take away too.

Under the capture's CPU recording each recorded range costs about 8 µs
(PERF.md §5), inside and outside the program alike, so the share
compares one version of the program with another and is not the
unprofiled host's.  Left out (None) where the capture holds no device
operation or the program emits no span."""

from perfbench import spans

STEP = ("perfbench.raster", "perfbench.grad")


def merged(intervals):
    """`intervals` ((start, end)) -> their union as sorted, disjoint
    (start, end)."""
    out = []
    for ts, end in sorted(intervals):
        if out and ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([ts, end])
    return out


def overlap(a, b) -> float:
    """The length of the intersection of two unions from `merged`."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def share(t):
    """The program's share, in %, of the step's host time in the capture
    `t` (a `perfbench.trace.Trace`); None where it holds no step range."""
    inside = [h for h in t.host if t.t0 <= h[1] <= t.t1]
    step = merged((ts, min(end, t.t1)) for _, ts, end, name in inside
                  if name in STEP)
    length = sum(end - ts for ts, end in step)
    if not length:
        return None
    program = merged((ts, min(end, t.t1)) for _, ts, end, name in inside
                     if name.startswith(spans.PREFIX))
    return 100.0 * overlap(program, step) / length


def read(ctx):
    t = ctx.attributed
    if t is None or ctx.kind != "fit" or not t.launches() \
            or not spans.has_program_spans(t):
        return None
    return share(t)
