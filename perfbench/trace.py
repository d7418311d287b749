"""The device trace of a window, from `torch.profiler`, reduced to what
the per-layer metrics read.

Two captures serve a traced run.  The device's own (CUDA activity alone)
costs the host little, so its idle share is the loop's: its window runs
from the first launch to the end of the last device operation.  The
attributing one (CPU and CUDA) records the host's ranges, which slow the
host: it runs inside a `perfbench.window` range that ends after a
synchronize, and a device operation (kernel, copy or memset) belongs to a
host range (the benchmark's own `perfbench.raster`, or autograd's
`_RasterBackward`) when the call that launched it lies inside that range
on the same thread, found through the trace's correlation ids.  The
Chrome trace is written under the run's TMPDIR and read back.
"""

from __future__ import annotations

import bisect
import json
import tempfile
import warnings
from pathlib import Path

import torch

WINDOW = "perfbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation")


def capture(fn, device, host=True):
    """Run `fn()` under the profiler, with a synchronize at its end, inside
    the window's range where `host` records the host's ranges -> `Trace`."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    activities = []
    if host or not cuda:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW):
                fn()
                if cuda:
                    torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return Trace(events)


class Trace:
    def __init__(self, events):
        self.host = []      # (tid, ts, end, name)
        launches = {}       # correlation -> (tid, ts)
        device = []         # (ts, end, name, correlation)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in _DEVICE_CATS:
                device.append((ts, ts + dur, e.get("name", ""), corr))
            elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launches[corr] = (e.get("tid"), ts)
            elif cat in _HOST_CATS:
                self.host.append((e.get("tid"), ts, ts + dur,
                                  e.get("name", "")))
        self._by_tid = {}
        for tid, ts, end, name in sorted(self.host, key=lambda h: h[1]):
            if name != WINDOW:
                self._by_tid.setdefault(tid, []).append((ts, end, name))
        windows = [h for h in self.host if h[3] == WINDOW]
        if windows:
            _, self.t0, self.t1, _ = windows[0]
        elif device:
            # the device's own capture: from the first launch to the end of
            # the last operation
            starts = [launches[c][1] for _, _, _, c in device
                      if c in launches] or [d[0] for d in device]
            self.t0 = min(starts)
            self.t1 = max(d[1] for d in device)
        else:
            self.t0 = self.t1 = 0.0
        self.window_s = (self.t1 - self.t0) * 1e-6
        # the device operations launched inside the window
        self.ops = []
        for ts, end, name, corr in device:
            launch = launches.get(corr)
            at = launch[1] if launch else ts
            if self.t0 <= at <= self.t1:
                self.ops.append((ts, end, name, launch))
        self.ops.sort()

    # -- the whole window ---------------------------------------------------
    def launches(self) -> int:
        return len(self.ops)

    def busy_s(self) -> float:
        """The union of the operations' intervals, clipped to the window."""
        busy, cur0, cur1 = 0.0, None, None
        for ts, end, _, _ in self.ops:
            ts, end = max(ts, self.t0), min(end, self.t1)
            if end <= ts:
                continue
            if cur1 is None or ts > cur1:
                if cur1 is not None:
                    busy += cur1 - cur0
                cur0, cur1 = ts, end
            else:
                cur1 = max(cur1, end)
        if cur1 is not None:
            busy += cur1 - cur0
        return busy * 1e-6

    def device_s(self, patterns=None) -> float:
        """The operations' summed time, of those whose name holds one of
        `patterns` (all where None)."""
        return sum(end - ts for ts, end, name, _ in self.ops
                   if patterns is None or any(p in name for p in patterns)
                   ) * 1e-6

    def by_name(self, top=10):
        totals = {}
        for ts, end, name, _ in self.ops:
            totals[name] = totals.get(name, 0.0) + (end - ts) * 1e-6
        return sorted(([n[:200], s] for n, s in totals.items()),
                      key=lambda x: -x[1])[:top]

    # -- host ranges --------------------------------------------------------
    def ranges(self, names):
        """The host ranges inside the window whose name is one of `names`."""
        return [h for h in self.host if h[3] in names
                and self.t0 <= h[1] <= self.t1]

    def device_s_in(self, ranges) -> float:
        """The summed time of the operations launched inside `ranges`, each
        on the range's own thread."""
        by_tid = {}
        for tid, ts, end, _ in ranges:
            by_tid.setdefault(tid, []).append((ts, end))
        for spans in by_tid.values():
            spans.sort()
        total = 0.0
        for ts, end, _, launch in self.ops:
            if launch is None or launch[0] not in by_tid:
                continue
            spans = by_tid[launch[0]]
            k = bisect.bisect_right(spans, (launch[1], float("inf"))) - 1
            if k >= 0 and spans[k][0] <= launch[1] <= spans[k][1]:
                total += end - ts
        return total * 1e-6

    def idle_gaps(self, top=10, named=200):
        """The device's idle gaps in the window, summed by the innermost
        host range that launched the operation which ended each gap (what
        the host was doing while the device waited), or in the device's
        own capture by the operation that followed; the `named` longest
        gaps are named, the rest summed as "other gaps"."""
        found, prev_end = [], self.t0
        for ts, end, name, launch in self.ops:
            if ts > prev_end:
                found.append(((ts - prev_end) * 1e-6, launch, name))
            prev_end = max(prev_end, end)
        found.sort(key=lambda g: -g[0])
        gaps = {}
        for k, (seconds, launch, nxt) in enumerate(found):
            if k >= named:
                name = "other gaps"
            elif not self.host:
                name = "before " + nxt[:120]
            else:
                name = self._host_at(launch) if launch else "unknown"
            gaps[name] = gaps.get(name, 0.0) + seconds
        if self.t1 > prev_end:
            gaps["window end"] = gaps.get("window end", 0.0) \
                + (self.t1 - prev_end) * 1e-6
        return sorted(([n[:200], s] for n, s in gaps.items()),
                      key=lambda x: -x[1])[:top]

    def _host_at(self, launch):
        """The innermost host range that holds the launch `(tid, at)`."""
        tid, at = launch
        spans = self._by_tid.get(tid, [])
        # ranges nest: the latest-starting range before `at` that still
        # holds it is the innermost
        k = bisect.bisect_right(spans, (at, float("inf"), "")) - 1
        while k >= 0:
            ts, end, name = spans[k]
            if end >= at:
                return name
            k -= 1
        return "host"

    def _outer_at(self, launch):
        """The outermost host range that holds the launch `(tid, at)`."""
        tid, at = launch
        for ts, end, name in self._by_tid.get(tid, []):
            if ts > at:
                break
            if end >= at:
                return name
        return "host"

    def by_range(self, top=12, outer=False):
        """Device time by the innermost (or outermost) host range that
        launched it."""
        totals = {}
        for ts, end, _, launch in self.ops:
            name = "unknown"
            if launch:
                name = self._outer_at(launch) if outer \
                    else self._host_at(launch)
            totals[name] = totals.get(name, 0.0) + (end - ts) * 1e-6
        return sorted(([n[:120], s] for n, s in totals.items()),
                      key=lambda x: -x[1])[:top]
