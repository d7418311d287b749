"""What every loop shares: steps dispatched ahead, the measured window,
the host probe and the warm-up.  A traffic file names its loop by
`loop`, and the loop's own file, `kinds/<loop>.py` under the benchmark's
paths, holds the loop (`Loop`, a subclass of `Loop` here) and the numbers
that judge it (`numbers`); a new kind of loop is a new file.

A loop takes the program's `raster` as an argument, so that a planted
fault or the reference put in the program's place runs through the same
loop (`perfbench.calibrate`, the tests); `fault` names a fault planted
around the program's call, and `backend` another of its backends.
"""

from __future__ import annotations

import contextlib
import time

import torch

from perfbench import inputs as inputs_mod

# warm-up: this many passes over the pool's pose batches, and no fewer
# steps than MIN_WARMUP_STEPS
WARMUP_CYCLES = 2
MIN_WARMUP_STEPS = 8

# CUDA events are made this many at a time, outside the steps they time
_EVENT_CHUNK = 4096


class Loop:
    kind = ""
    step_times = False     # a CUDA event at each step's start in the window
    host_probe_steps = 0   # steps of the host probe in a traced run

    def __init__(self, raster, config, traffic, inputs, device, reference,
                 fault=None, backend="auto"):
        self.raster = raster
        self.config, self.traffic, self.inputs = config, traffic, inputs
        self.reference = reference
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.fault = fault
        self.backend = backend
        # the weights `raster` is given, and the same for the reference
        self.weights = inputs_mod.weights(config, inputs)
        self.ref_weights = reference.Weights(**self.weights)
        # set-up seconds spent on the benchmark's own work (the
        # reference's targets, copies for the check), not the program's
        self.excluded_s = 0.0
        self.marks = {}        # set-up's phases: name -> the host's clock
        self.grid = tuple(config["grid"])
        self.calls = inputs.rotation.shape[0]
        self.rot = [r for r in inputs.rotation]
        self.tr = [t for t in inputs.translation]
        self.next = 0          # the index of the next step
        self.spans = None      # host spans (name -> [seconds]) when kept
        self.annotate = False  # record_function ranges for the trace
        self.window_batches = []

    # -- one step -----------------------------------------------------------
    def _range(self, name):
        if self.annotate:
            return torch.profiler.record_function(f"perfbench.{name}")
        return contextlib.nullcontext()

    def _timed(self, name, fn):
        if self.spans is None:
            with self._range(name):
                return fn()
        t = time.perf_counter()
        with self._range(name):
            out = fn()
        self.spans.setdefault(name, []).append(time.perf_counter() - t)
        return out

    def step(self, i, b):
        raise NotImplementedError

    def begin(self):
        """Called just before the measured or traced window."""

    def report(self, log):
        """Lines on standard error once the run is judged."""

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def mark(self, name):
        self.sync()
        self.marks[name] = time.perf_counter()

    def excluded(self, fn):
        """fn(), its seconds (synchronised) kept out of `setup_s`."""
        self.sync()
        t = time.perf_counter()
        out = fn()
        self.sync()
        self.excluded_s += time.perf_counter() - t
        return out

    def warmup_steps(self, first):
        return max(first, MIN_WARMUP_STEPS, WARMUP_CYCLES * self.calls)

    def run(self, count):
        """`count` steps, dispatched ahead, from `self.next` on."""
        for i in range(self.next, self.next + count):
            self.window_batches.append(i % self.calls)
            self.step(i, i % self.calls)
        self.next += count

    # -- the measured window ------------------------------------------------
    def window(self, seconds):
        """Steps dispatched ahead until `seconds` have passed on the host's
        clock, then one synchronize.  -> dict(wall_s, count, step_ms)."""
        step_times = self.step_times
        events, host_marks = [], []

        def mark(k):
            # a CUDA event on the stream at the start of step k (no host
            # sync); on the CPU the host's clock
            if not step_times:
                return
            if not self.cuda:
                host_marks.append(time.perf_counter())
                return
            if k >= len(events):
                events.extend(torch.cuda.Event(enable_timing=True)
                              for _ in range(_EVENT_CHUNK))
            events[k].record()

        if step_times and self.cuda:
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(_EVENT_CHUNK)]
        self.sync()
        i = self.next
        t0 = time.perf_counter()
        while True:
            mark(i - self.next)
            self.window_batches.append(i % self.calls)
            self.step(i, i % self.calls)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        count = i - self.next
        mark(count)
        self.sync()
        wall = time.perf_counter() - t0
        step_ms = None
        if step_times and self.cuda:
            step_ms = [events[k].elapsed_time(events[k + 1])
                       for k in range(count)]
        elif step_times:
            step_ms = [(host_marks[k + 1] - host_marks[k]) * 1e3
                       for k in range(count)]
        self.next = i
        return {"wall_s": wall, "count": count, "step_ms": step_ms}

    def host_probe(self, count):
        """`count` steps, each after a synchronize, with the host's time in
        each span -> {span: [seconds]}: what the host spends to enqueue a
        step when nothing is queued ahead of it."""
        self.spans = {}
        for i in range(self.next, self.next + count):
            self.sync()
            self.step(i, i % self.calls)
        self.sync()
        self.next += count
        spans, self.spans = self.spans, None
        return spans

