"""Run one cell of `BENCHMARK.json` on the card and print its result.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up makes the inputs on the device from
the seed, has the reference render the fit's targets, drives the loop
through its first steps and warms up every shape the cell uses; then the
window runs for `--seconds` (`--trace 0`: the end-to-end metrics), or a
fixed number of steps runs under the profiler (`--trace 1`: the per-layer
metrics).  `setup_s` leaves out the seconds of the benchmark's own work in
set-up (the reference's targets, the copy of a prediction for the check);
standard error gives the set-up's phases.  Once the window has closed and the peak memory is read, the
plain reference judges what the window's path produced.  The last line of
standard output is one JSON object; the last lines of standard error are
the numbers compared, each beside its limit.

Exits 3 without a result where there is no CUDA card (or fewer than the
cell asks for), 4 where the process holds JAX or the JAX package once
the window has closed, and 5 where the program is not the checkout's own.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()
# set-up's phases before a run starts: name -> seconds from the start
_PHASES = {}

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "dprast")
PROGRAM = "dprast_torch"
# a traced run: the device's capture of TRACE_STEPS steps, then the
# attributing capture (with the host's ranges) of ATTRIBUTION_STEPS more
TRACE_STEPS = 64
ATTRIBUTION_STEPS = 32


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def program_raster(root: Path):
    """The checkout's own `dprast_torch.raster`."""
    import dprast_torch

    origin = Path(os.path.abspath(dprast_torch.__file__))
    if root not in origin.parents:
        raise ImportError(f"{PROGRAM} comes from {origin}, not from the "
                          f"checkout at {root}")
    return dprast_torch.raster


def _device_info(device, count, peak):
    import torch

    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": count, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(peak)}


def judge(numbers: dict, limits: dict):
    """-> (correct, checks): each number that the loop's `numbers` gives
    (`kinds/<loop>.py`) with its limit from the cell's file under
    `cells/` (None where it sets none, and then it is shown but not
    compared)."""
    checks, correct = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is not None and not (math.isfinite(value)
                                      and value <= limit):
            correct = False
    return correct, checks


def run_cell(root, workload, seed, seconds, trace=False, device="cuda",
             raster=None, fault=None, backend="auto", log=None,
             setup_only=False, detail=None):
    """One run of a cell -> its result (a dict, `checks` last).  `raster`,
    `fault` and `backend` put another path in the program's place (the
    control and the planted faults of `perfbench.calibrate`);
    `setup_only` skips the window (a fit's readings need none); `detail`,
    a dict, gets the check's readings leaf by leaf."""
    import torch

    from perfbench import inputs
    from perfbench import trace as trace_mod
    from perfbench.spec import Spec

    log = log or (lambda *a: print(*a, file=sys.stderr))
    phases = dict(_PHASES, imports=time.perf_counter() - _T0)
    root = Path(root).resolve()
    spec = Spec(root)
    cell = spec.workload(workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    kind = spec.kind(traffic["loop"])
    limits = spec.cell_file(workload).get("limits", {})
    reference = spec.reference(config)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.init()
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.empty(1, device=device)
    phases["card"] = time.perf_counter() - _T0
    if raster is None:
        raster = program_raster(root)
    phases["program"] = time.perf_counter() - _T0

    data = inputs.make(config, traffic, seed, device)
    loop = kind.Loop(raster, config, traffic, data, device, reference,
                     fault=fault, backend=backend)
    loop.sync()
    phases["inputs"] = time.perf_counter() - _T0
    loop.setup()
    loop.sync()
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    phases["setup"] = time.perf_counter() - _T0
    setup_s = phases["setup"] - loop.excluded_s
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    host_spans, traced, attributed, trace_points = {}, None, None, None
    if setup_only:
        window = {"wall_s": 0.0, "count": 0, "step_ms": None}
    elif trace:
        if loop.host_probe_steps:
            host_spans = loop.host_probe(loop.host_probe_steps)
        loop.begin()
        loop.window_batches = []
        count = TRACE_STEPS
        traced = trace_mod.capture(lambda: loop.run(count), device,
                                   host=not cuda)
        window = {"wall_s": traced.window_s, "count": count,
                  "step_ms": None}
        # the attributing capture, with the host's ranges
        trace_points = loop.points.detach().clone()
        loop.window_batches = []
        loop.annotate = True
        attributed = trace_mod.capture(
            lambda: loop.run(ATTRIBUTION_STEPS), device)
        loop.annotate = False
    else:
        loop.begin()
        window = loop.window(seconds)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    numbers = kind.numbers(loop, reference, detail=detail)
    correct, checks = judge(numbers, limits)

    ctx = SimpleNamespace(
        kind=loop.kind, workload=workload, config=config, traffic=traffic,
        window=window, window_peak=window_peak, setup_s=setup_s,
        trace=traced, attributed=attributed, host_spans=host_spans,
        loop=loop, reference=reference, trace_points=trace_points,
        batches=list(loop.window_batches), device=device)
    metrics = {}
    for entry in spec.metrics(workload, per_layer=bool(trace)):
        value = spec.reader(entry["name"]).read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    info = _device_info(device, cell.get("chips", 1),
                        max(setup_peak, window_peak))
    if traced is not None:
        info["busy_s"] = traced.busy_s()
        info["window_s"] = traced.window_s
    result = {"correct": correct, "attempted": window["count"],
              "failed": 0 if correct else 1, "metrics": metrics,
              "device": info}
    if traced is not None:
        result["breakdown"] = {"device_ops": traced.by_name(10),
                               "idle_gaps": traced.idle_gaps(10)}
    result["checks"] = checks
    loop.report(log)
    log(f"window: {window['count']} steps in {window['wall_s']!r} s; "
        f"set-up {setup_s!r} s, leaving out {loop.excluded_s!r} s of the "
        f"benchmark's own; phases (s from the start): "
        + json.dumps(phases) + "; inside set-up: " + json.dumps(
            {k: v - _T0 for k, v in loop.marks.items()}))
    if attributed is not None:
        log("device seconds by the host range that launched them, "
            f"{ATTRIBUTION_STEPS} steps, innermost: "
            + json.dumps(attributed.by_range()))
        log("outermost: " + json.dumps(attributed.by_range(outer=True)))
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = Path.cwd().resolve()
    # every build and kernel cache inside the checkout, at fixed paths; the
    # bytecode of every module too, so that only the first run compiles
    # torch's sources, also where the environment asks Python to write
    # no bytecode beside them
    build = root / "build"
    sys.pycache_prefix = str(build / "pycache")
    sys.dont_write_bytecode = False
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")

    import torch

    _PHASES["torch"] = time.perf_counter() - _T0
    from perfbench.spec import Spec

    try:
        chips = Spec(root).workload(args.workload).get("chips", 1)
    except (OSError, KeyError, ValueError) as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 3
    try:
        result = run_cell(root, args.workload, args.seed, args.seconds,
                          trace=bool(args.trace), device="cuda")
    except ImportError as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 5
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process holds {', '.join(found)}; the "
              f"benchmark runs no JAX", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
