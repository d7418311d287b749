"""fit_step_p95_ms: the 95th percentile (nearest rank) over every step of
the window of the time between the CUDA events recorded on the stream at
the step's start and the next step's (the last against an event after
it), with no host sync: a step that waits for a late host counts its
wait."""

import math


def read(ctx):
    times = ctx.window.get("step_ms")
    if ctx.kind != "fit" or not times:
        return None
    ordered = sorted(times)
    return ordered[math.ceil(0.95 * len(ordered)) - 1]
