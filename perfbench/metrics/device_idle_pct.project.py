"""device_idle_pct.project: 100 x (1 - the union of the device operations'
intervals / the window) in the device's own capture of a traced run, whose
window runs from the first launch to the end of the last operation."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "project" or not ctx.trace.launches():
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
