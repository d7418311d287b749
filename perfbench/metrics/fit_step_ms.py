"""fit_step_ms: the window's wall time on the host's clock, from the first
step enqueued to the final synchronize, over the steps completed."""


def read(ctx):
    if ctx.kind != "fit" or not ctx.window["count"]:
        return None
    return ctx.window["wall_s"] * 1e3 / ctx.window["count"]
