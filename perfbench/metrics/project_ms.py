"""project_ms: the window's wall time on the host's clock, from the first
call enqueued to the final synchronize, over the calls completed."""


def read(ctx):
    if ctx.kind != "project" or not ctx.window["count"]:
        return None
    return ctx.window["wall_s"] * 1e3 / ctx.window["count"]
