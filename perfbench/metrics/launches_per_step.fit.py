"""launches_per_step.fit: the device operations (kernels, copies, memsets)
launched in the device's own capture of a traced
run, over its steps."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "fit" or not ctx.trace.launches():
        return None
    return ctx.trace.launches() / ctx.window["count"]
