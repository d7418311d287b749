"""launches_per_call.project: the device operations (kernels, copies,
memsets) launched in the device's own capture of a traced
run, over its calls."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "project" \
            or not ctx.trace.launches():
        return None
    return ctx.trace.launches() / ctx.window["count"]
