"""peak_mem_gb: torch.cuda.max_memory_allocated() over the window, after a
reset at its start, in 1e9 bytes."""


def read(ctx):
    if ctx.device.type != "cuda" or not ctx.window["count"]:
        return None
    return ctx.window_peak / 1e9
