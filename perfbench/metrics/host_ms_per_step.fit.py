"""host_ms_per_step.fit: the host's milliseconds a step inside the
benchmark's own spans around `raster` and `torch.autograd.grad`, over the
steps of the host probe, which runs each step after a synchronize so that
no launch waits for a full queue (without it a dispatched-ahead loop's
spans read the device's pace, not the host's work)."""


def read(ctx):
    spans = ctx.host_spans
    if ctx.kind != "fit" or not spans.get("raster"):
        return None
    total = sum(sum(v) for v in spans.values())
    return total * 1e3 / len(spans["raster"])
