"""step_workspace_gb: the device memory a step or call holds above what
stays allocated between steps, in 1e9 bytes: the caching allocator's
peak over a traced run's steps (`torch.cuda.max_memory_allocated`, reset
at their start) less what is allocated once they have ended (the inputs,
a fit's targets and state).  It is the program's workspace (frames, slot
tables, the pullback's partials), autograd's saved tensors and the loss's
temporaries: the part of `peak_mem_gb` that a step sets, not the
deployment's data.  On the card only."""

import torch


def read(ctx):
    if ctx.device.type != "cuda" or not ctx.window["count"]:
        return None
    torch.cuda.synchronize(ctx.device)
    held = torch.cuda.memory_allocated(ctx.device)
    return (ctx.window_peak - held) / 1e9
