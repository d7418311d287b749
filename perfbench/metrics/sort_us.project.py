"""sort_us.project: device microseconds a call in the kernels of the
stable sort (torch.sort's radix sort by CUB, its index fill and its
post-processing), by the name patterns below, in the device's own capture
of a traced project run."""

PATTERNS = ("RadixSort", "radix_sort", "sort_postprocess",
            "fill_index_and_segment", "fill_reverse_indices")


def read(ctx):
    if ctx.trace is None or ctx.kind != "project":
        return None
    seconds = ctx.trace.device_s(PATTERNS)
    if seconds <= 0:
        return None
    return seconds * 1e6 / ctx.window["count"]
