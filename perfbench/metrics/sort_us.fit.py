"""sort_us.fit: device microseconds a step launched inside the program's
`dprast.sort` spans (the stable `torch.sort` of the binning frame or of
the `xla` path's keys: CUB's radix sort, its index fill and its
post-processing), in the attributing capture of a traced fit run
(`perfbench/spans.py`); left out where the program emits no span."""

from perfbench import spans


def read(ctx):
    return spans.fit_step_us(ctx, ("dprast.sort",))
