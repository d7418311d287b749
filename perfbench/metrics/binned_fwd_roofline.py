"""binned_fwd_roofline: the forward's least time (`perfbench.work`: the
inputs read once, the B outputs written once, against 3.35 TB/s) over the
device time of the kernels launched inside the benchmark's `raster`
ranges in the attributing capture of a project window (`perfbench.trace`),
in percent."""

from perfbench import work


def read(ctx):
    return work.fwd_roofline_pct(ctx)
