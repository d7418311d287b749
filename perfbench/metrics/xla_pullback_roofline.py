"""xla_pullback_roofline: the pullback's least time (`perfbench.work`:
points and poses read once, the asked gradients written once, the
cotangent's touched 32-byte sectors read once, against 3.35 TB/s) over
the device time of the kernels launched inside autograd's backward of the
program's raster function in the attributing capture of a fit window
(`perfbench.trace`), in percent."""

from perfbench import work

# the autograd node of dprast_torch.ad._Raster / _RasterOnce in the trace
RANGES = ("_RasterBackward", "_RasterOnceBackward")


def read(ctx):
    return work.pullback_roofline_pct(ctx, RANGES)
