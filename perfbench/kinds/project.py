"""`project`: a forward projector, with its calls dispatched ahead.

Each call rasterises the pool's next pose batch with the points fixed.
Its output is dropped, but for the call drawn from the seed among the
window's first `inputs.SAMPLE_CALLS` and the last one, which the check
compares.  Planted fault: "altered" (one output value changed where it is
produced).

The number that judges it: out_err, the largest
|out - ref| / max(max |ref|, 1) over every voxel of those two calls.
"""

from __future__ import annotations

import torch

from perfbench.loops import Loop as _Base


class Loop(_Base):
    kind = "project"

    def __init__(self, raster, config, traffic, inputs, device, reference,
                 fault=None, backend="auto"):
        super().__init__(raster, config, traffic, inputs, device, reference,
                         fault, backend)
        self.points = inputs.points
        self.sample_at = None
        self.kept = {}

    def step(self, i, b):
        out = self._timed("raster", lambda: self.raster(
            self.grid, self.points, self.rot[b], self.tr[b],
            backend=self.backend, **self.weights))
        if self.fault == "altered":
            out.view(-1)[(i * 7919) % out.numel()] += 1.0
        if i == self.sample_at:
            self.kept["sample"] = (b, out)
        self.kept["last"] = (b, out)

    def setup(self):
        self.run(1)
        self.mark("first_call")
        self.run(self.warmup_steps(1) - 1)
        self.kept = {}
        self.window_batches = []
        self.mark("warmup")

    def begin(self):
        self.sample_at = self.next + self.inputs.sample


def numbers(loop, reference, dtype=torch.float64, detail=None) -> dict:
    worst = 0.0
    for b, out in loop.kept.values():
        worst = max(worst, reference.forward_error(
            loop.grid, out, loop.points, loop.rot[b], loop.tr[b],
            dtype=dtype, weights=loop.ref_weights))
    return {"out_err": worst}
