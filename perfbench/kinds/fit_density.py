"""`fit_density`: `fit`'s loop with the per-point weights' gradient among
the asked leaves (a density fit), judged by `fit`'s numbers and one more.

`fit`'s grad_gap and grad_err scale each leaf by the larger of its own
reference norm and the median leaf's.  The weights' gradient is two
orders smaller than the points' and the poses' at 1024^2, so under that
scale a wrong, halved or zero `d_point_weight` with a right forward reads
no more than a few thousandths.  Hence, besides `fit`'s numbers:
- pw_err: the first step's ||d_pw - d_pw_ref|| / ||d_pw_ref||, the
  weights' gradient against its own reference norm.
The loop is `fit`'s as it is: the points alone move.
"""

from __future__ import annotations

import math

import torch

from perfbench.kinds import fit

F64 = torch.float64
Loop = fit.Loop


class _FirstStep:
    """The reference, keeping the first `fit_step` it computes: the first
    step's, on the program's inputs, in `fit.numbers`."""

    def __init__(self, reference):
        self._reference = reference
        self.first = None

    def __getattr__(self, name):
        return getattr(self._reference, name)

    def fit_step(self, *args, **kwargs):
        out = self._reference.fit_step(*args, **kwargs)
        if self.first is None:
            self.first = out
        return out


def numbers(loop, reference, dtype=F64, detail=None) -> dict:
    kept = _FirstStep(reference)
    out = fit.numbers(loop, kept, dtype=dtype, detail=detail)
    grads = loop.checked[0][2]
    g = grads[loop.asked.index("point_weight")].to(F64)
    ref = kept.first.d_point_weight.to(F64)
    ref_norm = float(torch.linalg.vector_norm(ref))
    diff = float(torch.linalg.vector_norm(g - ref))
    out["pw_err"] = diff / ref_norm if ref_norm else math.inf
    return out
