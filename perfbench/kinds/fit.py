"""`fit`: a reconstruction loop, closed, with its steps dispatched ahead.

A step rasterises the pool's next pose batch, takes
mean((pred - target)^2), asks autograd for the gradients the traffic
names (`grads`: any of points, rotation, translation, point_weight) and
moves the points by SGD (`lr`); nothing is read back to the host.  The
targets are the reference's render of the truth cloud, made at set-up.
Planted faults: "unchanged" (the step leaves the points as they were),
"half_batch" (half of the poses left out, the mean taken over the rest).

The numbers that judge it (the training rule): the set-up drove the fit
object through its first CHECKED_STEPS steps by the window's own call, on
distinct pose batches where the pool has them; the reference follows
them from the same start in float64.
- out_err: the first step's prediction against the reference's forward,
  as project's out_err.
- loss_gap: the largest |loss - loss_ref| / |loss_ref| over the steps.
- grad_gap: the first step's worst leaf, |norm(g) - norm(g_ref)| as a
  share of the larger of the leaf's reference norm and the median leaf's;
  the points gradient worked out from the state, as the optimizer applied
  it ((p0 - p1) / lr).  A leaf whose reference norm is under a thousandth
  of the median leaf's is left out.  Later steps' gradients are not
  compared: the gradient jumps where a point crosses a voxel's edge, and
  the two paths' points part by rounding after the first update.
- grad_err: the same share for the norm of the difference, norm(g - g_ref),
  of the gradients the first step returned: a number that separates the
  lower precisions of the pullback, which move norms little.
- change_gap: |norm(p_k - p0) - norm(p_k_ref - p0)| / norm(p_k_ref - p0)
  after the checked steps.
"""

from __future__ import annotations

import math
import statistics

import torch

from perfbench import inputs as inputs_mod
from perfbench.loops import Loop as _Base

F64 = torch.float64
# the first steps, which the reference follows
CHECKED_STEPS = 3


class Loop(_Base):
    kind = "fit"
    step_times = True
    host_probe_steps = 16

    def __init__(self, raster, config, traffic, inputs, device, reference,
                 fault=None, backend="auto"):
        super().__init__(raster, config, traffic, inputs, device, reference,
                         fault, backend)
        self.targets = None
        self.points = inputs.points.clone().requires_grad_(True)
        self.rot = [r.clone().requires_grad_(True) for r in self.rot]
        self.tr = [t.clone().requires_grad_(True) for t in self.tr]
        self.asked = traffic["grads"]
        if "point_weight" in self.asked:
            self.weights["point_weight"] = \
                inputs.point_weight.clone().requires_grad_(True)
        # the mean's gradient times the voxels of a pose: `lr` moves the
        # points by the gradient of each pose's sum of squared errors,
        # averaged over the batch's poses
        self.lr = traffic["lr"] * math.prod(self.grid)
        self.checked = []
        self.keep_pred = False

    def _leaves(self, b):
        leaf = {"points": self.points, "rotation": self.rot[b],
                "translation": self.tr[b],
                "point_weight": self.weights.get("point_weight")}
        return [leaf[name] for name in self.asked]

    def step(self, i, b):
        rot, tr, target = self.rot[b], self.tr[b], self.targets[b]
        if self.fault == "half_batch":
            keep = rot.shape[0] // 2
            rot, tr, target = rot[:keep], tr[:keep], target[:keep]
        pred = self._timed("raster", lambda: self.raster(
            self.grid, self.points, rot, tr, backend=self.backend,
            **self.weights))
        loss = torch.mean((pred - target) ** 2)
        if self.keep_pred:
            # the first step's prediction waits on the host for the check
            self.pred0 = self.excluded(
                lambda: pred.detach().to("cpu", copy=True))
            self.keep_pred = False
        del pred
        grads = self._timed("grad", lambda: torch.autograd.grad(
            loss, self._leaves(b)))
        self.last_loss = loss.detach()
        if self.fault != "unchanged":
            with torch.no_grad():
                self.points.add_(grads[self.asked.index("points")],
                                 alpha=-self.lr)
        return loss, grads

    def setup(self):
        """The targets, the first steps, which the check follows, then the
        rest of the warm-up; the same object goes on into the window."""
        self.targets = self.excluded(lambda: inputs_mod.targets(
            self.config, self.inputs, self.reference))
        self.mark("targets")
        self.p0 = self.points.detach().clone()
        self.keep_pred = True
        for i in range(CHECKED_STEPS):
            loss, grads = self.step(i, i % self.calls)
            self.checked.append((i % self.calls, loss.detach(),
                                 [g.detach() for g in grads]))
            if i == 0:
                self.p1 = self.points.detach().clone()
                self.mark("first_step")
        self.pk = self.points.detach().clone()
        self.mark("checked_steps")
        moved = (self.pk - self.p0).abs()
        self.moved = (float(moved.pow(2).mean().sqrt()) / CHECKED_STEPS,
                      float(moved.max()))
        self.next = CHECKED_STEPS
        self.run(self.warmup_steps(CHECKED_STEPS) - CHECKED_STEPS)
        self.window_batches = []
        self.mark("warmup")

    def report(self, log):
        log(f"loss: first step {float(self.checked[0][1])!r}, last step "
            f"{float(self.last_loss)!r}; a point's move a step: rms "
            f"{self.moved[0]!r}, largest in the checked steps "
            f"{self.moved[1]!r}")


def _norm(t):
    return float(torch.linalg.vector_norm(t.to(F64)))


def numbers(loop, reference, dtype=F64, detail=None) -> dict:
    """`detail`, where given, gets the first step's leaves' (norm,
    reference norm, norm of the difference)."""
    grid = loop.grid
    dev = loop.p0.device
    weights = loop.ref_weights
    b, loss, grads = loop.checked[0]
    rot, tr = loop.rot[b].detach(), loop.tr[b].detach()
    pred0 = loop.pred0.to(dev)
    out_err = math.inf if pred0.shape[0] != rot.shape[0] else \
        reference.forward_error(grid, pred0, loop.p0, rot, tr, dtype=dtype,
                                weights=weights)
    # the first step, on the same inputs as the program's
    ref = reference.fit_step(grid, loop.p0.to(dtype), rot, tr,
                             loop.targets[b], dtype=dtype, weights=weights)
    ref_leaf = {"points": ref.d_points, "rotation": ref.d_rotation,
                "translation": ref.d_translation,
                "point_weight": ref.d_point_weight}
    returned = dict(zip(loop.asked, grads))
    applied = dict(returned)
    if "points" in applied:
        applied["points"] = (loop.p0.to(F64) - loop.p1.to(F64)) / loop.lr
    norms = {n: _norm(ref_leaf[n]) for n in returned}
    median = statistics.median(norms.values())
    grad_gap = grad_err = 0.0
    for name, g in returned.items():
        if norms[name] < 1e-3 * median:
            continue
        scale = max(norms[name], median)
        diff = _norm(g.to(F64) - ref_leaf[name].to(F64))
        grad_gap = max(grad_gap, abs(_norm(applied[name]) - norms[name])
                       / scale)
        grad_err = max(grad_err, diff / scale)
        if detail is not None:
            detail[name] = (_norm(applied[name]), norms[name], diff)
    # the loss of every checked step, the reference on its own path
    p = loop.p0.to(dtype)
    loss_gap = 0.0
    for k, (b, loss, _) in enumerate(loop.checked):
        if k:
            ref = reference.fit_step(grid, p, loop.rot[b].detach(),
                                     loop.tr[b].detach(), loop.targets[b],
                                     dtype=dtype, weights=weights)
        loss_gap = max(loss_gap, abs(float(loss) - ref.loss) / abs(ref.loss))
        p = p - loop.lr * ref.d_points
    moved_ref = _norm(p.to(F64) - loop.p0.to(F64))
    moved = _norm(loop.pk.to(F64) - loop.p0.to(F64))
    change_gap = abs(moved - moved_ref) / moved_ref if moved_ref else \
        math.inf
    return {"out_err": out_err, "loss_gap": loss_gap, "grad_gap": grad_gap,
            "grad_err": grad_err, "change_gap": change_gap}
