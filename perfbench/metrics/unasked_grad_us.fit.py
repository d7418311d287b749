"""unasked_grad_us.fit: device microseconds a step launched inside the
program's `dprast.grad.<input>` spans, the gradients that have work of
their own (the background's sum of the cotangent, the `xla` path's
out_weight and point_weight contractions), of the inputs that the
traffic's `grads` leave out: work of the autograd layer whose result
nobody reads.  From the attributing capture of a traced fit run
(`perfbench/spans.py`); 0.0 where the program's spans ran and none of
these did, left out where the program emits no span."""

from perfbench import spans

INPUTS = ("points", "rotation", "translation", "background", "out_weight",
          "point_weight")


def read(ctx):
    asked = set(ctx.traffic.get("grads", ()))
    return spans.fit_step_us(ctx, (f"dprast.grad.{name}" for name in INPUTS
                                   if name not in asked))
