"""The RDT's FLOPs a step (its passes a step, counted by the program, times
``roofline.rdt.flops`` at the rows a pass) over the untraced step time and
the dense peak of ``compute_dtype``, %.  Nothing to read where the driver
counts no RDT pass."""

from perfbench.metrics._common import mfu
from perfbench.roofline import rdt


def read(ctx):
    s = ctx.shapes
    if not s.get("eps_calls"):
        return None
    return mfu(ctx, s["eps_calls"] * rdt.flops(s["eps_net"],
                                               int(s["eps_rows"]), s["nt"]))
