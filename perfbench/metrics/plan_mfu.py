"""The plan step's matmul FLOPs (``roofline.plan_flops``) over its time
and the dense peak of ``compute_dtype``, %."""

from perfbench import roofline
from perfbench.metrics._common import mfu


def read(ctx):
    return mfu(ctx, roofline.plan_flops(ctx.fields, ctx.shapes["bs"]))
