"""Kernel 1 (``guidance_fused_kernel``): its bound at the cell's shapes
(``roofline.guidance_bound_s``) over its mean device time a launch, %."""

from perfbench import roofline
from perfbench.metrics._common import roofline_share


def read(ctx):
    return roofline_share(ctx, "guidance_fused_kernel",
                          roofline.guidance_bound_s(ctx.fields,
                                                    ctx.shapes["bs"]))
