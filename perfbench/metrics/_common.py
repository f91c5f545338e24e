"""What several readers share."""

from __future__ import annotations


def launches_per_step(ctx):
    """Device operations (kernels, copies, sets) of the window a step."""
    if not ctx.kernels or not ctx.steps:
        return None
    return len(ctx.kernels) / ctx.steps


def idle_share(ctx):
    """1 - the union of the traced device operations' intervals over the
    traced window's wall time, %.  The profiler slows the host, not the
    device, so this reads above the untraced run's idle share; the run
    prints the traced and the untraced step time beside it."""
    if not ctx.kernels or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)


def mfu(ctx, flops):
    """``flops`` a step over the untraced step time times the dense peak
    of the configuration's matmul precision, %."""
    from perfbench import roofline
    if not ctx.kernels or ctx.step_s <= 0:
        return None
    return 100.0 * flops / (ctx.step_s * roofline.matmul_peak(ctx.fields))


def roofline_share(ctx, fragment, bound_s):
    """A kernel's bound over its mean device time a launch, %: the launches
    whose name holds ``fragment``."""
    durs = [d for name, _, d in ctx.kernels if fragment in name]
    if not durs:
        return None
    return 100.0 * bound_s / (sum(durs) / len(durs) * 1e-6)
