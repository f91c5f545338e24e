"""Named spans at the layer boundaries of the closed-loop step.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler runs and a shared do-nothing context otherwise, so the spans are
on exactly when a ``torch.profiler`` session is (an operator's, or a
benchmark's traced window) and cost one flag read a site when none is.  A
``record_function`` range is stamped on the profiler's own clock, the
clock its device events are aligned to, so a chrome trace shows each
step's spans over the kernels they launched, and a reader can put every
device operation down to the span open at its host launch call
(``args.correlation``).

Spans sit at layer boundaries and never around single kernels.  They stay
on the host side of any region a CUDA graph may capture: inside one, a
span (like a Python launch counter) is recorded at capture only.
"""

from __future__ import annotations

import contextlib

import torch

#: every span the program opens, with what it covers
SPANS = (
    "sim.step",       # one replanning step: observe, plan, backup, env step
    "sim.observe",    # the observation around the simulated poses
    "sim.plan",       # the planner; self: stlp override, states, keep mask
    "plan.prep",      # densify, scorer, encoder and tiling, guidance loss
    "plan.sample",    # the sampler's chain: eps MLP, posterior, decodings
    "plan.guidance",  # one guided update: operands and kernel (or loop)
    "plan.score",     # one STL scorer call, wherever called
    "plan.select",    # multi-cands, RefineNet + rolls, refinement, argmax
    "sim.env",        # the backup controller, env step, carry update
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a span while a profiler runs."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
