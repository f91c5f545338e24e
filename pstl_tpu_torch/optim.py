"""``optax.adam`` written out by hand, for the port's Python loops of Adam
steps on one tensor (``trajopt.optimize``, and the three loops of
``refine.py``).

The JAX package runs these loops as ``lax.scan``s of ``optax.adam``.  Here
the update is optax's ``scale_by_adam`` in its order of float32
operations, then the step size and ``apply_updates``: b1 0.9, b2 0.999,
eps 1e-8, eps_root 0.  The bias corrections ``1 - b ** count`` and the
step sizes ``-lr`` are float32 tables computed once on the host, so the
loop makes no host synchronisation.  ``torch.optim.Adam`` is not used: it
orders the bias correction otherwise and reads its step count on the
host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor

#: optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def bias_corrections(iters: int) -> Tuple[np.ndarray, np.ndarray]:
    """(1 - b1 ** count, 1 - b2 ** count) at counts 1..iters, float32 (optax
    counts from 1 in int32 and corrects in the moments' dtype)."""
    f32 = torch.float32
    k = torch.arange(1, iters + 1, dtype=f32)
    bc1 = 1 - torch.tensor(ADAM_B1, dtype=f32) ** k
    bc2 = 1 - torch.tensor(ADAM_B2, dtype=f32) ** k
    return bc1.numpy(), bc2.numpy()


class Adam:
    """The state of ``optax.adam(lr)`` over one tensor for ``iters`` steps.
    ``lr``: a constant, or the per-step learning rate (a schedule read at
    counts 0..iters-1), in float32.  ``update(p, g, i)`` returns the
    parameters after step ``i`` (0-based) with gradient ``g``; call it
    outside autograd (the loops take their gradient with
    ``torch.autograd.grad`` of a detached leaf)."""

    def __init__(self, like: Tensor, lr, iters: int):
        lr = np.broadcast_to(np.asarray(lr, np.float32), (iters,))
        self.step = -lr
        self.bc1, self.bc2 = bias_corrections(iters)
        self.mu = torch.zeros_like(like)
        self.nu = torch.zeros_like(like)

    def update(self, p: Tensor, g: Tensor, i: int) -> Tensor:
        # optax.scale_by_adam, then the step size and apply_updates
        self.mu = (1 - ADAM_B1) * g + ADAM_B1 * self.mu
        self.nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * self.nu
        u = (self.mu / float(self.bc1[i])) / (
            torch.sqrt(self.nu / float(self.bc2[i])) + ADAM_EPS)
        return p + float(self.step[i]) * u
