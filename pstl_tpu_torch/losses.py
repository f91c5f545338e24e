"""Training losses (port of ``pstl_tpu/losses.py``): the STL hinge.

The mono training step (``train.py``) computes its VAE reconstruction and
KL terms and its epsilon-MSE inline, as the JAX package does.  Not ported
yet: the masked epsilon-MSE, the DPP diversity, RefineNet regularization,
dense VAE, BC and collision losses of the dense step.
"""

from __future__ import annotations

import torch

from pstl_tpu_torch.ops.guidance_loss import mask_mean

Tensor = torch.Tensor


def stl_hinge(scores: Tensor, valid: Tensor, thres: float,
              weight: float = 1.0) -> Tensor:
    """mask_mean(relu(thres - scores), valid) * weight."""
    return mask_mean(torch.relu(thres - scores), valid) * weight
