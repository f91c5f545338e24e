"""The baselines' losses against ``pstl_tpu.losses``, value and gradient to
1e-5 relative (``test_torch_dense_losses.check``): the dense VAE's
``vae_losses`` (reconstruction and KL, gradients through the controls and
the latent statistics) and ``bc_mse``, with ``stl_bc_mask`` on (some
rows, every row, no row satisfying: the all-masked batch, whose mask mean
clips at 1e-2) and off, and their weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import losses as jl
from pstl_tpu.config import Config as JConfig
from pstl_tpu_torch import losses as tl
from pstl_tpu_torch.config import Config as TConfig

from test_torch_dense_losses import BS, M, check, controls

N = BS * M * 3
#: the mask cases: stl_bc_mask and the targets' scores
MASKS = {"some": (True, 0.0), "all_kept": (True, 2.0),
         "all_masked": (True, -2.0), "off": (False, 0.0)}


def _targets(case, seed=0):
    """(stl_bc_mask, scores, valids): scores uniform in +-1 shifted by the
    case's offset, about a fifth of the rows invalid."""
    mask, shift = MASKS[case]
    rng = np.random.RandomState(seed)
    scores = (rng.uniform(-1, 1, N) + shift).astype(np.float32)
    valid = (rng.rand(N) > 0.2).astype(np.float32)
    return mask, scores, valid


@pytest.mark.parametrize("case", sorted(MASKS))
def test_bc_mse(case):
    mask, scores, valid = _targets(case)
    kw = dict(stl_bc_mask=mask, bc_weight=0.7)
    cfg, tcfg = JConfig(**kw), TConfig(**kw)
    v = check(lambda u, d: jl.bc_mse(u, d, jnp.asarray(scores),
                                     jnp.asarray(valid), cfg),
              lambda u, d: tl.bc_mse(u, d, torch.as_tensor(scores),
                                     torch.as_tensor(valid), tcfg),
              [controls(1), controls(2)], (0, 1))
    # an all-masked batch keeps no row: the loss is 0, and so are its
    # gradients
    assert (v == 0) == (case == "all_masked")


@pytest.mark.parametrize("case", sorted(MASKS))
def test_vae_losses(case):
    mask, scores, valid = _targets(case, seed=3)
    kw = dict(stl_bc_mask=mask, bc_weight=0.7, weight_vae_bc=1.3,
              weight_vae_kl=0.4, vae_dim=8)
    cfg, tcfg = JConfig(**kw), TConfig(**kw)
    rng = np.random.RandomState(4)
    mean = rng.randn(N, 8).astype(np.float32)
    logstd = (rng.randn(N, 8) * 0.5).astype(np.float32)

    def part(i):
        """The i-th of (recon, KL) as a function of (controls, targets,
        mean, logstd), in each package."""
        def jfn(u, d, mu, ls):
            return jl.vae_losses(u, d, (mu, ls, jnp.exp(ls)),
                                 jnp.asarray(scores), jnp.asarray(valid),
                                 cfg)[i]

        def tfn(u, d, mu, ls):
            return tl.vae_losses(u, d, (mu, ls, torch.exp(ls)),
                                 torch.as_tensor(scores),
                                 torch.as_tensor(valid), tcfg)[i]
        return jfn, tfn

    args = [controls(5), controls(6), mean, logstd]
    recon = check(*part(0), args, (0, 1))
    kl = check(*part(1), args, (2, 3))
    assert (recon == 0) == (case == "all_masked")
    assert kl > 0

