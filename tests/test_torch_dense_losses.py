"""The dense step's losses against ``pstl_tpu.losses``, value and gradient
to 1e-5 relative: ``diffusion_eps_mse`` with and without ``stl_bc_mask``,
``dpp_diversity`` (quality gate with gradient or ``diverse_detach``, two
kernel scales), both branches of ``rect_reg`` (with and without
``extra_rect_reg``) and ``collision``; the shard-count refusals of
``dpp_diversity`` and ``Net.rect``; and the flags ``rect_head`` forces."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import losses as jl
from pstl_tpu.config import Config as JConfig, PRESETS
from pstl_tpu_torch import losses as tl
from pstl_tpu_torch.config import Config as TConfig, PRESETS as TPRESETS
from pstl_tpu_torch.models.net import Net

import torch_parity  # noqa: F401  (torch thread count)

BS, M = 3, 4


def controls(seed, n=BS * M * 3, nt=20):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(-0.5, 0.5, (n, nt)),
                     rng.uniform(-5, 5, (n, nt))], -1).astype(np.float32)


def check(jfn, tfn, args, argnums, rtol=1e-5):
    """Value and the gradients w.r.t. ``argnums`` of a scalar loss."""
    jv, jg = jax.value_and_grad(jfn, argnums=argnums)(
        *[jnp.asarray(a) for a in args])
    ts = [torch.as_tensor(a).requires_grad_(i in argnums)
          for i, a in enumerate(args)]
    tv = tfn(*ts)
    if tv.requires_grad:
        tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=rtol, atol=1e-7)
    for i, g in zip(argnums, jg):
        # an input the loss does not reach (a detached one) has no .grad
        got = torch.zeros_like(ts[i]) if ts[i].grad is None else ts[i].grad
        scale = float(jnp.abs(g).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(g),
                                   rtol=rtol, atol=rtol * scale + 1e-12)
    return float(tv)


@pytest.mark.parametrize("mask", [True, False])
def test_diffusion_eps_mse(mask):
    n = BS * M * 3
    rng = np.random.RandomState(0)
    noise = rng.randn(n, 40).astype(np.float32)
    eps = rng.randn(n, 40).astype(np.float32)
    scores = rng.uniform(-1, 1, n).astype(np.float32)
    valid = (rng.rand(n) > 0.2).astype(np.float32)
    cfg = JConfig(stl_bc_mask=mask)
    tcfg = TConfig(stl_bc_mask=mask)
    check(lambda a, b: jl.diffusion_eps_mse(a, b, scores, valid, cfg),
          lambda a, b: tl.diffusion_eps_mse(a, b, torch.as_tensor(scores),
                                            torch.as_tensor(valid), tcfg),
          (noise, eps), (0, 1))


@pytest.mark.parametrize("detach,scale", [(False, 1.0), (True, 1.0),
                                          (False, 3.0)])
def test_dpp_diversity(detach, scale):
    kw = dict(n_randoms=M, n_shards=2, diverse_detach=detach,
              diversity_scale=scale, diversity_weight=0.7)
    cfg, tcfg = JConfig(**kw), TConfig(**kw)
    u = controls(1)
    # half the rows satisfy: the quality gate passes them
    scores = np.random.RandomState(2).uniform(-1, 1, len(u)).astype(
        np.float32)
    v = check(lambda a, s: jl.dpp_diversity(a, s, cfg),
              lambda a, s: tl.dpp_diversity(a, s, tcfg), (u, scores),
              (0,) if detach else (0, 1))
    assert v < 0


@pytest.mark.parametrize("diverse,extra", [(True, None), (False, None),
                                           (False, 0.5)])
def test_rect_reg(diverse, extra):
    kw = dict(diverse_loss=diverse, extra_rect_reg=extra, rect_reg_loss=0.3)
    cfg, tcfg = JConfig(**kw), TConfig(**kw)
    rect, nn = controls(3) * 1.3, controls(4)
    scores = np.random.RandomState(5).uniform(-1, 1, len(rect)).astype(
        np.float32)
    for part in (0, 1):
        check(lambda a, b: jl.rect_reg(a, b, scores, cfg)[part],
              lambda a, b: tl.rect_reg(a, b, torch.as_tensor(scores),
                                       tcfg)[part], (rect, nn), (0, 1))


def test_collision():
    rng = np.random.RandomState(6)
    d = rng.uniform(0, 6, (BS * M * 3, 3, 20)).astype(np.float32)
    r = rng.uniform(0, 4, d.shape).astype(np.float32)
    cfg, tcfg = JConfig(collision_loss=2.0), TConfig(collision_loss=2.0)
    assert check(lambda a, b: jl.collision(a, b, cfg),
                 lambda a, b: tl.collision(a, b, tcfg), (d, r), (0, 1)) > 0


def test_shard_count_refusals():
    """n_randoms must split into n_shards, in the DPP loss and in the
    RefineNet's merge."""
    cfg = TConfig(n_randoms=4, n_shards=3)
    with pytest.raises(ValueError, match="n_shards"):
        tl.dpp_diversity(torch.zeros(36, 20, 2), torch.zeros(36), cfg)
    rcfg = TPRESETS["e7_ours"].with_(n_randoms=4, n_shards=3,
                                     hiddens=(8,), rect_hiddens=(8,))
    with pytest.raises(ValueError, match="n_shards"):
        Net(rcfg).rect(torch.zeros(36, 224), torch.zeros(36, 1),
                       torch.zeros(36, 6), torch.zeros(36, 20, 2),
                       torch.zeros(36))


def test_rect_head_forces_its_flags():
    """rect_head forces interval, diffusion_clip and diff_full, as in the
    JAX package."""
    for preset in ("e7_ours", "e8_stl"):
        for c in (PRESETS[preset], TPRESETS[preset]):
            assert c.rect_head and c.interval and c.diffusion_clip \
                and c.diff_full and c.stl_bc_mask
    c = TConfig(rect_head=True, stl_bc_mask=False).finalize()
    assert c.interval and c.diffusion_clip and c.diff_full and c.stl_bc_mask
