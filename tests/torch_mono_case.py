"""Shared case of the mono train-step parity tests
(``tests/test_torch_mono_train*.py``): the port's train step
(``pstl_tpu_torch.train``) against
``pstl_tpu.train.make_train_step`` on the same converted parameters, batch
and draws, at a small size (hiddens (32, 32), vae_dim 8, M 4, bs 4, K 3):
``e2_vae_mono`` with stl_weight 0 and 1 (the clearance VJP carries a zero
and a nonzero cotangent), ``e4_ddpm_mono`` with 5 denoise steps; one and
two steps; fp32 and bf16 compute.  The JAX package runs its clearance
kernels in interpret mode, the port their plain versions.

The draws are the JAX step's own: ``k_prep, k_sample, k_vae =
split(key, 3)`` (the VAE latent noise from k_vae, prep's noise and steps
from k_prep, the sampler's chain from k_sample), handed to the port.

Tolerances.  fp32: loss and metrics rtol 1e-5; gradients rtol 1e-4 with
an absolute floor of 1e-6 of the tensor's largest entry (autograd sums in
another order).  bf16: the loss and metrics to one bf16 step at the
largest value of each (the spacing of bfloat16 numbers there, 2^(e-7) for
a largest value in [2^e, 2^(e+1))); the gradients to two such steps,
because a gradient of a bf16 layer sums bf16-rounded cotangents over rows,
which XLA and PyTorch round and add in another order (one step each way).

The second step starts from parameters that differ as described next, so
its loss and metrics are held to rtol 1e-3 / atol 1e-6 (a noise entry's
move of up to 2*lr changes an output by about lr times its input).

Parameters after the steps.  Adam divides the first moment by the root of
the second, so an entry whose gradient is rounding noise (its exact value
0, computed as +-1e-9 on one side and -+1e-9 on the other) moves by up to
lr in opposite directions: every entry must lie within 2*lr per step of
the JAX value.  Entries whose gradient stood above the noise at every step
(fp32: above 1e-6 of its tensor's largest; bf16: above 1/8 of it, where
two bf16 steps are at most 1/8 of the gradient) must lie within
0.01*lr per step (fp32) or 0.1*lr per step (bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pstl_tpu import diffusion as jdiff, specs as jspecs, train as jtrain
from pstl_tpu.config import PRESETS
from pstl_tpu.data.dataset import SceneDataset, batch_iterator
from pstl_tpu.models import Net as JNet
from pstl_tpu_torch import diffusion as tdiff, specs as tspecs
from pstl_tpu_torch import train as ttrain
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.models import convert
from pstl_tpu_torch.models.net import Net as TNet
from pstl_tpu_torch.ops import clearance_kernel as ck

from chip_smoke import straight_scenes, swerving_neighbor
from torch_parity import jax_cm_noise

SMALL = dict(exp_name=None, use_pallas_clearance=True, pallas_interpret=True,
             hiddens=(32, 32), vae_dim=8, n_randoms=4, batch_size=4,
             n_neighbors=3)


def jax_draws(cfg, key, bs, sample_scale=1.0):
    """The draws of pstl_tpu.train._mono_forward_and_loss under ``key``
    (the sampler's scaled by ``sample_scale``, as ``run_train_steps`` scales
    the JAX sampler's)."""
    n = bs * cfg.n_randoms
    k_prep, k_sample, k_vae = jax.random.split(key, 3)
    if cfg.vae:
        return {"vae_noise": torch.as_tensor(np.array(
            jax.random.normal(k_vae, (n, cfg.vae_dim))))}
    k_noise, k_t = jax.random.split(k_prep)
    return {"prep_noise": torch.as_tensor(np.array(
                jax.random.normal(k_noise, (n, cfg.nt * 2)))),
            "prep_t": torch.as_tensor(np.array(jax.random.randint(
                k_t, (n,), 1, cfg.diffusion_steps))).long(),
            "sample_noise": sample_scale * jax_cm_noise(
                k_sample, cfg.diffusion_steps, (n, cfg.nt * 2))}


def setup(preset, straight=False, swerve=False, **kw):
    """(cfg, numpy batches, the flax net, its state).  ``straight``: the
    batches made into ``straight_scenes``; ``swerve``: and neighbor 0's GT
    track sidestepping away (``swerving_neighbor``), so that its
    constant-velocity prediction differs from it."""
    cfg = PRESETS[preset].with_(**{**SMALL, **kw})
    ds = SceneDataset.from_synthetic(cfg, seed=0, n_scenes=12)
    ds.ensure_random_params(cfg.seed)
    batches = [{k: v for k, v in b.items() if k.startswith(ttrain.COLS)}
               for b in batch_iterator(ds, "train", cfg.batch_size,
                                       shuffle=False)]
    if straight or swerve:
        batches = [straight_scenes(b, cfg) for b in batches]
    if swerve:
        batches = [swerving_neighbor(b, cfg) for b in batches]
    net = JNet(cfg)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    state = jtrain.init_state(cfg, net, jb, jax.random.PRNGKey(0))
    if straight or swerve:
        # a near-zero control head: the rollouts stay near the GT line
        p = jax.device_get(state.params)
        last = p["params"]["policy_net"][f"Dense_{len(cfg.hiddens)}"]
        last["kernel"] = last["kernel"] * 0.01
        state = state._replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                             p))
    return cfg, batches, net, state


def jax_grad_fn(cfg, net):
    """(params, batch, key) -> (metrics, gradients as torch tensors in the
    port's parameter names), jitted once."""
    formulas = jspecs.build_scorer(cfg)
    coeffs = jdiff.get_coeffs(cfg)

    def loss_fn(p, batch, key):
        return jtrain.batch_forward_and_loss(p, key, batch, cfg, net,
                                             formulas, coeffs, train=True)

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def grads(params, batch, key):
        (_, rd), g = fn(params, batch, key)
        return rd, convert.from_flax(jax.device_get(g))

    return grads


def check_close(got, want, bf16, what, rtol=1e-5, bf16_steps=1, floor=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    if bf16:
        step = 2.0 ** (np.floor(np.log2(scale)) - 7)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=bf16_steps * step, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=floor * scale,
                                   err_msg=what)


def check_params(tnet, jparams, floor, lr, steps, bf16, what):
    """``floor``: per parameter, the entries whose JAX gradient stood
    above the noise at every step so far (see the module docstring)."""
    want = convert.from_flax(jax.device_get(jparams))
    sd = tnet.state_dict()
    assert sorted(sd) == sorted(want)
    tight = (0.1 if bf16 else 0.01) * lr * steps
    for k, w in want.items():
        d = (sd[k] - w).abs()
        assert float(d.max()) <= 2 * lr * steps, (what, k, float(d.max()))
        if floor[k].any():
            assert float(d[floor[k]].max()) <= tight, (
                what, k, float(d[floor[k]].max()), tight)


def run_train_steps(preset, kw, dtype, grad_floor=1e-6, sample_scale=1.0):
    """Two train steps: the first's loss, metrics and gradients, the
    second's loss and metrics, both steps' parameters, and the clearance
    VJP calls the port made on the way.  ``grad_floor``: the fp32
    gradients' absolute floor, a share of each tensor's largest entry;
    ``sample_scale``: both samplers' draws are this multiple of the JAX key
    chain's normals (``pstl_tpu.diffusion._normal``, the JAX package's seam
    for pinned noise), small to keep sampled rollouts near the GT."""
    cfg, batches, jnet, jstate = setup(preset, compute_dtype=dtype, **kw)
    bf16 = dtype == "bfloat16"
    tcfg = TConfig(**cfg.to_dict())
    tnet = TNet(tcfg)
    tnet.load_state_dict(convert.from_flax(jax.device_get(jstate.params)))
    opt = ttrain.make_optimizer(tcfg, tnet)
    tstep = ttrain.make_train_step(tcfg, tnet, tspecs.build_scorer(tcfg),
                                   tdiff.get_coeffs(tcfg), opt)
    jopt = jtrain.make_optimizer(cfg, jstate.params)
    jstate = jtrain.TrainState(jstate.params, jopt.init(jstate.params),
                               jstate.step)
    jstep = jtrain.make_train_step(cfg, jnet, jspecs.build_scorer(cfg),
                                   jdiff.get_coeffs(cfg), jopt)
    jgrad = jax_grad_fn(cfg, jnet)
    floor = {}
    calls = []
    real_bwd = ck.min_clearance_bwd_plain
    real_normal = jdiff._normal
    jdiff._normal = lambda k, shape: sample_scale * real_normal(k, shape)
    ck.min_clearance_bwd_plain = lambda *a: calls.append(a[2]) or \
        real_bwd(*a)
    try:
        for i, batch in enumerate(batches[:2]):
            key = jax.random.PRNGKey(11 + i)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            jrd, jgrads = jgrad(jstate.params, jb, key)
            jstate, jrd_step = jstep(jstate, jb, key)
            trd = tstep(ttrain.to_device(batch, "cpu"),
                        draws=jax_draws(cfg, key, cfg.batch_size,
                                        sample_scale))
            assert sorted(trd) == sorted(jrd)
            for k in jrd:
                if i == 0:
                    check_close(trd[k], jrd[k], bf16, k)
                np.testing.assert_allclose(float(trd[k]), float(jrd_step[k]),
                                           rtol=1e-3, atol=1e-6, err_msg=k)
            grads = {k: p.grad for k, p in tnet.named_parameters()}
            assert sorted(grads) == sorted(jgrads)
            for k, g in jgrads.items():
                if i == 0:
                    check_close(grads[k], g, bf16, f"grad {k}", rtol=1e-4,
                                bf16_steps=2, floor=grad_floor)
                above = g.abs() > (0.125 if bf16 else 1e-6) * g.abs().max()
                floor[k] = above & floor.get(k, above)
            check_params(tnet, jstate.params, floor, cfg.lr, i + 1, bf16,
                         f"params after step {i + 1}")
    finally:
        ck.min_clearance_bwd_plain = real_bwd
        jdiff._normal = real_normal
    # the VAE step runs the clearance VJP once per step, and so does e4
    # under grad_rollout (it differentiates through the sampler); with
    # stl_weight 0 its cotangent is zero, with 1 it is not; plain e4 scores
    # sampled controls without gradient and never runs it
    if cfg.vae or cfg.grad_rollout:
        assert len(calls) == 2
        assert (float(calls[0].abs().max()) > 0) == (cfg.stl_weight > 0)
    else:
        assert not calls
