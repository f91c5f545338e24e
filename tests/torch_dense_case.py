"""Shared case of the dense train-step parity tests
(``tests/test_torch_dense_train_*.py``): the port's train step
(``pstl_tpu_torch.train``) on ``e5_ddpm``, ``e7_ours``, ``e8_stl`` and the
baselines (``e3_vae``, ``e6_trafficsim``, BC) against ``pstl_tpu.train``
on the same converted parameters, batch and draws, at a small size
(hiddens and rect_hiddens (32, 32), n_randoms 4, n_shards 2, 8 denoise
steps, bs 3, K 3; the baselines' tests set vae_dim 8).

The scenes are ``lane_scenes``: the synthetic batch made straight (a
constant-speed GT line, lanes 3.5 m apart along it, every scene a lane
keep) with neighbor 0 driving beside the ego in the left lane, so that the
safety clause sits inside the clearance's (-5, 20) gate; the control head is
scaled by 0.01, so the sampled rollouts stay near the GT line.  Lane-keep
rows then mostly satisfy the spec and lane-change rows do not: the
epsilon-MSE mask, the RefineNet's violation gate and the DPP quality gate
each see both kinds of row.  The trajopt targets are the random control
seeds with one seed per (scene, maneuver) replaced by the GT controls,
scored by the step itself, or given as a ``tj_scores_prior`` column.

The draws are the JAX step's own: ``k_dense, k_prep, k_sample, k_vae =
split(key, 4)``; the flex uniforms from ``get_dense_stlp``'s three keys of
k_dense and ``generate_flex_pstl``'s six of each, prep's noise and steps
from k_prep, the sampler's chain from k_sample, the VAE's latent noise from
k_vae, handed to the port.

The JAX step is compiled with LLVM's optimizations off
(``xla_backend_optimization_level`` 0, ``JAX_OPTS``): with them on, XLA's
CPU gradient of the RefineNet step departs from the function's own.  On
the "flip" case the RefineNet bias entry [1] reads 2.50e-5 op by op, at
level 0 and in the port, 2.0e-5 by a central difference of the loss (steps
1e-2 and 3e-3), and 3.38e-4 compiled at the default level; the compiled
tail alone (rect, then the DPP loss on stopped scores) reads 9.06e-4.
Net.rect and dpp_diversity each agree compiled and op by op to 3e-7; their
composition does not.

Tolerances are ``torch_mono_case``'s (``check_close``, ``check_params``)
for the losses, metrics and parameters: fp32 losses and metrics rtol 1e-5,
bf16 one bf16 step of the largest value; the second step's metrics rtol
1e-3; parameters within 2*lr a step, tighter where the gradient stood above
the noise.  Gradients: fp32 rtol 1e-4 with a floor of 1e-6 of the tensor's
largest entry, and 1e-5 where the STL hinge reaches the lane-change rows
(the e8 case): their Eventually-Always clauses run a reverse
logcumsumexp of values x100 (tau), a sequential scan here and an
associative one in JAX, whose float32 cotangents agree to ~1e-4 of each
row's own size, and entries that sum rows with cancellation keep that
error.  In bf16 the gradients are held through the parameters after each
step only.  On e5 only the loose bound (``tight=False``): its loss reaches
the encoders through the policy's first layer alone, on the few rows the
eps-MSE keeps (3 of 36 here), and the 224-wide scene feature, whose bf16
entries XLA and PyTorch round half a step apart (0.0625 at 27.5), flips
ReLU gates of that layer, so an encoder gradient entry can change sign.
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

from chip_smoke import with_gt_seed
from torch_mono_case import check_close, check_params
from torch_parity import jax_cm_noise

#: compiler options of the JAX reference (see the module docstring)
JAX_OPTS = {"xla_backend_optimization_level": 0}


def jit_fast(fn, *args):
    """``fn(*args)`` compiled at ``JAX_OPTS``: the function's own arithmetic
    (see the module docstring), in a fraction of the default level's
    compile time."""
    return jax.jit(fn).lower(*args).compile(compiler_options=JAX_OPTS)(*args)


SMALL = dict(exp_name=None, hiddens=(32, 32), rect_hiddens=(32, 32),
             n_randoms=4, n_shards=2, diffusion_steps=8, batch_size=3,
             n_neighbors=3)


def lane_scenes(batch, cfg, nei_off=3.5):
    """``batch`` made straight: the GT a constant-speed line from each
    scene's start, the lanes along it 3.5 m apart, every scene a lane keep,
    neighbor 0 beside the ego, ``nei_off`` to its left (3.5: in the left
    lane), and the others gone; seed 0 of every maneuver holds the GT
    controls."""
    b = {k: v.copy() for k, v in batch.items()}
    ego = b["ego_traj"]
    bs, T = ego.shape[:2]
    x0, y0, th0, v0 = (ego[:, 0, i][:, None] for i in range(4))
    s = v0 * cfg.dt * np.arange(T)
    c, sn = np.cos(th0), np.sin(th0)
    ego[..., 0], ego[..., 1], ego[..., 2], ego[..., 3] = (
        x0 + s * c, y0 + s * sn, th0, v0)
    sl = -(np.linspace(-10.0, 1.0, cfg.n_segs) * (v0 * cfg.dt * T + 10.0)
           )[:, ::-1]
    for key, off in (("curr", 0.0), ("left", 3.5), ("right", -3.5)):
        b[f"{key}lane_wpts"] = np.stack(
            [x0 + sl * c - off * sn, y0 + sl * sn + off * c,
             np.broadcast_to(th0, sl.shape)], -1).astype(np.float32)
        b[f"{key}_id"] = np.ones((bs, 1), np.float32)
    nei = b["neighbors_traj"]
    nei[:, 1:, :, 0] = 0.0
    nei[:, 0, :, 0] = 1.0
    nei[:, 0, :, 1] = ego[..., 0] - nei_off * sn
    nei[:, 0, :, 2] = ego[..., 1] + nei_off * c
    nei[:, 0, :, 3:5] = ego[..., 2:4]
    nei[:, 0, :, 5], nei[:, 0, :, 6] = 4.0, 1.8
    b["neighbors"] = nei[:, :, 0].copy()
    b["gt_high_level"] = np.zeros((bs, 1), np.float32)
    return with_gt_seed(b, cfg)


#: the sampler's draws on both sides are this multiple of the JAX key
#: chain's normals (``pstl_tpu.diffusion._normal``, the JAX package's seam
#: for pinned noise): small controls keep the rollouts near the GT line
SAMPLE_SCALE = 0.05


def flip_stlp(batch, cfg):
    """A ``pre_stlp`` column on which the RefineNet head can flip a row: all
    bands loose but the speed's upper bound, 0.2 m/s above the start speed,
    so a sampled rollout that speeds up violates the spec by a little and
    the same rollout braked (the head of ``setup(case="flip")``) satisfies
    it."""
    bs, M = batch["ego_traj"].shape[0], cfg.n_randoms
    st = np.zeros((bs, M, 3, 6), np.float32)
    st[..., :] = (-100.0, 0.0, -50.0, 50.0, 0.0, 10.0)
    st[..., 1] = batch["ego_traj"][:, 0, 3][:, None, None] + 0.2
    return st


#: neighbor 0's lateral offset in the "near" case: 1.5 m, below the sum of
#: the ego's and its disc radii (0.865 + 0.9 m), so the collision loss
#: relu(1 - d / radius_sum) is positive on the rollouts
NEAR_OFF = 1.5


def setup(preset, case="flex", **kw):
    """(cfg, two numpy batches, the flax net, its params).  ``case``:
    "flex" (the step draws the dense pSTL parameters), "tj_prior" (and the
    batches carry a ``tj_scores_prior`` column), "flip" (the batches carry
    ``flip_stlp``'s ``pre_stlp`` column, and the RefineNet head brakes: its
    output layer scaled by 0.01 and its acceleration biases -1) or "near"
    (as "flex", neighbor 0 NEAR_OFF to the ego's left).  The control head is
    scaled by 0.01 and, in "flex", the RefineNet's output layer by 0.1:
    mild corrections.  ``kw`` overrides SMALL and the preset."""
    cfg = PRESETS[preset].with_(**{**SMALL, **kw})
    ds = SceneDataset.from_synthetic(cfg, seed=0, n_scenes=12)
    ds.ensure_random_params(cfg.seed)
    off = NEAR_OFF if case == "near" else 3.5
    batches = [lane_scenes({k: v for k, v in b.items()
                            if k.startswith(ttrain.COLS)}, cfg, off)
               for b in batch_iterator(ds, "train", cfg.batch_size,
                                       shuffle=False)][:2]
    rng = np.random.RandomState(5)
    for b in batches:
        if case == "tj_prior":
            b["tj_scores_prior"] = rng.uniform(
                -1, 1, (cfg.batch_size, cfg.n_randoms, 3)).astype(np.float32)
        if case == "flip":
            b["pre_stlp"] = flip_stlp(b, cfg)
    net = JNet(cfg)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    p = jax.device_get(jtrain.init_state(cfg, net, jb,
                                         jax.random.PRNGKey(0)).params)
    last = p["params"]["policy_net"][f"Dense_{len(cfg.hiddens)}"]
    last["kernel"] = last["kernel"] * 0.01
    if cfg.rect_head:
        rect = p["params"]["rect_net"][f"Dense_{len(cfg.rect_hiddens)}"]
        rect["kernel"] = rect["kernel"] * (0.01 if case == "flip" else 0.1)
        if case == "flip":
            rect["bias"] = np.array(rect["bias"])
            rect["bias"][1::2] = -1.0
    return cfg, batches, net, jax.tree_util.tree_map(jnp.asarray, p)


def flex_draws(cfg, k_dense, bs):
    """The (3, 6, bs, 1) uniforms ``get_dense_stlp`` draws from k_dense."""
    out = []
    for j, kj in enumerate(jax.random.split(k_dense, 3)):
        ranges = tspecs.FLEX_RANGES["keep" if j == 0 else "change"]
        ks = jax.random.split(kj, 6)
        out.append([np.asarray(jax.random.uniform(ks[i], (bs, 1), minval=lo,
                                                  maxval=hi))
                    for i, (lo, hi) in enumerate(ranges)])
    return torch.as_tensor(np.array(out))


def jax_draws(cfg, key, bs):
    """The draws of pstl_tpu.train.batch_forward_and_loss's dense branch
    under ``key``: the VAE's latent noise (k_vae) for the VAE, else the
    diffusion's."""
    n = bs * cfg.n_randoms * 3
    k_dense, k_prep, k_sample, k_vae = jax.random.split(key, 4)
    if not cfg.diffusion:
        out = {"flex": flex_draws(cfg, k_dense, bs)}
        if cfg.vae:
            out["vae_noise"] = torch.as_tensor(np.array(jax.random.normal(
                k_vae, (n, cfg.vae_dim))))
        return out
    k_noise, k_t = jax.random.split(k_prep)
    return {"flex": flex_draws(cfg, k_dense, bs),
            "prep_noise": torch.as_tensor(np.array(
                jax.random.normal(k_noise, (n, cfg.nt * 2)))),
            "prep_t": torch.as_tensor(np.array(jax.random.randint(
                k_t, (n,), 1, cfg.diffusion_steps))).long(),
            "sample_noise": SAMPLE_SCALE * jax_cm_noise(
                k_sample, cfg.diffusion_steps, (n, cfg.nt * 2))}


def small_sampler_noise(monkeypatch):
    """The JAX sampler's draws scaled by SAMPLE_SCALE, as ``jax_draws``
    hands them to the port."""
    real = jdiff._normal
    monkeypatch.setattr(jdiff, "_normal",
                        lambda k, shape: SAMPLE_SCALE * real(k, shape))


def torch_net(cfg, jparams):
    net = TNet(TConfig(**cfg.to_dict()))
    net.load_state_dict(convert.from_flax(jax.device_get(jparams)))
    return net


def run_train_steps(preset, dtype, monkeypatch, case="flex", grad_floor=1e-6,
                    tight=True, bf16_step_metrics=False, **kw):
    """Two train steps of ``preset``: the first's loss, metrics and every
    gradient, the second's metrics, and both steps' parameters against the
    JAX step; under the RefineNet-only mask every parameter outside the head
    must also stay as it was, bit for bit, on both sides, and the head must
    move.  ``bf16_step_metrics``: in bf16 step i's metrics (i = 1, 2) are
    held to i bf16 steps of their value (the first step's own bound, 2^-8 to
    2^-7 relative, and one more for the parameters a step apart) rather
    than rtol 1e-3; the baselines' tanh-bounded controls carry a rounding
    of their bf16 output layer straight into the target MSE, whose
    masked mean keeps a few rows.  Returns the first step's port metrics."""
    small_sampler_noise(monkeypatch)
    cfg, batches, jnet, jparams = setup(preset, case, compute_dtype=dtype,
                                        **kw)
    bf16 = dtype == "bfloat16"
    tcfg = TConfig(**cfg.to_dict())
    tnet = torch_net(cfg, jparams)
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    opt = ttrain.make_optimizer(tcfg, tnet)
    tstep = ttrain.make_train_step(tcfg, tnet, tspecs.build_scorer(tcfg),
                                   tdiff.get_coeffs(tcfg), opt)
    jopt = jtrain.make_optimizer(cfg, jparams)
    jstate = jtrain.TrainState(jparams, jopt.init(jparams), jnp.zeros(
        (), jnp.int32))
    formulas, coeffs = jspecs.build_scorer(cfg), jdiff.get_coeffs(cfg)
    jstep = jtrain.make_train_step(cfg, jnet, formulas, coeffs, jopt)
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b, k: jtrain.batch_forward_and_loss(
            p, k, b, cfg, jnet, formulas, coeffs, train=True), has_aux=True))
    jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    key0 = jax.random.PRNGKey(11)
    jstep = jstep.lower(jstate, jb0, key0).compile(compiler_options=JAX_OPTS)
    jgrad = jgrad.lower(jstate.params, jb0, key0).compile(
        compiler_options=JAX_OPTS)
    frozen = cfg.rect_head and not cfg.joint
    floor, first = {}, None
    for i, batch in enumerate(batches):
        key = jax.random.PRNGKey(11 + i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (_, jrd), jg = jgrad(jstate.params, jb, key)
        jstate, jrd_step = jstep(jstate, jb, key)
        jgrads = convert.from_flax(jax.device_get(jg))
        trd = tstep(ttrain.to_device(batch, "cpu"),
                    draws=jax_draws(cfg, key, cfg.batch_size))
        assert sorted(trd) == sorted(jrd_step)
        for k in jrd_step:
            if i == 0:
                check_close(trd[k], jrd[k], bf16, k)
            if bf16 and bf16_step_metrics:
                check_close(trd[k], jrd_step[k], True, k, bf16_steps=i + 1)
            else:
                np.testing.assert_allclose(float(trd[k]), float(jrd_step[k]),
                                           rtol=1e-3, atol=1e-6, err_msg=k)
        if i == 0:
            first = {k: float(v) for k, v in trd.items()}
            # a parameter the loss does not reach has no .grad; JAX's is 0
            grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                     for k, p in tnet.named_parameters()}
            assert sorted(grads) == sorted(jgrads)
            for k, g in jgrads.items():
                if not bf16:
                    check_close(grads[k], g, False, f"grad {k}", rtol=1e-4,
                                floor=grad_floor)
        for k, g in jgrads.items():
            above = g.abs() > (0.125 if bf16 else 1e-6) * g.abs().max()
            floor[k] = above & floor.get(k, above) & tight
        check_params(tnet, jstate.params, floor, cfg.lr, i + 1, bf16,
                     f"params after step {i + 1}")
        if frozen:
            jp = convert.from_flax(jax.device_get(jstate.params))
            moved = set()
            for k, v in tnet.state_dict().items():
                if k.split(".")[0] in ttrain.RECT_MODULES:
                    if not torch.equal(v, before[k]):
                        moved.add(k.split(".")[0])
                    continue
                assert torch.equal(v, before[k]), k
                assert torch.equal(jp[k], before[k]), k
            assert "rect_net" in moved
    return first
