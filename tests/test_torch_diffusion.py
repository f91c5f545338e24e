"""DDPM sampler: the torch port against ``pstl_tpu.diffusion`` on the CPU.

The reverse pass runs with the JAX key chain's draws fed to the torch
sampler (pinned noise).  On the JAX side the guidance is the XLA loop on
frozen selections (``guidance_reuse_selection``), which the JAX tests hold
equal to the fused Pallas kernel; on the torch side it is the fused
guidance kernel's plain version.  Tolerance 1e-4 on controls: the per-step
differences (fp32 sums in another order, rtol 2e-4 through the Adam
guidance) pass through 9 denoise steps and the guidance's trust-region
clip bounds each step's correction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff
from pstl_tpu import specs as jspecs
from pstl_tpu.config import Config as JConfig
from pstl_tpu.models import Net as JNet
from pstl_tpu.models import net as jnet
from pstl_tpu_torch import diffusion as tdiff
from pstl_tpu_torch import specs as tspecs
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.models import convert
from pstl_tpu_torch.models import net as tnet

from torch_parity import F32, guidance_case, jax_cm_noise, np_, to_t


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np_(a), np_(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kw", [
    dict(), dict(guidance_before=10), dict(guidance_sets=(1, 5, 7)),
    dict(guidance_freq=3, guidance_reverse=True), dict(guidance=False)])
def test_schedule_and_coeffs_match_jax(kw):
    cj = JConfig(diffusion=True, guidance=True, diffusion_steps=20).with_(
        **kw)
    ct = TConfig(diffusion=True, guidance=True, diffusion_steps=20).with_(
        **kw)
    np.testing.assert_array_equal(tdiff._trigger_schedule(ct),
                                  jdiff._trigger_schedule(cj))
    for a, b in zip(tdiff.get_coeffs(ct), jdiff.get_coeffs(cj)):
        _close(a, b, 1e-6, 1e-7)
    x = np.random.RandomState(0).randn(6, 40).astype(F32) * 2
    for clip in (False, True):
        _close(tdiff.denormalize_controls(torch.as_tensor(x), ct, clip=clip),
               jdiff.denormalize_controls(jnp.asarray(x), cj, clip=clip),
               0, 0)


def _setup(bs=2, M=4, steps=10, seed=0, cfg_t_kw=None, **kw):
    """Both packages' configs, dense batches and nets; ``kw`` overrides
    the shared flags, ``cfg_t_kw`` (default: the fused kernel) the port's
    guidance route."""
    flags = dict(diffusion=True, rect_head=True, diverse_loss=True,
                 n_randoms=M, n_neighbors=3, hiddens=(32, 32),
                 rect_hiddens=(32, 32), compute_dtype="float32",
                 diffusion_steps=steps, guidance=True, guidance_niters=3,
                 clearance_coarse_pair=True, guidance_reuse_selection=True,
                 flex=True)
    flags.update(kw)
    cfg_j = JConfig(**flags).finalize()
    if cfg_t_kw is None:
        cfg_t_kw = dict(guidance_pallas_fuse_freeze=True)
    cfg_t = TConfig(**flags).with_(**cfg_t_kw).finalize()
    batch, gt, stlp, states, _ = guidance_case(seed, bs, M, 20, 3, 15)
    batch["ego_traj"] = np.concatenate(
        [np.repeat(states[:, None], 20, 1), np.full((bs, 20, 2), 2.0, F32)],
        -1).astype(F32)
    batch["neighbors"] = batch["neighbor_trajs_aug"][:, :, 0]
    dj = jspecs.densify_batch({k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.asarray(gt), cfg_j,
                              stlp_dense=jnp.asarray(stlp))
    dt = tspecs.densify_batch(to_t(batch), torch.as_tensor(gt), cfg_t,
                              torch.as_tensor(stlp))
    n = bs * M * 3
    net_j = JNet(cfg_j)
    ext0 = {"timestep": jnp.ones((n, 1)), "highlevel": dj["highlevel_dense"],
            "noise": jnp.zeros((n, 40))}
    params = net_j.init(jax.random.PRNGKey(seed + 1), dj, ext0,
                        method=JNet.init_all)
    net_t = tnet.Net(cfg_t)
    net_t.load_state_dict(convert.from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return cfg_j, cfg_t, dj, dt, net_j, params, net_t, states


def test_reverse_sample_matches_jax_pinned_noise():
    """The candidate-minor reverse pass with all-step guidance: final
    controls and every per-step decoding (diff_full) match."""
    cfg_j, cfg_t, dj, dt, net_j, params, net_t, states = _setup()
    n = states.shape[0] * cfg_j.n_randoms * 3
    hl = dj["highlevel_dense"]
    ext0 = {"timestep": jnp.ones((n, 1)), "highlevel": hl,
            "noise": jnp.zeros((n, 40))}
    _, feat_j = net_j.apply(params, dj, ext0, get_feature=True)
    valid_j = dj["valids_dense"].reshape(-1)
    fj = jspecs.make_guidance_loss(dj, dj, cfg_j, jnp.asarray(states),
                                   valid_j)
    ctx = jdiff.make_guidance_ctx(None, valid_j, None, fj)
    cm_j = jnet.make_cm_eps_fn(params, dj, hl, feat_j, cfg_j)
    key = jax.random.PRNGKey(7)
    ctrl_j, steps_j = jax.jit(lambda k: jdiff.reverse_sample(
        k, None, dj, hl, feat_j, cfg_j, jdiff.get_coeffs(cfg_j), n,
        guidance_ctx=ctx, maximize=True, cm_fn=cm_j))(key)

    ft = tspecs.make_guidance_loss(dt, dt, cfg_t, torch.as_tensor(states),
                                   dt["valids_dense"].reshape(-1))
    with torch.no_grad():
        feat_t = torch.repeat_interleave(net_t.encode(dt), 3 * cfg_t.n_randoms,
                                         0)
        cm_t = tnet.make_cm_eps_fn(net_t, dt, dt["highlevel_dense"], feat_t,
                                   cfg_t)
        noise = jax_cm_noise(key, cfg_t.diffusion_steps,
                             (states.shape[0], 20, 2, 3 * cfg_t.n_randoms))
        ctrl_t, steps_t = tdiff.reverse_sample(
            cm_t, ft, cfg_t, tdiff.get_coeffs(cfg_t), maximize=True,
            noise=noise)
    assert steps_t.shape == steps_j.shape == (10, n, 20, 2)
    _close(steps_t[0], steps_j[0], 0, 0)          # x0 is the same draw
    _close(steps_t, steps_j, 1e-4, 1e-4)
    _close(ctrl_t, ctrl_j, 1e-4, 1e-4)


def test_select_multi_cands_matches_jax():
    cfg_j, cfg_t, dj, dt, *_, states = _setup()
    n = states.shape[0] * cfg_j.n_randoms * 3
    rng = np.random.RandomState(3)
    all_steps = (rng.randn(6, n, 20, 2) * [0.2, 2.0]).astype(F32)
    sf = np.repeat(states, 3 * cfg_j.n_randoms, axis=0)
    bj, sj = jdiff.select_multi_cands(
        jnp.asarray(all_steps), 4, jnp.asarray(sf),
        jspecs.make_score_rows(dj, dj, cfg_j), cfg_j)
    bt, st = tdiff.select_multi_cands(
        torch.as_tensor(all_steps), 4, torch.as_tensor(sf),
        tspecs.make_score_rows(dt, dt, cfg_t), cfg_t)
    _close(st, sj, 1e-4, 1e-4)
    _close(bt, bj, 0, 0)


def test_unported_sampler_options_raise():
    """Every guidance route of the candidate-minor loss is accepted (the
    fused and frozen-payload kernels, folded or not, and the XLA loop), and
    so are the unguided row-major pass, the fast samplers, the row-major
    guided chain, the row-major guidance loss and bf16 robustness on the
    XLA loop; bf16 robustness with a guidance kernel (fp32 only) raises."""
    cfg = TConfig(diffusion=True, guidance=True,
                  guidance_pallas_fuse_freeze=True).finalize()
    tdiff.check_supported(cfg)
    for kw in (dict(guidance_pallas_fuse_freeze=False),
               dict(guidance_pallas_fold=True),
               dict(guidance_pallas_fuse_freeze=False,
                    guidance_pallas_fold=True),
               dict(guidance_pallas=False, guidance_pallas_fuse_freeze=False),
               dict(guidance=False, cm_sampler=False),
               dict(sampler="ddim"), dict(sampler="dpmpp"),
               dict(cm_sampler=False),
               dict(guidance_pallas=False, guidance_pallas_fuse_freeze=False,
                    guidance_fused_loss=False),
               dict(guidance_pallas=False, guidance_pallas_fuse_freeze=False,
                    robustness_dtype="bfloat16")):
        tdiff.check_supported(cfg.with_(**kw))
    with pytest.raises(NotImplementedError):
        tdiff.check_supported(cfg.with_(robustness_dtype="bfloat16"))
