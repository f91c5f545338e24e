"""``diffusion.sample(mono=False)``: the unguided row-major DDPM pass over
the dense rows against ``pstl_tpu.diffusion.sample`` with the JAX key
chain's noise pinned, at 8 denoise steps: the controls and every decoding
(``diff_full``, clipped by ``diffusion_clip``, both forced by
``rect_head``) to 1e-5 (fp32); then ``select_multi_cands`` on them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff, specs as jspecs, train as jtrain
from pstl_tpu_torch import diffusion as tdiff, specs as tspecs
from pstl_tpu_torch import train as ttrain
from pstl_tpu_torch.config import Config as TConfig

from torch_dense_case import flex_draws, setup, torch_net
from torch_parity import jax_cm_noise


def test_dense_sample_matches_jax():
    cfg, batches, jnet, jparams = setup("e7_ours", "flex",
                                        compute_dtype="float32")
    tcfg = TConfig(**cfg.to_dict())
    tnet = torch_net(cfg, jparams).eval()
    b = batches[0]
    bs = cfg.batch_size
    n = bs * cfg.n_randoms * 3
    jb = jtrain.attach_neighbors({k: jnp.asarray(v) for k, v in b.items()},
                                 cfg)
    tb = ttrain.attach_neighbors(ttrain.to_device(b, "cpu"), tcfg)
    stlp = jspecs.calibrate_stlp(jb, jb["ego_traj"][..., :4], cfg)
    key = jax.random.PRNGKey(3)
    jd = jspecs.densify_batch(jb, stlp, cfg, key=key)
    td = tspecs.densify_batch(tb, torch.as_tensor(np.asarray(stlp)), tcfg,
                              flex=flex_draws(cfg, key, bs))
    ext0 = {"timestep": jnp.ones((n, 1)), "highlevel": jd["highlevel_dense"],
            "noise": jnp.zeros((n, cfg.nt * 2))}
    _, feat = jnet.apply(jparams, jd, ext0, get_feature=True)
    k_sample = jax.random.PRNGKey(4)
    coeffs = jdiff.get_coeffs(cfg)
    ctrl_j, steps_j = jax.jit(lambda k: jdiff.sample(
        k, lambda e: jnet.apply(jparams, jd, e, prev_feature=feat), jd,
        jd["highlevel_dense"], feat, cfg, coeffs, n))(k_sample)
    feat_t = torch.as_tensor(np.asarray(feat))
    with torch.no_grad():
        ctrl_t, steps_t = tdiff.sample(
            lambda e: tnet(td, e, prev_feature=feat_t),
            td["highlevel_dense"], tcfg, tdiff.get_coeffs(tcfg), n,
            noise=jax_cm_noise(k_sample, cfg.diffusion_steps,
                               (n, cfg.nt * 2)),
            stlp_dense=td["stlp_dense"])
    assert steps_t.shape == (cfg.diffusion_steps, n, cfg.nt, 2)
    np.testing.assert_allclose(steps_t.numpy(), np.asarray(steps_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ctrl_t.numpy(), np.asarray(ctrl_j),
                               rtol=1e-5, atol=1e-5)
    # diffusion_clip: every decoding inside the control bounds
    assert float(steps_t[..., 0].abs().max()) <= cfg.mul_w_max
    assert float(steps_t[..., 1].abs().max()) <= cfg.mul_a_max
    # the dense step's selection on these decodings
    states = np.repeat(np.asarray(jb["ego_traj"][:, 0, :4]), n // bs, 0)
    best_j, s_j = jdiff.select_multi_cands(
        steps_j, cfg.multi_cands, jnp.asarray(states),
        jspecs.make_score_rows(jb, jd, cfg), cfg)
    best_t, s_t = tdiff.select_multi_cands(
        steps_t, cfg.multi_cands, torch.as_tensor(states),
        tspecs.make_score_rows(tb, td, tcfg), tcfg)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(best_t.numpy(), np.asarray(best_j),
                               rtol=1e-5, atol=1e-5)


def test_dense_sample_needs_the_rows_stlp():
    cfg = TConfig(diffusion=True)
    with pytest.raises(ValueError, match="stlp_dense"):
        tdiff.sample(lambda e: None, torch.zeros(3, 1), cfg,
                     tdiff.get_coeffs(cfg), 3)
