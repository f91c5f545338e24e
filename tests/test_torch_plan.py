"""One closed-loop plan step: ``pstl_tpu_torch.sim.make_planner`` against
``pstl_tpu.sim.make_planner`` on the same synthetic scenes, weights and
sampler draws (the JAX key chain replayed and fed to the torch sampler).

Small size: 2 scenes, M=4 seeds, width-32 nets, 10 denoise steps, fp32
compute.  The JAX planner's guidance is the XLA loop on frozen selections,
which the JAX tests hold equal to the fused Pallas kernel; the torch
planner runs the fused guidance kernel's plain version.  Tolerance 1e-4
on controls, scores and the first control (see test_torch_diffusion.py);
the lane-keep argmax and the compliance share must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff
from pstl_tpu import sim as jsim
from pstl_tpu import specs as jspecs
from pstl_tpu.config import Config as JConfig
from pstl_tpu.data import synthetic as jsyn
from pstl_tpu.models import Net as JNet
from pstl_tpu_torch import diffusion as tdiff
from pstl_tpu_torch import sim as tsim
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.models import convert
from pstl_tpu_torch.models import net as tnet

from torch_parity import jax_plan_noise, np_

FLAGS = dict(diffusion=True, rect_head=True, diverse_loss=True,
             multi_cands=3, guidance=True, guidance_niters=3, n_rolls=2,
             n_randoms=4, n_neighbors=8, hiddens=(32, 32),
             rect_hiddens=(32, 32), diffusion_steps=10,
             compute_dtype="float32", flex=True,
             clearance_coarse_pair=True, guidance_reuse_selection=True)


def planner_setup(bs=2, scene_len=14, seed=0):
    """Both packages' configs, scenes and nets (the flax params converted
    into the torch net)."""
    cfg_j = JConfig(**FLAGS).finalize()
    cfg_t = TConfig(**FLAGS).with_(guidance_pallas_fuse_freeze=True
                                   ).finalize()
    data = jsyn.generate_dataset(seed, bs, cfg_j, scene_len=scene_len)
    sc_j = jsim.scenes_from_dataset(data)
    sc_t = tsim.scenes_from_dataset(data, device="cpu")
    net_j = JNet(cfg_j)
    n = bs * cfg_j.n_randoms * 3
    obs0 = jax.vmap(lambda s, e, t: jsim.observe(s, e, t, cfg_j))(
        sc_j, sc_j.ego_full[:, 0], jnp.zeros((bs,), jnp.int32))
    dense0 = jspecs.densify_batch(
        obs0, jnp.broadcast_to(jnp.asarray(jsim.AGGRESSIVE_STLP), (bs, 6)),
        cfg_j, stlp_dense=jnp.broadcast_to(
            jnp.asarray(jsim.AGGRESSIVE_STLP), (n, 1, 6)))
    ext0 = {"timestep": jnp.ones((n, 1)),
            "highlevel": dense0["highlevel_dense"],
            "noise": jnp.zeros((n, cfg_j.nt * 2))}
    params = net_j.init(jax.random.PRNGKey(1), dense0, ext0,
                        method=JNet.init_all)
    net_t = tnet.Net(cfg_t)
    net_t.load_state_dict(convert.from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return cfg_j, cfg_t, sc_j, sc_t, net_j, params, net_t.eval()


def test_plan_step_matches_jax():
    cfg_j, cfg_t, sc_j, sc_t, net_j, params, net_t = planner_setup()
    bs = sc_t.ego_full.shape[0]
    plan_j = jax.jit(jsim.make_planner(
        cfg_j, net_j, params, jspecs.build_scorer(cfg_j),
        jdiff.get_coeffs(cfg_j)))
    t0 = jnp.zeros((bs,), jnp.int32)
    obs_j = jax.vmap(lambda s, e, t: jsim.observe(s, e, t, cfg_j))(
        sc_j, sc_j.ego_full[:, 0], t0)
    key = jax.random.PRNGKey(5)
    u0_j, info_j = plan_j(key, obs_j)

    obs_t = tsim.observe(sc_t, sc_t.ego_full[:, 0],
                         torch.zeros(bs, dtype=torch.long), cfg_t)
    for k in obs_j:
        np.testing.assert_allclose(np_(obs_t[k]), np_(obs_j[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    noise = jax_plan_noise(key, cfg_t.diffusion_steps,
                           (bs, cfg_t.nt, 2, 3 * cfg_t.n_randoms))
    plan_t = tsim.make_planner(cfg_t, net_t, tdiff.get_coeffs(cfg_t))
    u0_t, info_t = plan_t(obs_t, noise=noise)

    for k in ("controls", "scores", "trajs", "plan_traj"):
        np.testing.assert_allclose(np_(info_t[k]), np_(info_j[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(np_(u0_t), np_(u0_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np_(info_t["stl_acc"]),
                                  np_(info_j["stl_acc"]))


def test_unported_planner_options_raise():
    """The backup controller, the refinement options, the VAE / BC planners
    and the init hint are accepted; the unported samplers raise by name, as
    do the configurations that cannot plan (no head, mono rows)."""
    cfg = TConfig(**FLAGS).with_(guidance_pallas_fuse_freeze=True).finalize()
    tsim.check_supported(cfg)
    tsim.check_supported(cfg.with_(use_pallas_clearance=True))
    for kw in (dict(backup=True), dict(refinement=True),
               dict(raw_refinement=True),
               dict(refinement=True, lite_refine=True),
               dict(diffusion=False, vae=True),
               dict(diffusion=False, vae=True, use_init_hint=True),
               dict(diffusion=False, bc=True), dict(use_init_hint=True)):
        tsim.check_supported(cfg.with_(**kw))
    for kw, match in ((dict(sampler="dpmpp"), "dpmpp"),
                      (dict(diffusion=False), "head"),
                      (dict(gt_data_training=True), "gt_data_training")):
        with pytest.raises(NotImplementedError, match=match):
            tsim.check_supported(cfg.with_(**kw))
