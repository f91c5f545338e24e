"""The baselines' closed-loop rows: ``pstl_tpu_torch.sim`` against
``pstl_tpu.sim`` on the same scenes, converted weights and draws, for
``e3_vae`` (the init hint), ``e6_trafficsim``, BC
(``PRESETS["e3_vae"].with_(vae=False, bc=True, use_init_hint=False)``; the
JAX package has no BC preset) and ``ctg`` (the diffusion head guided on
every denoise step, 3 Adam iterations, no RefineNet).  One plan step, and a
3-step ``run_closed_loop_host(record=True)``.

Small size: 2 synthetic scenes, M = 4 seeds, K = 8, width-32 nets,
vae_dim 8, 10 denoise steps, fp32; the control head scaled by 0.01
(``test_torch_closed_loop.tame``'s).  The draws are the JAX key chain's:
plan(key) splits (k_dense, k_sample); the VAE's prior latent is
normal(k_sample) and the hint's two uniforms come from k_dense's second
split; CTG's sampler chain from k_sample (``torch_parity.jax_plan_noise``).
The JAX planner guides CTG with its XLA loop on reused selections, the port
with the fused guidance kernel's plain version (``test_torch_plan``'s
pairing).

Tolerances are ``test_torch_closed_loop``'s: 1e-4 on controls, the first
control, the first two states of a rollout and the ego history; 1e-3 on
scores and whole rollouts; flags, step counts and the lane-keep compliance
exactly; the area to 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff, sim as jsim, specs as jspecs
from pstl_tpu.config import PRESETS as JPRESETS
from pstl_tpu.data import synthetic as jsyn
from pstl_tpu.models import Net as JNet
from pstl_tpu_torch import diffusion as tdiff, sim as tsim
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.models import convert
from pstl_tpu_torch.models.net import Net as TNet

from torch_dense_case import jit_fast
from torch_parity import jax_plan_noise, np_

SMALL = dict(exp_name=None, n_randoms=4, n_neighbors=8, hiddens=(32, 32),
             vae_dim=8, diffusion_steps=10, compute_dtype="float32")
#: the rows: (preset, overrides)
ROWS = {
    "e3": ("e3_vae", {}),
    "e6": ("e6_trafficsim", {}),
    "bc": ("e3_vae", dict(vae=False, bc=True, use_init_hint=False)),
    "ctg": ("ctg", dict(guidance_reuse_selection=True)),
}
STEPS = 3
TOL = 1e-4


def _close(a, b, tol=TOL, what=""):
    np.testing.assert_allclose(np_(a), np_(b), rtol=tol, atol=tol,
                               err_msg=what)


def configs(row):
    """(JAX config, port config): the port's CTG on the fused guidance
    kernel (its plain version here)."""
    preset, kw = ROWS[row]
    cfg_j = JPRESETS[preset].with_(**SMALL, **kw)
    cfg_t = TConfig(**cfg_j.to_dict())
    if cfg_t.guidance:
        cfg_t = cfg_t.with_(guidance_pallas_fuse_freeze=True).finalize()
    return cfg_j, cfg_t


def init_params(cfg, dense):
    """Flax parameters of ``cfg``'s head, every module touched, with the
    control head scaled by 0.01."""
    n = dense["stlp_dense"].shape[0]
    hl = dense["highlevel_dense"]
    if cfg.diffusion:
        ext = {"timestep": jnp.ones((n, 1)), "highlevel": hl,
               "noise": jnp.zeros((n, cfg.nt * 2))}
    elif cfg.vae:
        ext = {"highlevel": hl, "noise": jnp.zeros((n, cfg.vae_dim)),
               "trajopt_controls": jnp.zeros((n, cfg.nt, 2))}
    else:
        ext = {"highlevel": hl}
    p = jax.device_get(JNet(cfg).init(jax.random.PRNGKey(1), dense, ext,
                                      method=JNet.init_all))
    head = p["params"]["policy_net"][f"Dense_{len(cfg.hiddens)}"]
    head["kernel"] = np.asarray(head["kernel"]) * 0.01
    return p


@pytest.fixture(scope="module", params=sorted(ROWS))
def case(request):
    """(row, configs, both packages' scenes, the flax net and params, the
    torch net)."""
    cfg_j, cfg_t = configs(request.param)
    bs = 2
    data = jsyn.generate_dataset(0, bs, cfg_j, scene_len=14)
    sc_j = jsim.scenes_from_dataset(data)
    sc_t = tsim.scenes_from_dataset(data, device="cpu")
    n = bs * cfg_j.n_randoms * 3
    obs0 = jax.vmap(lambda s, e, t: jsim.observe(s, e, t, cfg_j))(
        sc_j, sc_j.ego_full[:, 0], jnp.zeros((bs,), jnp.int32))
    stlp = jnp.asarray(jsim.AGGRESSIVE_STLP)
    dense0 = jspecs.densify_batch(obs0, jnp.broadcast_to(stlp, (bs, 6)),
                                  cfg_j, stlp_dense=jnp.broadcast_to(
                                      stlp, (n, 1, 6)))
    dense0["params_init"] = jnp.zeros((n, cfg_j.nt, 2))
    p = init_params(cfg_j, dense0)
    net_t = TNet(cfg_t)
    net_t.load_state_dict(convert.from_flax(p))
    return (request.param, cfg_j, cfg_t, sc_j, sc_t, JNet(cfg_j),
            jax.tree_util.tree_map(jnp.asarray, p), net_t.eval())


def plan_draws(key, cfg, bs):
    """The draws of ``pstl_tpu.sim.make_planner``'s plan(key, obs) in the
    port planner's keywords: the VAE's prior latent or the sampler's chain
    as ``noise``, the init hint as ``hint``."""
    n = bs * cfg.n_randoms * 3
    k_dense, k_sample = jax.random.split(key)
    out = {}
    if cfg.diffusion:
        out["noise"] = jax_plan_noise(key, cfg.diffusion_steps,
                                      (bs, cfg.nt, 2, 3 * cfg.n_randoms))
    elif cfg.vae:
        out["noise"] = torch.as_tensor(np.array(
            jax.random.normal(k_sample, (n, cfg.vae_dim))))
    if cfg.use_init_hint:
        _, k_hint = jax.random.split(k_dense)
        kw, ka = jax.random.split(k_hint)
        out["hint"] = torch.as_tensor(np.stack([
            np.asarray(jax.random.uniform(kw, (n, cfg.nt),
                                          minval=-cfg.mul_w_max,
                                          maxval=cfg.mul_w_max)) * 0.1,
            np.asarray(jax.random.uniform(ka, (n, cfg.nt),
                                          minval=-cfg.mul_a_max,
                                          maxval=cfg.mul_a_max))], -1))
    return out


def test_plan_step_matches_jax(case):
    """One plan step from frame 1: the candidates, their scores and
    rollouts, the chosen plan and first control, the lane-keep compliance;
    the hint and the latent change the VAE's candidates."""
    row, cfg_j, cfg_t, sc_j, sc_t, net_j, params, net_t = case
    bs = sc_t.ego_full.shape[0]
    plan_j = jsim.make_planner(cfg_j, net_j, params,
                               jspecs.build_scorer(cfg_j),
                               jdiff.get_coeffs(cfg_j))
    obs_j = jax.vmap(lambda s, e, t: jsim.observe(s, e, t, cfg_j))(
        sc_j, sc_j.ego_full[:, 1], jnp.ones((bs,), jnp.int32))
    key = jax.random.PRNGKey(7)
    u0_j, info_j = jit_fast(plan_j, key, obs_j)

    obs_t = tsim.observe(sc_t, sc_t.ego_full[:, 1],
                         torch.ones(bs, dtype=torch.long), cfg_t)
    plan_t = tsim.make_planner(cfg_t, net_t, tdiff.get_coeffs(cfg_t))
    draws = plan_draws(key, cfg_t, bs)
    u0_t, info_t = plan_t(obs_t, **draws)
    _close(info_t["controls"], info_j["controls"], what="controls")
    _close(info_t["scores"], info_j["scores"], 1e-3, what="scores")
    for k in ("trajs", "plan_traj"):
        _close(info_t[k][:, :2], info_j[k][:, :2], what=k)
        _close(info_t[k], info_j[k], 1e-3, what=k)
    _close(u0_t, u0_j, what="u0")
    np.testing.assert_array_equal(np_(info_t["stl_acc"]),
                                  np_(info_j["stl_acc"]))
    for k in draws:
        if k == "noise" and cfg_t.diffusion:
            continue
        other = dict(draws, **{k: draws[k].flip(0)})
        _, info_o = plan_t(obs_t, **other)
        assert float((info_o["controls"] - info_t["controls"]).abs().max(
        )) > 1e-6, k


def test_closed_loop_record_matches_jax(case):
    """``run_closed_loop_host(record=True)``, 3 steps: the metrics, the
    ego and plan history and the per-step area; the port's own draws (the
    generator) give finite metrics of the same shapes."""
    row, cfg_j, cfg_t, sc_j, sc_t, net_j, params, net_t = case
    key = jax.random.PRNGKey(3)
    oj = jsim.run_closed_loop_host(
        key, sc_j, cfg_j, net_j, params, jspecs.build_scorer(cfg_j),
        jdiff.get_coeffs(cfg_j), max_steps=STEPS, record=True)
    bs = sc_t.ego_full.shape[0]
    draws, k = [], key
    for _ in range(STEPS):
        k, k_plan = jax.random.split(k)
        draws.append(plan_draws(k_plan, cfg_t, bs))
    coeffs = tdiff.get_coeffs(cfg_t)
    ot = tsim.run_closed_loop_host(0, sc_t, cfg_t, net_t, coeffs,
                                   max_steps=STEPS, record=True,
                                   noise=draws)
    hj, ht = oj["history"], ot["history"]
    assert len(ht["ego"]) == len(hj["ego"]) == STEPS + 1
    for k in ("ego", "plan"):
        _close(np.stack(ht[k]), np.stack(hj[k]), what=k)
    np.testing.assert_allclose(ht["area"], hj["area"], rtol=TOL)
    _close(ot["area"], oj["area"])
    for k in ("collide", "out_of_lane", "traj_len", "repairs"):
        np.testing.assert_array_equal(np_(ot[k]), np_(oj[k]), err_msg=k)
    for k in ("progress", "stl_acc"):
        _close(ot[k], oj[k], what=k)
    own = tsim.run_closed_loop_host(1, sc_t, cfg_t, net_t, coeffs,
                                    max_steps=STEPS, record=True)
    assert len(own["history"]["plan"]) == STEPS
    assert np.isfinite(np.stack(own["history"]["ego"])).all()
    assert np.isfinite(own["area"])
