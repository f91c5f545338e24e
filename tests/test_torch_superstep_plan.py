"""One closed-loop plan step under ``guidance_pallas_superstep`` on the
CPU: ``pstl_tpu_torch.sim.make_planner`` against ``pstl_tpu.sim.make_planner``
with the Pallas superstep kernel in interpret mode, on the same synthetic
scenes, weights and sampler draws.  Small size and tolerance as
tests/test_torch_plan.py: 1e-4 on controls, scores and the first control;
the lane-keep argmax and the compliance share must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pstl_tpu import diffusion as jdiff
from pstl_tpu import sim as jsim
from pstl_tpu import specs as jspecs
from pstl_tpu_torch import diffusion as tdiff
from pstl_tpu_torch import sim as tsim
from pstl_tpu_torch.ops import superstep_kernel as sk

from test_torch_plan import planner_setup
from torch_parity import jax_plan_noise, np_

SUPERSTEP = dict(guidance_pallas_superstep=True, pallas_interpret=True)


def test_plan_step_superstep_matches_jax(monkeypatch):
    cfg_j, cfg_t, sc_j, sc_t, net_j, params, net_t = planner_setup()
    cfg_j = cfg_j.with_(**SUPERSTEP).finalize()
    cfg_t = cfg_t.with_(**SUPERSTEP).finalize()
    bs = sc_t.ego_full.shape[0]
    plan_j = jax.jit(jsim.make_planner(
        cfg_j, net_j, params, jspecs.build_scorer(cfg_j),
        jdiff.get_coeffs(cfg_j)))
    obs_j = jax.vmap(lambda s, e, t: jsim.observe(s, e, t, cfg_j))(
        sc_j, sc_j.ego_full[:, 0], jnp.zeros((bs,), jnp.int32))
    key = jax.random.PRNGKey(5)
    u0_j, info_j = plan_j(key, obs_j)

    obs_t = tsim.observe(sc_t, sc_t.ego_full[:, 0],
                         torch.zeros(bs, dtype=torch.long), cfg_t)
    noise = jax_plan_noise(key, cfg_t.diffusion_steps,
                           (bs, cfg_t.nt, 2, 3 * cfg_t.n_randoms))
    plan_t = tsim.make_planner(cfg_t, net_t, tdiff.get_coeffs(cfg_t))
    calls = []
    real = sk.superstep
    monkeypatch.setattr(sk, "superstep",
                        lambda *a: calls.append(a[-1]) or real(*a))
    u0_t, info_t = plan_t(obs_t, noise=noise)
    assert calls == [True] * (cfg_t.diffusion_steps - 1)
    for k in ("controls", "scores", "trajs", "plan_traj"):
        np.testing.assert_allclose(np_(info_t[k]), np_(info_j[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(np_(u0_t), np_(u0_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np_(info_t["stl_acc"]),
                                  np_(info_j["stl_acc"]))
