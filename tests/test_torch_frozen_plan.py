"""One closed-loop plan step on the frozen-payload route, and the
``use_pallas_clearance`` flag, against ``pstl_tpu.sim`` on the CPU (small
size of tests/test_torch_plan.py: 2 scenes, M=4, width-32 nets, 10 denoise
steps, fp32 compute, the JAX key chain's draws fed to the torch sampler).

- ``BENCH_GPALLAS=1`` (``guidance_pallas`` without ``fuse_freeze``): the
  JAX planner runs the Pallas ``_kernel`` in interpret mode, the port the
  frozen-payload kernel's plain version, both on selections ``freeze_cm``
  froze at each posterior mean.  Tolerance 1e-4 (tests/test_torch_plan.py).
- ``use_pallas_clearance`` (``BENCH_PALLAS=1``) changes nothing on the
  planner's path: ``make_score_rows`` gives the same rows with the flag on
  and off in the JAX package (its signals carry hoisted neighbor discs, so
  the min-clearance kernels are not reached), and the port's plan step is
  unchanged by it.
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
from pstl_tpu_torch import diffusion as tdiff
from pstl_tpu_torch import sim as tsim
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.ops import guidance_kernel as gk

from test_torch_plan import FLAGS, planner_setup
from torch_parity import jax_plan_noise, np_


@pytest.fixture(scope="module")
def setup():
    return planner_setup()


def _obs(cfg_j, cfg_t, sc_j, sc_t):
    bs = sc_t.ego_full.shape[0]
    obs_j = jax.vmap(lambda s, e, t: jsim.observe(s, e, t, cfg_j))(
        sc_j, sc_j.ego_full[:, 0], jnp.zeros((bs,), jnp.int32))
    obs_t = tsim.observe(sc_t, sc_t.ego_full[:, 0],
                         torch.zeros(bs, dtype=torch.long), cfg_t)
    return obs_j, obs_t


def test_plan_step_frozen_route_matches_jax(setup):
    _, _, sc_j, sc_t, net_j, params, net_t = setup
    cfg_j = JConfig(**FLAGS).with_(guidance_pallas=True,
                                   pallas_interpret=True).finalize()
    cfg_t = TConfig(**FLAGS).with_(guidance_pallas=True).finalize()
    assert not cfg_t.guidance_pallas_fuse_freeze
    bs = sc_t.ego_full.shape[0]
    obs_j, obs_t = _obs(cfg_j, cfg_t, sc_j, sc_t)
    plan_j = jax.jit(jsim.make_planner(
        cfg_j, net_j, params, jspecs.build_scorer(cfg_j),
        jdiff.get_coeffs(cfg_j)))
    key = jax.random.PRNGKey(9)
    u0_j, info_j = plan_j(key, obs_j)

    noise = jax_plan_noise(key, cfg_t.diffusion_steps,
                           (bs, cfg_t.nt, 2, 3 * cfg_t.n_randoms))
    plan_t = tsim.make_planner(cfg_t, net_t, tdiff.get_coeffs(cfg_t))
    calls = []
    real = gk.guidance_frozen_plain
    gk.guidance_frozen_plain = lambda *a: calls.append(1) or real(*a)
    try:
        u0_t, info_t = plan_t(obs_t, noise=noise)
    finally:
        gk.guidance_frozen_plain = real
    assert len(calls) == int(tdiff._trigger_schedule(cfg_t).sum())
    for k in ("controls", "scores", "trajs", "plan_traj"):
        np.testing.assert_allclose(np_(info_t[k]), np_(info_j[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(np_(u0_t), np_(u0_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np_(info_t["stl_acc"]),
                                  np_(info_j["stl_acc"]))


def test_use_pallas_clearance_changes_nothing(setup):
    cfg_j, cfg_t, sc_j, sc_t, net_j, params, net_t = setup
    obs_j, obs_t = _obs(cfg_j, cfg_t, sc_j, sc_t)
    bs = sc_t.ego_full.shape[0]
    n = bs * cfg_j.n_randoms * 3
    stlp = jnp.asarray(jsim.AGGRESSIVE_STLP)
    dense = jspecs.densify_batch(obs_j, jnp.broadcast_to(stlp, (bs, 6)),
                                 cfg_j, stlp_dense=jnp.broadcast_to(
                                     stlp, (n, 1, 6)))
    u = jax.random.normal(jax.random.PRNGKey(2), (n, cfg_j.nt, 2)) \
        * jnp.asarray([0.2, 2.0])
    states = jnp.repeat(obs_j["ego_traj"][:, 0, :4], 3 * cfg_j.n_randoms, 0)
    trajs = jsim.dyn.rollout(states, u, cfg_j.dt)[:, :-1]
    rows = {}
    for on in (False, True):
        c = cfg_j.with_(use_pallas_clearance=on)
        rows[on] = np.asarray(jspecs.make_score_rows(obs_j, dense, c)(trajs))
    np.testing.assert_array_equal(rows[True], rows[False])
    assert np.isfinite(rows[False]).all()

    noise = jax_plan_noise(jax.random.PRNGKey(4), cfg_t.diffusion_steps,
                           (bs, cfg_t.nt, 2, 3 * cfg_t.n_randoms))
    out = {}
    for on in (False, True):
        c = cfg_t.with_(use_pallas_clearance=on)
        plan = tsim.make_planner(c, net_t, tdiff.get_coeffs(c))
        out[on] = plan(obs_t, noise=noise)
    for k in ("controls", "scores"):
        assert torch.equal(out[True][1][k], out[False][1][k]), k
    assert torch.equal(out[True][0], out[False][0])
