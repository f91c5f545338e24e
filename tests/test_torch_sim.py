"""Closed-loop simulator: observation, environment step and a short
episode of ``pstl_tpu_torch.sim`` against ``pstl_tpu.sim`` (CPU).

The episode runs 3 replanning steps on 2 synthetic scenes with the same
weights and, at every step, the sampler draws of the JAX key chain.  The
per-scene collide / out-of-lane flags and the step counts must agree
exactly, progress and compliance share to 1e-4 (see test_torch_plan.py for
the planner's tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff
from pstl_tpu import sim as jsim
from pstl_tpu import specs as jspecs
from pstl_tpu_torch import diffusion as tdiff
from pstl_tpu_torch import sim as tsim

from test_torch_plan import planner_setup
from torch_parity import jax_episode_noise, np_


@pytest.fixture(scope="module")
def setup():
    return planner_setup(bs=2, scene_len=14, seed=1)


def _close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np_(a), np_(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("per_t_lanes", [True, False])
def test_observe_matches_jax(setup, per_t_lanes):
    """Both observe branches: the per-t side lanes of the cache, and the
    legacy +-3.5 m offsets with lateral-offset maneuver labels."""
    cfg_j, cfg_t, sc_j, sc_t, *_ = setup
    if not per_t_lanes:
        sc_j = sc_j._replace(lanes_t=None, lane_valids_t=None, hl_t=None)
        sc_t = sc_t._replace(lanes_t=None, lane_valids_t=None, hl_t=None)
    rng = np.random.RandomState(0)
    ego = np.asarray(sc_j.ego_full[:, 3]) + rng.randn(2, 4).astype(
        np.float32) * [3.0, 3.0, 0.2, 1.0]
    t = np.array([3, 5], np.int32)
    oj = jax.vmap(lambda s, e, tt: jsim.observe(s, e, tt, cfg_j))(
        sc_j, jnp.asarray(ego, jnp.float32), jnp.asarray(t))
    ot = tsim.observe(sc_t, torch.as_tensor(ego, dtype=torch.float32),
                      torch.as_tensor(t).long(), cfg_t)
    assert sorted(oj) == sorted(ot)
    for k in oj:
        _close(ot[k], oj[k], 1e-6, 1e-5)


def test_env_step_matches_jax(setup):
    """Euler step with the nonnegative-speed clamp, the collision test
    (a neighbor teleported onto the ego) and the drivable raster lookup
    (an ego pushed 50 m off the road)."""
    cfg_j, cfg_t, sc_j, sc_t, *_ = setup
    ego = np.asarray(sc_j.ego_full[:, 2]).copy()
    ego[1, 1] += 50.0
    ego[0, 3] = 0.3
    u = np.array([[0.1, -2.0], [-0.2, 1.0]], np.float32)
    t = np.array([2, 2], np.int32)
    nei = np.asarray(sc_j.nei_full).copy()
    nei[0, 0, 3, 0] = 1.0
    nei[0, 0, 3, 1:3] = ego[0, :2]
    nei[0, 0, 3, 5:7] = [4.0, 2.0]
    sc_j = sc_j._replace(nei_full=jnp.asarray(nei))
    sc_t = sc_t._replace(nei_full=torch.as_tensor(nei))
    rj = jax.vmap(lambda s, e, tt, uu: jsim.env_step(s, e, tt, uu, cfg_j))(
        sc_j, jnp.asarray(ego), jnp.asarray(t), jnp.asarray(u))
    rt = tsim.env_step(sc_t, torch.as_tensor(ego), torch.as_tensor(t).long(),
                       torch.as_tensor(u), cfg_t)
    _close(rt[0], rj[0])
    for a, b in zip(rt[1:], rj[1:]):
        np.testing.assert_array_equal(np_(a), np_(b))
    assert np_(rt[1]).tolist() == [True, False]      # collision in scene 0
    assert np_(rt[2]).tolist() == [False, True]      # scene 1 off the road


def test_scenes_and_lane_window_match_jax(setup):
    cfg_j, cfg_t, sc_j, sc_t, *_ = setup
    for a, b in zip(sc_t, sc_j):
        np.testing.assert_array_equal(np_(a), np_(b))
    pose = np.array(sc_j.center_dense[:, 50, :2])
    wj = jax.vmap(lambda c, p: jsim.lane_window_device(c, p, 15))(
        sc_j.center_dense, jnp.asarray(pose))
    wt = tsim.lane_window_device(sc_t.center_dense, torch.as_tensor(pose), 15)
    np.testing.assert_array_equal(np_(wt), np_(wj))
    _close(tsim.offset_lane_device(wt, 3.5),
           jax.vmap(lambda l: jsim.offset_lane_device(l, 3.5))(wj))


def test_episode_matches_jax(setup):
    cfg_j, cfg_t, sc_j, sc_t, net_j, params, net_t = setup
    steps = 3
    init_j, step_j = jsim.make_closed_loop_step(
        sc_j, cfg_j, net_j, params, jspecs.build_scorer(cfg_j),
        jdiff.get_coeffs(cfg_j))
    key = jax.random.PRNGKey(3)
    c = init_j(key)
    for _ in range(steps):
        c = step_j(c)
    mj = jsim._carry_metrics(c)

    init_t, step_t = tsim.make_closed_loop_step(sc_t, cfg_t, net_t,
                                                tdiff.get_coeffs(cfg_t))
    ct = init_t(0)
    bs = sc_t.ego_full.shape[0]
    for noise in jax_episode_noise(key, steps, cfg_t.diffusion_steps,
                                   (bs, cfg_t.nt, 2, 3 * cfg_t.n_randoms)):
        ct = step_t(ct, noise=noise)
    mt = tsim._carry_metrics(ct)
    _close(ct.ego, c.ego, 1e-4, 1e-4)
    for k in ("collide", "out_of_lane", "traj_len", "repairs"):
        np.testing.assert_array_equal(np_(mt[k]), np_(mj[k]), err_msg=k)
    for k in ("progress", "stl_acc"):
        _close(mt[k], mj[k], 1e-4, 1e-4)


def test_scenes_default_to_the_card(setup):
    """``scenes_from_dataset`` with no device goes to the card; where there
    is none it raises and names the argument that asks for the CPU."""
    from pstl_tpu_torch.data import synthetic
    from pstl_tpu_torch.device import resolve_device
    from pstl_tpu_torch import train
    cfg_t = setup[1]
    data = synthetic.generate_dataset(1, 2, cfg_t, scene_len=14)
    assert train.resolve_device is resolve_device    # one place for both
    if torch.cuda.is_available():
        assert tsim.scenes_from_dataset(data).ego_full.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsim.scenes_from_dataset(data)
    sc = tsim.scenes_from_dataset(data, device="cpu")
    assert all(t.device.type == "cpu" for t in sc if t is not None)
    for a, b in zip(sc, setup[3]):
        np.testing.assert_array_equal(np_(a), np_(b))


def test_planner_refuses_another_device(setup):
    """The planner runs where the scenes are: a net or coefficients on
    another device raise, at construction and in the plan."""
    import copy
    _, cfg_t, _, sc_t, _, _, net_t = setup
    coeffs = tdiff.get_coeffs(cfg_t)
    elsewhere = copy.deepcopy(net_t).to("meta")
    with pytest.raises(ValueError, match="the net"):
        tsim.make_closed_loop_step(sc_t, cfg_t, elsewhere, coeffs)
    moved = tdiff.Coeffs(*(c.to("meta") for c in coeffs))
    with pytest.raises(ValueError, match="coefficients"):
        tsim.make_closed_loop_step(sc_t, cfg_t, net_t, moved)
    plan = tsim.make_planner(cfg_t, elsewhere, coeffs)
    obs = tsim.observe(sc_t, sc_t.ego_full[:, 0],
                       torch.zeros(2, dtype=torch.long), cfg_t)
    with pytest.raises(ValueError, match="the net"):
        plan(obs)
