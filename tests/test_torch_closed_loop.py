"""The closed-loop Table-II evaluation of ``pstl_tpu_torch.sim`` against
``pstl_tpu.sim`` on the CPU: the backup controller, the planner's
per-scene stlp presets and refinement branches, and both episode runners.

Small size (``test_torch_plan.planner_setup``): 3 synthetic scenes,
M = 4 seeds, width-32 nets, 10 denoise steps, fp32, the JAX key chain's
sampler draws handed to the port.  With 10 denoise steps the refinement's
cache indices past 9 read the last decoding in both packages (the JAX
package's static index clamps, the port clamps them alike).  The control
head is scaled by 0.01 and the RefineNet's output by 0.1
(``torch_dense_case``'s), so that some lane-keep candidates satisfy the
aggressive spec (the area metric counts those).

The planner's refinement loops are cut to 3 Adam steps in both packages
(their functions patched): on the sampled candidates the full loops are
chaotic.  Perturbing the port's own pre-refinement controls by one part in
1e-7 moves its 50-step convex refinement by up to 2.3 on 12 of 36 rows:
Adam's normalized steps at lr 0.3 carry rounding-level gradient entries
and kinks of the robustness into full steps.  The two packages' refined
controls part by 6e-4 after 5 steps and 5e-2 after 10.  Cut to 3 steps,
the test holds the planner's wiring (the cache's K = 6 entries, the
violated rows, the lite gate, the raw residual); ``test_torch_refine``
holds the full loops on inputs where they are well conditioned.

The unsafe fixture is ``scripts/closed_loop_eval.py``'s: a neighbor box
riding the GT corridor two frames ahead of the ego, so the plan's 2-step
clearance drops below D_SAFE and the backup fires.

Tolerances: the plan tests' 1e-4 on controls, the first two states of a
rollout and progress; flags, step counts, repairs and lane-keep
compliance exactly.  A rollout's later states and the scores to 1e-3
(``test_torch_trajopt``'s bound for scores after Adam steps): a control
1e-5 apart, as the refinement's steps leave them, moves the 20-step
rollout (0.5 s steps at ~6 m/s) by up to ~1e-3 m at the horizon, which
the lane clauses read at tau = 100.
The backup residual after 50 Adam steps to 1e-4 (``test_torch_refine``).
The candidate-area metric, an occupancy count of 0.5 m x 0.5 m x heading
cells, to 1e-4 relative: a rollout 1e-4 away moves no cell here.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff, refine as jrefine, sim as jsim
from pstl_tpu import specs as jspecs
from pstl_tpu.config import Config as JConfig
from pstl_tpu_torch import diffusion as tdiff, refine as trefine
from pstl_tpu_torch import sim as tsim
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.models import convert
from pstl_tpu_torch.models.net import Net as TNet

from test_torch_plan import planner_setup
from torch_dense_case import jit_fast
from torch_parity import jax_episode_noise, jax_plan_noise, np_

TOL = 1e-4


def _close(a, b, tol=TOL, what=""):
    np.testing.assert_allclose(np_(a), np_(b), rtol=tol, atol=tol,
                               err_msg=what)


def first_unsafe_case():
    """``tests/test_sim.py``'s first-unsafe-neighbor fixture: scene 0 has
    slot 0 far, slots 1 and 2 unsafe at distinct poses (slot 2 nearer);
    scene 1 has every neighbor far away."""
    cfg = JConfig().finalize().with_(backup=True, backup_niters=50)
    bs, K, nt = 2, 3, cfg.nt
    ts = np.arange(nt + 1) * cfg.dt
    plan = np.zeros((bs, nt + 1, 4), np.float32)
    plan[:, :, 0] = 2.0 * ts
    plan[:, :, 3] = 2.0
    px = plan[0, 2, 0]
    nei = np.zeros((bs, K, nt, 7), np.float32)
    nei[:, :, :, 0] = 1.0
    nei[:, :, :, 5] = 4.0
    nei[:, :, :, 6] = 2.0
    nei[0, 0, :, 1] = 100.0
    nei[0, 1, :, 1] = px + 1.0
    nei[0, 2, :, 1] = px - 1.0
    nei[0, 2, :, 2] = 0.5
    nei[1, :, :, 1] = 200.0
    return cfg, plan, nei


def test_apply_backup_first_unsafe_neighbor():
    """The real 50-step solve against the first unsafe slot in slot order
    (slot 1, not the nearer slot 2); the safe scene keeps its plan."""
    cfg_j, plan, nei = first_unsafe_case()
    cfg_t = TConfig(**cfg_j.to_dict())
    u0 = np.ones((2, 2), np.float32)
    out_j, unsafe_j = jsim._apply_backup(
        jnp.asarray(u0), {"plan_traj": jnp.asarray(plan)},
        {"neighbor_trajs_aug": jnp.asarray(nei)}, cfg_j)
    out_t, unsafe_t = tsim._apply_backup(
        torch.as_tensor(u0), {"plan_traj": torch.as_tensor(plan)},
        {"neighbor_trajs_aug": torch.as_tensor(nei)}, cfg_t)
    np.testing.assert_array_equal(np_(unsafe_t), [True, False])
    np.testing.assert_array_equal(np_(unsafe_t), np_(unsafe_j))
    _close(out_t, out_j)
    np.testing.assert_array_equal(np_(out_t)[1], u0[1])

    def repaired_against(slot):
        res = trefine.solve_backup(
            torch.as_tensor(plan[:1, 0:3]), torch.zeros(1, 2, 2),
            torch.as_tensor(nei[:1, slot, 0:3]), cfg_t, n_iters=50)
        return np_(res[0, 0])

    np.testing.assert_allclose(np_(out_t)[0], repaired_against(1),
                               atol=1e-6)
    assert np.abs(repaired_against(2) - repaired_against(1)).max() > 1e-3


def test_backup_unsafe_only_equals_full_solve(monkeypatch):
    """Solving only the unsafe scenes gives the full solve's controls
    (every scene solved, the safe ones then discarded, as the JAX package
    does); with no unsafe scene nothing is solved."""
    cfg_j, plan, nei = first_unsafe_case()
    cfg = TConfig(**cfg_j.to_dict())
    plan = np.concatenate([plan, plan])
    nei = np.concatenate([nei, nei[::-1]])           # unsafe: 0, 3
    plan[2:, :, 0] += 0.3
    u0 = torch.as_tensor(np.random.RandomState(0).randn(4, 2).astype(
        np.float32))
    info = {"plan_traj": torch.as_tensor(plan)}
    obs = {"neighbor_trajs_aug": torch.as_tensor(nei)}
    out, unsafe = tsim._apply_backup(u0, info, obs, cfg)
    assert np_(unsafe).tolist() == [True, False, False, True]

    # the full solve, written out: every scene against its first unsafe
    # slot (slot 0 where none is unsafe), the safe scenes then discarded
    pt = info["plan_traj"]
    u01 = torch.stack([(pt[:, 1:3, 2] - pt[:, 0:2, 2]) / cfg.dt,
                       (pt[:, 1:3, 3] - pt[:, 0:2, 3]) / cfg.dt], -1)
    j = torch.tensor([1, 0, 0, 1])
    res = trefine.solve_backup(pt[:, 0:3], u01,
                               obs["neighbor_trajs_aug"][torch.arange(4), j,
                                                         0:3], cfg,
                               n_iters=cfg.backup_niters)
    full = torch.where(unsafe[:, None], u01[:, 0] + res[:, 0], u0)
    np.testing.assert_array_equal(np_(out), np_(full))

    def no_solve(*a, **k):
        raise AssertionError("a safe batch reached the solve")

    monkeypatch.setattr(trefine, "solve_backup", no_solve)
    safe = {"neighbor_trajs_aug": obs["neighbor_trajs_aug"][1:3]}
    out2, unsafe2 = tsim._apply_backup(
        u0[1:3], {"plan_traj": info["plan_traj"][1:3]}, safe, cfg)
    assert not bool(unsafe2.any())
    np.testing.assert_array_equal(np_(out2), np_(u0[1:3]))


def tame(case):
    """``planner_setup``'s case with the control head x0.01 and the
    RefineNet's output x0.1 in both packages' nets."""
    cfg_j, cfg_t, sc_j, sc_t, net_j, params, _ = case
    p = jax.tree_util.tree_map(np.array, params)
    head = p["params"]["policy_net"][f"Dense_{len(cfg_j.hiddens)}"]
    head["kernel"] = head["kernel"] * 0.01
    rect = p["params"]["rect_net"][f"Dense_{len(cfg_j.rect_hiddens)}"]
    rect["kernel"] = rect["kernel"] * 0.1
    net_t = TNet(cfg_t)
    net_t.load_state_dict(convert.from_flax(p))
    return (cfg_j, cfg_t, sc_j, sc_t, net_j,
            jax.tree_util.tree_map(jnp.asarray, p), net_t.eval())


@pytest.fixture(scope="module")
def setup():
    return tame(planner_setup(bs=3, scene_len=14, seed=2))


#: the refinement rows run unguided (the row-major sampler): the guidance
#: is held by test_torch_plan, and the JAX planner compiles faster without
PLANNERS = {
    "test_aggressive": ({}, jsim.TEST_AGGRESSIVE_STLPS),
    "refinement": (dict(refinement=True, guidance=False), None),
    "refinement_lite": (dict(refinement=True, lite_refine=True,
                             guidance=False), None),
    "raw_refinement": (dict(raw_refinement=True, guidance=False), None),
}


@pytest.mark.parametrize("variant", sorted(PLANNERS))
def test_planner_variants_match_jax(setup, variant, monkeypatch):
    """One plan step of the per-scene stlp presets and of each refinement
    branch (its loop cut to 3 steps): controls, scores, rollouts, the
    chosen plan and its first control, lane-keep compliance exactly."""
    for mod in (jrefine, trefine):
        for name in ("convex_refinement", "raw_refinement"):
            monkeypatch.setattr(mod, name, functools.partial(
                getattr(mod, name), n_iters=3))
    cfg_j, cfg_t, sc_j, sc_t, net_j, params, net_t = setup
    kw, override = PLANNERS[variant]
    cfg_j, cfg_t = cfg_j.with_(**kw), cfg_t.with_(**kw)
    np.testing.assert_array_equal(tsim.TEST_AGGRESSIVE_STLPS,
                                  jsim.TEST_AGGRESSIVE_STLPS)
    bs = sc_t.ego_full.shape[0]
    plan_j = jsim.make_planner(
        cfg_j, net_j, params, jspecs.build_scorer(cfg_j),
        jdiff.get_coeffs(cfg_j), stlp_override=override)
    obs_j = jax.vmap(lambda s, e, t: jsim.observe(s, e, t, cfg_j))(
        sc_j, sc_j.ego_full[:, 1], jnp.ones((bs,), jnp.int32))
    key = jax.random.PRNGKey(11)
    u0_j, info_j = jit_fast(plan_j, key, obs_j)

    obs_t = tsim.observe(sc_t, sc_t.ego_full[:, 1],
                         torch.ones(bs, dtype=torch.long), cfg_t)
    shape = ((bs, cfg_t.nt, 2, 3 * cfg_t.n_randoms) if cfg_t.guidance
             else (bs * 3 * cfg_t.n_randoms, cfg_t.nt * 2))
    noise = jax_plan_noise(key, cfg_t.diffusion_steps, shape)
    plan_t = tsim.make_planner(cfg_t, net_t, tdiff.get_coeffs(cfg_t),
                               stlp_override=override)
    u0_t, info_t = plan_t(obs_t, noise=noise)
    _close(info_t["controls"], info_j["controls"], what="controls")
    _close(info_t["scores"], info_j["scores"], 1e-3, what="scores")
    for k in ("trajs", "plan_traj"):
        _close(info_t[k][:, :2], info_j[k][:, :2], what=k)
        _close(info_t[k], info_j[k], 1e-3, what=k)
    _close(u0_t, u0_j)
    np.testing.assert_array_equal(np_(info_t["stl_acc"]),
                                  np_(info_j["stl_acc"]))


def unsafe_fixture(scenes, lib):
    """``scripts/closed_loop_eval.py``'s ``--unsafe-fixture`` on a scene
    batch of either package (neighbor slot 0 := the GT ego pose two frames
    ahead, a 6 m x 6 m box)."""
    nei = np.array(np_(scenes.nei_full))
    ego = np_(scenes.ego_full)
    T = ego.shape[1]
    ahead = ego[:, np.minimum(np.arange(T) + 2, T - 1)]
    nei[:, 0, :, 0] = 1.0
    nei[:, 0, :, 1:5] = ahead
    nei[:, 0, :, 5] = 6.0
    nei[:, 0, :, 6] = 6.0
    return scenes._replace(nei_full=lib(nei))


def test_run_closed_loop_backup_matches_jax(setup):
    """``run_closed_loop`` with the backup controller on the unsafe
    fixture, 3 steps: the repairs fire and every metric agrees."""
    cfg_j, cfg_t, sc_j, sc_t, net_j, params, net_t = setup
    cfg_j = cfg_j.with_(backup=True, backup_niters=50)
    cfg_t = cfg_t.with_(backup=True, backup_niters=50)
    sc_j = unsafe_fixture(sc_j, jnp.asarray)
    sc_t = unsafe_fixture(sc_t, torch.as_tensor)
    key = jax.random.PRNGKey(4)
    mj = jit_fast(lambda k: jsim.run_closed_loop(
        k, sc_j, cfg_j, net_j, params, jspecs.build_scorer(cfg_j),
        jdiff.get_coeffs(cfg_j), max_steps=3), key)
    bs = sc_t.ego_full.shape[0]
    noise = jax_episode_noise(key, 3, cfg_t.diffusion_steps,
                              (bs, cfg_t.nt, 2, 3 * cfg_t.n_randoms))
    mt = tsim.run_closed_loop(0, sc_t, cfg_t, net_t,
                              tdiff.get_coeffs(cfg_t), 3, noise=noise)
    assert sorted(mt) == sorted(mj)
    for k in ("collide", "out_of_lane", "traj_len", "repairs",
              "agent_steps"):
        np.testing.assert_array_equal(np_(mt[k]), np_(mj[k]), err_msg=k)
    for k in ("progress", "stl_acc"):
        _close(mt[k], mj[k], what=k)
    assert float(np_(mt["repairs"]).sum()) > 0


def test_run_closed_loop_host_record_matches_jax(setup):
    """``run_closed_loop_host(record=True)`` from per-scene start frames,
    both scenes at the end of their scene: the loop stops once both are
    done, and the metrics, the ego and plan history and the per-step area
    agree."""
    cfg_j, cfg_t, sc_j, sc_t, net_j, params, net_t = setup
    t0 = np.array([8, 9, 9], np.int32)
    key = jax.random.PRNGKey(6)
    oj = jsim.run_closed_loop_host(
        key, sc_j, cfg_j, net_j, params, jspecs.build_scorer(cfg_j),
        jdiff.get_coeffs(cfg_j), max_steps=6, record=True, t0=t0)
    bs = sc_t.ego_full.shape[0]
    noise = jax_episode_noise(key, 6, cfg_t.diffusion_steps,
                              (bs, cfg_t.nt, 2, 3 * cfg_t.n_randoms))
    ot = tsim.run_closed_loop_host(
        0, sc_t, cfg_t, net_t, tdiff.get_coeffs(cfg_t), max_steps=6,
        record=True, t0=t0, noise=noise)
    hj, ht = oj["history"], ot["history"]
    assert len(ht["ego"]) == len(hj["ego"]) < 7       # stopped early
    assert len(ht["step_s"]) == len(hj["step_s"]) == len(ht["area"])
    for k in ("ego", "plan"):
        _close(np.stack(ht[k]), np.stack(hj[k]), what=k)
    np.testing.assert_allclose(ht["area"], hj["area"], rtol=TOL)
    assert max(hj["area"]) > 0
    _close(ot["area"], oj["area"])
    for k in ("collide", "out_of_lane", "traj_len", "repairs"):
        np.testing.assert_array_equal(np_(ot[k]), np_(oj[k]), err_msg=k)
    for k in ("progress", "stl_acc"):
        _close(ot[k], oj[k], what=k)
    assert bool(np.all(np_(ot["traj_len"]) < 6))


def test_chunk_equals_single_steps(setup):
    """``chunk=2`` runs two bodies a call: the same carry as two calls of
    ``chunk=1`` on the same draws, bit for bit."""
    _, cfg_t, _, sc_t, _, _, net_t = setup
    coeffs = tdiff.get_coeffs(cfg_t)
    bs = sc_t.ego_full.shape[0]
    g = torch.Generator().manual_seed(0)
    noise = [torch.randn((cfg_t.diffusion_steps, bs, cfg_t.nt, 2,
                          3 * cfg_t.n_randoms), generator=g)
             for _ in range(4)]
    init1, step1 = tsim.make_closed_loop_step(sc_t, cfg_t, net_t, coeffs)
    init2, step2 = tsim.make_closed_loop_step(sc_t, cfg_t, net_t, coeffs,
                                              chunk=2)
    c1, c2 = init1(0), init2(0)
    for i in range(4):
        c1 = step1(c1, noise[i])
    for i in range(2):
        c2 = step2(c2, noise[2 * i:2 * i + 2])
    for a, b in zip(c1[:-1], c2[:-1]):
        np.testing.assert_array_equal(np_(a), np_(b))
    assert float(c1.steps.min()) == 4
    out = tsim.run_closed_loop_host(0, sc_t, cfg_t, net_t, coeffs, 4,
                                    chunk=2, noise=noise)
    assert len(out["repairs"]) == bs and "history" not in out
    for k, v in tsim._carry_metrics(c1).items():
        np.testing.assert_array_equal(np_(out[k]), np_(v), err_msg=k)


def test_render_dir_refused(setup, tmp_path):
    """``render_dir`` draws only a recorded run, as in the JAX package: a
    frame per step of each of the first four scenes and a GIF each."""
    _, cfg_t, _, sc_t, _, _, net_t = setup
    coeffs = tdiff.get_coeffs(cfg_t)
    tsim.run_closed_loop_host(0, sc_t, cfg_t, net_t, coeffs, 2,
                              render_dir=str(tmp_path / "off"))
    assert not (tmp_path / "off").exists()
    tsim.run_closed_loop_host(0, sc_t, cfg_t, net_t, coeffs, 2, record=True,
                              render_dir=str(tmp_path / "frames"))
    bs = min(sc_t.ego_full.shape[0], 4)
    assert sorted(os.listdir(tmp_path / "frames")) == sorted(
        [f"frame_s{i:02d}_t{t:03d}.png" for i in range(bs) for t in (1, 2)]
        + [f"episode_{i:02d}.gif" for i in range(bs)])
