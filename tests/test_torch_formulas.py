"""The port's maneuver formulas (``pstl_tpu_torch.specs.build_formulas``,
trees of ``ops/stl.py``) against the JAX package's, against the port's own
``ClauseBank``, and through every caller that takes ``formulas``:
``compute_scores`` (with and without the scene accuracy),
``make_score_rows(tiled_scorer=False)``, a trajopt loss and one planner
step.

The scenes are ``tests/test_specs.py``'s straight-lane batch (a GT
driving the current lane, a neighbor ahead in the left lane), the GT
perturbed so that scores span satisfied and violated rows, as
``tests/test_clause_bank.py`` does.

Tolerances.  The port's tree against JAX's on the same prepared signals:
``tests/test_torch_stl.py``'s (rtol 1e-5 / atol 2e-5 soft, equal hard).
Each package's own ``prep_signals`` first: the lane distances agree to
~1e-5 (``tests/test_torch_ops.py``), which tau = 100 carries into a score
unchanged: atol 1e-4.  The port's ``ClauseBank`` against its tree: the
JAX package's bank-vs-tree tolerances (``tests/test_clause_bank.py``),
2e-4 on scores and rtol 1e-3 / atol 1e-5 on gradients (the bank's suffix
scans sum in another order than the tree's masked windows).  Callers: the
tolerances of their own parity tests (``test_torch_ops.py``'s 1e-4 for
``make_score_rows``, ``test_torch_trajopt.py``'s for the loss,
``test_torch_plan.py``'s 1e-4 for the plan step).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff, refine as jrefine, sim as jsim
from pstl_tpu import specs as jspecs, trajopt as jtrajopt
from pstl_tpu.config import Config as JConfig
from pstl_tpu.ops import dynamics as jdyn
from pstl_tpu_torch import diffusion as tdiff, refine as trefine
from pstl_tpu_torch import sim as tsim, specs as tspecs, trajopt as ttrajopt
from pstl_tpu_torch.config import Config as TConfig

from test_specs import make_batch
from test_torch_plan import planner_setup
from test_torch_trajopt import _case
from torch_dense_case import jit_fast
from torch_mono_case import check_close
from torch_parity import F32, guidance_case, jax_plan_noise, np_, to_t

VAL = dict(rtol=1e-5, atol=2e-5)
BANK = dict(rtol=2e-4, atol=2e-4)
BANK_GRAD = dict(rtol=1e-3, atol=1e-5)
KEEP = ("alw_vmin", "alw_vmax", "alw_dmin", "alw_dmax", "alw_th",
        "alw_safe")


def _cfgs(**kw):
    cfg_j = JConfig(diffusion=True, n_randoms=4, n_neighbors=2, **kw)
    return cfg_j, TConfig(**cfg_j.to_dict())


@functools.lru_cache(maxsize=None)
def scene(bs=3, norm_stl=False, seed=0):
    """(raw signal inputs as numpy (the GT as ``ego_traj``, perturbed by
    0, 0.05 and 0.5 in turn: a scene's GT satisfies its lane keep, the
    others less or not; the calibrated stlp as (bs, 1, 6)), the GT
    high-level labels)."""
    cfg_j, _ = _cfgs(norm_stl=norm_stl)
    batch = make_batch(cfg_j, bs=bs)
    gt = batch["ego_traj"][..., :4]
    stlp = jspecs.calibrate_stlp(batch, gt, cfg_j)
    rng = np.random.RandomState(seed)
    scale = np.resize(np.array([0.0, 0.05, 0.5], F32), bs)[:, None, None]
    traj = gt + jnp.asarray(rng.randn(*gt.shape).astype(F32) * scale)
    raw = {"ego_traj": traj, "neighbors": batch["neighbor_trajs_aug"],
           "currlane_wpts": batch["currlane_wpts"],
           "leftlane_wpts": batch["leftlane_wpts"],
           "rightlane_wpts": batch["rightlane_wpts"],
           "stlp": stlp[:, None, :]}
    return ({k: np.asarray(v) for k, v in raw.items()},
            np.asarray(batch["gt_high_level"][:, 0]))


def prepped(raw, cfg_j):
    """JAX's prepared signals, as numpy and as torch tensors."""
    sj = jit_fast(lambda r: jspecs.prep_signals(r, cfg_j),
                  {k: jnp.asarray(v) for k, v in raw.items()})
    return sj, to_t({k: np.asarray(v) for k, v in sj.items()})


@pytest.mark.parametrize("norm_stl", [False, True])
@pytest.mark.parametrize("hard", [False, True])
def test_build_formulas_match_jax(norm_stl, hard):
    """Each formula's whole trace (n, T) and its clauses' traces
    (``ListAnd(full=True)``), on the same prepared signals; then each
    package on its own ``prep_signals``."""
    cfg_j, cfg_t = _cfgs(norm_stl=norm_stl)
    raw, _ = scene(norm_stl=norm_stl)
    sj, st = prepped(raw, cfg_j)
    tau = cfg_t.smoothing_factor
    fj, ft = jspecs.build_formulas(cfg_j), tspecs.build_formulas(cfg_t)
    assert [str(f) for f in ft] == [str(f) for f in fj]
    tol = dict(rtol=0, atol=0) if hard else VAL
    own = tspecs.prep_signals(to_t(raw), cfg_t)
    for i, (a, b) in enumerate(zip(ft, fj)):
        s_t, v_t = a(st, tau, hard, full=True)
        s_j, v_j = jit_fast(lambda x: b(x, tau, hard, full=True), sj)
        np.testing.assert_allclose(np_(v_t), np.asarray(v_j), **tol,
                                   err_msg=f"formula {i} clauses")
        np.testing.assert_allclose(np_(s_t), np.asarray(s_j), **tol,
                                   err_msg=f"formula {i}")
        np.testing.assert_allclose(np_(a.robustness(own, tau, hard)),
                                   np.asarray(s_j)[:, 0], rtol=1e-4,
                                   atol=1e-4, err_msg=f"formula {i} own")
    scores = np.stack([np_(a.robustness(st, tau, hard)) for a in ft])
    assert (scores > 0).any() and (scores < 0).any()


@pytest.mark.parametrize("norm_stl", [False, True])
@pytest.mark.parametrize("hard", [False, True])
def test_bank_matches_tree(norm_stl, hard):
    """``tests/test_clause_bank.py``'s check in the port: the production
    ``ClauseBank`` against the tree it fuses."""
    _, cfg_t = _cfgs(norm_stl=norm_stl)
    raw, _ = scene(norm_stl=norm_stl)
    sig = tspecs.prep_signals(to_t(raw), cfg_t)
    tau = cfg_t.smoothing_factor
    want = [f(sig, tau, hard)[:, 0] for f in tspecs.build_formulas(cfg_t)]
    got = tspecs.build_scorer(cfg_t).scores(sig, tau, hard)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(np_(g), np_(w), **BANK,
                                   err_msg=f"formula {i}")


@pytest.mark.parametrize("norm_stl", [False, True])
def test_bank_gradients_match_tree(norm_stl):
    """d hinge / d ego_traj through ``compute_scores``: the bank against
    the tree, and the tree against jax.grad of JAX's tree."""
    cfg_j, cfg_t = _cfgs(norm_stl=norm_stl)
    raw, hl = scene(bs=2, norm_stl=norm_stl)
    traj0 = raw["ego_traj"]
    mask = np.ones((2,), F32)

    def tloss(traj, scorer):
        sig = dict(to_t(raw), ego_traj=traj)
        _, s, _ = tspecs.compute_scores(sig, scorer, torch.as_tensor(hl),
                                        torch.as_tensor(mask), cfg_t)
        return torch.mean(torch.relu(0.01 - s))

    def tgrad(scorer):
        x = torch.as_tensor(traj0).requires_grad_(True)
        g, = torch.autograd.grad(tloss(x, scorer), x)
        return np_(g)

    g_tree = tgrad(tspecs.build_formulas(cfg_t))
    g_bank = tgrad(tspecs.build_scorer(cfg_t))
    assert np.abs(g_tree).sum() > 0
    np.testing.assert_allclose(g_bank, g_tree, **BANK_GRAD)

    def jloss(traj):
        sig = dict({k: jnp.asarray(v) for k, v in raw.items()},
                   ego_traj=traj)
        _, s, _ = jspecs.compute_scores(sig, jspecs.build_formulas(cfg_j),
                                        jnp.asarray(hl), jnp.asarray(mask),
                                        cfg_j)
        return jnp.mean(jax.nn.relu(0.01 - s))

    g_j = np.asarray(jit_fast(jax.grad(jloss), jnp.asarray(traj0)))
    check_close(g_tree, g_j, False, "tree gradient", rtol=1e-4, floor=1e-5)


@pytest.mark.parametrize("hard", [False, True])
def test_clause_breakdown(hard):
    """The ten clauses by name, against JAX's breakdown and against the
    tree's clauses at t = 0; the hard keep conjunction is formula 0."""
    cfg_j, cfg_t = _cfgs()
    raw, _ = scene()
    sj, st = prepped(raw, cfg_j)
    tau = cfg_t.smoothing_factor
    bank = tspecs.build_scorer(cfg_t)
    br = bank.clause_breakdown(st, tau, hard)
    br_j = jspecs.build_scorer(cfg_j).clause_breakdown(sj, tau, hard)
    assert list(br) == list(tspecs.ClauseBank.CLAUSES)
    assert set(br) == set(br_j)
    for k in br:
        np.testing.assert_allclose(np_(br[k]), np.asarray(br_j[k]), **VAL,
                                   err_msg=k)
    fs = tspecs.build_formulas(cfg_t)
    _, v_keep = fs[0](st, tau, hard, full=True)
    _, v_left = fs[1](st, tau, hard, full=True)
    _, v_right = fs[2](st, tau, hard, full=True)
    tree = dict(zip(KEEP, v_keep[..., 0].unbind(1)))
    tree.update(reach_left_d=v_left[:, 2, 0], reach_left_th=v_left[:, 3, 0],
                reach_right_d=v_right[:, 2, 0],
                reach_right_th=v_right[:, 3, 0])
    for k, v in tree.items():
        np.testing.assert_allclose(np_(br[k]), np_(v), **BANK, err_msg=k)
    if hard:
        keep = torch.amin(torch.stack([br[k] for k in KEEP]), 0)
        np.testing.assert_array_equal(np_(keep),
                                      np_(bank.scores(st, tau, True)[0]))


def dense_rows(cfg_j, bs=3, norm_stl=False, seed=1):
    """A dense-layout scoring case: bs scenes x n_randoms x 3 rows of
    ``scene``'s signals (every row a copy of scene ``r // (M * 3)``), the
    maneuver labels tiled [0, 1, 2] with a few outlier rows (3) and a random
    mask; numpy."""
    M = cfg_j.n_randoms
    raw, _ = scene(bs=bs, norm_stl=norm_stl)
    n = bs * M * 3
    rng = np.random.RandomState(seed)
    rows = {k: np.repeat(v, M * 3, 0) for k, v in raw.items()}
    rows["ego_traj"] = rows["ego_traj"] + (rng.randn(
        *rows["ego_traj"].shape) * 0.2).astype(F32)
    idx = np.tile(np.arange(3, dtype=F32), n // 3)
    idx[rng.rand(n) < 0.1] = 3.0
    mask = (rng.rand(n) > 0.2).astype(F32)
    return rows, idx, mask


@pytest.mark.parametrize("norm_stl", [False, True])
@pytest.mark.parametrize("scene_acc", [False, True])
@pytest.mark.parametrize("hard", [False, True])
def test_compute_scores_with_the_tree(norm_stl, scene_acc, hard):
    """``compute_scores`` with ``build_formulas``' list: the scores list,
    the selected scores (label 3 -> +1), the accuracy and, with ``scene``,
    the scene accuracy, against JAX; the list gives the bank's numbers."""
    cfg_j, cfg_t = _cfgs(norm_stl=norm_stl)
    rows, idx, mask = dense_rows(cfg_j, norm_stl=norm_stl)
    kw = dict(hard=hard, scene=scene_acc)
    out_t = tspecs.compute_scores(
        to_t(rows), tspecs.build_formulas(cfg_t), torch.as_tensor(idx),
        torch.as_tensor(mask), cfg_t, **kw)
    out_j = jit_fast(lambda r, i, m: jspecs.compute_scores(
        r, jspecs.build_formulas(cfg_j), i, m, cfg_j, **kw),
        {k: jnp.asarray(v) for k, v in rows.items()}, jnp.asarray(idx),
        jnp.asarray(mask))
    assert len(out_t) == len(out_j) == (4 if scene_acc else 3)
    for a, b in zip(out_t[0], out_j[0]):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(np_(out_t[1]), np.asarray(out_j[1]),
                               rtol=1e-4, atol=1e-4)
    s = np_(out_t[1])
    assert np.all(s[idx == 3] == 1.0) and (s > 0).any() and (s < 0).any()
    for a, b, what in zip(out_t[2:], out_j[2:], ("acc", "scene_acc")):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, err_msg=what)
    bank = tspecs.compute_scores(
        to_t(rows), tspecs.build_scorer(cfg_t), torch.as_tensor(idx),
        torch.as_tensor(mask), cfg_t, **kw)
    np.testing.assert_allclose(np_(bank[1]), s, **BANK)


@pytest.mark.parametrize("norm_stl", [False, True])
def test_score_rows_with_the_tree(norm_stl):
    """``make_score_rows(tiled_scorer=False, formulas=list)`` on the
    planner's dense layout against JAX's, and against the port's
    ``TiledScorer`` (the same numbers)."""
    bs, M, nt = 2, 4, 20
    flags = dict(n_randoms=M, n_neighbors=3, nt=nt, norm_stl=norm_stl,
                 tiled_scorer=False)
    cfg_j, cfg_t = JConfig(**flags), TConfig(**flags)
    batch, gt_stlp, stlp, states, _ = guidance_case(4, bs, M, nt, 3, 15)
    dj = jspecs.densify_batch({k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.asarray(gt_stlp), cfg_j,
                              stlp_dense=jnp.asarray(stlp))
    dt = tspecs.densify_batch(to_t(batch), torch.as_tensor(gt_stlp), cfg_t,
                              torch.as_tensor(stlp))
    rng = np.random.RandomState(5)
    us = (rng.randn(bs * M * 3, nt, 2) * [0.2, 1.5]).astype(F32)
    tr = jdyn.rollout(jnp.asarray(np.repeat(states, M * 3, 0)),
                      jnp.asarray(us), 0.5)[:, :-1]
    trt = torch.as_tensor(np.array(tr))
    sj = jspecs.make_score_rows(dj, dj, cfg_j, jspecs.build_formulas(cfg_j))
    st = tspecs.make_score_rows(dt, dt, cfg_t,
                                formulas=tspecs.build_formulas(cfg_t))
    got = np_(st(trt))
    np.testing.assert_allclose(got, np.asarray(jit_fast(sj, tr)), rtol=1e-4,
                               atol=1e-4)
    tiled = tspecs.make_score_rows(dt, dt, cfg_t.with_(tiled_scorer=True))
    np.testing.assert_allclose(got, np_(tiled(trt)), **BANK)


def test_trajopt_loss_with_the_tree():
    """One ``trajopt_loss`` (K = 4 draws, tau 30) and its gradient with
    the tree in both packages (``tests/test_torch_trajopt.py``'s case)."""
    cfg_j, cfg_t, p0, (st_j, sb_j, hl_j, dr_j), (st_t, sb_t, hl_t, dr_t) = \
        _case(4)
    bs, M = p0.shape[:2]
    n = bs * M * 3
    rng = np.random.RandomState(2)
    p = p0.copy()
    p[:, 1:] += (rng.randn(*p[:, 1:].shape) * [0.05, 1.0]).astype(F32)
    p = p.reshape(n, cfg_j.nt, 2)
    fj = jspecs.build_formulas(cfg_j)

    def jloss(x):
        return jtrajopt.trajopt_loss(x, jnp.repeat(st_j, M * 3, 0), sb_j,
                                     hl_j, fj, cfg_j, tau=30.0,
                                     stlp_draws=dr_j)

    (lj, aux_j), gj = jit_fast(jax.value_and_grad(jloss, has_aux=True),
                               jnp.asarray(p))
    x = torch.as_tensor(p).requires_grad_(True)
    lt, aux_t = ttrajopt.trajopt_loss(
        x, torch.repeat_interleave(st_t, M * 3, 0), sb_t, hl_t,
        tspecs.build_formulas(cfg_t), cfg_t, tau=30.0, stlp_draws=dr_t)
    gt, = torch.autograd.grad(lt, x)
    check_close(lt.detach(), lj, False, "loss")
    check_close(aux_t["scores"].detach(), aux_j["scores"], False, "scores")
    check_close(gt, gj, False, "grad", rtol=1e-4, floor=1e-5)
    s = np.asarray(aux_j["scores"])
    assert (s > cfg_j.stl_trajopt_thres).any() and (s < 0).any()


#: the planner rows: guided by the row-major fallback loss (no fused loss
#: without the tiled scorer) and, unguided, the convex refinement (its loop
#: cut to 3 steps, as tests/test_torch_closed_loop.py cuts it)
PLAN_ROWS = {"guided": {}, "refinement": dict(refinement=True,
                                              guidance=False)}


@pytest.mark.parametrize("row", sorted(PLAN_ROWS))
def test_plan_step_with_the_tree(row, monkeypatch):
    """One plan step with ``tiled_scorer=False`` and the tree
    (``make_planner(formulas=)``) against JAX's
    ``make_planner(formulas=build_formulas(cfg))``: controls, scores,
    rollouts, the chosen first control and the compliance."""
    for mod in (jrefine, trefine):
        monkeypatch.setattr(mod, "convex_refinement", functools.partial(
            mod.convex_refinement, n_iters=3))
    cfg_j, cfg_t, sc_j, sc_t, net_j, params, net_t = planner_setup(
        bs=2, scene_len=14, seed=0)
    kw = dict(tiled_scorer=False, guidance_pallas=False,
              guidance_pallas_fuse_freeze=False, guidance_fused_loss=False,
              multi_cands=2, n_rolls=1, **PLAN_ROWS[row])
    cfg_j, cfg_t = cfg_j.with_(**kw), cfg_t.with_(**kw)
    bs = sc_t.ego_full.shape[0]
    plan_j = jsim.make_planner(cfg_j, net_j, params,
                               jspecs.build_formulas(cfg_j),
                               jdiff.get_coeffs(cfg_j))
    obs_j = jax.vmap(lambda s, e, t: jsim.observe(s, e, t, cfg_j))(
        sc_j, sc_j.ego_full[:, 0], jnp.zeros((bs,), jnp.int32))
    key = jax.random.PRNGKey(5)
    u0_j, info_j = jit_fast(plan_j, key, obs_j)
    obs_t = tsim.observe(sc_t, sc_t.ego_full[:, 0],
                         torch.zeros(bs, dtype=torch.long), cfg_t)
    noise = jax_plan_noise(key, cfg_t.diffusion_steps,
                           tdiff.draw_layout(cfg_t, bs, 3 * cfg_t.n_randoms))
    plan_t = tsim.make_planner(cfg_t, net_t, tdiff.get_coeffs(cfg_t),
                               formulas=tspecs.build_formulas(cfg_t))
    u0_t, info_t = plan_t(obs_t, noise=noise)
    for k in ("controls", "scores", "trajs", "plan_traj"):
        np.testing.assert_allclose(np_(info_t[k]), np_(info_j[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(np_(u0_t), np_(u0_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np_(info_t["stl_acc"]),
                                  np_(info_j["stl_acc"]))
    # the default planner scores with the bank: the same plan
    u0_b, _ = tsim.make_planner(cfg_t, net_t, tdiff.get_coeffs(cfg_t))(
        obs_t, noise=noise)
    np.testing.assert_allclose(np_(u0_b), np_(u0_t), rtol=1e-4, atol=1e-4)


def test_train_step_and_eval_row_take_the_tree():
    """``formulas`` as the tree through the dense and mono train steps
    (the trajopt targets' scores, the mono rollouts' scores) and the eval's
    trajopt row: the bank's numbers, within the bank-vs-tree tolerance."""
    from pstl_tpu_torch import eval_openloop, train as ttrain
    from pstl_tpu_torch.config import PRESETS, mono_config
    from pstl_tpu_torch.data.dataset import SceneDataset, batch_iterator
    from pstl_tpu_torch.models.net import Net

    dense = PRESETS["e5_ddpm"].with_(
        exp_name=None, hiddens=(8,), n_randoms=2, diffusion_steps=4,
        n_neighbors=3)
    mono = mono_config("e2_vae_mono", hiddens=(8,), vae_dim=4, n_randoms=2,
                       n_neighbors=3, stl_weight=1.0)
    for cfg in (dense, mono):
        ds = SceneDataset.from_synthetic(cfg, n_scenes=4)
        ds.ensure_random_params(0)
        batch = ttrain.to_device(next(batch_iterator(ds, "train", 2,
                                                     shuffle=False)), "cpu")
        torch.manual_seed(0)
        net = Net(cfg)
        out = {}
        for name, form in (("tree", tspecs.build_formulas(cfg)),
                           ("bank", tspecs.build_scorer(cfg))):
            gen = torch.Generator().manual_seed(3)
            _, rd = ttrain.batch_forward_and_loss(
                net, batch, cfg, form, tdiff.get_coeffs(cfg), True,
                generator=gen)
            out[name] = rd
            if cfg is dense:
                tj = eval_openloop._trajopt_row(
                    net, batch, cfg, form,
                    generator=torch.Generator().manual_seed(4))
                out[name + " eval"] = {k: tj[k] for k in ("acc", "scores")}
        for k, v in out["tree"].items():
            np.testing.assert_allclose(np_(v), np_(out["bank"][k]), **BANK,
                                       err_msg=k)
        if cfg is dense:
            for k in ("acc", "scores"):
                np.testing.assert_allclose(np_(out["tree eval"][k]),
                                           np_(out["bank eval"][k]), **BANK,
                                           err_msg=k)
