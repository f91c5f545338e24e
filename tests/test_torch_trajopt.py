"""``pstl_tpu_torch.trajopt`` against ``pstl_tpu.trajopt`` on the CPU: the
loss and its gradient, the learning-rate / temperature / bias-correction
schedules, ``optimize`` and ``augment_dataset`` with the JAX package's own
flex draws handed to the port (``trajopt.batch_draws``' layout, replayed
from the JAX key chain).

Small size: the ``e1_trajopt`` preset with n_randoms 2-4, 3 neighbors, 3-5
synthetic scenes whose seed 0 holds the GT controls (so each labelled
maneuver has a row that satisfies its spec and one hinge is inactive).

Tolerances.  The loss to rtol 1e-5.  Gradients to rtol 1e-4 with a floor
of 1e-5 of the tensor's largest entry (``torch_dense_case``'s, for the
same reason: the lane-change rows' Eventually-Always clauses run a reverse
logcumsumexp of values x tau, sequential here and associative in JAX).
The schedules: every entry within 2 ulp of its table's largest entry (the
port's float32 ``cos`` and ``pow`` are not XLA's and differ by an ulp; near
the end of the decay 1 + cos cancels, so the learning rate's own ulp is too
fine a unit).  After 20-40 Adam steps the controls to atol 1e-4: Adam's
update is g / (|g| + eps)-like, so where |g| is tiny an ulp-level gradient
difference moves a step by a part of the learning rate (0.015); the
scores to atol 1e-3, since a 1e-4 difference in a control moves the 2 s
rollout, whose positions the lane clauses read at tau = 100, by up to
about that.  The augmentation's columns:
the same bounds; the persisted draw (``pre_stlp``) to 1e-6 (the same
best-of-K choice in every row), and the oracle rates (``trajopt_stats``)
equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import specs as jspecs, trajopt as jtrajopt
from pstl_tpu.config import PRESETS as JPRESETS
from pstl_tpu.data.dataset import SceneDataset as JDataset
from pstl_tpu_torch import specs as tspecs, trajopt as ttrajopt
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.data.dataset import SceneDataset as TDataset

from chip_smoke import with_gt_seed
from torch_dense_case import flex_draws, jit_fast
from torch_mono_case import check_close
from torch_parity import np_, to_t

SCORE_ATOL, PARAM_ATOL = 1e-3, 1e-4


def _cfg(K=4, nonneg=0.0, **kw):
    cfg_j = JPRESETS["e1_trajopt"].with_(
        exp_name=None, n_randoms=kw.pop("n_randoms", 3), n_neighbors=3,
        trajopt_robust_draws=K, trajopt_nonneg_speed=nonneg, **kw)
    return cfg_j, TConfig(**cfg_j.to_dict())


def _case(K=4, nonneg=0.0, bs=3, seed=0):
    """Both packages' optimize inputs on one batch: (cfg_j, cfg_t, params0,
    jax inputs, torch inputs), each inputs (states, signal_base, highlevel,
    stlp_draws)."""
    return _cfg(K, nonneg) + _inputs(K, bs, seed)


@functools.lru_cache(maxsize=None)
def _inputs(K, bs, seed):
    cfg_j, cfg_t = _cfg(K)
    ds = JDataset.from_synthetic(cfg_j, seed=seed, n_scenes=bs)
    ds.ensure_random_params(seed)
    b = with_gt_seed(ds.gather(np.arange(bs)), cfg_j)
    b["neighbor_trajs_aug"] = b["neighbors_traj"]
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), K)
    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            bb = {k: jnp.asarray(v) for k, v in b.items()}
            stlp = jspecs.calibrate_stlp(bb, bb["ego_traj"][..., :4], cfg_j)
            dense = jspecs.densify_batch(bb, stlp, cfg_j, key=keys[0])
            sb = jspecs.dense_signal_input(dense, cfg=cfg_j)
            draws = [dense["stlp_dense"]] + [
                jspecs.get_dense_stlp(k, bb["gt_high_level"], stlp, cfg_j)
                for k in keys[1:]]
            draws = jnp.stack(draws)
        else:
            bb = to_t({k: v for k, v in b.items()
                       if v.dtype != np.float64})
            stlp = tspecs.calibrate_stlp(bb, bb["ego_traj"][..., :4], cfg_t)
            flex = [flex_draws(cfg_j, k, bs) for k in keys]
            dense = tspecs.densify_batch(bb, stlp, cfg_t, flex=flex[0])
            sb = tspecs.dense_signal_input(dense, cfg=cfg_t)
            draws = torch.stack([dense["stlp_dense"]] + [
                tspecs.get_dense_stlp(bb["gt_high_level"], stlp, cfg_t,
                                      flex=f) for f in flex[1:]])
        out.append((bb["ego_traj"][:, 0, :4], sb, dense["highlevel_dense"],
                    draws))
    return b["params"], out[0], out[1]


@pytest.mark.parametrize("K,nonneg", [(1, 0.0), (1, 2.0), (4, 0.0),
                                      (4, 2.0)],
                         ids=["K1", "K1_nonneg", "K4", "K4_nonneg"])
def test_trajopt_loss_and_grad(K, nonneg):
    """K = 1: the single-draw path (``stlp_draws=None``); K = 4: the
    weighted hinge over four draws.  Value, aux and jax.grad at tau 30
    (mid-anneal) on the GT-seeded controls, the random seeds perturbed."""
    cfg_j, cfg_t, p0, (st_j, sb_j, hl_j, dr_j), (st_t, sb_t, hl_t, dr_t) = \
        _case(K, nonneg)
    bs, M = p0.shape[:2]
    n = bs * M * 3
    # seed 0 keeps the GT controls (satisfied rows, inactive hinge), the
    # others move off their random draws
    rng = np.random.RandomState(2)
    p = p0.copy()
    p[:, 1:] += (rng.randn(*p[:, 1:].shape) * [0.05, 1.0]).astype(np.float32)
    p = p.reshape(n, cfg_j.nt, 2)
    sf_j = jnp.repeat(st_j, M * 3, 0)
    sf_t = torch.repeat_interleave(st_t, M * 3, 0)
    use_draws = K > 1

    def jloss(x):
        return jtrajopt.trajopt_loss(x, sf_j, sb_j, hl_j,
                                     jspecs.build_scorer(cfg_j), cfg_j,
                                     tau=30.0,
                                     stlp_draws=dr_j if use_draws else None)

    (lj, aux_j), gj = jit_fast(jax.value_and_grad(jloss, has_aux=True),
                               jnp.asarray(p))
    x = torch.as_tensor(p).requires_grad_(True)
    lt, aux_t = ttrajopt.trajopt_loss(
        x, sf_t, sb_t, hl_t, tspecs.build_scorer(cfg_t), cfg_t, tau=30.0,
        stlp_draws=dr_t if use_draws else None)
    gt, = torch.autograd.grad(lt, x)
    check_close(lt.detach(), lj, False, "loss")
    for k in ("dense_loss", "reg_loss", "scores", "trajs"):
        check_close(aux_t[k].detach(), aux_j[k], False, k)
    check_close(gt, gj, False, "grad", rtol=1e-4, floor=1e-5)
    s = np.asarray(aux_j["scores"])
    assert (s > cfg_j.stl_trajopt_thres).any() and (s < 0).any()
    if nonneg:
        assert float(jnp.min(aux_j["trajs"][..., 3])) < 0


@pytest.mark.parametrize("iters", [20, 2000])
def test_schedules_match_optax(iters):
    """The learning rate optax's cosine schedule gives at counts 0..iters-1
    (negated: optax's step size), Adam's bias corrections 1 - b**count
    (count 1..iters, int32 as optax keeps it) and the annealed tau, each
    within 2 ulp of its table's largest entry."""
    import optax
    cfg_j, cfg_t = _cfg()
    sch = ttrajopt.schedules(cfg_t, iters)
    sched = optax.cosine_decay_schedule(cfg_j.trajopt_lr * 3.0, iters,
                                        alpha=0.02)
    count = jnp.arange(iters)
    cnt1 = jnp.arange(1, iters + 1, dtype=jnp.int32)
    tau_final = cfg_j.smoothing_factor
    tau_start = min(10.0, tau_final)

    def tau(i):
        frac = i.astype(jnp.float32) / max(iters - 1, 1)
        return tau_start * (tau_final / tau_start) ** frac

    want = {"step": jax.vmap(lambda c: -sched(c))(count),
            "bc1": jax.vmap(lambda c: 1 - 0.9 ** c)(cnt1),
            "bc2": jax.vmap(lambda c: 1 - 0.999 ** c)(cnt1),
            "tau": jax.vmap(tau)(count)}
    for k, w in want.items():
        w = np.asarray(w)
        got = getattr(sch, k)
        assert got.dtype == w.dtype == np.float32, k
        ulps = (np.abs(got.astype(np.float64) - w)
                / np.spacing(np.abs(w).max()))
        assert ulps.max() <= 2, (k, ulps.max())
    assert sch.tau[0] == 10.0 and abs(sch.tau[-1] - 100.0) < 1e-4


def test_optimize_20_iterations():
    """20 Adam steps from the GT-seeded random controls under 4 draws."""
    cfg_j, cfg_t, p0, (st_j, sb_j, hl_j, dr_j), (st_t, sb_t, hl_t, dr_t) = \
        _case(K=4)
    pj, sj, aux_j = jit_fast(lambda p, st, sb, hl, d: jtrajopt.optimize(
        p, st, sb, hl, jspecs.build_scorer(cfg_j), cfg_j, iters=20,
        stlp_draws=d), jnp.asarray(p0), st_j, sb_j, hl_j, dr_j)
    pt, s_t, aux_t = ttrajopt.optimize(
        torch.as_tensor(p0), st_t, sb_t, hl_t, tspecs.build_scorer(cfg_t),
        cfg_t, iters=20, stlp_draws=dr_t)
    assert pt.shape == tuple(pj.shape) and s_t.shape == tuple(sj.shape)
    np.testing.assert_allclose(np_(pt), np.asarray(pj), rtol=0,
                               atol=PARAM_ATOL)
    np.testing.assert_allclose(np_(s_t), np.asarray(sj), rtol=0,
                               atol=SCORE_ATOL)
    for k in aux_j:
        check_close(aux_t[k], aux_j[k], False, k, rtol=1e-4)
    moved = float(np.abs(np.asarray(pj) - p0).max())
    assert moved > 0.1, moved


def jax_augment_draws(cfg, seed, n, batch_size, K, epochs):
    """The flex draws ``pstl_tpu.trajopt.augment_dataset`` makes from
    PRNGKey(seed), in ``trajopt.batch_draws``' layout: per batch, the
    densify key, K-1 extra keys and the fresh key split off in turn."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(epochs):
        for i0 in range(0, n, batch_size):
            rows = min(i0 + batch_size, n) - i0
            bs = min(rows + rows, batch_size)        # the JAX padding
            key, k_d = jax.random.split(key)
            extra = []
            for _ in range(K - 1):
                key, k_k = jax.random.split(key)
                extra.append(flex_draws(cfg, k_k, bs))
            key, k_f = jax.random.split(key)
            out.append({"densify": flex_draws(cfg, k_d, bs), "extra": extra,
                        "fresh": flex_draws(cfg, k_f, bs)})
    return out


@pytest.mark.parametrize("n,batch_size,epochs", [(4, 4, 1), (5, 3, 2)],
                         ids=["epochs1", "epochs2_padded_tail"])
def test_augment_dataset_with_jax_draws(n, batch_size, epochs):
    """n_randoms 2, K=2, 20 iterations, the GT controls in seed 0: 4 scenes
    in one batch, one epoch; 5 scenes in batches of 3 (the tail padded to
    [3, 4, 3]), two epochs (the second warm-started).  The three columns
    and the stats."""
    K = 2
    cfg_j, cfg_t = _cfg(K, n_randoms=2)
    dss = []
    for cls, cfg in ((JDataset, cfg_j), (TDataset, cfg_t)):
        ds = cls.from_synthetic(cfg, seed=0, n_scenes=n)
        ds.ensure_random_params(0)
        ds.attach("params", with_gt_seed(ds.data, cfg)["params"])
        dss.append(ds)
    dj, dt = dss
    kw = dict(batch_size=batch_size, iters=20, seed=3, verbose=False,
              epochs=epochs)
    jtrajopt.augment_dataset(dj, cfg_j, jspecs.build_scorer(cfg_j), **kw)
    ttrajopt.augment_dataset(
        dt, cfg_t, tspecs.build_scorer(cfg_t), device="cpu",
        draws=jax_augment_draws(cfg_j, 3, n, batch_size, K, epochs), **kw)
    a, b = dt.data, dj.data
    assert a["params"].shape == b["params"].shape == (n, 2, 3, cfg_t.nt, 2)
    assert a["pre_stlp"].shape == b["pre_stlp"].shape == (n, 2, 3, 1, 6)
    assert a["tj_scores_prior"].shape == (n, 2, 3)
    np.testing.assert_allclose(a["params"], b["params"], rtol=0,
                               atol=PARAM_ATOL)
    np.testing.assert_allclose(a["tj_scores_prior"], b["tj_scores_prior"],
                               rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(a["params_init"], b["params_init"])
    np.testing.assert_allclose(a["pre_stlp"], b["pre_stlp"], rtol=0,
                               atol=1e-6)
    assert dt.trajopt_stats == dj.trajopt_stats
    assert dt.trajopt_stats["acc_seen"] > 0


def test_short_tail_pads_as_jax_and_completes():
    """A tail shorter than half a batch: the JAX package pads it to twice
    its length (``idx[:batch_size - len(idx)]``), then reshapes by the full
    batch size and raises; the port reshapes by the padded length.  One
    scene in a batch of 3: two rows."""
    cfg_j, cfg_t = _cfg(1, n_randoms=2)
    dj = JDataset.from_synthetic(cfg_j, seed=0, n_scenes=1)
    with pytest.raises(ValueError, match="reshape"):
        jtrajopt.augment_dataset(dj, cfg_j, jspecs.build_scorer(cfg_j),
                                 batch_size=3, iters=1, verbose=False)
    dt = TDataset.from_synthetic(cfg_t, seed=0, n_scenes=1)
    ttrajopt.augment_dataset(
        dt, cfg_t, tspecs.build_scorer(cfg_t), batch_size=3, iters=1,
        verbose=False, device="cpu",
        draws=jax_augment_draws(cfg_j, 0, 1, 3, 1, 1))
    assert np.isfinite(dt.data["params"]).all()
    assert dt.data["pre_stlp"].shape == (1, 2, 3, 1, 6)


def test_augment_runs_on_the_card_by_default():
    """Without ``device`` the augmentation runs on the card, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, cfg_t = _cfg(1, n_randoms=2)
    dt = TDataset.from_synthetic(cfg_t, seed=0, n_scenes=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrajopt.augment_dataset(dt, cfg_t, tspecs.build_scorer(cfg_t),
                                 batch_size=2, iters=1, verbose=False)
