"""The dense step's pSTL draws and batching against ``pstl_tpu.specs``:
``generate_flex_pstl`` and ``get_dense_stlp`` under the JAX keys' own
uniforms (injected), the three branches of ``densify_batch`` (the caller's
``stlp_dense``, the ``pre_stlp`` column, the flex draw),
``dense_signal_input`` with its hoisted discs and norm factors,
``repeat_n`` and ``detach``, ``compute_scores`` on the "discs" route and
``make_score_rows`` without the tiled scorer.  Every draw and every tensor
built from the same numbers is exact, but the neighbor discs, whose cos /
sin XLA and PyTorch round apart by a few ulps (rtol 1e-6, atol 1e-6);
scores to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import specs as jspecs, train as jtrain
from pstl_tpu.config import PRESETS
from pstl_tpu.data.dataset import SceneDataset, batch_iterator
from pstl_tpu.ops import dynamics as jdyn
from pstl_tpu_torch import specs as tspecs, train as ttrain
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.ops import dynamics as tdyn
from pstl_tpu_torch.ops.geometry import NeighborDiscs

from torch_dense_case import SMALL, flex_draws
from torch_parity import np_


def case(preset="e5_ddpm", **kw):
    """(cfg, JAX batch, port batch, calibrated stlp (JAX)) of a synthetic
    batch with labels 0-3 and neighbors attached on both sides."""
    cfg = PRESETS[preset].with_(**SMALL, **kw)
    ds = SceneDataset.from_synthetic(cfg, seed=1, n_scenes=12)
    ds.ensure_random_params(cfg.seed)
    b = {k: v for k, v in next(batch_iterator(
        ds, "train", 4, shuffle=False)).items() if k.startswith(ttrain.COLS)}
    b["gt_high_level"] = np.array([[0.], [1.], [2.], [3.]], np.float32)
    jb = jtrain.attach_neighbors({k: jnp.asarray(v) for k, v in b.items()},
                                 cfg)
    tb = ttrain.attach_neighbors(ttrain.to_device(b, "cpu"),
                                 TConfig(**cfg.to_dict()))
    stlp = jspecs.calibrate_stlp(jb, jb["ego_traj"][..., :4], cfg)
    return cfg, jb, tb, stlp


def exact(got, want, what=""):
    np.testing.assert_array_equal(np_(got), np.asarray(want), err_msg=what)


@pytest.mark.parametrize("hl", [0, 1, 2])
def test_generate_flex_pstl_exact(hl):
    rng = np.random.RandomState(hl)
    mid = np.stack([rng.uniform(0, 3, (3, 4)), rng.uniform(5, 9, (3, 4)),
                    rng.uniform(-3, -1, (3, 4)), rng.uniform(1, 3, (3, 4)),
                    rng.uniform(-0.5, 2, (3, 4)), rng.uniform(0.1, 0.5, (3, 4))],
                   -1).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jspecs.generate_flex_pstl(key, jnp.asarray(mid), hl, 4)
    # the same uniforms: flex_draws' maneuver-0 (keep) or -1 (change) ranges
    ranges = tspecs.FLEX_RANGES["keep" if hl == 0 else "change"]
    ks = jax.random.split(key, 6)
    u = torch.as_tensor(np.array([np.asarray(jax.random.uniform(
        ks[i], (3, 1), minval=lo, maxval=hi))
        for i, (lo, hi) in enumerate(ranges)]))
    exact(tspecs.generate_flex_pstl(torch.as_tensor(mid), hl, 4, u), want)


@pytest.mark.parametrize("flex", [True, False])
def test_get_dense_stlp_exact(flex):
    """Labels 0-3 (3, the outlier, takes the keep row's calibrated params
    under flex and the defaults without)."""
    cfg, jb, tb, stlp = case(flex=flex)
    key = jax.random.PRNGKey(3)
    want = jspecs.get_dense_stlp(key, jb["gt_high_level"], stlp, cfg)
    got = tspecs.get_dense_stlp(tb["gt_high_level"], torch.as_tensor(
        np.asarray(stlp)), TConfig(**cfg.to_dict()),
        flex=flex_draws(cfg, key, 4))
    assert got.shape == (4 * cfg.n_randoms * 3, 1, 6)
    exact(got, want)


def test_flex_uniforms_ranges():
    u = tspecs.flex_uniforms(64, torch.Generator().manual_seed(0))
    assert u.shape == (3, 6, 64, 1)
    for j in range(3):
        for i, (lo, hi) in enumerate(
                tspecs.FLEX_RANGES["keep" if j == 0 else "change"]):
            assert float(u[j, i].min()) >= lo and float(u[j, i].max()) < hi


@pytest.mark.parametrize("branch", ["stlp_dense", "pre_stlp", "flex"])
def test_densify_batch_branches_exact(branch):
    cfg, jb, tb, stlp = case()
    tcfg = TConfig(**cfg.to_dict())
    n = 4 * cfg.n_randoms * 3
    key = jax.random.PRNGKey(5)
    kw_j, kw_t = {}, {}
    if branch == "stlp_dense":
        sd = np.random.RandomState(0).randn(n, 1, 6).astype(np.float32)
        kw_j["stlp_dense"], kw_t["stlp_dense"] = jnp.asarray(sd), \
            torch.as_tensor(sd)
    elif branch == "pre_stlp":
        pre = np.random.RandomState(1).randn(4, cfg.n_randoms, 3, 6).astype(
            np.float32)
        jb = dict(jb, pre_stlp=jnp.asarray(pre))
        tb = dict(tb, pre_stlp=torch.as_tensor(pre))
    else:
        cfg = cfg.with_(load_stlp=False)
        tcfg = TConfig(**cfg.to_dict())
        kw_t["flex"] = flex_draws(cfg, key, 4)
    want = jspecs.densify_batch(jb, stlp, cfg, key=key, **kw_j)
    got = tspecs.densify_batch(tb, torch.as_tensor(np.asarray(stlp)), tcfg,
                               **kw_t)
    assert sorted(got) == sorted(want)
    for k in want:
        exact(got[k], want[k], k)


@pytest.mark.parametrize("norm_stl", [False, True])
def test_dense_signal_input_exact(norm_stl):
    cfg, jb, tb, stlp = case(norm_stl=norm_stl)
    tcfg = TConfig(**cfg.to_dict())
    key = jax.random.PRNGKey(5)
    jd = jspecs.densify_batch(jb, stlp, cfg, key=key)
    td = tspecs.densify_batch(tb, torch.as_tensor(np.asarray(stlp)), tcfg,
                              flex=flex_draws(cfg, key, 4))
    trajs = np.random.RandomState(2).randn(4 * cfg.n_randoms * 3, cfg.nt,
                                           4).astype(np.float32)
    for kw in (dict(), dict(repeat_n=2), dict(detach=True)):
        want = jspecs.dense_signal_input(jd, jnp.asarray(trajs), cfg=cfg,
                                         **kw)
        got = tspecs.dense_signal_input(td, torch.as_tensor(trajs), cfg=tcfg,
                                        **kw)
        assert sorted(got) == sorted(want)
        assert ("v_factor" in got) == norm_stl and "nei_discs" in got
        for k in want:
            if k == "nei_discs":
                assert isinstance(got[k], NeighborDiscs)
                for a, b in zip(got[k], want[k]):
                    np.testing.assert_allclose(np_(a), np.asarray(b),
                                               rtol=1e-6, atol=1e-6, err_msg=k)
            else:
                exact(got[k], want[k], k)
    # detach cuts autograd; without cfg nothing is hoisted
    st = td["stlp_dense"].clone().requires_grad_(True)
    sig = tspecs.dense_signal_input(dict(td, stlp_dense=st), detach=True,
                                    cfg=tcfg.with_(norm_stl=True))
    assert not sig["stlp"].requires_grad and not sig["v_factor"].requires_grad
    assert "nei_discs" not in tspecs.dense_signal_input(td)


def test_discs_route_scores_and_clause_bank_rows_match_jax():
    """The targets' scores of the dense step (``compute_scores`` on the
    hoisted discs) and ``make_score_rows(tiled_scorer=False)``, which must
    also equal the TiledScorer."""
    cfg, jb, tb, stlp = case()
    tcfg = TConfig(**cfg.to_dict())
    key = jax.random.PRNGKey(5)
    jd = jspecs.densify_batch(jb, stlp, cfg, key=key)
    td = tspecs.densify_batch(tb, torch.as_tensor(np.asarray(stlp)), tcfg,
                              flex=flex_draws(cfg, key, 4))
    n = 4 * cfg.n_randoms * 3
    states = np.repeat(np.asarray(jb["ego_traj"][:, 0, :4]), n // 4, 0)
    u = np.asarray(jb["params"]).reshape(n, cfg.nt, 2)
    jt = jdyn.rollout(jnp.asarray(states), jnp.asarray(u), cfg.dt)[:, :-1]
    tt = tdyn.rollout(torch.as_tensor(states), torch.as_tensor(u),
                      cfg.dt)[:, :-1]
    jsig = jspecs.dense_signal_input(jd, jt, cfg=cfg)
    tsig = tspecs.dense_signal_input(td, tt, cfg=tcfg)
    assert tspecs.clearance_route(tcfg, tsig) == "discs"
    valid_j = jd["valids_dense"].reshape(-1)
    _, want, acc_j = jspecs.compute_scores(
        jsig, jspecs.build_scorer(cfg), jd["highlevel_dense"], valid_j, cfg)
    _, got, acc_t = tspecs.compute_scores(
        tsig, tspecs.build_scorer(tcfg), td["highlevel_dense"],
        td["valids_dense"].reshape(-1), tcfg)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert float(acc_t) == float(acc_j)
    off = cfg.with_(tiled_scorer=False)
    rows_j = jspecs.make_score_rows(jb, jd, off)(jt)
    rows_t = tspecs.make_score_rows(tb, td, TConfig(**off.to_dict()))(tt)
    np.testing.assert_allclose(np_(rows_t), np.asarray(rows_j), rtol=1e-6,
                               atol=1e-6)
    tiled = tspecs.make_score_rows(tb, td, tcfg)(tt)
    np.testing.assert_allclose(np_(rows_t), np_(tiled), rtol=1e-5, atol=1e-5)
