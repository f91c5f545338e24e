"""The mono training step's scoring pieces against the JAX package on the
same seeded numpy inputs: ``prep_signals`` (each of its clearance routes),
``ClauseBank`` / ``compute_scores`` (the outlier class too) and their
gradient, ``calibrate_stlp`` (both ``flex`` branches), the ``PRESETS``
table field for field, and the dataset mirror (bit-identical batches).

Tolerances: signals and scores 1e-5 (the same float32 ops; cos / sin /
logsumexp may differ by an ulp between the libraries, which the tau = 100
soft-min amplifies at most 100-fold), gradients rtol 1e-4 (autograd in
another association order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import specs as jspecs
from pstl_tpu.config import Config as JConfig, PRESETS as JPRESETS
from pstl_tpu.data import dataset as jds
from pstl_tpu.ops import dynamics as jdyn
from pstl_tpu_torch import specs as tspecs
from pstl_tpu_torch.config import (Config as TConfig, PRESETS as TPRESETS,
                                   mono_config)
from pstl_tpu_torch.data import dataset as tds
from pstl_tpu_torch.ops import geometry as tgeom

from torch_parity import np_, to_t

KW = dict(n_neighbors=3, n_randoms=4, pallas_interpret=True)


def mono_case(seed=0, bs=3, M=4, **kw):
    """A mono batch's signals: a synthetic scene batch (with an outlier
    row), GT-calibrated stlp, and rollouts of random controls, repeated M
    times per scene as the mono step builds them."""
    cfg = JConfig(**KW, **kw)
    data = jds.SceneDataset.from_synthetic(cfg, seed=seed, n_scenes=bs).data
    batch = {k: jnp.asarray(v) for k, v in data.items()
             if not k.startswith(("traj_i", "ti"))}
    batch["gt_high_level"] = batch["gt_high_level"].at[0, 0].set(3.0)
    batch["neighbor_trajs_aug"] = batch["neighbors_traj"]
    gt = batch["ego_traj"][..., :4]
    stlp = jspecs.calibrate_stlp(batch, gt, cfg)
    rng = np.random.RandomState(seed)
    u = rng.randn(bs * M, cfg.nt, 2).astype(np.float32)
    u[..., 0] *= 0.1
    states = np.repeat(np.asarray(gt[:, 0]), M, 0)
    trajs = np.asarray(jdyn.rollout(jnp.asarray(states), jnp.asarray(u),
                                    cfg.dt))[:, :-1]
    mul = lambda x: np.repeat(np.asarray(x), M, 0)
    sig = {"ego_traj": trajs, "neighbors": mul(batch["neighbor_trajs_aug"]),
           "currlane_wpts": mul(batch["currlane_wpts"]),
           "leftlane_wpts": mul(batch["leftlane_wpts"]),
           "rightlane_wpts": mul(batch["rightlane_wpts"]),
           "stlp": mul(stlp)[:, None, :]}
    return cfg, sig, mul(batch["gt_high_level"])


@pytest.mark.parametrize("route", ["pallas", "xla", "xla_full", "discs"])
def test_prep_signals_routes_match(route):
    cfg, sig, _ = mono_case(norm_stl=route == "xla")
    cfg = cfg.with_(use_pallas_clearance=route == "pallas")
    tcfg = TConfig(**cfg.to_dict())
    jsig = {k: jnp.asarray(v) for k, v in sig.items()}
    tsig = to_t(sig)
    if route == "discs":
        nei = sig["neighbors"]
        from pstl_tpu.ops import geometry as jgeom
        jsig["nei_discs"] = jgeom.precompute_neighbor_discs(
            jnp.asarray(nei[..., 1:7]), jnp.asarray(nei[..., 0]), 4)
        tsig["nei_discs"] = tgeom.precompute_neighbor_discs(
            tsig["neighbors"][..., 1:7], tsig["neighbors"][..., 0], 4)
    full = route == "xla_full"
    want = jspecs.prep_signals(jsig, cfg, with_collision=full)
    got = tspecs.prep_signals(tsig, tcfg, with_collision=full)
    keys = [k for k in want if k not in sig and k != "nei_discs"]
    assert sorted(keys) == sorted(k for k in got if k not in tsig)
    assert "min_nei_d" in keys and ("radius_sum" in keys) == full
    assert ("v_factor" in keys) == (route == "xla")
    for k in keys:
        np.testing.assert_allclose(np_(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("route", ["pallas", "xla", "discs"])
def test_prep_signals_per_scene_neighbors(route):
    """One neighbor set per scene (the mono step's layout on the kernel
    route): the kernel route gives the repeated call's bits, the other two
    routes refuse it."""
    cfg, sig, _ = mono_case(seed=2)
    tcfg = TConfig(**cfg.with_(use_pallas_clearance=route == "pallas")
                   .to_dict())
    assert tspecs.clearance_route(tcfg) == {"pallas": "kernel"}.get(
        route, "geometry")
    tsig = to_t(sig)
    shared = dict(tsig, neighbors=tsig["neighbors"][::4].contiguous())
    if route == "discs":
        for s in (tsig, shared):
            s["nei_discs"] = tgeom.precompute_neighbor_discs(
                s["neighbors"][..., 1:7], s["neighbors"][..., 0], 4)
        assert tspecs.clearance_route(tcfg, shared) == "discs"
    want = tspecs.prep_signals(tsig, tcfg)["min_nei_d"]
    if route == "pallas":
        got = tspecs.prep_signals(shared, tcfg)["min_nei_d"]
        assert got.shape == want.shape and torch.equal(got, want)
        bad = dict(tsig, neighbors=tsig["neighbors"][:5].contiguous())
        with pytest.raises(ValueError, match="rows_per_scene"):
            tspecs.prep_signals(bad, tcfg)
    else:
        with pytest.raises(ValueError, match="per-scene neighbors"):
            tspecs.prep_signals(shared, tcfg)
    assert tspecs.clearance_route(tcfg, shared,
                                  with_collision=True) == "geometry"


@pytest.mark.parametrize("norm_stl,hard", [(False, False), (True, False),
                                           (False, True)])
def test_compute_scores_match(norm_stl, hard):
    """ClauseBank through compute_scores, with an outlier row (+1)."""
    cfg, sig, hl = mono_case(seed=1, norm_stl=norm_stl,
                             use_pallas_clearance=True)
    tcfg = TConfig(**cfg.to_dict())
    n = hl.shape[0]
    mask = np.ones(n, np.float32)
    mask[-1] = 0.0
    jl, js, jacc = jspecs.compute_scores(
        {k: jnp.asarray(v) for k, v in sig.items()},
        jspecs.build_scorer(cfg), jnp.asarray(hl), jnp.asarray(mask), cfg,
        hard=hard)
    tl, ts, tacc = tspecs.compute_scores(
        to_t(sig), tspecs.build_scorer(tcfg), torch.as_tensor(hl),
        torch.as_tensor(mask), tcfg, hard=hard)
    assert len(tl) == len(jl) == 4
    for w, g in zip(jl, tl):
        np.testing.assert_allclose(np_(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(np_(ts), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    assert np.all(np_(ts)[:4] == 1.0)            # the outlier scene's rows
    assert float(tacc) == float(jacc)
    signs = np.sign(np.asarray(js))
    assert (signs > 0).any() and (signs < 0).any()


@pytest.mark.parametrize("pallas", [True, False], ids=["kernel", "xla"])
def test_score_gradient_matches(pallas):
    """d(hinge of compute_scores)/d(ego states): through the clearance VJP
    (kernel route) or autograd of the XLA route."""
    cfg, sig, hl = mono_case(seed=3, use_pallas_clearance=pallas)
    tcfg = TConfig(**cfg.to_dict())
    n = hl.shape[0]
    ones = np.ones(n, np.float32)

    def jloss(ego):
        s = {k: jnp.asarray(v) for k, v in sig.items()}
        s["ego_traj"] = ego
        _, sc, _ = jspecs.compute_scores(s, jspecs.build_scorer(cfg),
                                         jnp.asarray(hl), jnp.asarray(ones),
                                         cfg)
        return jnp.mean(jax.nn.relu(1.0 - sc))

    g_want = jax.grad(jloss)(jnp.asarray(sig["ego_traj"]))
    t = to_t(sig)
    ego = t["ego_traj"].requires_grad_(True)
    _, sc, _ = tspecs.compute_scores(t, tspecs.build_scorer(tcfg),
                                     torch.as_tensor(hl),
                                     torch.as_tensor(ones), tcfg)
    torch.mean(torch.relu(1.0 - sc)).backward()
    assert np.abs(np.asarray(g_want)[..., :3]).max() > 0
    np.testing.assert_allclose(np_(ego.grad), np.asarray(g_want), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("flex", [False, True])
def test_calibrate_stlp_matches(flex):
    cfg = JConfig(**KW, flex=flex)
    data = jds.SceneDataset.from_synthetic(cfg, seed=4, n_scenes=6).data
    data["gt_high_level"][:4, 0] = [0.0, 1.0, 2.0, 3.0]
    data["neighbor_trajs_aug"] = data["neighbors_traj"]
    gt = data["ego_traj"][..., :4]
    want = jspecs.calibrate_stlp({k: jnp.asarray(v) for k, v in data.items()
                                  if k not in ("traj_i", "ti")},
                                 jnp.asarray(gt), cfg)
    got = tspecs.calibrate_stlp(to_t({k: v for k, v in data.items()
                                      if k not in ("traj_i", "ti")}),
                                torch.as_tensor(gt),
                                TConfig(**cfg.to_dict()))
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_presets_mirror_jax():
    assert list(JPRESETS) == list(TPRESETS)
    for k in JPRESETS:
        assert JPRESETS[k].to_dict() == TPRESETS[k].to_dict(), k
    cfg = mono_config("e4_ddpm_mono")
    assert cfg.use_pallas_clearance and cfg.exp_name is None
    assert cfg.to_dict() == JPRESETS["e4_ddpm_mono"].with_(
        use_pallas_clearance=True, exp_name=None).to_dict()
    with pytest.raises(ValueError):
        mono_config("e5_ddpm")


def test_dataset_mirror_bit_identical():
    """Splits, random control seeds and shuffled / wrapped batches equal the
    JAX package's, array for array."""
    cfg_kw = dict(n_neighbors=3, n_randoms=4, train_ratio=0.7)
    jd = jds.SceneDataset.from_synthetic(JConfig(**cfg_kw), seed=5,
                                         n_scenes=11)
    td = tds.SceneDataset.from_synthetic(TConfig(**cfg_kw), seed=5,
                                         n_scenes=11)
    for split in ("train", "val"):
        np.testing.assert_array_equal(jd.splits[split], td.splits[split])
        assert jd.split_len(split) == td.split_len(split)
    jd.ensure_random_params(3)
    td.ensure_random_params(3)
    assert len(jd) == len(td) == 11 and "params_init" in td.data
    extra = np.arange(11, dtype=np.float32)
    jd.attach("extra", extra)
    td.attach("extra", extra)
    for split, shuffle, drop_last, epoch in (("train", True, True, 2),
                                             ("val", False, False, 0),
                                             ("val", False, True, 0)):
        ja = list(jds.batch_iterator(jd, split, 3, shuffle, seed=7,
                                     drop_last=drop_last, epoch=epoch))
        ta = list(tds.batch_iterator(td, split, 3, shuffle, seed=7,
                                     drop_last=drop_last, epoch=epoch))
        assert len(ja) == len(ta) > 0
        for a, b in zip(ja, ta):
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError):
        td.attach("bad", np.zeros(3))
