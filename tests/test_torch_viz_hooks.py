"""The port's viz hooks against the JAX package's: ``train._viz_sample``
with the JAX draws pinned (PRNGKey(7) for the flex pSTL draws and the
sampler, as ``pstl_tpu.train._viz_sample`` uses it) within
``tests/test_torch_dense_sampler.py``'s tolerance, and the files that
``train.train(exp_name=...)``, ``sim.run_closed_loop_host(render_dir=...)``
and ``eval_openloop.run(viz_dir=...)`` write, by name."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pstl_tpu import diffusion as jdiff, eval_openloop as jeval
from pstl_tpu import sim as jsim, specs as jspecs, train as jtrain
from pstl_tpu.config import Config as JConfig, PRESETS
from pstl_tpu.data import synthetic as jsyn
from pstl_tpu.data.dataset import SceneDataset as JDataset, batch_iterator
from pstl_tpu.models import Net as JNet
from pstl_tpu_torch import diffusion as tdiff, eval_openloop as teval
from pstl_tpu_torch import sim as tsim, specs as tspecs, train as ttrain
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.data.dataset import SceneDataset as TDataset

from torch_dense_case import SMALL, flex_draws, torch_net
from torch_parity import jax_cm_noise

#: candidates a (scene, maneuver) of the tests' viz samples
S = 2


def jax_case(preset, n_scenes=12, **kw):
    """(cfg, JAX store, its first two val scenes, flax net, params) at
    ``torch_dense_case.SMALL`` in fp32."""
    cfg = PRESETS[preset].with_(**SMALL, compute_dtype="float32", **kw)
    ds = JDataset.from_synthetic(cfg, seed=0, n_scenes=n_scenes)
    ds.ensure_random_params(cfg.seed)
    batch = next(batch_iterator(ds, "val", 2, shuffle=False,
                                drop_last=False))
    net = JNet(cfg)
    params = jtrain.init_state(
        cfg, net, {k: jnp.asarray(v) for k, v in batch.items()
                   if not k.startswith("scene_")},
        jax.random.PRNGKey(0)).params
    return cfg, ds, batch, net, params


def port_viz_sample(cfg, params, batch):
    """The port's ``_viz_sample`` on ``batch`` with the JAX function's
    draws."""
    tcfg = TConfig(**cfg.to_dict())
    key = jax.random.PRNGKey(7)
    bs = batch["ego_traj"].shape[0]
    draws = {"flex": flex_draws(cfg, key, bs),
             "sample_noise": jax_cm_noise(key, cfg.diffusion_steps,
                                          (bs * S * 3, cfg.nt * 2))}
    return ttrain._viz_sample(tcfg, torch_net(cfg, params).eval(),
                              tspecs.build_scorer(tcfg),
                              tdiff.get_coeffs(tcfg), batch, S, draws=draws)


def test_viz_sample_matches_jax():
    cfg, _, batch, net, params = jax_case("e7_ours")
    trajs_j, scores_j = jtrain._viz_sample(
        cfg, net, params, jspecs.build_scorer(cfg), jdiff.get_coeffs(cfg),
        batch, S)
    trajs_t, scores_t = port_viz_sample(cfg, params, batch)
    assert trajs_t.shape == (2, S, 3, cfg.nt, 4) == trajs_j.shape
    # the sampler's 1e-5 on the controls, integrated by the 20-step rollout
    # (heading and speed sum dt * control; position sums dt * v * cos)
    np.testing.assert_allclose(trajs_t, np.asarray(trajs_j), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(scores_t, np.asarray(scores_j), rtol=1e-4,
                               atol=1e-4)


def test_viz_sample_leaves_out_pre_stlp():
    """A trajopt store's ``pre_stlp`` column holds n_randoms rows a scene:
    the JAX function reshapes it to S rows and raises (so JAX's viz draws
    nothing on such a store); the port leaves the column out and samples
    as on a store without it."""
    cfg, _, batch, net, params = jax_case("e7_ours")
    with_col = dict(batch, pre_stlp=np.zeros(
        (2, cfg.n_randoms, 3, 6), np.float32))
    with pytest.raises(TypeError, match="reshape"):
        jtrain._viz_sample(cfg, net, params, jspecs.build_scorer(cfg),
                           jdiff.get_coeffs(cfg), with_col, S)
    got = port_viz_sample(cfg, params, with_col)
    want = port_viz_sample(cfg, params, batch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_train_writes_jax_viz_files(tmp_path, monkeypatch):
    """``train.train`` with an ``exp_name`` draws the first ``num_viz`` val
    scenes every ``viz_freq`` epochs, under the names JAX's epoch hook
    gives them."""
    monkeypatch.chdir(tmp_path)
    cfg, ds, batch, net, params = jax_case("e5_ddpm", num_viz=2,
                                           viz_freq=1)
    for epi in (0, 1):
        jtrain._viz_epoch(cfg.with_(exp_name="jax"), ds, epi, net=net,
                          state=jtrain.TrainState(params, None, 0),
                          formulas=jspecs.build_scorer(cfg),
                          coeffs=jdiff.get_coeffs(cfg))
    tcfg = TConfig(**cfg.to_dict()).with_(exp_name="port")
    ttrain.train(tcfg, TDataset.from_synthetic(tcfg, seed=0, n_scenes=12),
                 epochs=2, device="cpu", log=lambda m: None)
    want = [f"epoch{e:04d}_scene{i:02d}.png" for e in (0, 1) for i in (0, 1)]
    assert sorted(os.listdir("exps/jax/viz")) == want
    assert sorted(os.listdir("exps/port/viz")) == want


def test_render_dir_writes_jax_frames(tmp_path):
    """``run_closed_loop_host(record=True, render_dir=...)``: a frame per
    step of each of the first four scenes and a GIF each, under JAX's
    names."""
    cfg = TConfig(n_randoms=2, n_neighbors=2, diffusion=True,
                  diffusion_steps=4, compute_dtype="float32",
                  batch_size=2).finalize().with_(test=True, epochs=1)
    data = jsyn.generate_dataset(0, 12, cfg, scene_len=8)
    scene_data = {k: v for k, v in data.items() if k.startswith("scene_")}
    jcfg = JConfig(**cfg.to_dict())
    net = JNet(jcfg)
    ds = JDataset({k: v for k, v in data.items()
                   if not k.startswith("scene_")}, jcfg)
    sample = next(batch_iterator(ds, "train", 4, shuffle=False))
    params = jtrain.init_state(jcfg, net, sample,
                               jax.random.PRNGKey(0)).params
    jsim.run_closed_loop_host(
        jax.random.PRNGKey(0), jsim.scenes_from_dataset(scene_data), jcfg,
        net, params, jspecs.build_scorer(jcfg), jdiff.get_coeffs(jcfg),
        max_steps=2, record=True, render_dir=str(tmp_path / "jax"))
    tnet = torch_net(jcfg, params).eval()
    tsim.run_closed_loop_host(
        0, tsim.scenes_from_dataset(scene_data, device="cpu"), cfg, tnet,
        tdiff.get_coeffs(cfg), max_steps=2, record=True,
        render_dir=str(tmp_path / "port"))
    want = sorted([f"frame_s{i:02d}_t{t:03d}.png" for i in range(4)
                   for t in (1, 2)] + [f"episode_{i:02d}.gif"
                                       for i in range(4)])
    assert sorted(os.listdir(tmp_path / "jax")) == want
    assert sorted(os.listdir(tmp_path / "port")) == want


def test_viz_dir_writes_jax_paper_figures(tmp_path):
    """``eval_openloop.run(viz_dir=...)``: the first six scenes of batch 0
    as ``paper_scene{i:02d}.png``, as JAX's."""
    cfg = PRESETS["e7_ours"].with_(
        n_randoms=2, sampling_size=2, n_neighbors=2, n_shards=2,
        hiddens=(32, 32), rect_hiddens=(32, 32), diffusion_steps=4,
        batch_size=8, compute_dtype="float32", exp_name=None)
    ds = JDataset.from_synthetic(cfg, seed=0, n_scenes=30)
    ds.ensure_random_params(cfg.seed)
    net = JNet(cfg)
    sample = next(batch_iterator(ds, "val", 4, shuffle=False))
    params = jtrain.init_state(cfg, net, sample,
                               jax.random.PRNGKey(0)).params
    jeval.run(cfg, ds, params, net=net, n_trials=0, log=lambda m: None,
              viz_dir=str(tmp_path / "jax"))
    tcfg = TConfig(**cfg.to_dict())
    teval.run(tcfg, TDataset.from_synthetic(tcfg, seed=0, n_scenes=30),
              torch_net(cfg, params).eval(), n_trials=0, log=lambda m: None,
              viz_dir=str(tmp_path / "port"), device="cpu")
    want = [f"paper_scene{i:02d}.png" for i in range(6)]
    assert sorted(os.listdir(tmp_path / "jax")) == want
    assert sorted(os.listdir(tmp_path / "port")) == want
