"""``pstl_tpu_torch.eval_openloop`` against ``pstl_tpu.eval_openloop`` on
the CPU: the trajopt oracle row, the timed sampling region and the metric
tail of one batch, and ``run``'s keys.

Small size: hiddens and rect_hiddens (32, 32), 6 denoise steps, 3 scenes
x 4 candidates x 3 maneuvers, multi_cands 3, fp32; the scenes are
``torch_dense_case.lane_scenes`` (straight GT, lanes along it, seed 0 the
GT controls, which some oracle rows then satisfy) and the control head is
scaled by 0.01; on the guided routes some final rows satisfy their spec,
so the guidance hinge (threshold ``stl_nn_thres``, ``maximize=False``) is
inactive on some columns and active on others.  The draws are the JAX
package's: ``k_dense, k_dense2, k_sample = split(key, 3)``, the flex
uniforms of the two densify keys and the sampler chain of k_sample (scaled
by ``SAMPLE_SCALE`` on both sides through ``pstl_tpu.diffusion._normal``,
the JAX package's seam for pinned noise).  Routes: unguided (``e7_ours``,
row-major), guided with the XLA loop (``ours_guidance``) and guided with
the fused kernel (``guidance_pallas_fuse_freeze``: JAX runs the Pallas
kernel in interpret mode, the port the kernel's plain version).

The "refinement" route is e7 with ``cfg.refinement``: the convex
refinement (K = 8; with 6 denoise steps the cache's indices past 5 read
its last decoding in both packages) after the RefineNet, its Adam loop cut
to ``REFINE_ITERS`` steps in both packages.  The full 50 steps at lr 0.3
are chaotic on these candidates (scores 0.14 apart after 50 steps, where
both packages' first gradients agree to rounding), as
``test_torch_closed_loop`` measures on the planner; ``test_torch_refine``
holds the full loop on well-conditioned inputs.

Tolerances: scores, controls and rollouts 1e-4 (the plan tests'); rates
exact.  The metric tail on the same (JAX) inputs: rtol 1e-5 / atol 1e-6
(``test_torch_metrics``'s).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff, eval_openloop as jeval
from pstl_tpu import refine as jrefine
from pstl_tpu import specs as jspecs, train as jtrain
from pstl_tpu.config import PRESETS as JPRESETS
from pstl_tpu.data.dataset import SceneDataset as JDataset, batch_iterator
from pstl_tpu.models import Net as JNet
from pstl_tpu_torch import diffusion as tdiff, eval_openloop as teval
from pstl_tpu_torch import refine as trefine
from pstl_tpu_torch import specs as tspecs, train as ttrain
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.data.dataset import SceneDataset as TDataset

from torch_dense_case import (SAMPLE_SCALE, flex_draws, jit_fast,
                              lane_scenes, small_sampler_noise, torch_net)
from torch_parity import jax_cm_noise, np_

TOL = 1e-4
#: the convex refinement's Adam steps in the "refinement" route
REFINE_ITERS = 3
SMALL = dict(exp_name=None, hiddens=(32, 32), rect_hiddens=(32, 32),
             n_randoms=4, sampling_size=4, n_shards=2, diffusion_steps=6,
             batch_size=3, n_neighbors=3, multi_cands=3,
             compute_dtype="float32")
ROUTES = {"unguided": ("e7_ours", {}),
          "refinement": ("e7_ours", {"refinement": True}),
          "guided_xla": ("ours_guidance", {}),
          "guided_kernel": ("ours_guidance",
                            {"guidance_pallas_fuse_freeze": True})}


def _cfgs(route):
    preset, kw = ROUTES[route]
    cfg_j = JPRESETS[preset].with_(**SMALL, **kw).with_(
        run_sampling_test=True, pallas_interpret=True).finalize()
    return cfg_j, TConfig(**cfg_j.to_dict())


@functools.lru_cache(maxsize=None)
def _setup():
    """A numpy batch of lane scenes (seed 0 the GT controls) with a
    ``pre_stlp`` column of JAX flex draws, and the flax params (control head
    x0.01, RefineNet output x0.1)."""
    cfg, _ = _cfgs("guided_xla")
    ds = JDataset.from_synthetic(cfg, seed=0, n_scenes=12)
    ds.ensure_random_params(cfg.seed)
    b = next(batch_iterator(ds, "val", cfg.batch_size, shuffle=False,
                            drop_last=False))
    b = lane_scenes({k: v for k, v in b.items()
                     if k.startswith(ttrain.COLS)}, cfg)
    jb = jtrain.attach_neighbors({k: jnp.asarray(v) for k, v in b.items()},
                                 cfg)
    stlp = jspecs.calibrate_stlp(jb, jb["ego_traj"][..., :4], cfg)
    pre = jspecs.get_dense_stlp(jax.random.PRNGKey(8), jb["gt_high_level"],
                                stlp, cfg)
    b["pre_stlp"] = np.array(pre).reshape(cfg.batch_size, cfg.n_randoms, 3,
                                            1, 6)
    p = jax.device_get(jtrain.init_state(
        cfg, JNet(cfg), {k: jnp.asarray(v) for k, v in b.items()},
        jax.random.PRNGKey(0)).params)
    last = p["params"]["policy_net"][f"Dense_{len(cfg.hiddens)}"]
    last["kernel"] = last["kernel"] * 0.01
    rect = p["params"]["rect_net"][f"Dense_{len(cfg.rect_hiddens)}"]
    rect["kernel"] = rect["kernel"] * 0.1
    return b, p


def _both(route, with_pre=True):
    cfg_j, cfg_t = _cfgs(route)
    b, p = _setup()
    if not with_pre:
        b = {k: v for k, v in b.items() if k != "pre_stlp"}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = ttrain.to_device(b, "cpu")
    params = jax.tree_util.tree_map(jnp.asarray, p)
    net_t = torch_net(cfg_j, params)
    return cfg_j, cfg_t, jb, tb, params, net_t.eval()


def _keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), 3)


@pytest.mark.parametrize("with_pre", [True, False], ids=["pre_stlp", "flex"])
def test_trajopt_row(with_pre):
    """The oracle row on the batch's ``params``: under ``load_stlp`` with
    the ``pre_stlp`` column (the augmented store), and with flex draws
    where the column is missing."""
    cfg_j, cfg_t, jb, tb, params, net_t = _both("guided_xla", with_pre)
    key = jax.random.PRNGKey(3)
    net_j = JNet(cfg_j)
    want = jit_fast(lambda p, k, b: jeval._trajopt_row(
        p, k, b, cfg_j, net_j, jspecs.build_scorer(cfg_j),
        jdiff.get_coeffs(cfg_j)), params, key, jb)
    with torch.no_grad():
        got = teval._trajopt_row(net_t, tb, cfg_t, tspecs.build_scorer(cfg_t),
                                 flex=flex_draws(cfg_j, _keys(3)[0],
                                                 cfg_j.batch_size))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np_(got[k]), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    s = np.asarray(want["scores"])
    assert (s > 0).any() and (s < 0).any()


@functools.lru_cache(maxsize=None)
def _sampled(route):
    """Both packages' timed region on the batch under key 5."""
    with pytest.MonkeyPatch.context() as mp:
        small_sampler_noise(mp)
        for mod in (jrefine, trefine):     # see the module docstring
            mp.setattr(mod, "convex_refinement", functools.partial(
                mod.convex_refinement, n_iters=REFINE_ITERS))
        cfg_j, cfg_t, jb, tb, params, net_t = _both(route)
        key = jax.random.PRNGKey(5)
        net_j = JNet(cfg_j)
        want = jit_fast(lambda p, k, b: jeval._sample_and_score(
            p, k, b, cfg_j, net_j, jspecs.build_scorer(cfg_j),
            jdiff.get_coeffs(cfg_j)), params, key, jb)
        _, k_dense2, k_sample = _keys(5)
        bs = cfg_j.batch_size
        noise = SAMPLE_SCALE * jax_cm_noise(
            k_sample, cfg_t.diffusion_steps, teval.sampler_shape(cfg_t, bs))
        with torch.no_grad():
            got = teval._sample_and_score(
                net_t, tb, cfg_t, tspecs.build_scorer(cfg_t),
                tdiff.get_coeffs(cfg_t), flex=flex_draws(cfg_j, k_dense2, bs),
                noise=noise)
    return cfg_j, cfg_t, jb, tb, want, got


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sample_and_score(route):
    """Scores, final controls, rollouts and validity to 1e-4; the
    compliance and scene success equal."""
    *_, want, got = _sampled(route)
    (nn_j, u_j, tr_j, v_j), (nn_t, u_t, tr_t, v_t) = want, got
    for k, a, b in (("scores", nn_t["scores"], nn_j["scores"]),
                    ("controls", u_t, u_j), ("trajs", tr_t, tr_j),
                    ("valid", v_t, v_j)):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=TOL, atol=TOL,
                                   err_msg=k)
    s = np.asarray(nn_j["scores"])
    assert np.abs(s).min() > TOL, "a score within the tolerance of 0"
    for k in ("acc", "scene_acc"):
        assert float(nn_t[k]) == pytest.approx(float(nn_j[k]), abs=1e-6), k
    if route != "unguided":
        assert (s > 0).any() and (s < 0).any()
    if route == "refinement":      # the violating rows moved, the others not
        u0 = np.asarray(_sampled("unguided")[4][1])
        moved = np.abs(np.asarray(u_j) - u0).max(axis=(1, 2)) > 1e-3
        s0 = np.asarray(_sampled("unguided")[4][0]["scores"])
        assert moved.any() and not moved[s0 > 0].any()


def test_guided_kernel_route_reaches_the_plain_kernel(monkeypatch):
    """Under ``guidance_pallas_fuse_freeze`` the port's guided denoise
    steps run the fused kernel's plain version once each (the CPU stands
    in for the card), with the eval's threshold ``stl_nn_thres``."""
    from pstl_tpu_torch.ops import guidance_kernel as gk
    cfg_j, cfg_t, jb, tb, *_ = _sampled("guided_kernel")
    calls = []
    real = gk.guidance_fused_plain
    monkeypatch.setattr(gk, "guidance_fused_plain",
                        lambda *a: calls.append(float(a[-2][1])) or real(*a))
    _, net_t = _both("guided_kernel")[4:]
    with torch.no_grad():
        teval._sample_and_score(net_t, tb, cfg_t, tspecs.build_scorer(cfg_t),
                                tdiff.get_coeffs(cfg_t),
                                generator=torch.Generator().manual_seed(0))
    assert len(calls) == int(tdiff._trigger_schedule(cfg_t).sum()) > 0
    assert calls == pytest.approx([cfg_t.stl_nn_thres] * len(calls))


@pytest.mark.parametrize("route", ["guided_kernel"])
def test_nn_metrics(route):
    """The metric tail on the JAX region's outputs, fed to both.  The JAX
    function runs op by op: jitted, XLA fuses the hull's edge test and
    rounds the crosses of a near-collinear point set differently (a scene's
    rollouts start at one point and part slowly), which reads 4.8e-6 m2 of
    sliver area here where op by op JAX and the port read 0."""
    cfg_j, cfg_t, jb, tb, (nn_j, u_j, tr_j, v_j), _ = _sampled(route)
    want = jeval._nn_metrics(nn_j, u_j, tr_j, v_j, jb, cfg_j)
    conv = lambda x: torch.as_tensor(np.asarray(x))
    got = teval._nn_metrics({k: conv(v) for k, v in nn_j.items()},
                            conv(u_j), conv(tr_j), conv(v_j), tb, cfg_t)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np_(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_run_keys_and_refusals(tmp_path):
    """``run`` at the tiny size on the CPU: every Table-I key, finite; a
    config without a head raises by name; ``viz_dir`` draws the paper
    figures; without ``device`` it wants the card."""
    cfg_j, cfg_t = _cfgs("guided_kernel")
    b, p = _setup()
    ds = TDataset.from_synthetic(cfg_t, seed=0, n_scenes=12)
    net = torch_net(cfg_j, jax.tree_util.tree_map(jnp.asarray, p)).eval()
    times = []
    out = teval.run(cfg_t, ds, net, n_trials=1, log=lambda *a: None,
                    device="cpu", times=times)
    keys = {f"{r}_{m}" for r in ("tj", "nn") for m in teval.RUN_METRICS}
    assert sorted(out) == sorted(keys | {"time"})
    assert all(np.isfinite(v) for v in out.values()), out
    assert len(times) == 2 and 0 <= out["tj_acc"] <= 1
    # the VAE and BC heads and the fast samplers are accepted; no head
    # raises by name
    for kw in (dict(diffusion=False, vae=True), dict(diffusion=False,
                                                     bc=True),
               dict(sampler="dpmpp"), dict(sampler="ddim")):
        teval.check_supported(cfg_t.with_(**kw))
    with pytest.raises(NotImplementedError, match="head"):
        teval.run(cfg_t.with_(diffusion=False), ds, net, device="cpu")
    # viz_dir: the paper figures of batch 0's first scenes (up to six)
    teval.run(cfg_t, ds, net, n_trials=0, log=lambda *a: None,
              device="cpu", viz_dir=str(tmp_path))
    n_fig = min(ds.split_len("val"), cfg_t.batch_size, 6)
    assert sorted(os.listdir(tmp_path)) == [f"paper_scene{i:02d}.png"
                                            for i in range(n_fig)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            teval.run(cfg_t, ds, net)
