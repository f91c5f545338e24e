"""The baselines' Table-I rows: ``pstl_tpu_torch.eval_openloop`` against
``pstl_tpu.eval_openloop`` on the CPU for ``vae_mono`` (``e2_vae_mono``
with ``gt_data_training=False``, as ``scripts/e2e_pipeline.py`` evaluates
it), ``vae_aug`` (``e3_vae``: the init hint is the batch's ``params_init``
column), ``trafficsim`` (``e6_trafficsim``), BC
(``PRESETS["e3_vae"].with_(vae=False, bc=True, use_init_hint=False)``) and
``ctg`` (e5's DDPM guided on every denoise step under
``guidance_pallas_fuse_freeze``: JAX runs the Pallas kernel in interpret
mode, the port the kernel's plain version).  The timed region of one batch
on the same draws, and ``run``'s keys.

The batch, sizes and tolerances are ``test_torch_eval_openloop``'s (3
lane scenes x 4 candidates x 3 maneuvers with a ``pre_stlp`` column,
width 32, 6 denoise steps, fp32; scores, controls and rollouts 1e-4, rates
exact), vae_dim 8, the control head scaled by 0.01.  On the CTG row, guided
on every denoise step with 3 Adam iterations, the controls agree to
1.9e-5 and are held to 1e-4, the rollouts' first two states to 1e-4, whole
rollouts and scores to ``test_torch_closed_loop``'s 1e-3 (a control 1e-5
apart moves the 20-step rollout by up to ~1e-3 m at the horizon, which the
lane clauses read at tau = 100; measured 4.3e-4 and 3.6e-4); the rates
stay exact, every score lying farther from 0 than the two packages part.
The draws are the JAX package's: ``_, k_dense2, k_sample = split(key,
3)``; the VAE's prior latent is normal(k_sample), CTG's sampler chain
comes from k_sample (scaled by ``SAMPLE_SCALE`` on both sides); BC draws
nothing.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff, eval_openloop as jeval
from pstl_tpu import specs as jspecs, train as jtrain
from pstl_tpu.config import PRESETS as JPRESETS
from pstl_tpu.models import Net as JNet
from pstl_tpu_torch import diffusion as tdiff, eval_openloop as teval
from pstl_tpu_torch import specs as tspecs, train as ttrain
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.data.dataset import SceneDataset as TDataset

from test_torch_eval_openloop import SMALL, TOL, _keys, _setup
from torch_dense_case import (SAMPLE_SCALE, flex_draws, jit_fast,
                              small_sampler_noise, torch_net)
from torch_parity import jax_cm_noise, np_

#: the rows: (preset, overrides)
ROWS = {
    "vae_mono": ("e2_vae_mono", dict(gt_data_training=False)),
    "vae_aug": ("e3_vae", {}),
    "trafficsim": ("e6_trafficsim", {}),
    "bc": ("e3_vae", dict(vae=False, bc=True, use_init_hint=False)),
    "ctg": ("ctg", dict(guidance_pallas_fuse_freeze=True)),
}


def _cfgs(row):
    preset, kw = ROWS[row]
    cfg_j = JPRESETS[preset].with_(**SMALL, vae_dim=8, **kw).with_(
        run_sampling_test=True, pallas_interpret=True).finalize()
    return cfg_j, TConfig(**cfg_j.to_dict())


@functools.lru_cache(maxsize=None)
def _params(row):
    """Flax parameters of the row's head on the shared batch, the control
    head x0.01."""
    cfg, _ = _cfgs(row)
    b, _ = _setup()
    p = jax.device_get(jtrain.init_state(
        cfg, JNet(cfg), {k: jnp.asarray(v) for k, v in b.items()},
        jax.random.PRNGKey(0)).params)
    last = p["params"]["policy_net"][f"Dense_{len(cfg.hiddens)}"]
    last["kernel"] = np.asarray(last["kernel"]) * 0.01
    return jax.tree_util.tree_map(jnp.asarray, p)


@pytest.mark.parametrize("row", sorted(ROWS))
def test_sample_and_score(row, monkeypatch):
    """Scores, final controls, rollouts and validity (to the tolerances of
    the module docstring); the compliance and scene success equal; the e3
    hint reaches the VAE."""
    small_sampler_noise(monkeypatch)
    cfg_j, cfg_t = _cfgs(row)
    b, _ = _setup()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = ttrain.to_device(b, "cpu")
    params = _params(row)
    net_t = torch_net(cfg_j, params).eval()
    key = jax.random.PRNGKey(5)
    net_j = JNet(cfg_j)
    nn_j, u_j, tr_j, v_j = jit_fast(
        lambda p, k, b: jeval._sample_and_score(
            p, k, b, cfg_j, net_j, jspecs.build_scorer(cfg_j),
            jdiff.get_coeffs(cfg_j)), params, key, jb)
    _, k_dense2, k_sample = _keys(5)
    bs = cfg_j.batch_size
    if cfg_t.diffusion:
        noise = SAMPLE_SCALE * jax_cm_noise(
            k_sample, cfg_t.diffusion_steps, teval.sampler_shape(cfg_t, bs))
    elif cfg_t.vae:
        noise = torch.as_tensor(np.array(jax.random.normal(
            k_sample, teval.draw_shape(cfg_t, bs))))
    else:
        noise = None
        assert teval.draw_shape(cfg_t, bs) is None

    def sample(batch):
        with torch.no_grad():
            return teval._sample_and_score(
                net_t, batch, cfg_t, tspecs.build_scorer(cfg_t),
                tdiff.get_coeffs(cfg_t), flex=flex_draws(cfg_j, k_dense2, bs),
                noise=noise)

    nn_t, u_t, tr_t, v_t = sample(tb)
    far = 1e-3 if cfg_t.guidance else TOL      # see the module docstring
    for k, a, want, tol in (
            ("scores", nn_t["scores"], nn_j["scores"], far),
            ("controls", u_t, u_j, TOL), ("trajs", tr_t, tr_j, far),
            ("trajs[:, :2]", tr_t[:, :2], tr_j[:, :2], TOL),
            ("valid", v_t, v_j, TOL)):
        np.testing.assert_allclose(np_(a), np.asarray(want), rtol=tol,
                                   atol=tol, err_msg=k)
    s_j = np.asarray(nn_j["scores"])
    assert np.abs(s_j).min() > np.abs(np_(nn_t["scores"]) - s_j).max()
    for k in ("acc", "scene_acc"):
        assert float(nn_t[k]) == pytest.approx(float(nn_j[k]), abs=1e-6), k
    if cfg_t.use_init_hint:
        other = dict(tb, params_init=tb["params_init"].flip(0))
        assert float((sample(other)[1] - u_t).abs().max()) > 1e-6


@pytest.mark.parametrize("row", sorted(ROWS))
def test_run_keys(row):
    """``run`` at the tiny size: every Table-I key, finite, a timed batch
    and its warm-up, on the port's own draws."""
    cfg_j, cfg_t = _cfgs(row)
    ds = TDataset.from_synthetic(cfg_t, seed=0, n_scenes=12)
    net = torch_net(cfg_j, _params(row)).eval()
    times = []
    out = teval.run(cfg_t, ds, net, n_trials=1, log=lambda *a: None,
                    device="cpu", times=times)
    keys = {f"{r}_{m}" for r in ("tj", "nn") for m in teval.RUN_METRICS}
    assert sorted(out) == sorted(keys | {"time"})
    assert all(np.isfinite(v) for v in out.values()), out
    assert len(times) == 2 and 0 <= out["nn_acc"] <= 1
