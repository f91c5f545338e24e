"""The constant-velocity neighbor prediction (``gt_nei=False``) in the
port: ``dynamics.neighbor_rollout`` and ``train.attach_neighbors`` against
the JAX package, and one fp32 ``e2_vae_mono`` train step under
``gt_nei=False`` against ``pstl_tpu.train`` (``tests/torch_mono_case.py``:
the JAX clearance kernels in interpret mode, the port's plain versions),
whose clearance then reads the constant-velocity tracks.

Tolerances: the rollout is a prefix sum of v cos(th) dt in both packages,
in the same order: rtol 1e-6 / atol 1e-5 (the positions reach ~50 m, whose
ulp is 4e-6); the train step ``torch_mono_case``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu.config import Config as JConfig
from pstl_tpu.ops import dynamics as jdyn
from pstl_tpu.train import attach_neighbors as j_attach
from pstl_tpu_torch import train as ttrain
from pstl_tpu_torch.config import PRESETS, Config as TConfig, mono_config
from pstl_tpu_torch.data.dataset import SceneDataset
from pstl_tpu_torch.ops import dynamics as tdyn

from chip_smoke import straight_scenes, swerving_neighbor
from torch_mono_case import run_train_steps
from torch_parity import F32, np_

TOL = dict(rtol=1e-6, atol=1e-5)


def neighbors(shape, seed=0):
    rng = np.random.RandomState(seed)
    nei = np.zeros(shape + (7,), F32)
    nei[..., 0] = rng.rand(*shape) > 0.3
    nei[..., 1:3] = rng.uniform(-30, 30, shape + (2,))
    nei[..., 3] = rng.uniform(-np.pi, np.pi, shape)
    nei[..., 4] = rng.uniform(0, 12, shape)
    nei[..., 5] = rng.uniform(3.5, 5.5, shape)
    nei[..., 6] = rng.uniform(1.5, 2.2, shape)
    return nei


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("shape", [(5, 3), (2, 4, 3)])
def test_neighbor_rollout_matches_jax(full, shape):
    nei = neighbors(shape)
    got = tdyn.neighbor_rollout(torch.as_tensor(nei), 20, 0.5, full=full)
    want = jdyn.neighbor_rollout(jnp.asarray(nei), 20, 0.5, full=full)
    assert tuple(got.shape) == shape + (20, 7 if full else 5)
    np.testing.assert_allclose(np_(got), np.asarray(want), **TOL)
    # constant velocity: the heading, speed, validity (and box) hold still
    g = np_(got)
    for c in (0, 3, 4) + ((5, 6) if full else ()):
        np.testing.assert_array_equal(g[..., c], np.broadcast_to(
            nei[..., None, c], g.shape[:-1]))


@pytest.mark.parametrize("gt_nei", [True, False])
def test_attach_neighbors_matches_jax(gt_nei):
    """``tests/test_train.py``'s case: the GT tracks, or the current frame
    at constant velocity."""
    cfg = JConfig(nt=6, dt=0.5, n_neighbors=2, gt_nei=gt_nei)
    rng = np.random.RandomState(0)
    nt = rng.randn(3, 2, 6, 7).astype(F32)
    nt[..., 0] = 1.0
    want = j_attach({"neighbors_traj": jnp.asarray(nt)}, cfg)
    got = ttrain.attach_neighbors({"neighbors_traj": torch.as_tensor(nt)},
                                  TConfig(**cfg.to_dict()))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np_(got[k]), np.asarray(want[k]), **TOL,
                                   err_msg=k)
    aug = np_(got["neighbor_trajs_aug"])
    if gt_nei:
        np.testing.assert_array_equal(aug, nt)
    else:
        np.testing.assert_allclose(aug[:, :, 1, 1] - aug[:, :, 0, 1],
                                   aug[:, :, 0, 4] * np.cos(aug[:, :, 0, 3])
                                   * cfg.dt, rtol=1e-4, atol=1e-5)


def test_constant_velocity_on_synthetic_and_swerving_scenes():
    """The synthetic generator's neighbors drive at constant speed and
    heading, so there the prediction reproduces the GT tracks (to the
    rollout's rounding); on ``swerving_neighbor``'s scenes neighbor 0's GT
    track leaves the ego's while its prediction stays on it."""
    cfg = mono_config("e2_vae_mono", n_neighbors=3)
    ds = SceneDataset.from_synthetic(cfg, seed=0, n_scenes=8)
    raw = ds.gather(np.arange(8))
    for name, batch in (("synthetic", raw), ("swerving", swerving_neighbor(
            straight_scenes(raw, cfg), cfg))):
        b = {"neighbors_traj": torch.as_tensor(batch["neighbors_traj"])}
        gt = ttrain.attach_neighbors(b, cfg)["neighbor_trajs_aug"]
        cv = ttrain.attach_neighbors(b, cfg.with_(gt_nei=False))[
            "neighbor_trajs_aug"]
        np.testing.assert_array_equal(np_(cv[:, :, 0]), np_(gt[:, :, 0]))
        diff = float((cv[..., 1:3] - gt[..., 1:3])[gt[..., 0] > 0].abs()
                     .max())
        if name == "synthetic":
            assert diff < 1e-4
        else:
            assert diff > 5.0
            ego = torch.as_tensor(batch["ego_traj"])
            np.testing.assert_allclose(np_(cv[:, 0, :, 1:3]),
                                       np_(ego[..., 0:2]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("stl_weight", [0.0, 1.0])
def test_e2_step_under_constant_velocity_matches_jax(stl_weight):
    """Two fp32 ``e2_vae_mono`` steps with ``gt_nei=False`` on the swerving
    scenes: loss, metrics, every gradient and the parameters against JAX;
    the clearance VJP runs once a step on the constant-velocity tracks,
    with a nonzero cotangent under stl_weight 1 (the prediction stays on
    the ego's track, where the safety clause binds)."""
    run_train_steps("e2_vae_mono", dict(gt_nei=False, stl_weight=stl_weight,
                                        swerve=True), "float32")


def test_cli_preset_reaches_constant_velocity():
    """``train --preset e2_vae_mono --set gt_nei=false``: the overrides
    apply after ``finalize`` (which sets gt_nei), as in the JAX CLI."""
    import argparse
    from pstl_tpu_torch import cli
    cfg = cli.build_config(argparse.Namespace(
        preset="e2_vae_mono", set=["gt_nei=false"], exp_name=None))
    assert cfg.gt_nei is False and PRESETS["e2_vae_mono"].gt_nei is True
