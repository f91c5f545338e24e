"""The port's training loop (``pstl_tpu_torch.train.train``) on the CPU at a
small size: one epoch of each mono preset, the clearance calls it makes
(what the launch counts must show on the card), determinism under the
seed, the flax-like initialization, and what the port refuses (the dense
presets' loop: ``tests/test_torch_checkpoint.py``)."""

import os

import numpy as np
import pytest
import torch

from pstl_tpu.config import Config as JConfig
from pstl_tpu.models import Net as JNet
from pstl_tpu_torch import diffusion, sim, specs, train
from pstl_tpu_torch.config import PRESETS, mono_config
from pstl_tpu_torch.data.dataset import SceneDataset, batch_iterator
from pstl_tpu_torch.models import convert
from pstl_tpu_torch.models.net import Net, init_flax_like
from pstl_tpu_torch.ops import clearance_kernel as ck

import torch_parity  # noqa: F401  (torch thread count)

SMALL = dict(hiddens=(32, 32), vae_dim=8, n_randoms=4, batch_size=4,
             n_neighbors=3, print_freq=1, diffusion_steps=6)


def run_epoch(preset, monkeypatch, **kw):
    cfg = mono_config(preset, **SMALL, **kw)
    ds = SceneDataset.from_synthetic(cfg, n_scenes=14)
    calls = {"fwd": 0, "bwd": 0}
    real_f, real_b = ck.min_clearance_fwd_plain, ck.min_clearance_bwd_plain

    def fwd(*a):
        calls["fwd"] += 1
        return real_f(*a)

    def bwd(*a):
        calls["bwd"] += 1
        return real_b(*a)

    monkeypatch.setattr(ck, "min_clearance_fwd_plain", fwd)
    monkeypatch.setattr(ck, "min_clearance_bwd_plain", bwd)
    hist, logs = [], []
    state = train.train(cfg, ds, epochs=1, device="cpu", log=logs.append,
                        history=hist)
    n_train = ds.split_len("train") // cfg.batch_size
    n_val = ds.split_len("val") // cfg.batch_size
    return cfg, state, hist, logs, calls, n_train, n_val


@pytest.mark.parametrize("preset", ["e2_vae_mono", "e4_ddpm_mono"])
def test_one_epoch_and_its_clearance_calls(preset, monkeypatch):
    cfg, state, hist, logs, calls, n_train, n_val = run_epoch(
        preset, monkeypatch)
    assert n_train == 2 and n_val == 1
    assert [m for _, m, _ in hist] == ["train"] * n_train + ["val"] * n_val
    assert state.step == n_train
    for _, _, vals in hist:
        assert "loss" in vals and "loss_stl" in vals and "acc" in vals
        assert all(np.isfinite(v) for v in vals.values())
    # one forward per step; the VAE step differentiates through the
    # rollout (one VJP per train step), the DDPM step does not
    assert calls["fwd"] == n_train + n_val
    assert calls["bwd"] == (n_train if cfg.vae else 0)
    assert any(line.startswith("val  [000]") for line in logs)


def test_training_is_seeded(monkeypatch):
    """The same seed gives the same parameters; another seed does not."""
    _, a, *_ = run_epoch("e2_vae_mono", monkeypatch)
    _, b, *_ = run_epoch("e2_vae_mono", monkeypatch)
    _, c, *_ = run_epoch("e2_vae_mono", monkeypatch, seed=5)
    for (k, pa), pb, pc in zip(a.net.state_dict().items(),
                               b.net.state_dict().values(),
                               c.net.state_dict().values()):
        assert torch.equal(pa, pb), k
    assert any(not torch.equal(pa, pc) for pa, pc in zip(
        a.net.state_dict().values(), c.net.state_dict().values()))


def test_init_flax_like_matches_flax_statistics():
    """Weights drawn as flax's Dense draws them: zero biases, a normal
    truncated at two standard deviations with variance 1/fan_in (the
    moments of the truncated normal, and flax's own draw, agree)."""
    import jax
    cfg = PRESETS["e2_vae_mono"]
    net = Net(cfg)
    init_flax_like(net, torch.Generator().manual_seed(0))
    jcfg = JConfig(**cfg.to_dict())
    jnet = JNet(jcfg)
    from pstl_tpu import train as jtrain
    from pstl_tpu.data.dataset import SceneDataset as JDS, batch_iterator
    ds = JDS.from_synthetic(jcfg, n_scenes=4)
    ds.ensure_random_params(0)
    b = next(batch_iterator(ds, "train", 2, shuffle=False))
    b = {k: v for k, v in b.items() if k.startswith(train.COLS)}
    jparams = convert.from_flax(jax.device_get(
        jtrain.init_state(jcfg, jnet, b, jax.random.PRNGKey(0)).params))
    sd = net.state_dict()
    assert sorted(sd) == sorted(jparams)
    for k, w in sd.items():
        if k.endswith("bias"):
            assert torch.equal(w, torch.zeros_like(w)) and torch.equal(
                jparams[k], w)
            continue
        fan_in = w.shape[1]
        std = np.sqrt(1.0 / fan_in)
        assert float(w.abs().max()) <= 2 * std / 0.8796256610342398 + 1e-6
        if w.numel() >= 4096:
            for x in (w, jparams[k]):
                assert abs(float(x.std()) / std - 1) < 0.05, k
                assert abs(float(x.mean())) < 0.05 * std, k


def test_refusals():
    """What the port does not run raises, naming what is missing; the
    baselines' heads, the dense grad_rollout step and the constant-velocity
    neighbors (gt_nei=False), once refused here, run and give finite
    losses."""
    if torch.cuda.is_available():
        pytest.skip("the no-card refusal needs a host without CUDA")
    with pytest.raises(RuntimeError):
        train.resolve_device(None)
    cfg = mono_config("e2_vae_mono", **SMALL)
    ds = SceneDataset.from_synthetic(cfg, n_scenes=8)
    # pretrained weights: an orbax directory of the JAX package is refused
    with pytest.raises(ValueError, match="export_torch_weights"):
        train.train(cfg.with_(net_pretrained_path=os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "checkpoints", "e7_round5")), ds, device="cpu")
    # the constant-velocity neighbors, once refused here, run
    cv = train.attach_neighbors({"neighbors_traj": torch.ones(1, 1, 2, 7)},
                                cfg.with_(gt_nei=False))
    assert tuple(cv["neighbor_trajs_aug"].shape) == (1, 1, cfg.nt, 7)
    assert bool(torch.isfinite(cv["neighbor_trajs_aug"]).all())
    # the dense step: training through the sampler, once refused here, and
    # guidance in the sampler (ours_guidance) run
    dense = PRESETS["e5_ddpm"].with_(
        exp_name=None, hiddens=(8,), rect_hiddens=(8,), n_randoms=2,
        n_shards=1, diffusion_steps=4, n_neighbors=3)
    dds = SceneDataset.from_synthetic(dense, n_scenes=8)
    dds.ensure_random_params(0)
    batch = train.to_device(next(batch_iterator(dds, "train", 2,
                                                shuffle=False)), "cpu")
    e7 = PRESETS["e7_ours"].with_(**{k: getattr(dense, k) for k in (
        "exp_name", "hiddens", "rect_hiddens", "n_randoms", "n_shards",
        "diffusion_steps", "n_neighbors")})
    for ok in (dense.with_(grad_rollout=True, stl_weight=1.0),
               cfg.with_(gt_nei=False)):
        b = (batch if not ok.gt_data_training else train.to_device(next(
            batch_iterator(ds, "train", 2, shuffle=False)), "cpu"))
        loss, rd = train.batch_forward_and_loss(
            Net(ok), b, ok, specs.build_scorer(ok), diffusion.get_coeffs(ok),
            True)
        assert bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(v)) for v in rd.values())
    guided = e7.with_(guidance=True, guidance_before=2)
    loss, rd = train.batch_forward_and_loss(
        Net(guided), batch, guided, specs.build_scorer(guided),
        diffusion.get_coeffs(guided), True)
    assert bool(torch.isfinite(loss)) and "loss_diversity" in rd
    # the baselines are accepted: the dense VAE (with and without the init
    # hint) and BC heads build, and their dense step runs
    for kw in (dict(use_init_hint=False), {},
               dict(vae=False, bc=True, use_init_hint=False)):
        base = PRESETS["e3_vae"].with_(**{k: getattr(dense, k) for k in (
            "exp_name", "hiddens", "n_randoms", "n_neighbors")}, vae_dim=4,
            **kw)
        loss, rd = train.batch_forward_and_loss(
            Net(base), batch, base, specs.build_scorer(base),
            diffusion.get_coeffs(base), True)
        assert bool(torch.isfinite(loss)) and "loss_coll" in rd
    Net(cfg.with_(vae=False, bc=True))
    # the planner runs multi-candidate rows: a mono (gt_data_training)
    # preset still raises, by name
    with pytest.raises(NotImplementedError, match="gt_data_training"):
        sim.check_supported(cfg)
