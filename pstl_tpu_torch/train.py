"""Training engine for the mono (``gt_data_training``) step — port of
``pstl_tpu/train.py`` for the presets ``e2_vae_mono`` and ``e4_ddpm_mono``.

One train step is everything between the data loader and the optimizer:
neighbor attachment, pSTL calibration from the GT trajectory, the policy
forward on n = batch_size * n_randoms rows, the rollout of its controls,
their STL robustness (``specs.compute_scores``, whose neighbor clearance is
the clearance kernel pair under ``cfg.use_pallas_clearance``), the losses,
autograd and Adam.  The VAE branch differentiates through the rollout, so
each train step launches the forward clearance kernel once and its
backward once; the diffusion branch scores controls sampled without
gradient (unless ``grad_rollout``), so it launches the forward kernel only.

Randomness is injectable: ``draws`` maps "vae_noise" (n, vae_dim),
"prep_noise" (n, nt*2), "prep_t" (n,) and "sample_noise"
(diffusion_steps, n, nt*2) to the values the step uses; what is not given
is drawn from ``generator``.  The parameters live in the ``Net``; a train
step updates them in place.

Not ported (each raises): the dense (``multi_check``) step with RefineNet
parameter groups, DPP and collision losses; checkpoints and viz of an
experiment directory (``cfg.exp_name``); pretrained weights
(``net_pretrained_path``); the constant-velocity neighbor prediction; the
shard store and the device-side chunking of the JAX package, which is a
TPU dispatch device and exact by construction.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pstl_tpu_torch import diffusion, losses, specs
from pstl_tpu_torch.config import Config
from pstl_tpu_torch.data.dataset import SceneDataset, batch_iterator
from pstl_tpu_torch.device import resolve_device
from pstl_tpu_torch.models.net import Net, init_flax_like
from pstl_tpu_torch.ops import dynamics as dyn

Tensor = torch.Tensor

#: batch columns a step reads (the JAX package's filter)
COLS = ("ego", "neighbors", "curr", "left", "right", "gt_", "params",
        "tj_scores", "pre_stlp")
METRIC_KEYS = ("loss", "loss_stl", "loss_diffusion", "loss_reg",
               "loss_diversity", "loss_vae_bc", "loss_vae_kl", "loss_bc",
               "acc", "tj_acc")


class TrainState(NamedTuple):
    """What training leaves: the net (its parameters, which each train step
    updates in place), its optimizer and the number of steps taken."""
    net: Net
    opt: torch.optim.Optimizer
    step: int


def make_optimizer(cfg: Config, params: Net) -> torch.optim.Adam:
    """Adam at ``cfg.lr`` over every parameter (optax.adam's update)."""
    if cfg.rect_head and not cfg.joint:
        raise NotImplementedError("RefineNet-only training (the optax "
                                  "multi_transform mask) is not ported")
    return torch.optim.Adam(params.parameters(), lr=cfg.lr)


def init_state(cfg: Config, net: Net,
               generator: torch.Generator) -> TrainState:
    """Fresh flax-like parameters drawn from ``generator`` (on the net's
    device), a new optimizer, step 0."""
    init_flax_like(net, generator)
    return TrainState(net, make_optimizer(cfg, net), 0)


def attach_neighbors(batch: Dict[str, Tensor],
                     cfg: Config) -> Dict[str, Tensor]:
    """Current-frame neighbors and the GT neighbor tracks (``gt_nei``)."""
    if not cfg.gt_nei:
        raise NotImplementedError("the constant-velocity neighbor "
                                  "prediction (neighbor_rollout) is not "
                                  "ported")
    batch = dict(batch)
    batch["neighbors"] = batch["neighbors_traj"][:, :, 0, :]
    batch["neighbor_trajs_aug"] = batch["neighbors_traj"]
    return batch


def _mono_forward_and_loss(net: Net, batch, cfg: Config, formulas,
                           coeffs: diffusion.Coeffs, gt_stlp: Tensor,
                           states: Tensor, draws: Dict[str, Tensor],
                           generator: Optional[torch.Generator]):
    """The GT-data ("mono") branch: n_randoms samples per scene, STL under
    the calibrated pSTL parameters (``pstl_tpu/train.py``)."""
    bs = states.shape[0]
    M = cfg.n_randoms
    n = bs * M
    dev = states.device
    rd: Dict[str, Tensor] = {}
    ego = batch["ego_traj"]
    gt_controls = (ego[:, 1:, 2:4] - ego[:, :-1, 2:4]) / cfg.dt
    gt_controls = torch.cat([gt_controls, gt_controls[:, -1:]], dim=1)
    states_mul = torch.repeat_interleave(states, M, 0)
    hl = batch["gt_high_level"]
    hl_mul = torch.repeat_interleave(hl, M, 0)
    ones = torch.ones((n,), device=dev)
    mul = lambda x: torch.repeat_interleave(x, M, 0)

    # the clearance kernels read a scene's neighbors once for its M rows
    nei = batch["neighbor_trajs_aug"]
    if specs.clearance_route(cfg) != "kernel":
        nei = mul(nei)

    def scores_of(controls):
        trajs = dyn.rollout(states_mul, controls, cfg.dt)
        sig = {"ego_traj": trajs[:, :-1],
               "neighbors": nei,
               "currlane_wpts": mul(batch["currlane_wpts"]),
               "leftlane_wpts": mul(batch["leftlane_wpts"]),
               "rightlane_wpts": mul(batch["rightlane_wpts"]),
               "stlp": mul(gt_stlp)[:, None, :]}
        _, scores, acc = specs.compute_scores(sig, formulas, hl_mul, ones,
                                              cfg)
        return scores, acc

    if cfg.diffusion:
        noise, steps, noised = diffusion.prep(
            gt_controls, cfg, coeffs, mono=True,
            noise=draws.get("prep_noise"), t=draws.get("prep_t"),
            generator=generator)
        ext = {"timestep": steps.float(), "highlevel": hl, "noise": noised,
               "gt_stlp": gt_stlp}
        eps_hat, feature = net(batch, ext, get_feature=True)
        eps_hat = eps_hat.reshape(n, cfg.nt * 2)
        rd["loss_diffusion"] = torch.mean(torch.square(noise - eps_hat))
        # the sampler runs without gradient unless grad_rollout
        with torch.set_grad_enabled(cfg.grad_rollout
                                    and torch.is_grad_enabled()):
            feat = feature if cfg.grad_rollout else feature.detach()
            controls, _ = diffusion.sample(
                lambda e: net(batch, e, prev_feature=feat, n_randoms=M),
                hl, cfg, coeffs, n, mono=True, tmp_stlp=gt_stlp,
                noise=draws.get("sample_noise"), generator=generator)
        scores, acc = scores_of(controls)
        rd["loss_stl"] = losses.stl_hinge(scores, ones, cfg.stl_nn_thres,
                                          cfg.stl_weight)
        rd["loss"] = rd["loss_diffusion"] + (rd["loss_stl"]
                                             if cfg.grad_rollout else 0.0)
    elif cfg.vae:
        noise = draws.get("vae_noise")
        if noise is None:
            noise = torch.randn((n, cfg.vae_dim), generator=generator,
                                device=dev)
        ext = {"gt_stlp": gt_stlp, "highlevel": hl,
               "gt_controls": gt_controls, "noise": noise}
        controls_mul, (mean, logstd, std) = net(batch, ext)
        scores, acc = scores_of(controls_mul)
        # minimum-over-n reconstruction; torch.amin splits ties as jnp.min
        l2 = torch.mean(torch.mean(torch.square(
            controls_mul.reshape(bs, M, cfg.nt, 2) - gt_controls[:, None]),
            dim=-1), dim=-1)
        rd["loss_vae_bc"] = torch.mean(torch.amin(l2, dim=1)) * cfg.bc_weight
        rd["loss_vae_kl"] = (-0.5 * torch.mean(
            1 + 2 * logstd - mean * mean - std * std)) * cfg.weight_vae_kl
        rd["loss_stl"] = losses.stl_hinge(scores, ones, cfg.stl_nn_thres,
                                          cfg.stl_weight)
        rd["loss"] = rd["loss_vae_bc"] + rd["loss_vae_kl"] + rd["loss_stl"]
    else:
        raise NotImplementedError("mono mode needs diffusion or vae")
    rd["acc"] = acc
    rd["tj_acc"] = acc * 0.0
    return rd["loss"], rd


def batch_forward_and_loss(params: Net, batch: Dict[str, Tensor],
                           cfg: Config, formulas, coeffs: diffusion.Coeffs,
                           train: bool,
                           draws: Optional[Dict[str, Tensor]] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Everything between data loader and optimizer for one batch; returns
    (loss, metrics).  ``train`` is the JAX signature's flag: the mono step
    computes the same either way."""
    if not cfg.gt_data_training:
        raise NotImplementedError(
            "the dense (multi_check) training step is not ported "
            "(ROADMAP.md §1 item 7); the port trains the mono presets")
    batch = attach_neighbors(batch, cfg)
    gt_trajs = batch["ego_traj"][..., :4]
    states = gt_trajs[:, 0, :4]
    gt_stlp = specs.calibrate_stlp(batch, gt_trajs, cfg)
    return _mono_forward_and_loss(params, batch, cfg, formulas, coeffs,
                                  gt_stlp, states, draws or {}, generator)


def make_train_step(cfg: Config, net: Net, formulas,
                    coeffs: diffusion.Coeffs, opt: torch.optim.Optimizer):
    """``train_step(batch, draws=None, generator=None) -> metrics``: loss,
    gradients (left in the parameters' ``.grad``) and one Adam update of
    ``net`` by ``opt``, in place."""

    def train_step(batch: Dict[str, Tensor],
                   draws: Optional[Dict[str, Tensor]] = None,
                   generator: Optional[torch.Generator] = None):
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, rd = batch_forward_and_loss(net, batch, cfg, formulas,
                                              coeffs, True, draws, generator)
            loss.backward()
        opt.step()
        return {k: v.detach() for k, v in rd.items()}

    return train_step


def make_eval_step(cfg: Config, net: Net, formulas,
                   coeffs: diffusion.Coeffs):
    """``eval_step(batch, draws=None, generator=None) -> metrics``, without
    gradient."""

    def eval_step(batch: Dict[str, Tensor],
                  draws: Optional[Dict[str, Tensor]] = None,
                  generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            _, rd = batch_forward_and_loss(net, batch, cfg, formulas, coeffs,
                                           False, draws, generator)
        return rd

    return eval_step


class MeterDict:
    """Last value and running mean per metric."""

    def __init__(self):
        self.cur: Dict[str, float] = {}
        self.sum: Dict[str, float] = {}
        self.count: Dict[str, int] = {}

    def update(self, key: str, val: float):
        self.cur[key] = val
        self.sum[key] = self.sum.get(key, 0.0) + val
        self.count[key] = self.count.get(key, 0) + 1

    def summary(self) -> str:
        avg = {k: self.sum[k] / self.count[k] for k in self.cur}
        return " ".join(f"{k}:{self.cur[k]:.3f}({avg[k]:.3f})"
                        for k in sorted(self.cur))


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Tensor]:
    """A step's columns on ``device`` (float64 arrays as float32)."""
    out = {}
    for k, v in batch.items():
        if k.startswith(COLS):
            v = np.asarray(v)
            if v.dtype == np.float64:
                v = v.astype(np.float32)
            out[k] = torch.as_tensor(v, device=device)
    return out


def train(cfg: Config, ds: SceneDataset, epochs: Optional[int] = None,
          device=None, log: Callable = print,
          history: Optional[list] = None) -> TrainState:
    """The epoch loop over {train, val} with one step per batch
    (``pstl_tpu/train.py:train``): flax-like initialization from
    ``cfg.seed``, random control seeds for the dataset, shuffled train
    batches and unshuffled val batches (the ragged tail dropped), metrics
    logged per ``print_freq`` batches and per pass.  Every draw comes from
    one generator on ``device`` seeded with ``cfg.seed``.  ``history``, when
    given, receives (epoch, mode, {metric: value}) for every batch."""
    if cfg.exp_name:
        raise NotImplementedError(
            "checkpoints and viz of an experiment directory are not ported "
            "(ROADMAP.md §1 items 7 and 12): pass exp_name=None")
    if cfg.net_pretrained_path:
        raise NotImplementedError("loading pretrained weights into training "
                                  "is not ported")
    dev = resolve_device(device)
    formulas = specs.build_scorer(cfg)
    coeffs = diffusion.get_coeffs(cfg, device=dev)
    net = Net(cfg).to(dev)
    ds.ensure_random_params(cfg.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    state = init_state(cfg, net, gen)
    train_step = make_train_step(cfg, net, formulas, coeffs, state.opt)
    eval_step = make_eval_step(cfg, net, formulas, coeffs)
    n_epochs = epochs if epochs is not None else cfg.epochs
    for epi in range(n_epochs):
        for mode in ("train", "val"):
            md = MeterDict()
            t0 = time.time()
            for bi, b in enumerate(batch_iterator(
                    ds, mode, cfg.batch_size, shuffle=(mode == "train"),
                    seed=cfg.seed, epoch=epi)):
                batch = to_device(b, dev)
                if mode == "train":
                    rd = train_step(batch, generator=gen)
                    state = state._replace(step=state.step + 1)
                else:
                    rd = eval_step(batch, generator=gen)
                vals = {k: float(rd[k]) for k in METRIC_KEYS if k in rd}
                for k, v in vals.items():
                    md.update(k, v)
                if history is not None:
                    history.append((epi, mode, vals))
                if (mode == "train" and cfg.print_freq > 0
                        and bi % cfg.print_freq == 0):
                    log(f"{mode:5s}[{epi:03d}|{bi:04d}] " + md.summary())
            log(f"{mode:5s}[{epi:03d}] " + md.summary()
                + f" T:{time.time() - t0:.1f}s")
    return state
