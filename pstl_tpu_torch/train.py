"""Training engine — port of ``pstl_tpu/train.py``.

One train step is everything between the data loader and the optimizer,
for two kinds of preset:

- **mono** (``gt_data_training``: ``e2_vae_mono``, ``e4_ddpm_mono``): the
  policy on n = batch_size * n_randoms rows under the pSTL parameters
  calibrated from the GT trajectory; the rollout of its controls is scored
  by ``specs.compute_scores``, whose neighbor clearance is the clearance
  kernel pair under ``cfg.use_pallas_clearance``.  The VAE branch
  differentiates through the rollout (the forward and the backward kernel
  once a step); the diffusion branch scores controls sampled without
  gradient (unless ``grad_rollout``), the forward kernel only.
- **dense** (``multi_check``: ``e5_ddpm``, ``e7_ours``, ``e8_stl``,
  ``e3_vae``, ``e6_trafficsim``, BC): the batch densified to
  n = batch_size * n_randoms * 3 rows (flex pSTL draws, or the
  ``pre_stlp`` column), the hoisted signal dict
  (``specs.dense_signal_input``), the trajopt targets' scores (the
  ``tj_scores_prior`` column, else the rollout of ``params`` scored on the
  "discs" route) and, for the diffusion head, the epsilon-MSE of the
  noised targets, masked to the satisfying rows (``stl_bc_mask``).  Plain
  DDPM (e5) stops there.  With
  ``rect_head`` (e7 / e8) the step also runs the full unguided sampler
  without gradient, picks the best of the last ``multi_cands`` decodings
  under the ``TiledScorer``, rectifies them with ``Net.rect`` and scores the
  result with gradient (``geometry.min_clearance_tiled``'s recompute VJP):
  the STL hinge, the DPP diversity and the stay-close regularizer, or,
  without ``diverse_loss``, the normalized regularizer and the collision
  loss.  The baselines' heads on the same rows: the VAE (``e3_vae`` with
  the init hint, ``e6_trafficsim``) encodes the trajopt controls and
  decodes a latent drawn per row, the BC head maps the scene to controls;
  each is trained on the STL hinge of its controls' rollouts (with
  gradient, through the ``TiledScorer``), the target MSE masked by
  ``stl_bc_mask`` (``losses.vae_losses`` with the KL term, or
  ``losses.bc_mse``) and the collision loss, whose full geometry route
  materializes (n, K, T, nL, nW) pair tensors.  No custom kernel runs on
  this path, as none does in the JAX package's.

With ``rect_head`` and not ``joint``, Adam updates the RefineNet head
(``rect_net``, ``merge_net``) only, and every other parameter stays as it
was to the bit (``optax.multi_transform`` with ``set_to_zero``).

Randomness is injectable: ``draws`` maps "vae_noise" (n, vae_dim),
"prep_noise" (n, nt*2), "prep_t" (n,), "sample_noise" (diffusion_steps, n,
nt*2) and, on the dense step, "flex" (the (3, 6, batch_size, 1) uniforms of
``specs.flex_uniforms``) to the values the step uses; what is not given is
drawn from ``generator``.  The parameters live in the ``Net``; a train step
updates them in place.  Checkpoints (``save_checkpoint``,
``load_checkpoint``, ``load_params_only``) are torch files under
``exps/<exp_name>/torch_models``.

With ``guidance`` (``ours_guidance``, ``ours_guidance_sim``) the dense
step's sampler is guided through a context with no fused loss, so it runs
the row-major fallback loss at the threshold ``stl_nn_thres``, as the JAX
step does.  ``train`` reads batches from the native shard store under
``use_shard_store`` and logs per-section wall times under
``time_profile``.

Not ported (each raises, by name): ``grad_rollout`` on the dense
diffusion step, the constant-velocity neighbor prediction
(``gt_nei=False``), and the viz of an experiment directory (``exp_name``
with ``no_viz`` False; ROADMAP.md §1 item 5).  The JAX package's
device-side chunking (``train_chunk``) is exact by construction, so the
port steps once per batch.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pstl_tpu_torch import diffusion, losses, specs
from pstl_tpu_torch.config import Config
from pstl_tpu_torch.data.dataset import (SceneDataset, batch_iterator,
                                         shard_store_iterator, to_shard_store)
from pstl_tpu_torch.device import resolve_device
from pstl_tpu_torch.models import convert
from pstl_tpu_torch.models.net import Net, init_flax_like
from pstl_tpu_torch.ops import dynamics as dyn
from pstl_tpu_torch.utils.exp import MODELS_DIR, setup_exp_dir
from pstl_tpu_torch.utils.meters import EtaEstimator, MeterDict, Timer

Tensor = torch.Tensor

#: batch columns a step reads (the JAX package's filter)
COLS = ("ego", "neighbors", "curr", "left", "right", "gt_", "params",
        "tj_scores", "pre_stlp")
#: the RefineNet head: what Adam updates with rect_head and not joint
RECT_MODULES = ("rect_net", "merge_net")
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
    """Adam at ``cfg.lr`` (optax.adam's update) over every parameter, or,
    with ``rect_head`` and not ``joint``, over the RefineNet head only: the
    other parameters are not in the optimizer and never move."""
    if cfg.rect_head and not cfg.joint:
        return torch.optim.Adam(
            [p for k, p in params.named_parameters()
             if k.split(".")[0] in RECT_MODULES], lr=cfg.lr)
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


def _dense_forward_and_loss(net: Net, batch, cfg: Config, formulas,
                            coeffs: diffusion.Coeffs, gt_stlp: Tensor,
                            states: Tensor, draws: Dict[str, Tensor],
                            generator: Optional[torch.Generator]):
    """The dense (``multi_check``) branch: plain DDPM, or with ``rect_head``
    the sampler, the multi-candidate selection and the RefineNet; the VAE
    (``e3_vae``, ``e6_trafficsim``) and BC heads on the trajopt targets
    (``pstl_tpu/train.py:batch_forward_and_loss``)."""
    if cfg.diffusion and cfg.grad_rollout and not cfg.rect_head:
        raise NotImplementedError("grad_rollout (training through the dense "
                                  "sampler) is not ported")
    if not (cfg.diffusion or cfg.vae or cfg.bc):
        raise NotImplementedError("the dense step needs a diffusion, VAE or "
                                  "BC head")
    bs = states.shape[0]
    n = bs * cfg.n_randoms * 3
    rd: Dict[str, Tensor] = {}
    dense = specs.densify_batch(batch, gt_stlp, cfg, flex=draws.get("flex"),
                                generator=generator)
    states_flat = torch.repeat_interleave(states, cfg.n_randoms * 3, 0)
    highlevel = dense["highlevel_dense"]
    signal_base = specs.dense_signal_input(dense, cfg=cfg)
    valid = dense["valids_dense"].reshape(-1)

    # the trajopt targets and their scores (offline sidecars, else scored)
    dense_controls = batch["params"].reshape(n, cfg.nt, 2)
    if "tj_scores_prior" in batch:
        dense_scores = batch["tj_scores_prior"].reshape(-1)
    else:
        tj_trajs = dyn.rollout(states_flat, dense_controls, cfg.dt)
        _, dense_scores, _ = specs.compute_scores(
            dict(signal_base, ego_traj=tj_trajs[:, :-1]), formulas,
            highlevel, valid, cfg)
    score_rows = specs.make_score_rows(batch, dense, cfg, formulas=formulas)

    def score_controls(controls):
        s = score_rows(dyn.rollout(states_flat, controls, cfg.dt)[:, :-1])
        return s, specs.mask_mean((s > 0).float(), valid)

    def coll_loss(controls):
        """TrafficSim collision loss on the rollouts (``collision_loss``)."""
        if cfg.collision_loss is None:
            return controls.new_zeros(())
        trajs = dyn.rollout(states_flat, controls, cfg.dt)
        sig = specs.prep_signals(dict(signal_base, ego_traj=trajs[:, :-1]),
                                 cfg, with_collision=True)
        return losses.collision(sig["min_centroid_d"], sig["radius_sum"],
                                cfg)

    if not cfg.diffusion:
        # the VAE (trajopt controls encoded, the latent drawn per row) or
        # the BC head, trained on the hinge of its own controls' scores,
        # the target MSE and the collision loss
        if cfg.vae:
            noise = draws.get("vae_noise")
            if noise is None:
                noise = torch.randn((n, cfg.vae_dim), generator=generator,
                                    device=states.device)
            nn_controls, latent_stats = net(dense, {
                "highlevel": highlevel, "noise": noise,
                "trajopt_controls": dense_controls})
        else:
            nn_controls = net(dense, {"highlevel": highlevel})
        scores, acc = score_controls(nn_controls)
        rd["loss_stl"] = losses.stl_hinge(scores, valid, cfg.stl_nn_thres,
                                          cfg.stl_weight)
        if cfg.vae:
            rd["loss_vae_bc"], rd["loss_vae_kl"] = losses.vae_losses(
                nn_controls, dense_controls, latent_stats, dense_scores,
                valid, cfg)
            rd["loss_coll"] = coll_loss(nn_controls)
            rd["loss"] = (rd["loss_stl"] + rd["loss_vae_bc"]
                          + rd["loss_vae_kl"] + rd["loss_coll"])
        else:
            rd["loss_bc"] = losses.bc_mse(nn_controls, dense_controls,
                                          dense_scores, valid, cfg)
            rd["loss_coll"] = coll_loss(nn_controls)
            rd["loss"] = rd["loss_stl"] + rd["loss_bc"] + rd["loss_coll"]
        rd["acc"] = acc
        rd["tj_acc"] = specs.mask_mean((dense_scores > 0).float(), valid)
        return rd["loss"], rd

    noise, steps, noised = diffusion.prep(
        batch["params"], cfg, coeffs, noise=draws.get("prep_noise"),
        t=draws.get("prep_t"), generator=generator)
    ext = {"timestep": steps.float(), "highlevel": highlevel,
           "noise": noised}
    eps_hat, feature = net(dense, ext, get_feature=True)
    rd["loss_diffusion"] = losses.diffusion_eps_mse(
        noise, eps_hat.reshape(n, cfg.nt * 2), dense_scores, valid, cfg)

    if cfg.rect_head:
        # the sampler and the selection carry no gradient (stop_gradient in
        # the JAX step)
        with torch.no_grad():
            feat = feature.detach()
            # guided (ours_guidance): the context carries no fused loss, so
            # the guidance runs the row-major fallback loss, threshold
            # stl_nn_thres (maximize=False)
            ctx = (diffusion.make_guidance_ctx(score_rows, valid, states_flat)
                   if cfg.guidance else None)
            nn_controls, all_steps = diffusion.sample(
                lambda e: net(dense, e, prev_feature=feat), highlevel, cfg,
                coeffs, n, noise=draws.get("sample_noise"),
                generator=generator, stlp_dense=dense["stlp_dense"],
                guide=ctx)
            if cfg.multi_cands is not None:
                nn_controls, prev_scores = diffusion.select_multi_cands(
                    all_steps, cfg.multi_cands, states_flat, score_rows, cfg)
            else:
                prev_scores, _ = score_controls(nn_controls)
        rect_controls = net.rect(feature, highlevel,
                                 dense["stlp_dense"][:, 0], nn_controls,
                                 prev_scores)
        scores, acc = score_controls(rect_controls)
        rd["loss_stl"] = losses.stl_hinge(scores, valid, cfg.stl_nn_thres,
                                          cfg.stl_weight)
        if cfg.diverse_loss:
            rd["loss_diversity"] = losses.dpp_diversity(rect_controls, scores,
                                                        cfg)
            # the stay-close mask reads the post-rect scores
            rd["loss_reg"], _ = losses.rect_reg(rect_controls, nn_controls,
                                                scores, cfg)
            rd["loss"] = (rd["loss_stl"] + rd["loss_reg"] * cfg.rect_reg_loss
                          + rd["loss_diversity"])
        else:
            rd["loss_reg"], rd["extra_loss_reg"] = losses.rect_reg(
                rect_controls, nn_controls, prev_scores, cfg)
            rd["loss_coll"] = coll_loss(rect_controls)
            rd["loss"] = (rd["loss_stl"] + rd["loss_reg"]
                          + rd["extra_loss_reg"] + rd["loss_coll"])
    else:
        # plain DDPM: the STL hinge of the targets' scores is a metric only
        acc = specs.mask_mean((dense_scores > 0).float(), valid)
        rd["loss_stl"] = losses.stl_hinge(dense_scores, valid,
                                          cfg.stl_nn_thres,
                                          cfg.stl_weight) * 0.0
        rd["loss_coll"] = coll_loss(dense_controls)
        rd["loss"] = rd["loss_stl"] + rd["loss_diffusion"] + rd["loss_coll"]
    rd["acc"] = acc
    rd["tj_acc"] = specs.mask_mean((dense_scores > 0).float(), valid)
    return rd["loss"], rd


def batch_forward_and_loss(params: Net, batch: Dict[str, Tensor],
                           cfg: Config, formulas, coeffs: diffusion.Coeffs,
                           train: bool,
                           draws: Optional[Dict[str, Tensor]] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Everything between data loader and optimizer for one batch; returns
    (loss, metrics).  ``train`` is the JAX signature's flag: the step
    computes the same either way."""
    batch = attach_neighbors(batch, cfg)
    gt_trajs = batch["ego_traj"][..., :4]
    states = gt_trajs[:, 0, :4]
    gt_stlp = specs.calibrate_stlp(batch, gt_trajs, cfg)
    branch = (_mono_forward_and_loss if cfg.gt_data_training
              else _dense_forward_and_loss)
    return branch(params, batch, cfg, formulas, coeffs, gt_stlp, states,
                  draws or {}, generator)


def make_train_step(cfg: Config, net: Net, formulas,
                    coeffs: diffusion.Coeffs, opt: torch.optim.Optimizer):
    """``train_step(batch, draws=None, generator=None) -> metrics``: loss,
    gradients of every parameter (left in their ``.grad``) and one Adam
    update by ``opt`` of the parameters it holds, in place."""

    def train_step(batch: Dict[str, Tensor],
                   draws: Optional[Dict[str, Tensor]] = None,
                   generator: Optional[torch.Generator] = None):
        net.zero_grad(set_to_none=True)
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


# ---------------------------------------------------------------------------
# checkpoints (torch files)
# ---------------------------------------------------------------------------

def save_checkpoint(ckpt_dir: str, state: TrainState, step: int) -> str:
    """Write the parameters, the optimizer state and the step count to
    ``<ckpt_dir>/step_<step>.pt`` and point ``<ckpt_dir>/LAST`` at it;
    returns the file."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}.pt"))
    # written beside and renamed: an interrupted save leaves no half file
    torch.save({"params": state.net.state_dict(),
                "opt_state": state.opt.state_dict(), "step": state.step},
               path + ".tmp")
    os.replace(path + ".tmp", path)
    with open(os.path.join(ckpt_dir, "LAST"), "w") as f:
        f.write(path)
    return path


def _resolve_ckpt(ckpt_dir: str) -> str:
    """The file ``LAST`` points at (looked up beside it when the directory
    moved), or ``ckpt_dir`` itself without a pointer."""
    last = os.path.join(ckpt_dir, "LAST")
    if not os.path.exists(last):
        return os.path.abspath(ckpt_dir)
    with open(last) as f:
        path = f.read().strip()
    if not os.path.exists(path):
        path = os.path.join(ckpt_dir, os.path.basename(path))
    return os.path.abspath(path)


def _read_checkpoint(path: str, device) -> dict:
    return torch.load(_resolve_ckpt(path), map_location=device,
                      weights_only=True)


def load_checkpoint(ckpt_dir: str, state: TrainState) -> TrainState:
    """Resume: the checkpoint's parameters and optimizer state into
    ``state``'s net and optimizer (made as the saved ones were), and its
    step count."""
    ck = _read_checkpoint(ckpt_dir, next(state.net.parameters()).device)
    state.net.load_state_dict(ck["params"])
    state.opt.load_state_dict(ck["opt_state"])
    return TrainState(state.net, state.opt, int(ck["step"]))


def load_params_only(path: str, state: TrainState) -> TrainState:
    """Pretrained weights into ``state``'s net, from a port checkpoint (a
    directory with ``LAST``, or a file) or a flat flax ``.npz``
    (``models/convert.py``).  Each top-level module the source holds is
    loaded whole; a module it lacks keeps its parameters (the RefineNet head
    of a plain DDPM source stays as initialized); modules of the source that
    the net lacks are ignored."""
    if path.endswith(".npz"):
        src = convert.load_npz(path)
    else:
        src = _read_checkpoint(path, "cpu")["params"]
    have = {k.split(".")[0] for k in src}
    with torch.no_grad():
        for k, p in state.net.state_dict().items():
            if k.split(".")[0] not in have:
                continue
            if k not in src:
                raise KeyError(f"{path}: module {k.split('.')[0]} lacks {k}")
            p.copy_(src[k])
    return state


# ---------------------------------------------------------------------------
# training loop
# ---------------------------------------------------------------------------

def train(cfg: Config, ds: SceneDataset, epochs: Optional[int] = None,
          device=None, log: Callable = print,
          history: Optional[list] = None, epoch_cb=None) -> TrainState:
    """The epoch loop over {train, val} with one step per batch
    (``pstl_tpu/train.py:train``): flax-like initialization from
    ``cfg.seed``, then ``cfg.net_pretrained_path``'s weights
    (``load_params_only``) and a fresh optimizer; random control seeds for
    the dataset where it has no trajopt ``params``; shuffled train batches
    and unshuffled val batches (the ragged tail dropped); metrics logged per
    ``print_freq`` batches and per pass with the time left.  Every draw
    comes from one generator on ``device`` seeded with ``cfg.seed``.
    ``history``, when given, receives (epoch, mode, {metric: value}) for
    every batch; ``epoch_cb(epoch, state)`` runs after each epoch's val
    pass.  With ``cfg.exp_name`` the experiment directory is made
    (``utils.exp.setup_exp_dir``, no tee) and a checkpoint is written under
    ``exps/<exp_name>/torch_models`` every ``save_freq`` epochs and after
    the last.  ``cfg.use_shard_store``: the batches come from the native
    shard store under ``exps/<exp_name or _tmp>/shard_store`` (written from
    ``ds`` when it holds no ``meta.json``; the same batches as
    ``batch_iterator``).  ``cfg.time_profile``: each pass also logs the
    mean wall seconds between its marks ``data`` (the iterator), ``h2d``
    (the copy to the device), ``step`` (the step, synchronized) and ``log``
    (the metrics)."""
    if cfg.exp_name and not cfg.no_viz:
        raise NotImplementedError(
            "the viz of an experiment directory is not ported (ROADMAP.md "
            "§1 item 12): pass no_viz=True, or exp_name=None")
    dev = resolve_device(device)
    formulas = specs.build_scorer(cfg)
    coeffs = diffusion.get_coeffs(cfg, device=dev)
    net = Net(cfg).to(dev)
    ds.ensure_random_params(cfg.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    state = init_state(cfg, net, gen)
    if cfg.net_pretrained_path:
        state = load_params_only(cfg.net_pretrained_path, state)
    state = TrainState(net, make_optimizer(cfg, net), 0)
    train_step = make_train_step(cfg, net, formulas, coeffs, state.opt)
    eval_step = make_eval_step(cfg, net, formulas, coeffs)
    if cfg.exp_name:
        ckpt_dir = os.path.join(setup_exp_dir(cfg, tee=False), MODELS_DIR)
    store = None
    if cfg.use_shard_store:
        # the native data path: a memory-mapped column store, gathered by a
        # C++ thread pool with double-buffered prefetch
        from pstl_tpu_torch.runtime import ShardStore
        sdir = os.path.join("exps", cfg.exp_name or "_tmp", "shard_store")
        if not os.path.exists(os.path.join(sdir, "meta.json")):
            to_shard_store(ds, sdir)
        store = ShardStore(sdir)
        store_cols = tuple(c for c in store.columns if c.startswith(COLS))

    def make_iter(mode, epi):
        if store is not None:
            return shard_store_iterator(store, ds, mode, cfg.batch_size,
                                        shuffle=(mode == "train"),
                                        seed=cfg.seed, epoch=epi,
                                        columns=store_cols)
        return batch_iterator(ds, mode, cfg.batch_size,
                              shuffle=(mode == "train"), seed=cfg.seed,
                              epoch=epi)

    n_epochs = epochs if epochs is not None else cfg.epochs
    eta = EtaEstimator(n_epochs, ds.split_len("train") // cfg.batch_size,
                       ds.split_len("val") // cfg.batch_size, cfg.viz_freq)
    for epi in range(n_epochs):
        for mode in ("train", "val"):
            md = MeterDict()
            it = make_iter(mode, epi)
            t0 = time.time()
            bi = -1
            timer = Timer() if cfg.time_profile else None
            for bi, b in enumerate(it):
                if timer:
                    timer.add("data")
                batch = to_device(b, dev)
                if timer:
                    timer.add("h2d")
                if mode == "train":
                    rd = train_step(batch, generator=gen)
                    state = state._replace(step=state.step + 1)
                else:
                    rd = eval_step(batch, generator=gen)
                if timer:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    timer.add("step")
                vals = {k: float(rd[k]) for k in METRIC_KEYS if k in rd}
                for k, v in vals.items():
                    md.update(k, v)
                if history is not None:
                    history.append((epi, mode, vals))
                if timer:
                    timer.add("log")
                if (mode == "train" and cfg.print_freq > 0
                        and bi % cfg.print_freq == 0):
                    log(f"{mode:5s}[{epi:03d}|{bi:04d}] " + md.summary())
            if timer:
                log(f"profile[{epi:03d}|{mode}] " + timer.report())
            dur = time.time() - t0
            eta.update(mode, dur, n=max(bi + 1, 1))
            if mode == "val":
                eta.epoch_done()
            log(f"{mode:5s}[{epi:03d}] " + md.summary()
                + f" T:{dur:.1f}s ETA:{eta.eta_str()}")
        if epoch_cb is not None:
            epoch_cb(epi, state)
        if cfg.exp_name and (epi % cfg.save_freq == 0 or epi == n_epochs - 1):
            save_checkpoint(ckpt_dir, state, epi)
    if store is not None:
        store.close()
    return state
