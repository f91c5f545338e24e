"""Open-loop evaluation harness, the Table-I metrics (port of
``pstl_tpu/eval_openloop.py``).  Per batch of the val split:

1. the trajopt oracle row (:func:`_trajopt_row`): the store's ``params``
   rolled out and scored, outside the timer;
2. the timed region (:func:`_sample_and_score`): ``sampling_size``
   candidates per (scene, maneuver) from the DDPM reverse pass, guided on
   the candidate-minor route as the planner builds it (``maximize=False``:
   the hinge threshold is ``stl_nn_thres``) or unguided row-major,
   multi-cands selection, RefineNet and ``n_rolls`` re-rectifications, the
   convex refinement under ``cfg.refinement`` (K = 8); or, for the
   baselines, the VAE decoder on a prior latent or the BC head (the init
   hint of ``e3_vae`` is the store's ``params_init`` column); then the
   final rollout and scores;
3. the untimed metric tail (:func:`_nn_metrics`): std, hull area, min-ADE /
   FDE, entropies, occupancy area, label breakdown.

Table-I columns: "Success" = scene_acc, "Compliance" = acc, "Valid area" =
area, "Entropy" = ent_s.

The draws of a batch (the two densify flex draws and the sampler's noise)
are made before its warm-up, so the warm-up and the timed call compute the
same thing, as the JAX package's two calls under one key do.  The functions
take them as arguments (``flex``, ``noise``), so tests can hand in the JAX
package's own.

Refused by name: ``viz_dir`` (``viz.py`` is not ported).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from pstl_tpu_torch import diffusion, metrics, refine, sim, specs
from pstl_tpu_torch.config import Config
from pstl_tpu_torch.data.dataset import SceneDataset, batch_iterator
from pstl_tpu_torch.device import resolve_device
from pstl_tpu_torch.models import net as models
from pstl_tpu_torch.models.net import Net
from pstl_tpu_torch.ops import dynamics as dyn
from pstl_tpu_torch.train import attach_neighbors, to_device
from pstl_tpu_torch.utils.meters import MeterDict

Tensor = torch.Tensor

#: the per-batch metrics ``run`` averages, per row ("tj", "nn")
RUN_METRICS = ("acc", "scene_acc", "ade", "fde", "std", "vol", "ent_ent_s",
               "ent_ent_wa", "area")


def check_supported(cfg: Config) -> None:
    """Raise for evaluation configurations that cannot sample: the
    evaluation needs a diffusion, VAE or BC head (the JAX package's fails
    on the headless policy), and a sampler the port runs."""
    if not (cfg.diffusion or cfg.vae or cfg.bc):
        raise NotImplementedError("the evaluation needs a diffusion, VAE or "
                                  "BC head")
    if cfg.diffusion:
        diffusion.check_supported(cfg)


def _trajopt_row(net: Net, batch: Dict[str, Tensor], cfg: Config, formulas,
                 flex: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None):
    """The trajopt oracle row of Table I: the batch's ``params`` rolled out
    and scored under the dense pSTL parameters (``pre_stlp`` under
    ``load_stlp``, else the flex draw ``flex`` / ``generator``)."""
    batch = attach_neighbors(batch, cfg)
    gt_trajs = batch["ego_traj"][..., :4]
    states = gt_trajs[:, 0, :4]
    bs = states.shape[0]
    M = cfg.n_randoms
    gt_stlp = specs.calibrate_stlp(batch, gt_trajs, cfg)
    n_tj = bs * M * 3
    dense_tj = specs.densify_batch(batch, gt_stlp, cfg, flex=flex,
                                   generator=generator)
    sig_tj = specs.dense_signal_input(dense_tj, cfg=cfg)
    valid_tj = dense_tj["valids_dense"].reshape(-1)
    states_tj = states[:, None, None].expand(bs, M, 3, 4).reshape(n_tj, 4)
    tj_controls = batch["params"].reshape(n_tj, cfg.nt, 2)
    tj_trajs = dyn.rollout(states_tj, tj_controls, cfg.dt)
    _, tj_scores, tj_acc, tj_scene_acc = specs.compute_scores(
        dict(sig_tj, ego_traj=tj_trajs[:, :-1]), formulas,
        dense_tj["highlevel_dense"], valid_tj, cfg, scene=True)

    tj = {"acc": tj_acc, "scene_acc": tj_scene_acc, "scores": tj_scores}
    div = metrics.measure_diversity(
        tj_trajs[:, :-1, :2].reshape(bs, M, 3, cfg.nt * 2),
        tj_scores.reshape(bs, M, 3), valid_tj.reshape(bs, M, 3), cfg.nt)
    tj["std"], tj["vol"] = div["ma_std"], div["ma_vol"]
    tj["ade"], tj["fde"] = metrics.ade_fde(
        gt_trajs, tj_trajs[:, :-1].reshape(bs, M, 3, cfg.nt, 4),
        valid_tj.reshape(bs, -1))
    if cfg.extra_diversity:
        extra = metrics.measure_extra_diversity(
            tj_trajs[:, :-1].reshape(bs, M, 3, cfg.nt * 4),
            tj_scores.reshape(bs, M, 3), valid_tj.reshape(bs, M, 3), cfg.nt,
            tj_controls.reshape(bs, M, 3, cfg.nt * 2),
            -cfg.mul_w_max, cfg.mul_w_max, -cfg.mul_a_max, cfg.mul_a_max)
        tj.update({f"ent_{k}": v for k, v in extra.items()
                   if k.startswith("ent")})
        tj["area"] = extra["area"]
    return tj


def _sample_and_score(net: Net, batch: Dict[str, Tensor], cfg: Config,
                      formulas, coeffs: diffusion.Coeffs,
                      flex: Optional[Tensor] = None,
                      noise: Optional[Tensor] = None,
                      generator: Optional[torch.Generator] = None):
    """The timed region: dense batch of ``sampling_size`` = S candidates per
    (scene, maneuver), the configured sampler (``diffusion.sample``; the
    DDPM chain guided candidate-minor with ``make_guidance_loss`` and
    ``make_cm_eps_fn``, ``maximize=False``; otherwise row-major with the
    network's diffusion forward, guided through the context), multi-cands,
    RefineNet and ``n_rolls``, or the VAE / BC decoder, then the final
    rollout and scores.  ``flex``: the densify draw; ``noise``: the
    sampler's draws or the VAE's prior latent (N, vae_dim), of
    ``draw_shape``; what is not given
    comes from ``generator``.  Returns (nn, controls (N, nt, 2), trajs
    (N, nt+1, 4), valid (N,))."""
    check_supported(cfg)
    S = cfg.sampling_size
    batch = attach_neighbors(batch, cfg)
    gt_trajs = batch["ego_traj"][..., :4]
    states = gt_trajs[:, 0, :4]
    bs = states.shape[0]
    gt_stlp = specs.calibrate_stlp(batch, gt_trajs, cfg)

    N = bs * S * 3
    dense = specs.densify_batch(batch, gt_stlp, cfg, n_randoms=S, flex=flex,
                                generator=generator)
    valid = dense["valids_dense"].reshape(-1)
    highlevel = dense["highlevel_dense"]
    states_flat = states[:, None, None].expand(bs, S, 3, 4).reshape(N, 4)
    score_rows = specs.make_score_rows(batch, dense, cfg, n_randoms=S,
                                       formulas=formulas)

    def score_controls(u):
        trajs = dyn.rollout(states_flat, u, cfg.dt)
        s = score_rows(trajs[:, :-1])
        acc = specs.mask_mean((s > 0).to(s.dtype), valid)
        sc = s.reshape(-1, S, 3)
        mc = valid.reshape(-1, S, 3)
        scene_acc = specs.mask_mean(
            (torch.amax(sc, dim=1) > 0).to(s.dtype), mc[:, 0, :])
        return (s, acc, scene_acc), trajs

    # the scene feature, tiled to the N candidate rows
    feature = torch.repeat_interleave(net.encode(dense), S * 3, 0)
    if not cfg.diffusion:
        nn_controls = sim.decode_baseline(net, dense, feature, cfg, noise,
                                          generator, n_randoms=S)
        (scores, acc, scene_acc), nn_trajs = score_controls(nn_controls)
        nn = {"acc": acc, "scene_acc": scene_acc, "scores": scores}
        return nn, nn_controls, nn_trajs, valid
    fused = (specs.make_guidance_loss(batch, dense, cfg, states, valid,
                                      n_randoms=S)
             if cfg.guidance else None)
    ctx = (diffusion.make_guidance_ctx(score_rows, valid, states_flat, fused)
           if cfg.guidance else None)
    cm_fn = (models.make_cm_eps_fn(net, dense, highlevel, feature, cfg,
                                   n_randoms=S)
             if cfg.cm_sampler and fused is not None else None)
    nn_controls, all_steps = diffusion.sample(
        lambda e: net(dense, e, prev_feature=feature, n_randoms=S),
        highlevel, cfg, coeffs, N, noise=noise, generator=generator,
        stlp_dense=dense["stlp_dense"], guide=ctx, maximize=False,
        cm_fn=cm_fn)
    if cfg.rect_head and not cfg.not_use_rect:
        if cfg.multi_cands is not None:
            nn_controls, prev_scores = diffusion.select_multi_cands(
                all_steps, cfg.multi_cands, states_flat, score_rows, cfg)
        else:
            (prev_scores, _, _), _ = score_controls(nn_controls)
        stlp_rows = dense["stlp_dense"][:, 0]
        if not cfg.no_refinenet:
            nn_controls = net.rect(feature, highlevel, stlp_rows,
                                   nn_controls, prev_scores)
        for _ in range(cfg.n_rolls or 0):
            (s_re, _, _), _ = score_controls(nn_controls)
            nn_controls = net.rect(feature, highlevel, stlp_rows,
                                   nn_controls, s_re)
        if cfg.refinement:
            nn_controls = refine.convex_refinement(
                nn_controls, all_steps, states_flat, score_rows, valid, cfg)

    (scores, acc, scene_acc), nn_trajs = score_controls(nn_controls)
    nn = {"acc": acc, "scene_acc": scene_acc, "scores": scores}
    return nn, nn_controls, nn_trajs, valid


def _nn_metrics(nn, nn_controls: Tensor, nn_trajs: Tensor, valid: Tensor,
                batch: Dict[str, Tensor], cfg: Config):
    """The untimed metric tail: diversity, ADE/FDE, entropy / area, label
    breakdown."""
    S = cfg.sampling_size
    batch = attach_neighbors(batch, cfg)
    gt_trajs = batch["ego_traj"][..., :4]
    bs = gt_trajs.shape[0]
    scores = nn["scores"]
    nn = dict(nn)
    div = metrics.measure_diversity(
        nn_trajs[:, :-1, :2].reshape(bs, S, 3, cfg.nt * 2),
        scores.reshape(bs, S, 3), valid.reshape(bs, S, 3), cfg.nt)
    nn["std"], nn["vol"] = div["ma_std"], div["ma_vol"]
    nn["ade"], nn["fde"] = metrics.ade_fde(
        gt_trajs, nn_trajs[:, :-1].reshape(bs, S, 3, cfg.nt, 4),
        valid.reshape(bs, -1))
    if cfg.extra_diversity:
        extra = metrics.measure_extra_diversity(
            nn_trajs[:, :-1].reshape(bs, S, 3, cfg.nt * 4),
            scores.reshape(bs, S, 3), valid.reshape(bs, S, 3), cfg.nt,
            nn_controls.reshape(bs, S, 3, cfg.nt * 2),
            -cfg.mul_w_max, cfg.mul_w_max, -cfg.mul_a_max, cfg.mul_a_max)
        nn.update({f"ent_{k}": v for k, v in extra.items()
                   if k.startswith("ent")})
        nn["area"] = extra["area"]
    nn.update(metrics.label_score_breakdown(
        scores.reshape(bs, S, 3), batch["gt_high_level"][:, 0],
        valid.reshape(bs, S, 3)))
    return nn


def sampler_shape(cfg: Config, bs: int):
    """The layout of one of the sampler's draws for ``bs`` scenes: the
    candidate-minor (bs, nt, 2, 3*S) on the DDPM chain with a guided step,
    ``cm_sampler`` and the fused loss, else the row-major (bs*3*S, nt*2)
    (``diffusion.draw_layout``)."""
    return diffusion.draw_layout(cfg, bs, 3 * cfg.sampling_size)


def draw_shape(cfg: Config, bs: int):
    """The shape of ``_sample_and_score``'s ``noise`` for ``bs`` scenes: the
    sampler's (``diffusion.n_draws``, *sampler_shape) -- DDPM T, DDIM S + 1,
    DPM++ 1 --, the VAE's prior latent (bs*3*S, vae_dim), or None (the BC
    head draws nothing)."""
    if cfg.diffusion:
        return (diffusion.n_draws(cfg),) + sampler_shape(cfg, bs)
    if cfg.vae:
        return (bs * 3 * cfg.sampling_size, cfg.vae_dim)
    return None


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def run(cfg: Config, ds: SceneDataset, net: Net,
        n_trials: Optional[int] = None, log: Callable = print,
        viz_dir: Optional[str] = None, device=None,
        times: Optional[list] = None) -> Dict[str, float]:
    """Open-loop evaluation over the val split; returns the averaged
    metrics ("tj_*" the oracle row, "nn_*" the sampled one, "time" the timed
    region in seconds).  ``cfg`` is finalized with ``run_sampling_test``
    (which turns ``extra_diversity`` on); batches of ``cfg.batch_size``
    scenes, the tail wrapped, ``n_trials`` + 1 of them at most.  The first
    batch's sampling runs once before the timer (warm-up).  Every draw comes
    from one generator on the device seeded with ``cfg.seed + 123``.  Runs
    on the card unless ``device`` says otherwise; ``net`` must be there.
    ``times``, when given, receives each batch's timed seconds."""
    cfg = cfg.with_(run_sampling_test=True).finalize()
    check_supported(cfg)
    if viz_dir:
        raise NotImplementedError("viz_dir: the paper figures (viz.py) are "
                                  "not ported")
    dev = resolve_device(device)
    p_dev = next(net.parameters()).device
    if p_dev != dev:
        raise ValueError(f"the evaluation runs on {dev} but the net is on "
                         f"{p_dev}: move it there")
    formulas = specs.build_scorer(cfg)
    coeffs = diffusion.get_coeffs(cfg, device=dev)
    ds.ensure_random_params(cfg.seed)
    md = MeterDict()
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed + 123)
    n_trials = n_trials if n_trials is not None else cfg.n_trials
    warmed = False
    for bi, b in enumerate(batch_iterator(ds, "val", cfg.batch_size,
                                          shuffle=False, drop_last=False)):
        if bi > n_trials:
            break
        batch = to_device(b, dev)
        bs = batch["ego_traj"].shape[0]
        tj_flex = specs.flex_uniforms(bs, gen, dev)
        flex = specs.flex_uniforms(bs, gen, dev)
        shape = draw_shape(cfg, bs)
        noise = (torch.randn(shape, generator=gen, device=dev)
                 if shape is not None else None)
        tj = _trajopt_row(net, batch, cfg, formulas, flex=tj_flex)

        def sample():
            return _sample_and_score(net, batch, cfg, formulas, coeffs,
                                     flex=flex, noise=noise)

        if not warmed:     # first-call costs stay outside the timer
            warmed = True
            sample()
            _sync(dev)
        _sync(dev)
        t0 = time.time()
        nn, nn_controls, nn_trajs, valid = sample()
        _sync(dev)
        dt = time.time() - t0
        if times is not None:
            times.append(dt)
        nn = _nn_metrics(nn, nn_controls, nn_trajs, valid, batch, cfg)
        for name, d in (("tj", tj), ("nn", nn)):
            for met in RUN_METRICS:
                if met in d:
                    md.update(f"{name}_{met}", float(d[met]))
        md.update("time", dt)
        log(f"[{bi:03d}] tj_acc:{md('tj_acc'):.3f} acc:{md('nn_acc'):.3f} "
            f"scene_acc:{md('nn_scene_acc'):.3f} std:{md('nn_std'):.3f} "
            f"vol:{md('nn_vol'):.3f} area:{md('nn_area'):.3f} "
            f"T:{md('time'):.3f}s")
    return {k: md.avg(k) for k in md.sum}
