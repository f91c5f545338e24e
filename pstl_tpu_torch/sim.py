"""Closed-loop replanning simulator (port of ``pstl_tpu/sim.py``).

Every scene is pre-extracted into fixed-shape tensors, so one step —
observe around the simulated pose, plan (DDPM reverse pass with fused
guidance, multi-candidate selection, RefineNet + ``n_rolls``
re-rectification, the optional test-time refinement, lane-keep argmax),
the optional backup safety controller, Euler env step with collision and
drivable-area checks, metric update — runs on the device for a batch of
scenes.  The JAX package writes observe / env_step per scene and vmaps
them; here they take the scene batch directly.  ``chunk`` (steps per
jitted scan in JAX) is a Python loop of steps per call here.

The runners are ``run_closed_loop`` (a fixed number of done-masked steps)
and ``run_closed_loop_host`` (the closed-loop Table-II evaluation: per-step
history, step times and the candidate-area metric under ``record``,
per-scene start frames, an early exit when every scene is done).  The JAX
key becomes a seed: the planner draws its noise from a device generator
seeded with it; the tests hand in the JAX key chain's draws as ``noise``.

The planner runs every head: the diffusion policy, and the baselines'
VAE (a prior latent decoded, with the init-hint draws under
``use_init_hint``) and BC heads, whose candidates go straight to the
lane-keep argmax.  ``run_closed_loop_host(render_dir=...)`` draws the
recorded episodes' frames and GIFs with ``viz``.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from pstl_tpu_torch import diffusion, metrics, refine, specs
from pstl_tpu_torch.config import Config
from pstl_tpu_torch.device import resolve_device
from pstl_tpu_torch.models import net as models
from pstl_tpu_torch.models.net import Net
from pstl_tpu_torch.ops import dynamics as dyn
from pstl_tpu_torch.ops import geometry as geom
from pstl_tpu_torch.parallel import mesh as pmesh
from pstl_tpu_torch.utils.trace import span

Tensor = torch.Tensor

LANE_OFFSET = 3.5
D_SAFE = 0.1
CORRIDOR_HALF = 3.25
# fixed aggressive stlp override (nusc_sim.py:466-472)
AGGRESSIVE_STLP = np.array([1.0, 9.0, -3.0, 2.0, 0.1, 0.2], np.float32)
# --test_aggressive per-episode presets (nusc_sim.py:444-465)
TEST_AGGRESSIVE_STLPS = np.array([
    [0.0, 1.0, -1.0, 2.0, 2.0, 0.2],
    [0.0, 4.0, -1.0, 1.0, 1.0, 0.2],
    [0.0, 6.0, -1.0, 1.0, 0.2, 0.2],
], np.float32)


class SceneTensors(NamedTuple):
    """Per-scene pre-extracted tensors, stacked over a batch of scenes."""
    ego_full: Tensor        # (bs, L_full, 4) GT ego states
    nei_full: Tensor        # (bs, K, L_full, 7) neighbor tracks
    center_dense: Tensor    # (bs, n_dense, 3) dense current-lane centerline
    lane_valids: Tensor     # (bs, 3)
    length: Tensor          # (bs,) scene length (sim steps)
    drivable: Tensor        # (bs, H, W) bool drivable-area raster
    drivable_origin: Tensor  # (bs, 2)
    drivable_res: Tensor    # (bs,)
    lanes_t: Optional[Tensor] = None        # (bs, Lt, 3, n_segs, 3)
    lane_valids_t: Optional[Tensor] = None  # (bs, Lt, 3)
    hl_t: Optional[Tensor] = None           # (bs, Lt)


def rasterize_corridor(center_dense: np.ndarray, lane_valids: np.ndarray,
                       resolution: float = 0.5, margin: float = 12.0):
    """Drivable raster of the analytic lane corridor: a cell is drivable
    within CORRIDOR_HALF of a valid lane's centerline.  Returns (mask
    (H, W) bool, origin (2,), resolution)."""
    pts = center_dense[:, :2]
    lo = pts.min(axis=0) - (LANE_OFFSET + margin)
    hi = pts.max(axis=0) + (LANE_OFFSET + margin)
    H = int(np.ceil((hi[1] - lo[1]) / resolution))
    W = int(np.ceil((hi[0] - lo[0]) / resolution))
    gx = lo[0] + (np.arange(W) + 0.5) * resolution
    gy = lo[1] + (np.arange(H) + 0.5) * resolution
    offsets = [0.0] + [LANE_OFFSET * s for s, v in
                       ((+1.0, lane_valids[1]), (-1.0, lane_valids[2]))
                       if v > 0.5]
    nx = -np.sin(center_dense[:, 2])
    ny = np.cos(center_dense[:, 2])
    mask = np.zeros((H, W), bool)
    for i0 in range(0, H, 64):
        gyc = gy[i0:i0 + 64]
        ok = np.zeros((len(gyc), W), bool)
        for off in offsets:
            ox = pts[None, None, :, 0] + nx[None, None, :] * off
            oy = pts[None, None, :, 1] + ny[None, None, :] * off
            dd = (gx[None, :, None] - ox) ** 2 \
                + (gyc[:, None, None] - oy) ** 2
            ok |= np.min(dd, axis=-1) <= CORRIDOR_HALF ** 2
        mask[i0:i0 + 64] = ok
    return mask, lo.astype(np.float32), np.float32(resolution)


def scenes_from_dataset(data: Dict[str, np.ndarray],
                        device=None) -> SceneTensors:
    """The scene tensors of a dataset on ``device``: by default the card,
    and an error without one (``device="cpu"`` for the CPU).  The planner
    and the closed loop run where the scenes are."""
    device = resolve_device(device)
    if "scene_drivable" in data:
        mask = np.asarray(data["scene_drivable"])
        origin = np.asarray(data["scene_drivable_origin"])
        res = np.asarray(data["scene_drivable_res"])
    else:
        masks, origins, ress = [], [], []
        for i in range(len(data["scene_center_dense"])):
            m, o, r = rasterize_corridor(
                np.asarray(data["scene_center_dense"][i]),
                np.asarray(data["scene_lane_valids"][i]))
            masks.append(m)
            origins.append(o)
            ress.append(r)
        Hm = max(m.shape[0] for m in masks)
        Wm = max(m.shape[1] for m in masks)
        mask = np.zeros((len(masks), Hm, Wm), bool)
        for i, m in enumerate(masks):
            mask[i, :m.shape[0], :m.shape[1]] = m
        origin = np.stack(origins)
        res = np.stack(ress)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)
    opt = {k: (t(data[f"scene_{k}"]) if f"scene_{k}" in data else None)
           for k in ("lanes_t", "lane_valids_t", "hl_t")}
    return SceneTensors(
        ego_full=t(data["scene_ego_full"]),
        nei_full=t(data["scene_nei_full"]),
        center_dense=t(data["scene_center_dense"]),
        lane_valids=t(data["scene_lane_valids"]),
        length=t(data["scene_len"]).long(),
        drivable=t(mask),
        drivable_origin=t(origin),
        drivable_res=t(res),
        **opt)


# ---------------------------------------------------------------------------
# observation
# ---------------------------------------------------------------------------

def _rows(x: Tensor, idx: Tensor) -> Tensor:
    """x[b, idx[b]] for a leading batch axis: (bs, n, ...) -> (bs, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def lane_window_device(center_dense: Tensor, pose_xy: Tensor,
                       n_segs: int) -> Tensor:
    """Re-window each scene's dense centerline around its pose.
    center_dense (bs, n_dense, 3), pose_xy (bs, 2) -> (bs, n_segs, 3)."""
    n_dense = center_dense.shape[1]
    d2 = torch.sum((center_dense[..., :2] - pose_xy[:, None]) ** 2, dim=-1)
    i0 = torch.clamp(torch.argmin(d2, dim=-1) - 2, min=0)
    stride = torch.clamp((n_dense - i0 - 1) // (n_segs * 2), min=1)
    idx = torch.clamp(i0[:, None] + torch.arange(n_segs, device=d2.device)
                      * stride[:, None], 0, n_dense - 1)
    return torch.gather(center_dense, 1, idx[..., None].expand(-1, -1, 3))


def offset_lane_device(lane: Tensor, offset: float) -> Tensor:
    nx = -torch.sin(lane[..., 2])
    ny = torch.cos(lane[..., 2])
    return torch.stack([lane[..., 0] + nx * offset,
                        lane[..., 1] + ny * offset, lane[..., 2]], dim=-1)


def observe(scenes: SceneTensors, ego_state: Tensor, t: Tensor,
            cfg: Config) -> Dict[str, Tensor]:
    """Fixed-shape observations of a scene batch at sim times t (bs,)
    around the simulated poses ego_state (bs, 4)."""
    nt = cfg.nt
    bs = ego_state.shape[0]
    dev = ego_state.device
    steps = t[:, None] + torch.arange(nt, device=dev)            # (bs, nt)
    nei = scenes.nei_full                                        # (bs,K,L,7)
    nei_win = torch.gather(nei, 2, steps[:, None, :, None].expand(
        -1, nei.shape[1], -1, 7))                                # (bs,K,nt,7)
    curr = lane_window_device(scenes.center_dense, ego_state[:, :2],
                              cfg.n_segs)
    if scenes.lanes_t is not None:
        Lt = scenes.lanes_t.shape[1]
        d2g = torch.sum((scenes.ego_full[:, :Lt, :2]
                         - ego_state[:, None, :2]) ** 2, dim=-1)
        it = torch.argmin(d2g, dim=-1)
        valids = (_rows(scenes.lane_valids_t, it)
                  if scenes.lane_valids_t is not None
                  else scenes.lane_valids)
        lanes = _rows(scenes.lanes_t, it)                        # (bs,3,S,3)
        left = lanes[:, 1] * valids[:, 1, None, None]
        right = lanes[:, 2] * valids[:, 2, None, None]
    else:
        valids = scenes.lane_valids
        left = offset_lane_device(curr, LANE_OFFSET) \
            * valids[:, 1, None, None]
        right = offset_lane_device(curr, -LANE_OFFSET) \
            * valids[:, 2, None, None]
    ego_traj = torch.cat(
        [ego_state[:, None, :].expand(bs, nt, 4),
         torch.full((bs, nt, 1), cfg.ego_L, device=dev),
         torch.full((bs, nt, 1), cfg.ego_W, device=dev)], dim=-1)
    if scenes.hl_t is not None and scenes.lanes_t is not None:
        hl = _rows(scenes.hl_t, it).float()
    else:
        d0 = geom.point_to_polyline(ego_state[:, None, :3], curr)[:, 0]
        zero = torch.zeros_like(d0)
        hl = torch.where(
            d0 > LANE_OFFSET / 2,
            torch.where(valids[:, 1] > 0.5, zero + 1.0, zero),
            torch.where(d0 < -LANE_OFFSET / 2,
                        torch.where(valids[:, 2] > 0.5, zero + 2.0, zero),
                        zero))
    return {
        "ego_traj": ego_traj,
        "neighbors": nei_win[:, :, 0],
        "neighbors_traj": nei_win,
        "neighbor_trajs_aug": nei_win,
        "currlane_wpts": curr,
        "leftlane_wpts": left,
        "rightlane_wpts": right,
        "curr_id": valids[:, 0:1],
        "left_id": valids[:, 1:2],
        "right_id": valids[:, 2:3],
        "gt_high_level": hl[:, None],
    }


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

def check_supported(cfg: Config) -> None:
    """Raise for planner configurations that cannot plan: the planner needs
    a diffusion, VAE or BC head on multi-candidate rows (the JAX planner
    fails on the others), and a sampler the port runs."""
    if not (cfg.diffusion or cfg.vae or cfg.bc):
        raise NotImplementedError("the planner needs a diffusion, VAE or BC "
                                  "head (the headless policy reads "
                                  "per-scene labels)")
    if cfg.gt_data_training:
        raise NotImplementedError(
            "gt_data_training is a training mode: the planner runs "
            "multi-candidate rows (evaluate a mono preset with "
            "gt_data_training=False)")
    # use_pallas_clearance (BENCH_PALLAS=1) is accepted and changes nothing
    # here: the planner scores through TiledScorer (min_clearance_tiled on
    # per-scene discs) and never calls specs.prep_signals, the only caller
    # of the clearance kernels (ops/clearance_kernel.py), which the mono
    # training step reaches (train.py)
    if cfg.diffusion:
        diffusion.check_supported(cfg)


def check_devices(dev: torch.device, net: Net,
                  coeffs: diffusion.Coeffs) -> None:
    """The planner runs where its scenes are: raise if the net or the
    diffusion coefficients lie elsewhere."""
    for what, t in (("the net", next(net.parameters())),
                    ("the diffusion coefficients", coeffs.beta)):
        if t.device != dev:
            raise ValueError(f"the scenes are on {dev} but {what} on "
                             f"{t.device}: move them to the scenes' device")


def hint_draws(n: int, cfg: Config, generator: Optional[torch.Generator],
               device) -> Tensor:
    """The planner's init hint (``use_init_hint``): a control seed a row as
    the dataset's random seeds are drawn (``pstl_tpu/sim.py:275-286``),
    steering uniform in +-mul_w_max times 0.1 and acceleration uniform in
    +-mul_a_max, (n, nt, 2).  Under a data sharding (``parallel.mesh``)
    ``n`` is this rank's rows, drawn as the whole batch's."""
    u = pmesh.draw(lambda s: torch.rand(s, generator=generator,
                                        device=device), (2, n, cfg.nt),
                   rows=1)
    return torch.stack([(u[0] * 2 - 1) * cfg.mul_w_max * 0.1,
                        (u[1] * 2 - 1) * cfg.mul_a_max], dim=-1)


def make_planner(cfg: Config, net: Net, coeffs: diffusion.Coeffs,
                 stlp_override: Optional[np.ndarray] = None, formulas=None):
    """Returns ``plan(obs, noise=None, generator=None, hint=None) ->
    (u0 (bs, 2), info)``: dense batching with the aggressive stlp override,
    the candidates (``diffusion.sample``'s configured sampler with
    guidance, maximize, ``noise`` in the sampler's layout,
    ``diffusion.n_draws`` / ``draw_layout``;
    the VAE decoder on a prior latent, ``noise`` (n, vae_dim); the BC head,
    no draw), under ``use_init_hint`` with ``hint`` (n, nt, 2) as the
    rows' control seeds (``hint_draws``), multi-cands + RefineNet +
    n_rolls re-rectification, the test-time refinement (``refinement``:
    ``refine.convex_refinement`` with K = 6; ``raw_refinement``; under
    ``lite_refine`` only when no lane-keep candidate of the batch satisfies
    its spec), lane-keep restriction with the forward shield, argmax
    robustness.

    ``stlp_override`` (bs, 6): per-scene stlp rows (the ``--test_aggressive``
    presets, ``TEST_AGGRESSIVE_STLPS``).  As in the JAX package, each
    scene's candidate rows take its own row, while the scene-level stlp
    takes the override's last row for every scene.

    ``formulas``: what ``specs.make_score_rows`` scores with under
    ``tiled_scorer=False`` (the ``ClauseBank`` of ``build_scorer`` when
    None, or ``specs.build_formulas``'s tree, the same numbers)."""
    check_supported(cfg)
    M = cfg.n_randoms
    override_np = np.asarray(stlp_override if stlp_override is not None
                             else AGGRESSIVE_STLP, np.float32)

    @torch.no_grad()
    def plan(obs: Dict[str, Tensor], noise: Optional[Tensor] = None,
             generator: Optional[torch.Generator] = None,
             hint: Optional[Tensor] = None):
        with span("sim.plan"):
            bs = obs["ego_traj"].shape[0]
            dev = obs["ego_traj"].device
            check_devices(dev, net, coeffs)
            n = bs * M * 3
            override = torch.as_tensor(override_np, device=dev)
            states = obs["ego_traj"][:, 0, :4]
            gt_stlp = override.reshape(-1, 6)[-1].expand(bs, 6)
            if override.ndim == 2:
                stlp_dense = torch.repeat_interleave(override, M * 3,
                                                     0)[:, None, :]
            else:
                stlp_dense = override.expand(n, 1, 6)
            with span("plan.prep"):
                dense = specs.densify_batch(obs, gt_stlp, cfg, stlp_dense)
                if cfg.use_init_hint:
                    # the closed loop has no trajopt seeds: draw them as the
                    # dataset draws its random ones
                    dense["params_init"] = (
                        pmesh.local_part(hint) if hint is not None
                        else hint_draws(n, cfg, generator, dev))
                highlevel = dense["highlevel_dense"]
                valid = dense["valids_dense"].reshape(-1)
                states_flat = torch.repeat_interleave(states, M * 3, 0)
                score_rows = specs.make_score_rows(obs, dense, cfg,
                                                   formulas=formulas)
                # the scene feature, tiled to the n candidate rows (the JAX
                # planner reads it from Net.__call__(get_feature=True))
                enc = net.encode(dense)
                feature = torch.repeat_interleave(enc, M * 3, 0)

            def score_controls(u):
                trajs = dyn.rollout(states_flat, u, cfg.dt)
                s = score_rows(trajs[:, :-1])
                return s, trajs

            if cfg.diffusion:
                nn_controls, all_steps = _candidates(
                    net, obs, dense, gt_stlp, states, states_flat, enc,
                    feature, score_rows, cfg, coeffs, noise, generator,
                    formulas)
            else:
                nn_controls = decode_baseline(net, dense, feature, cfg,
                                              noise, generator)
                all_steps = nn_controls[None]

            with span("plan.select"):
                if cfg.rect_head and not cfg.not_use_rect:
                    if cfg.multi_cands is not None:
                        nn_controls, prev_scores = \
                            diffusion.select_multi_cands(
                                all_steps, cfg.multi_cands, states_flat,
                                score_rows, cfg)
                    else:
                        prev_scores, _ = score_controls(nn_controls)
                    stlp_rows = dense["stlp_dense"][:, 0]
                    controls = net.rect(feature, highlevel, stlp_rows,
                                        nn_controls, prev_scores)
                    for _ in range(cfg.n_rolls or 0):
                        s_re, _ = score_controls(controls)
                        controls = net.rect(feature, highlevel, stlp_rows,
                                            controls, s_re)
                    if cfg.refinement or cfg.raw_refinement:
                        # lite_refine (nusc_sim.py:554-557): skip the repair
                        # when a lane-keep candidate of the batch already
                        # satisfies its spec (the JAX package's lax.cond;
                        # here a host sync)
                        if not cfg.lite_refine or float(pmesh.shard_max(
                                torch.amax(score_controls(controls)[0]
                                           .reshape(bs, M, 3)[:, :, 0]))) \
                                <= 0:
                            controls = _refine(controls, all_steps,
                                               states_flat, score_rows,
                                               valid, cfg)
                else:
                    controls = nn_controls

                scores, trajs = score_controls(controls)
                scores3 = scores.reshape(bs, M, 3)
                if cfg.forward_shield:
                    min_v = torch.amin(trajs[..., 3],
                                       dim=-1).reshape(bs, M, 3)
                    scores3 = scores3 - torch.clamp(-min_v, min=0.0) * 1e3
                keep = torch.arange(3, device=dev)[None, None, :] == 0
                keep_scores = torch.where(keep, scores3,
                                          torch.full_like(scores3, -10000.0))
                best = torch.argmax(keep_scores.reshape(bs, M * 3), dim=-1)
                u_all = controls.reshape(bs, M * 3, cfg.nt, 2)
                tr_all = trajs.reshape(bs, M * 3, cfg.nt + 1, 4)
                u_best = _rows(u_all, best)
                tr_best = _rows(tr_all, best)
                stl_acc = torch.mean((keep_scores[:, :, 0] > 0).float(),
                                     dim=-1)
                info = {"controls": controls, "trajs": trajs,
                        "scores": scores, "plan_traj": tr_best,
                        "stl_acc": stl_acc,
                        "valids_dense": dense["valids_dense"]}
        return u_best[:, 0, :], info

    return plan


def _sample(net: Net, obs, dense, states: Tensor, states_flat: Tensor,
            feature: Tensor, score_rows, cfg: Config,
            coeffs: diffusion.Coeffs, noise, generator):
    """The guided diffusion sampler on the dense rows of ``dense``
    (``cfg.n_randoms`` seeds a scene and maneuver; ``states_flat``,
    ``feature`` the start states and scene feature tiled to them,
    ``score_rows`` their robustness): (controls, all_steps) as
    ``diffusion.sample`` returns them."""
    M = cfg.n_randoms
    n = states.shape[0] * M * 3
    highlevel = dense["highlevel_dense"]
    valid = dense["valids_dense"].reshape(-1)
    with span("plan.prep"):
        fused = (specs.make_guidance_loss(obs, dense, cfg, states, valid)
                 if cfg.guidance else None)
        ctx = (diffusion.make_guidance_ctx(score_rows, valid, states_flat,
                                           fused)
               if cfg.guidance else None)
        cm_fn = (models.make_cm_eps_fn(net, dense, highlevel, feature, cfg)
                 if cfg.cm_sampler and fused is not None else None)
    return diffusion.sample(
        lambda e: net(dense, e, prev_feature=feature, n_randoms=M),
        highlevel, cfg, coeffs, n, noise=noise, generator=generator,
        stlp_dense=dense["stlp_dense"], guide=ctx, maximize=True,
        cm_fn=cm_fn)


def _candidates(net: Net, obs, dense, gt_stlp: Tensor, states: Tensor,
                states_flat: Tensor, enc: Tensor, feature: Tensor,
                score_rows, cfg: Config, coeffs: diffusion.Coeffs, noise,
                generator, formulas=None):
    """The sampler's candidates (controls, all_steps) of every dense row.
    Inside ``parallel.candidate_sharding`` this rank samples its share of
    every scene's seeds (M' = n_randoms / world of them, a valid layout of
    3*M' candidate columns: the kernels run unchanged) from its part of the
    whole draws, and the decodings are gathered: every rank returns all
    rows, and the selection after it runs replicated."""
    ax = pmesh.candidate_axis()
    if ax is None or ax.world == 1:
        return _sample(net, obs, dense, states, states_flat, feature,
                       score_rows, cfg, coeffs, noise, generator)
    if cfg.n_randoms % ax.world:
        raise ValueError(f"candidate sharding splits the n_randoms "
                         f"({cfg.n_randoms}) seeds of a scene over the "
                         f"{ax.world} ranks of its axis: it must divide")
    cfg_l = cfg.with_(n_randoms=cfg.n_randoms // ax.world)
    with pmesh.candidate_share(ax, cfg_l.n_randoms):
        dense_l = specs.densify_batch(
            obs, gt_stlp, cfg_l, pmesh.candidate_part(dense["stlp_dense"]))
        if "params_init" in dense:
            dense_l["params_init"] = pmesh.candidate_part(
                dense["params_init"])
        rows = cfg_l.n_randoms * 3
        _, steps_l = _sample(
            net, obs, dense_l, states,
            torch.repeat_interleave(states, rows, 0),
            torch.repeat_interleave(enc, rows, 0),
            specs.make_score_rows(obs, dense_l, cfg_l, formulas=formulas),
            cfg_l, coeffs, noise, generator)
        all_steps = pmesh.gather_candidates(steps_l, rows=1)
    return all_steps[-1], all_steps


def decode_baseline(net: Net, dense, feature: Tensor, cfg: Config,
                     z: Optional[Tensor],
                     generator: Optional[torch.Generator],
                     n_randoms: Optional[int] = None) -> Tensor:
    """The VAE (decoding a prior latent ``z`` (n, vae_dim), drawn from
    ``generator`` when not given) or the BC head on the dense rows: their
    controls (n, nt, 2)."""
    ext = {"highlevel": dense["highlevel_dense"]}
    if not cfg.vae:
        return net(dense, ext, prev_feature=feature, n_randoms=n_randoms)
    if z is None:
        z = pmesh.draw(lambda s: torch.randn(s, generator=generator,
                                             device=feature.device),
                       (feature.shape[0], cfg.vae_dim))
    else:
        z = pmesh.local_part(z)
    return net(dense, ext, prev_feature=feature, n_randoms=n_randoms,
               sample=z)[0]


def _refine(controls: Tensor, all_steps: Tensor, states_flat: Tensor,
            score_rows, valid: Tensor, cfg: Config) -> Tensor:
    """The planner's test-time refinement: convex with K = 6, or raw."""
    if cfg.refinement:
        return refine.convex_refinement(controls, all_steps, states_flat,
                                        score_rows, valid, cfg, K=6)
    return refine.raw_refinement(controls, states_flat, score_rows, valid,
                                 cfg)


def _apply_backup(u0: Tensor, info: Dict[str, Tensor],
                  obs: Dict[str, Tensor], cfg: Config):
    """The backup safety controller (nusc_sim.py:686-708) for a scene
    batch: where the chosen plan's clearance 2 steps ahead to a valid
    neighbor drops below D_SAFE, solve a control residual
    (``refine.solve_backup``, ``cfg.backup_niters`` Adam steps) against the
    first unsafe neighbor in slot order and apply the corrected first
    control.  Returns (u0 (bs, 2), unsafe (bs,) bool).

    The JAX package solves every scene and keeps the unsafe ones; the solve
    of a scene depends on that scene alone, so here only the unsafe scenes
    are solved, and none when no scene is unsafe (one host sync)."""
    plan_traj = info["plan_traj"]                    # (bs, nt+1, 4)
    nei = obs["neighbor_trajs_aug"]                  # (bs, K, nt, 7)
    # the chosen plan's first two controls, recovered from its states
    dth = (plan_traj[:, 1:3, 2] - plan_traj[:, 0:2, 2]) / cfg.dt
    dv = (plan_traj[:, 1:3, 3] - plan_traj[:, 0:2, 3]) / cfg.dt
    u01 = torch.stack([dth, dv], dim=-1)             # (bs, 2, 2)
    clear = geom.car_clearance(
        plan_traj[:, None, 2, :3], cfg.ego_L, cfg.ego_W,
        nei[:, :, 2, 1:4], nei[:, :, 2, 5], nei[:, :, 2, 6],
        cfg.refined_nL, cfg.refined_nW)              # (bs, K)
    unsafe_k = (nei[:, :, 2, 0] > 0.5) \
        & (torch.clamp(clear, -5.0, 20.0) < D_SAFE)
    unsafe = torch.any(unsafe_k, dim=-1)
    rows = torch.nonzero(unsafe)[:, 0]
    if rows.numel() == 0:
        return u0, unsafe
    # the first unsafe slot (argmax returns the first maximum)
    j = torch.argmax(unsafe_k[rows].to(torch.uint8), dim=-1)
    u_res = refine.solve_backup(plan_traj[rows, 0:3], u01[rows],
                                nei[rows, j, 0:3], cfg,
                                n_iters=cfg.backup_niters)
    out = u0.clone()
    out[rows] = u01[rows, 0] + u_res[:, 0]
    return out, unsafe


# ---------------------------------------------------------------------------
# environment step
# ---------------------------------------------------------------------------

def env_step(scenes: SceneTensors, ego_state: Tensor, t: Tensor, u: Tensor,
             cfg: Config):
    """One Euler step + collision / out-of-lane checks for a scene batch.
    Returns (new_state (bs, 4), collide, out_of_lane, done_t) (bs,)."""
    new_state = ego_state + dyn.dynamics(ego_state, u) * cfg.dt
    if cfg.env_nonnegative_speed:
        new_state = torch.cat([new_state[:, :3],
                               torch.clamp(new_state[:, 3:4], min=0.0)], -1)
    nei = scenes.nei_full
    nei_next = torch.gather(nei, 2, (t + 1)[:, None, None, None].expand(
        -1, nei.shape[1], 1, 7))[:, :, 0]                        # (bs,K,7)
    clear = geom.car_clearance(new_state[:, None, :3], cfg.ego_L, cfg.ego_W,
                               nei_next[..., 1:4], nei_next[..., 5],
                               nei_next[..., 6], cfg.refined_nL,
                               cfg.refined_nW)
    clear = torch.clamp(clear, -5.0, 20.0) * nei_next[..., 0] \
        + (1 - nei_next[..., 0]) * 100.0
    collide = torch.amin(clear, dim=-1) < D_SAFE
    rel = (new_state[:, :2] - scenes.drivable_origin) \
        / scenes.drivable_res[:, None]
    j = torch.floor(rel[:, 0]).long()
    i = torch.floor(rel[:, 1]).long()
    H, W = scenes.drivable.shape[1:]
    in_bounds = (i >= 0) & (i < H) & (j >= 0) & (j < W)
    cell = scenes.drivable[torch.arange(i.shape[0], device=i.device),
                           torch.clamp(i, 0, H - 1), torch.clamp(j, 0, W - 1)]
    out_of_lane = ~(in_bounds & cell)
    done_t = t + 1 >= scenes.length - 2
    return new_state, collide, out_of_lane, done_t


# ---------------------------------------------------------------------------
# episode runner
# ---------------------------------------------------------------------------

class Carry(NamedTuple):
    """Closed-loop episode state (batched over scenes)."""
    ego: Tensor          # (bs, 4)
    t: Tensor            # (bs,) long
    done: Tensor         # (bs,) bool
    collide: Tensor
    out_of_lane: Tensor
    progress: Tensor
    stl_acc_sum: Tensor
    steps: Tensor
    repairs: Tensor
    generator: torch.Generator   # the planner's noise source


def _init_carry(scenes: SceneTensors, generator: torch.Generator,
                t0: Optional[Tensor] = None) -> Carry:
    bs = scenes.ego_full.shape[0]
    dev = scenes.ego_full.device
    t0 = (torch.zeros((bs,), dtype=torch.long, device=dev) if t0 is None
          else torch.as_tensor(t0, device=dev).long())
    ego0 = _rows(scenes.ego_full, t0)
    zf = torch.zeros((bs,), device=dev)
    zb = torch.zeros((bs,), dtype=torch.bool, device=dev)
    return Carry(ego=ego0, t=t0, done=zb, collide=zb, out_of_lane=zb,
                 progress=zf, stl_acc_sum=zf, steps=zf, repairs=zf,
                 generator=generator)


def _make_body(scenes: SceneTensors, cfg: Config, plan, with_info=False):
    """The (observe -> plan -> backup -> env step -> metric update) step:
    ``body(carry, noise=None)`` returns the next carry, and with
    ``with_info`` also the plan's info.  ``noise`` pins the plan's draws:
    a tensor (the sampler's noise, or the VAE's prior latent) or a dict of
    the planner's keywords ("noise", "hint")."""

    def body(c: Carry, noise=None):
        with span("sim.step"):
            with span("sim.observe"):
                obs = observe(scenes, c.ego, c.t, cfg)
            draws = noise if isinstance(noise, dict) else {"noise": noise}
            u0, info = plan(obs, generator=c.generator, **draws)
            with span("sim.env"):
                if cfg.backup:
                    u0, repaired = _apply_backup(u0, info, obs, cfg)
                else:
                    repaired = torch.zeros_like(c.done)
                new_ego, collide, ool, done_t = env_step(scenes, c.ego, c.t,
                                                         u0, cfg)
                active = ~c.done
                carry = Carry(
                    ego=torch.where(active[:, None], new_ego, c.ego),
                    t=torch.where(active, c.t + 1, c.t),
                    done=c.done | ((collide | ool | done_t) & active),
                    collide=c.collide | (collide & active),
                    out_of_lane=c.out_of_lane | (ool & active),
                    progress=c.progress + active * c.ego[:, 3] * cfg.dt,
                    stl_acc_sum=c.stl_acc_sum + active * info["stl_acc"],
                    steps=c.steps + active,
                    repairs=c.repairs + (active & repaired),
                    generator=c.generator)
        if with_info:
            return carry, info
        return carry

    return body


def _carry_metrics(c: Carry, mesh=None) -> Dict[str, Tensor]:
    """The per-scene metrics of a carry; with a ``mesh`` (a carry of this
    rank's scenes, ``make_closed_loop_step(mesh=...)``) those of every
    rank's scenes, gathered in rank order, the whole batch's order."""
    steps = torch.clamp(c.steps, min=1.0)
    out = {
        "collide": c.collide.float(),
        "out_of_lane": c.out_of_lane.float(),
        "traj_len": c.steps,
        "progress": c.progress,
        "stl_acc": c.stl_acc_sum / steps,
        "agent_steps": torch.sum(c.steps),
        "repairs": c.repairs,
    }
    if mesh is None:
        return out
    out = {k: v if k == "agent_steps" else pmesh.gather_rows(v, mesh)
           for k, v in out.items()}
    out["agent_steps"] = torch.sum(out["traj_len"])
    return out


def shard_scenes(scenes: SceneTensors, mesh) -> SceneTensors:
    """This rank's scenes of ``scenes`` over the "data" axis of ``mesh`` (an
    equal share a rank; ValueError if the scene count does not divide)."""
    world = pmesh.axis_of(mesh, "data").world
    if scenes.ego_full.shape[0] % world:
        raise ValueError(f"{scenes.ego_full.shape[0]} scenes do not split "
                         f"over the {world} ranks of the data axis")
    return SceneTensors(**pmesh.shard_batch(scenes._asdict(), mesh))


def make_closed_loop_step(scenes: SceneTensors, cfg: Config, net: Net,
                          coeffs: diffusion.Coeffs, with_info: bool = False,
                          stlp_override=None, chunk: int = 1, mesh=None,
                          formulas=None):
    """Returns (init_carry, step).  ``init_carry(seed=0, t0=None)`` starts
    the episodes at frames ``t0`` (bs,) (default 0; the planner draws its
    noise from a device generator seeded with ``seed``).  ``step(carry,
    noise=None)`` runs ``chunk`` replanning steps for every scene (done
    scenes are masked, not skipped); ``noise`` pins the plan's draws (see
    ``_make_body``): one for a step, a sequence of ``chunk`` for a chunk.
    ``with_info`` forces chunk 1 and returns (carry, the plan's info).

    ``mesh``: ``scenes`` are this rank's share of the whole batch over its
    "data" axis (``shard_scenes``), every rank starting from the same seed; a
    step draws the whole batch's noise (pinned ``noise`` is the whole
    batch's too) and keeps its scenes' part, so each scene runs as it runs
    unsharded.  ``_carry_metrics(carry, mesh)`` gathers the metrics.
    ``formulas``: the planner's (``make_planner``)."""
    dev = scenes.ego_full.device
    check_devices(dev, net, coeffs)
    plan = make_planner(cfg, net, coeffs, stlp_override=stlp_override,
                        formulas=formulas)
    body = _make_body(scenes, cfg, plan, with_info=with_info)
    if mesh is not None:
        local_body = body

        def body(c: Carry, noise=None):
            with pmesh.data_sharding(mesh):
                return local_body(c, noise)

    if with_info or chunk <= 1:
        step = body
    else:
        def step(c: Carry, noise: Optional[Sequence] = None):
            for i in range(chunk):
                c = body(c, None if noise is None else noise[i])
            return c

    def init_carry(seed: int = 0, t0=None):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        return _init_carry(scenes, gen, t0=t0)

    return init_carry, step


def run_closed_loop(seed: int, scenes: SceneTensors, cfg: Config, net: Net,
                    coeffs: diffusion.Coeffs, max_steps: int,
                    noise: Optional[Sequence] = None, formulas=None
                    ) -> Dict[str, Tensor]:
    """``max_steps`` done-masked replanning steps of every scene (no early
    exit); returns the per-scene metrics: collide, out_of_lane, traj_len,
    progress, stl_acc (mean over active steps), agent_steps, repairs.
    ``noise``: the plan's draws of each step (see ``_make_body``);
    ``formulas``: the planner's (``make_planner``)."""
    init_carry, step = make_closed_loop_step(scenes, cfg, net, coeffs,
                                             formulas=formulas)
    c = init_carry(seed)
    for i in range(max_steps):
        c = step(c, None if noise is None else noise[i])
    return _carry_metrics(c)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_closed_loop_host(seed: int, scenes: SceneTensors, cfg: Config,
                         net: Net, coeffs: diffusion.Coeffs, max_steps: int,
                         record: bool = False,
                         render_dir: Optional[str] = None,
                         stlp_override=None, chunk: int = 1, t0=None,
                         noise: Optional[Sequence] = None, formulas=None
                         ) -> Dict[str, object]:
    """The closed-loop Table-II evaluation: ``run_closed_loop``'s metrics
    over up to ``max_steps`` steps (``chunk`` a call), stopping early once
    every scene is done.  ``record`` (forces chunk 1) adds ``history``:
    the ego states before and after every step ("ego", numpy (bs, 4)
    each), the chosen plans ("plan", (bs, nt+1, 4)), the per-step
    candidate-area diversity ("area", nusc_sim.py:714-735) and the step
    times ("step_s": host clock around the step and its record, after a
    device sync), and ``area``, the mean over the steps.  ``t0``: per-scene
    start frames; ``noise``: the plan's draws of each step; ``formulas``:
    the planner's (``make_planner``).  With
    ``record`` and ``render_dir``, the first four scenes' frames
    (``frame_s{i:02d}_t{t:03d}.png``) and GIFs (``episode_{i:02d}.gif``)
    are written there."""
    chunk = 1 if record else max(chunk, 1)
    init_carry, step = make_closed_loop_step(
        scenes, cfg, net, coeffs, with_info=record,
        stlp_override=stlp_override, chunk=chunk, formulas=formulas)
    dev = scenes.ego_full.device
    c = init_carry(seed, t0=t0)
    bs = scenes.ego_full.shape[0]
    M, nt = cfg.n_randoms, cfg.nt
    hist = {"ego": [c.ego.cpu().numpy()], "plan": [], "area": [],
            "step_s": []}
    for si in range(max(max_steps // chunk, 1)):
        pinned = None
        if noise is not None:
            pinned = (noise[si] if chunk == 1
                      else noise[si * chunk:(si + 1) * chunk])
        t_start = time.time()
        if record:
            c, info = step(c, pinned)
            hist["ego"].append(c.ego.cpu().numpy())
            hist["plan"].append(info["plan_traj"].cpu().numpy())
            area = metrics.measure_extra_diversity(
                info["trajs"][:, :-1].reshape(bs, M, 3, nt * 4),
                info["scores"].reshape(bs, M, 3),
                info["valids_dense"].reshape(bs, M, 3), nt,
                info["controls"].reshape(bs, M, 3, nt * 2),
                -cfg.mul_w_max, cfg.mul_w_max, -cfg.mul_a_max,
                cfg.mul_a_max)["area"]
            hist["area"].append(float(area))
        else:
            c = step(c, pinned)
        _sync(dev)
        hist["step_s"].append(time.time() - t_start)
        if bool(c.done.all()):
            break
    out: Dict[str, object] = dict(_carry_metrics(c))
    if record:
        out["history"] = hist
        out["area"] = float(np.mean(hist["area"])) if hist["area"] else 0.0
    if render_dir and record:
        _render_episodes(render_dir, scenes, cfg, hist)
    return out


def _render_episodes(render_dir: str, scenes: SceneTensors, cfg: Config,
                     hist: Dict[str, list]) -> None:
    """The closed-loop frames of the first four scenes and their GIFs, from
    a recorded history."""
    from pstl_tpu_torch import viz
    sc = {k: getattr(scenes, k).cpu().numpy()
          for k in ("center_dense", "lane_valids", "nei_full", "drivable",
                    "drivable_origin", "drivable_res")}
    ego_hist = np.stack(hist["ego"], axis=1)         # (bs, S+1, 4)
    for i in range(min(ego_hist.shape[0], 4)):
        frames = []
        for t in range(1, ego_hist.shape[1]):
            path = f"{render_dir}/frame_s{i:02d}_t{t:03d}.png"
            viz.render_closed_loop_frame(
                path, sc["center_dense"][i], sc["lane_valids"][i],
                ego_hist[i, :t + 1],
                sc["nei_full"][i, :, min(t, sc["nei_full"].shape[2] - 1)],
                hist["plan"][t - 1][i] if t - 1 < len(hist["plan"])
                else None,
                ego_LW=(cfg.ego_L, cfg.ego_W),
                drivable=sc["drivable"][i],
                drivable_origin=sc["drivable_origin"][i],
                drivable_res=float(sc["drivable_res"][i]))
            frames.append(path)
        viz.generate_gif(f"{render_dir}/episode_{i:02d}.gif", frames)
