"""Driving pSTL specifications (port of ``pstl_tpu/specs.py``): the signal
cache ``prep_signals`` (whose neighbor clearance runs the clearance kernels
under ``cfg.use_pallas_clearance``), the fused ``ClauseBank`` scorer,
``compute_scores``, the pSTL calibration ``calibrate_stlp``, the flex pSTL
draws (``generate_flex_pstl``, ``get_dense_stlp``), dense batching
(``densify_batch``) with its hoisted signal dict (``dense_signal_input``),
and the ``TiledScorer`` robustness of (bs x n_randoms x 3) candidate rows.

The 6-dim pSTL parameter vector is
``stlp = (v_min, v_max, d_min, d_max, d_safe, th_max)``.  The flex draws
are injectable: :func:`flex_uniforms` makes the (3, 6, bs, 1) tensor of
uniforms the JAX package draws per maneuver and parameter (in each draw's
own range), and every function that draws takes it as ``flex=``.

``build_formulas`` gives the three maneuver formulas as trees of
``ops/stl.py``; ``ClauseBank`` computes their robustness at t = 0 with
each clause once (the production scorer), and every function that takes
``formulas`` takes either.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import torch

from pstl_tpu_torch.config import Config
from pstl_tpu_torch.ops import clearance_kernel
from pstl_tpu_torch.ops import geometry as geom
from pstl_tpu_torch.ops import stl
from pstl_tpu_torch.parallel import mesh
from pstl_tpu_torch.utils.trace import span
from pstl_tpu_torch.ops.guidance_loss import (  # noqa: F401
    I_DMAX, I_DMIN, I_DSAFE, I_THMAX, I_VAL, I_VMAX, I_VMIN,
    CandMinorGuidanceLoss, make_guidance_loss, mask_mean)

Tensor = torch.Tensor

# high-level maneuver labels
HL_KEEP, HL_LEFT, HL_RIGHT, HL_OUTLIER = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# signal cache
# ---------------------------------------------------------------------------

def clearance_route(cfg: Config, x: Sequence[str] = (),
                    with_collision: bool = False) -> str:
    """Which of its three routes ``prep_signals`` takes for the neighbor
    clearance of signals with the keys ``x``: "discs" (hoisted neighbor
    discs), "kernel" (the clearance kernels) or "geometry"
    (``geometry.min_neighbor_distance``)."""
    if (with_collision or cfg.collision_loss is not None
            or cfg.refined_nW != 1):
        return "geometry"
    if "nei_discs" in x:
        return "discs"
    return "kernel" if cfg.use_pallas_clearance else "geometry"


def prep_signals(x: Dict[str, Tensor], cfg: Config,
                 with_collision: bool = False) -> Dict[str, Tensor]:
    """Lane-distance / neighbor-clearance signals the formulas read.

    ``x``: ego_traj (n, T, >=4) rollout states; neighbors (n, K, T, 7)
    tracks (valid, x, y, th, v, L, W); {curr,left,right}lane_wpts
    (n, n_segs, 3); stlp (n, 1, 6) or (n, T, 6); optionally nei_discs.
    Adds x2{curr,left,right}_d / _th (n, T), min_nei_d (n, T)
    [, min_centroid_d, radius_sum] and the norm_stl factors.  The neighbor
    clearance takes one of three routes (``clearance_route``), as in the
    JAX package: hoisted discs (``geometry.min_clearance_tiled``), the
    clearance kernels under ``cfg.use_pallas_clearance``
    (``ops/clearance_kernel.py``), or ``geometry.min_neighbor_distance``.
    On the kernel route only, ``neighbors`` may hold one set per scene,
    (n / m, K, T, 7) for m consecutive ego rows a scene: the kernels read a
    scene's neighbors once for all its rows.  The other routes raise on
    that.
    """
    out = dict(x)
    pts = x["ego_traj"][..., 0:3]
    for key in ("curr", "left", "right"):
        d, th = geom.point_to_polyline(pts, x[f"{key}lane_wpts"],
                                       clip=cfg.clip_dist, with_angle=True,
                                       inline=cfg.inline)
        out[f"x2{key}_d"] = d
        out[f"x2{key}_th"] = th

    nei = x["neighbors"]
    n = x["ego_traj"].shape[0]
    need_full = with_collision or cfg.collision_loss is not None
    route = clearance_route(cfg, x, with_collision)
    if route != "kernel" and nei.shape[0] != n:
        raise ValueError(
            f"prep_signals: neighbors for {nei.shape[0]} rows, ego_traj has "
            f"{n}; only the clearance kernels take per-scene neighbors")
    if route == "discs":
        out["min_nei_d"] = geom.min_clearance_pre(
            x["ego_traj"][..., 0:3], x["nei_discs"], cfg.ego_L, cfg.ego_W,
            cfg.refined_nL)
    elif route == "kernel":
        out["min_nei_d"] = clearance_kernel.min_neighbor_distance_fused(
            x["ego_traj"][..., 0:4], nei[..., 1:7], nei[..., I_VAL],
            ego_L=cfg.ego_L, ego_W=cfg.ego_W, num_L=cfg.refined_nL,
            rows_per_scene=max(n // max(nei.shape[0], 1), 1))
    else:
        res = geom.min_neighbor_distance(
            x["ego_traj"][..., 0:4], nei[..., 1:7], nei[..., I_VAL],
            ego_L=cfg.ego_L, ego_W=cfg.ego_W, num_L=cfg.refined_nL,
            num_W=cfg.refined_nW, full=need_full)
        if need_full:
            out["min_nei_d"], out["min_centroid_d"], out["radius_sum"] = res
        else:
            out["min_nei_d"] = res

    if cfg.norm_stl and "v_factor" not in x:
        stlp = x["stlp"]
        out["v_factor"] = torch.clamp(stlp[..., I_VMAX] - stlp[..., I_VMIN],
                                      min=0.3)
        out["d_factor"] = torch.clamp(
            (stlp[..., I_DMAX] - stlp[..., I_DMIN]) * 5, min=0.3)
        out["safe_factor"] = torch.clamp(stlp[..., I_DSAFE], min=0.3)
    return out


# ---------------------------------------------------------------------------
# the maneuver formulas
# ---------------------------------------------------------------------------

def build_formulas(cfg: Config) -> List[stl.ListAnd]:
    """The three maneuver formulas [keep, left-change, right-change]
    (``pstl_tpu.specs.build_formulas``): each a ``ListAnd`` of Always /
    Eventually clauses on the speed band, the signed lane-offset band, the
    heading and the neighbor clearance, divided by the ``norm_stl``
    factors when set; the heading clauses are always divided by th_max.
    They read the signals of :func:`prep_signals`, ``stlp`` as (n, 1, 6)
    so that a parameter broadcasts over T."""
    nt = cfg.nt

    def P(i):
        return lambda x: x["stlp"][..., i]

    if cfg.norm_stl:
        vf = lambda x: x["v_factor"]
        df = lambda x: x["d_factor"]
        sf = lambda x: x["safe_factor"]
    else:
        vf = df = sf = lambda x: 1.0
    alw = lambda expr, name="": stl.Always(0, nt, stl.AP(expr, name))
    keep_v_min = alw(lambda x: (x["ego_traj"][..., 3] - P(I_VMIN)(x))
                     / vf(x), "vmin")
    keep_v_max = alw(lambda x: (-x["ego_traj"][..., 3] + P(I_VMAX)(x))
                     / vf(x), "vmax")
    keep_d_min = alw(lambda x: (x["x2curr_d"] - P(I_DMIN)(x)) / df(x),
                     "dmin")
    keep_d_max = alw(lambda x: (-x["x2curr_d"] + P(I_DMAX)(x)) / df(x),
                     "dmax")
    safe = alw(lambda x: (x["min_nei_d"] - P(I_DSAFE)(x)) / sf(x), "safe")
    keep_th_max = alw(lambda x: (P(I_THMAX)(x) - x["x2curr_th"])
                      / P(I_THMAX)(x), "thmax")

    def reach_d(side):
        return stl.Eventually(0, nt // 2, stl.Always(0, nt, stl.And(
            stl.AP(lambda x: (x[f"x2{side}_d"] - P(I_DMIN)(x)) / df(x)),
            stl.AP(lambda x: (-x[f"x2{side}_d"] + P(I_DMAX)(x)) / df(x)))))

    def reach_th(side):
        return stl.Eventually(0, nt // 2, stl.Always(0, nt, stl.AP(
            lambda x: (P(I_THMAX)(x) - x[f"x2{side}_th"]) / P(I_THMAX)(x))))

    return [stl.ListAnd([keep_v_min, keep_v_max, keep_d_min, keep_d_max,
                         keep_th_max, safe]),
            stl.ListAnd([keep_v_min, keep_v_max, reach_d("left"),
                         reach_th("left"), safe]),
            stl.ListAnd([keep_v_min, keep_v_max, reach_d("right"),
                         reach_th("right"), safe])]


# ---------------------------------------------------------------------------
# the fused clause-bank scorer
# ---------------------------------------------------------------------------

class ClauseBank:
    """Robustness at t = 0 of the three maneuver formulas [keep,
    left-change, right-change]: each of the 10 distinct clauses is computed
    once, Always(0, nt) as one soft-min over the horizon and
    Eventually(0, nt//2, Always(0, nt, .)) through one reverse
    ``logcumsumexp``.  See ``pstl_tpu.specs.ClauseBank``."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.robustness_dtype == "bfloat16" \
            else torch.float32

    def _alw0(self, g: Tensor, tau: float, hard: bool) -> Tensor:
        return stl.soft_min(g, tau, dim=-1, hard=hard, dtype=self.dtype)

    def _ev_alw0(self, g: Tensor, tau: float, hard: bool) -> Tensor:
        nt2 = self.cfg.nt // 2
        g = g.to(self.dtype)
        if hard:
            suffix = stl.cumulative(torch.minimum, g, dim=-1, reverse=True)
            return torch.amax(suffix[..., :nt2], dim=-1)
        suffix = -stl.logcumsumexp(-g * tau, dim=-1, reverse=True) / tau
        return stl.soft_max(suffix[..., :nt2], tau, dim=-1, dtype=self.dtype)

    #: the clauses of :meth:`_clauses`, in order
    CLAUSES = ("alw_vmin", "alw_vmax", "alw_dmin", "alw_dmax", "alw_th",
               "alw_safe", "reach_left_d", "reach_left_th", "reach_right_d",
               "reach_right_th")

    def clause_breakdown(self, x: Dict[str, Tensor], tau: float,
                         hard: bool = False) -> Dict[str, Tensor]:
        """Each clause's robustness at t = 0 (the ``ListAnd(full=True)``
        diagnostic), keyed by clause name."""
        return dict(zip(self.CLAUSES, self._clauses(x, tau, hard)))

    def _clauses(self, x, tau, hard):
        cfg = self.cfg
        v = x["ego_traj"][..., 3]
        stlp = x["stlp"]
        P = lambda i: stlp[..., i]
        if cfg.norm_stl:
            vf, df, sf = x["v_factor"], x["d_factor"], x["safe_factor"]
        else:
            vf = df = sf = 1.0
        pair = lambda a, b: stl.soft_min(torch.stack([a, b], -1), tau,
                                         dim=-1, hard=hard, dtype=self.dtype)
        out = [
            self._alw0((v - P(I_VMIN)) / vf, tau, hard),
            self._alw0((-v + P(I_VMAX)) / vf, tau, hard),
            self._alw0((x["x2curr_d"] - P(I_DMIN)) / df, tau, hard),
            self._alw0((-x["x2curr_d"] + P(I_DMAX)) / df, tau, hard),
            self._alw0((P(I_THMAX) - x["x2curr_th"]) / P(I_THMAX), tau,
                       hard),
            self._alw0((x["min_nei_d"] - P(I_DSAFE)) / sf, tau, hard),
        ]
        for side in ("left", "right"):
            d = x[f"x2{side}_d"]
            g_d = pair((d - P(I_DMIN)) / df, (-d + P(I_DMAX)) / df)
            out.append(self._ev_alw0(g_d, tau, hard))
            g_th = (P(I_THMAX) - x[f"x2{side}_th"]) / P(I_THMAX)
            out.append(self._ev_alw0(g_th, tau, hard))
        return out

    def scores(self, x: Dict[str, Tensor], tau: float,
               hard: bool = False) -> List[Tensor]:
        (alw_vmin, alw_vmax, alw_dmin, alw_dmax, alw_th, alw_safe,
         left_d, left_th, right_d, right_th) = self._clauses(x, tau, hard)

        def conj(parts):
            return stl.soft_min(torch.stack(parts, dim=-1), tau, dim=-1,
                                hard=hard, dtype=self.dtype)

        return [conj([alw_vmin, alw_vmax, alw_dmin, alw_dmax, alw_th,
                      alw_safe]),
                conj([alw_vmin, alw_vmax, left_d, left_th, alw_safe]),
                conj([alw_vmin, alw_vmax, right_d, right_th, alw_safe])]


def build_scorer(cfg: Config) -> ClauseBank:
    """The production robustness scorer (fused clause bank)."""
    return ClauseBank(cfg)


def select_scores(scores_list: Sequence[Tensor], stl_idx: Tensor) -> Tensor:
    """Per-row formula selection; the outlier class 3 selects the last
    entry (+1 in ``compute_scores``)."""
    out = torch.zeros_like(scores_list[0])
    for i, s in enumerate(scores_list):
        out = out + s * (stl_idx == i)
    return out


def compute_scores(signals: Dict[str, Tensor], formulas, stl_idx: Tensor,
                   mask: Tensor, cfg: Config, tau: Optional[float] = None,
                   hard: bool = False, scene: bool = False):
    """Evaluate the three formulas (a ``ClauseBank`` or the list of
    :func:`build_formulas`), select per row (label 3: +1), masked accuracy.
    ``signals`` are prepared here when the lane distances are missing.
    stl_idx (n,) or (n, 1); mask (n,).  Returns (scores_list, scores (n,),
    acc), and with ``scene`` a fourth value, ``scene_acc``: the share of
    (scene, maneuver) pairs, masked by their first row, whose best score
    over the n_randoms rows of the pair is positive."""
    if tau is None:
        tau = cfg.smoothing_factor
    if "x2curr_d" not in signals:
        signals = prep_signals(signals, cfg)
    if isinstance(formulas, ClauseBank):
        scores_list = formulas.scores(signals, tau, hard)
    else:
        scores_list = [f(signals, tau, hard)[:, 0] for f in formulas]
    scores_list = scores_list + [scores_list[-1].detach() * 0.0 + 1.0]
    scores = select_scores(scores_list, stl_idx.reshape(-1))
    acc = mask_mean((scores > 0).to(scores.dtype), mask.reshape(-1))
    if scene:
        sc = scores.reshape(-1, cfg.n_randoms, 3)
        mc = mask.reshape(-1, cfg.n_randoms, 3)
        scene_acc = mask_mean(
            (torch.amax(sc, dim=1) > 0).to(scores.dtype), mc[:, 0, :])
        return scores_list, scores, acc, scene_acc
    return scores_list, scores, acc


# ---------------------------------------------------------------------------
# STL parameter calibration
# ---------------------------------------------------------------------------

def calibrate_stlp(batch: Dict[str, Tensor], gt_trajs: Tensor,
                   cfg: Config) -> Tensor:
    """Per-scene ground-truth pSTL parameters from the GT trajectory
    (``pstl_tpu.specs.calibrate_stlp``).  batch: neighbor_trajs_aug
    (n, K, T, 7), {curr,left,right}lane_wpts, gt_high_level (n, 1);
    gt_trajs (n, T, >=4).  Returns stlp (n, 6)."""
    DEFAULT_DMIN, DEFAULT_DMAX, DEFAULT_TH = -5.0, 5.0, 0.5
    nt = cfg.nt
    gt_vmin = torch.amin(gt_trajs[..., 3], dim=-1)
    gt_vmax = torch.amax(gt_trajs[..., 3], dim=-1)
    nei = batch["neighbor_trajs_aug"]
    nei_dist = geom.min_neighbor_distance(
        gt_trajs[..., 0:4], nei[..., 1:7], nei[..., 0], ego_L=cfg.ego_L,
        ego_W=cfg.ego_W, num_L=cfg.refined_nL, num_W=cfg.refined_nW)
    gt_d_safe = torch.amin(nei_dist, dim=-1)

    dists, angles = {}, {}
    for key in ("curr", "left", "right"):
        dists[key], angles[key] = geom.point_to_polyline(
            gt_trajs[..., 0:3], batch[f"{key}lane_wpts"],
            clip=cfg.clip_dist, inline=cfg.inline, with_angle=True)
    hl = batch["gt_high_level"][:, 0]
    half = nt // 2 - 1
    dmin = {"curr": torch.amin(dists["curr"], -1),
            "left": torch.amin(dists["left"][:, half:], -1),
            "right": torch.amin(dists["right"][:, half:], -1)}
    dmax = {"curr": torch.amax(dists["curr"], -1),
            "left": torch.amax(dists["left"][:, half:], -1),
            "right": torch.amax(dists["right"][:, half:], -1)}
    thm = {"curr": torch.amax(angles["curr"], -1),
           "left": torch.amax(angles["left"][:, half:], -1),
           "right": torch.amax(angles["right"][:, half:], -1)}

    def pick(d, default):
        return (d["curr"] * (hl == 0) + d["left"] * (hl == 1)
                + d["right"] * (hl == 2) + default * (hl == 3))

    gt_dmin = pick(dmin, DEFAULT_DMIN)
    gt_dmax = pick(dmax, DEFAULT_DMAX)
    gt_th_max = pick(thm, DEFAULT_TH)
    if cfg.flex:
        return torch.stack([torch.clamp(gt_vmin - 1, min=-0.3), gt_vmax + 1,
                            gt_dmin - 0.3, gt_dmax + 0.3,
                            torch.clamp(gt_d_safe - 0.1, min=0),
                            gt_th_max + 0.1], dim=-1)
    return torch.stack([gt_vmin - 0.1, gt_vmax + 0.1, gt_dmin - 0.1,
                        gt_dmax + 0.1, gt_d_safe - 0.1, gt_th_max + 0.05],
                       dim=-1)


# ---------------------------------------------------------------------------
# flex pSTL draws, dense batching and the tiled scorer
# ---------------------------------------------------------------------------

#: the range of each of the six uniforms of ``generate_flex_pstl``, for the
#: lane keep (maneuver 0) and for a lane change (1, 2): the speed-band
#: widenings, the d-band blend (keep) or bounds (change), the d_safe and
#: th_max blends
FLEX_RANGES = {
    "keep": ((1.3, 3.0), (1.3, 3.0), (0.0, 1.0), (0.0, 1.0), (0.0, 1.0),
             (0.0, 1.0)),
    "change": ((1.3, 3.0), (1.3, 3.0), (-2.5, -0.5), (0.5, 2.5), (0.0, 1.0),
               (0.0, 1.0)),
}


def flex_uniforms(bs: int, generator: Optional[torch.Generator] = None,
                  device=None) -> Tensor:
    """The uniforms of ``get_dense_stlp``'s three ``generate_flex_pstl``
    calls: (3, 6, bs, 1), entry [j, i] in the range ``FLEX_RANGES`` gives
    maneuver j's i-th draw.  Under a data sharding (``parallel.mesh``)
    ``bs`` is this rank's scenes, drawn as the whole batch's."""
    u = mesh.draw(lambda s: torch.rand(s, generator=generator,
                                       device=device), (3, 6, bs, 1), rows=2)
    lo = torch.tensor([[r[0] for r in FLEX_RANGES["keep" if j == 0
                                                   else "change"]]
                       for j in range(3)], device=u.device)
    hi = torch.tensor([[r[1] for r in FLEX_RANGES["keep" if j == 0
                                                   else "change"]]
                       for j in range(3)], device=u.device)
    return u * (hi - lo)[..., None, None] + lo[..., None, None]


def generate_flex_pstl(stlp_mid: Tensor, the_high_level: int, n_randoms: int,
                       u: Tensor) -> Tensor:
    """Randomized relaxation of calibrated params for an off-label
    maneuver (``pstl_tpu.specs.generate_flex_pstl``).  stlp_mid:
    (bs, n_randoms, 6); ``u``: the maneuver's six (bs, 1) uniforms, each in
    its ``FLEX_RANGES`` range.  Returns (bs, n_randoms, 6)."""
    bs = stlp_mid.shape[0]
    rep = lambda v: v.expand(bs, n_randoms)
    new_vmin = torch.clamp(stlp_mid[:, :, 0] - rep(u[0]), min=-0.3)
    new_vmax = torch.clamp(stlp_mid[:, :, 1] + rep(u[1]), min=-0.3)
    if the_high_level == 0:
        lamb0, lamb1 = rep(u[2]), rep(u[3])
        new_dmin = (lamb0 * stlp_mid[:, :, 2]
                    + (1 - lamb0) * (stlp_mid[:, :, 2] - 2.5))
        new_dmax = (lamb1 * stlp_mid[:, :, 2]
                    + (1 - lamb1) * (stlp_mid[:, :, 2] + 2.5))
    else:
        new_dmin, new_dmax = rep(u[2]), rep(u[3])
    lamb2 = rep(u[4])
    new_dsafe = torch.clamp(lamb2 * stlp_mid[:, :, 4]
                            + (1 - lamb2) * (stlp_mid[:, :, 4] - 1.5), min=0)
    lamb3 = rep(u[5])
    new_thmax = (lamb3 * stlp_mid[:, :, 5]
                 + (1 - lamb3) * (stlp_mid[:, :, 5] + 0.3))
    return torch.stack([new_vmin, new_vmax, new_dmin, new_dmax, new_dsafe,
                        new_thmax], dim=-1)


def get_dense_stlp(gt_high_level: Tensor, the_stlp: Tensor, cfg: Config,
                   n_randoms: Optional[int] = None,
                   flex: Optional[Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> Tensor:
    """Dense (bs * n_randoms * 3, 1, 6) pSTL parameters: the calibrated
    params on the labeled maneuver, flex draws (``cfg.flex``; ``flex`` the
    (3, 6, bs, 1) uniforms, else drawn from ``generator``) or defaults
    elsewhere (``pstl_tpu.specs.get_dense_stlp``)."""
    if n_randoms is None:
        n_randoms = cfg.n_randoms
    bs = the_stlp.shape[0]
    hl = gt_high_level.reshape(bs, 1, 1)
    stlp_mid = the_stlp[:, None, :].expand(bs, n_randoms, 6)
    dt = stlp_mid.dtype
    if cfg.flex:
        if flex is None:
            flex = flex_uniforms(bs, generator, the_stlp.device)
        else:
            flex = mesh.local_part(flex, rows=2)
        d = [generate_flex_pstl(stlp_mid, j, n_randoms, flex[j])
             for j in range(3)]
        hlf = hl.to(dt)
        ins = [(hlf * (3 - hlf) == 0).to(dt),             # keep or outlier
               (hl == 1).to(dt), (hl == 2).to(dt)]
    else:
        default = torch.tensor([0.0, 20.0, -2.5, 2.5, 0.1, 0.5], dtype=dt,
                               device=the_stlp.device)
        d = [default.expand(bs, n_randoms, 6)] * 3
        ins = [(hl == j).to(dt) for j in range(3)]
    stlp_mul = torch.stack([m * stlp_mid + (1 - m) * dj
                            for m, dj in zip(ins, d)], dim=-2)
    return stlp_mul.reshape(bs * n_randoms * 3, 1, 6)


def dup(x: Tensor, m: int) -> Tensor:
    """(N, ...) -> (N*m, ...) tiling along a new candidate axis."""
    return torch.repeat_interleave(x, m, dim=0)


def densify_batch(batch: Dict[str, Tensor], the_stlp: Tensor, cfg: Config,
                  stlp_dense: Optional[Tensor] = None,
                  n_randoms: Optional[int] = None,
                  flex: Optional[Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, Tensor]:
    """Expand a per-scene batch to the (bs * n_randoms * 3) dense layout
    (``pstl_tpu.specs.densify_batch``).  The dense pSTL parameters are the
    caller's ``stlp_dense`` (the planner), else the batch's ``pre_stlp``
    column under ``cfg.load_stlp``, else :func:`get_dense_stlp`'s draws
    (``flex`` / ``generator``)."""
    if n_randoms is None:
        n_randoms = cfg.n_randoms
    m = n_randoms * 3
    bs = batch["currlane_wpts"].shape[0]
    out = dict(batch)
    out["neighbors_dense"] = dup(batch["neighbor_trajs_aug"], m)
    for k in ("currlane_wpts", "leftlane_wpts", "rightlane_wpts"):
        out[f"{k}_dense"] = dup(batch[k], m)
    out["stlp"] = the_stlp[:, None, :]
    if stlp_dense is not None:
        out["stlp_dense"] = stlp_dense
    elif cfg.load_stlp and "pre_stlp" in batch:
        out["stlp_dense"] = batch["pre_stlp"].reshape(bs * m, 1, 6)
    else:
        out["stlp_dense"] = get_dense_stlp(batch["gt_high_level"], the_stlp,
                                           cfg, n_randoms, flex, generator)
    valids = torch.cat([batch["curr_id"], batch["left_id"],
                        batch["right_id"]], dim=-1)              # (bs, 3)
    out["valids_dense"] = dup(valids, n_randoms).reshape(bs * n_randoms, 3)
    hl = torch.tensor([0.0, 1.0, 2.0], device=valids.device)
    out["highlevel_dense"] = hl.repeat(bs * n_randoms).reshape(bs * m, 1)
    return out


def _map_signals(out: Dict, fn) -> Dict:
    """``fn`` on every tensor of a signal dict, the disc fields included."""
    return {k: (geom.NeighborDiscs(*(fn(t) for t in v))
                if isinstance(v, geom.NeighborDiscs) else fn(v))
            for k, v in out.items()}


def dense_signal_input(batch: Dict[str, Tensor],
                       dense_trajs: Optional[Tensor] = None,
                       repeat_n: Optional[int] = None,
                       detach: bool = False,
                       cfg: Optional[Config] = None) -> Dict[str, Tensor]:
    """The signal dict the formulas read, from a densified batch
    (``pstl_tpu.specs.dense_signal_input``).  With ``cfg`` it also hoists
    what stays constant across evaluations on the batch: the neighbor discs
    (``nei_discs``, when ``refined_nW`` is 1 and there is no collision
    loss; ``prep_signals`` then takes its "discs" route) and the norm_stl
    factors.  ``detach`` cuts every entry from autograd; ``repeat_n`` tiles
    every entry ``repeat_n`` times along its first axis; ``dense_trajs``
    becomes ``ego_traj``."""
    out = {
        "neighbors": batch["neighbors_dense"],
        "currlane_wpts": batch["currlane_wpts_dense"],
        "leftlane_wpts": batch["leftlane_wpts_dense"],
        "rightlane_wpts": batch["rightlane_wpts_dense"],
        "stlp": batch["stlp_dense"],
        "dense_valids": batch["valids_dense"],
        "gt_high_level": batch["gt_high_level"],
    }
    if cfg is not None:
        if cfg.refined_nW == 1 and cfg.collision_loss is None:
            nei = out["neighbors"]
            out["nei_discs"] = geom.precompute_neighbor_discs(
                nei[..., 1:7], nei[..., I_VAL], cfg.refined_nL)
        if cfg.norm_stl:
            stlp = out["stlp"]
            out["v_factor"] = torch.clamp(
                stlp[..., I_VMAX] - stlp[..., I_VMIN], min=0.3)
            out["d_factor"] = torch.clamp(
                (stlp[..., I_DMAX] - stlp[..., I_DMIN]) * 5, min=0.3)
            out["safe_factor"] = torch.clamp(stlp[..., I_DSAFE], min=0.3)
    if detach:
        out = _map_signals(out, lambda v: v.detach())
    if repeat_n is not None:
        out = _map_signals(out, lambda v: v.repeat(
            (repeat_n,) + (1,) * (v.ndim - 1)))
    if dense_trajs is not None:
        out["ego_traj"] = dense_trajs
    return out


def _u(f):
    """Unsqueeze a (bs, M, 3) norm factor to broadcast over T (scalars pass
    through)."""
    return f[..., None] if torch.is_tensor(f) and f.ndim == 3 else f


class TiledScorer:
    """Robustness of the canonical dense layout (bs x n_randoms x 3
    maneuvers): each row evaluates only its own maneuver's formula against
    its own lane, and the scene constants stay per scene.  ``__call__(trajs)``
    maps (N, T, >=4) rollout states (t = 0..T-1) to per-row robustness (N,).
    See ``pstl_tpu.specs.TiledScorer``.  ``inputs``, ``on_base`` and
    ``counters`` are what the plan's captured selection tail reads of it
    (``sim``), as the DDPM chain's graph reads the fused loss."""

    #: launch counters a captured scorer holds: none, it runs plain torch
    #: ops (the clearance kernels are ``prep_signals``' route)
    counters = ()

    def __init__(self, batch: Dict[str, Tensor], stlp_dense: Tensor,
                 cfg: Config, n_randoms: Optional[int] = None):
        self.cfg = cfg
        M = n_randoms if n_randoms is not None else cfg.n_randoms
        self.R = M * 3
        nei = batch["neighbor_trajs_aug"]                   # (bs, K, T, 7)
        self.bs = nei.shape[0]
        self.discs = geom.precompute_neighbor_discs(
            nei[..., 1:7], nei[..., I_VAL], cfg.refined_nL)
        self.lanes = torch.stack([batch["currlane_wpts"],
                                  batch["leftlane_wpts"],
                                  batch["rightlane_wpts"]], dim=1)
        self.stlp = stlp_dense.reshape(self.bs, M, 3, 6)
        self.dtype = torch.bfloat16 if cfg.robustness_dtype == "bfloat16" \
            else torch.float32
        if cfg.norm_stl:
            s = self.stlp
            self.vf = torch.clamp(s[..., I_VMAX] - s[..., I_VMIN], min=0.3)
            self.df = torch.clamp((s[..., I_DMAX] - s[..., I_DMIN]) * 5,
                                  min=0.3)
            self.sf = torch.clamp(s[..., I_DSAFE], min=0.3)
        else:
            self.vf = self.df = self.sf = 1.0

    @property
    def inputs(self) -> Dict[str, Tensor]:
        """By name, the tensors a plan makes fresh: the neighbor discs'
        fields ("discs.<field>"), the lanes, the stlp and, under
        ``norm_stl``, the norm factors."""
        out = {"discs." + k: v for k, v in self.discs._asdict().items()}
        out.update(lanes=self.lanes, stlp=self.stlp)
        if torch.is_tensor(self.vf):
            out.update(vf=self.vf, df=self.df, sf=self.sf)
        return out

    def on_base(self, d: Dict[str, Tensor]) -> "TiledScorer":
        """A copy that reads :attr:`inputs` from ``d``."""
        scorer = copy.copy(self)
        scorer.discs = geom.NeighborDiscs(
            *(d["discs." + k] for k in geom.NeighborDiscs._fields))
        for k in ("lanes", "stlp", "vf", "df", "sf"):
            if k in d:
                setattr(scorer, k, d[k])
        return scorer

    def _alw(self, g, tau, hard):
        return stl.soft_min(g, tau, dim=-1, hard=hard, dtype=self.dtype)

    def _ev_alw(self, g, tau, hard):
        nt2 = self.cfg.nt // 2
        g = g.to(self.dtype)
        if hard:
            suffix = stl.cumulative(torch.minimum, g, dim=-1, reverse=True)
            return torch.amax(suffix[..., :nt2], dim=-1)
        suffix = -stl.logcumsumexp(-g * tau, dim=-1, reverse=True) / tau
        return stl.soft_max(suffix[..., :nt2], tau, dim=-1, dtype=self.dtype)

    def __call__(self, trajs: Tensor, tau: Optional[float] = None,
                 hard: bool = False) -> Tensor:
        with span("plan.score"):
            return self._scores(trajs, tau, hard)

    def _scores(self, trajs: Tensor, tau: Optional[float],
                hard: bool) -> Tensor:
        cfg = self.cfg
        if tau is None:
            tau = cfg.smoothing_factor
        bs, R, M = self.bs, self.R, self.R // 3
        ego = trajs.reshape(bs, M, 3, cfg.nt, trajs.shape[-1])
        stlp = self.stlp                                      # (bs, M, 3, 6)
        P = lambda i: stlp[..., i:i + 1]                      # (bs, M, 3, 1)
        soft_min = lambda x: stl.soft_min(x, tau, dim=-1, hard=hard,
                                          dtype=self.dtype)

        v = ego[..., 3]                                       # (bs, M, 3, T)
        alw_vmin = self._alw((v - P(I_VMIN)) / _u(self.vf), tau, hard)
        alw_vmax = self._alw((-v + P(I_VMAX)) / _u(self.vf), tau, hard)
        mnd = geom.min_clearance_tiled(
            ego[..., :3].reshape(bs, R, cfg.nt, 3), self.discs, cfg.ego_L,
            cfg.ego_W, cfg.refined_nL).reshape(bs, M, 3, cfg.nt)
        alw_safe = self._alw((mnd - P(I_DSAFE)) / _u(self.sf), tau, hard)

        # one lane per row: maneuver j reads lane j
        ego_j = torch.swapaxes(ego[..., :3], 1, 2)            # (bs,3,M,T,3)
        lanes_j = self.lanes[:, :, None]                      # (bs,3,1,S,3)
        d_all, th_all = geom.point_to_polyline(
            ego_j, lanes_j, clip=cfg.clip_dist, with_angle=True,
            inline=cfg.inline)                                # (bs, 3, M, T)
        Pj = lambda i: torch.swapaxes(stlp[..., i:i + 1], 1, 2)
        dfj = torch.swapaxes(self.df, 1, 2)[..., None] \
            if torch.is_tensor(self.df) else self.df

        g_dmin = (d_all - Pj(I_DMIN)) / dfj
        g_dmax = (-d_all + Pj(I_DMAX)) / dfj
        g_th = (Pj(I_THMAX) - th_all) / Pj(I_THMAX)

        alw_keep = self._alw(torch.stack([g_dmin[:, 0], g_dmax[:, 0],
                                          g_th[:, 0]], dim=-2), tau, hard)
        s_keep = soft_min(torch.stack(
            [alw_vmin[:, :, 0], alw_vmax[:, :, 0], alw_keep[:, :, 0],
             alw_keep[:, :, 1], alw_keep[:, :, 2], alw_safe[:, :, 0]], -1))

        g_band = soft_min(torch.stack([g_dmin[:, 1:], g_dmax[:, 1:]], -1))
        ev_d = self._ev_alw(g_band, tau, hard)                # (bs, 2, M)
        ev_th = self._ev_alw(g_th[:, 1:], tau, hard)
        vmin_j = torch.movedim(alw_vmin[:, :, 1:], -1, 1)     # (bs, 2, M)
        vmax_j = torch.movedim(alw_vmax[:, :, 1:], -1, 1)
        safe_j = torch.movedim(alw_safe[:, :, 1:], -1, 1)
        s_change = soft_min(torch.stack([vmin_j, vmax_j, ev_d, ev_th,
                                         safe_j], -1))        # (bs, 2, M)
        scores = torch.stack([s_keep, s_change[:, 0], s_change[:, 1]],
                             dim=-1)                          # (bs, M, 3)
        return scores.reshape(bs * R)


def make_score_rows(batch: Dict[str, Tensor], dense: Dict[str, Tensor],
                    cfg: Config, n_randoms: Optional[int] = None,
                    formulas=None):
    """Per-row robustness function for the canonical dense layout:
    ``score_rows(ego_states (N, T, >=4)) -> (N,)``.  ``TiledScorer`` by
    default; ``cfg.tiled_scorer=False`` scores with ``formulas`` (a
    ``ClauseBank`` or :func:`build_formulas`'s list; the ``ClauseBank`` when
    None) over the pre-tiled signals of ``dense_signal_input`` (the same
    numbers)."""
    if cfg.tiled_scorer:
        return TiledScorer(batch, dense["stlp_dense"], cfg, n_randoms)
    if formulas is None:
        formulas = build_scorer(cfg)
    signal_base = dense_signal_input(dense, cfg=cfg)
    hl = dense["highlevel_dense"]
    valid = dense["valids_dense"].reshape(-1)

    def score_rows(ego):
        with span("plan.score"):
            _, s, _ = compute_scores(dict(signal_base, ego_traj=ego),
                                     formulas, hl, valid, cfg)
        return s

    return score_rows
