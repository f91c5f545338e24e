"""A frozen copy of ``pstl_tpu_torch/specs.py`` of the PyTorch port, kept as the benchmark's plain
reference: every kernel dispatch runs the plain version.  Do not edit to
follow the program."""


from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench.reference.port.config import HELD, Config
from perfbench.reference.port.ops import geometry as geom
from perfbench.reference.port.ops import stl
from perfbench.reference.port.parallel import mesh
from perfbench.reference.port.ops.guidance_loss import (  # noqa: F401
    I_DMAX, I_DMIN, I_DSAFE, I_THMAX, I_VAL, I_VMAX, I_VMIN,
    CandMinorGuidanceLoss, make_guidance_loss, mask_mean)

Tensor = torch.Tensor

# high-level maneuver labels
HL_KEEP, HL_LEFT, HL_RIGHT, HL_OUTLIER = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# signal cache
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the maneuver formulas
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the fused clause-bank scorer
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# STL parameter calibration
# ---------------------------------------------------------------------------


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


def _u(f):
    """Unsqueeze a (bs, M, 3) norm factor to broadcast over T (scalars pass
    through)."""
    return f[..., None] if torch.is_tensor(f) and f.ndim == 3 else f


class TiledScorer:
    """Robustness of the canonical dense layout (bs x n_randoms x 3
    maneuvers): each row evaluates only its own maneuver's formula against
    its own lane, and the scene constants stay per scene.  ``__call__(trajs)``
    maps (N, T, >=4) rollout states (t = 0..T-1) to per-row robustness (N,).
    See ``pstl_tpu.specs.TiledScorer``."""

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
    ``score_rows(ego_states (N, T, >=4)) -> (N,)``: ``TiledScorer`` (the
    frozen copy holds no other scorer)."""
    if not cfg.tiled_scorer or formulas is not None:
        raise NotImplementedError(f"{HELD}: the tiled scorer")
    return TiledScorer(batch, dense["stlp_dense"], cfg, n_randoms)
