"""Candidate-minor fused STL-guidance loss (port of
``pstl_tpu/ops/guidance_loss.py``).

Same math as rollout -> TiledScorer -> mask_mean(relu(thres - scores)),
with the large candidate axis R = 3*M minor and j-major candidates
(r = j*M + m, so lane selection per row is slicing at M boundaries).
Torch autograd through :meth:`CandMinorGuidanceLoss.loss_cm` with frozen
selections is the gradient oracle of the fused guidance kernel
(``ops/guidance_kernel.py``), and its constructor holds the per-plan
invariants the kernels read (recentred lanes, neighbor discs, stlp rows).
:meth:`CandMinorGuidanceLoss.freeze_cm` makes the frozen payloads that the
frozen-payload kernel and the XLA guidance loop read.  As in the JAX
package, ``geometry_dtype`` is the dtype of the selection fields (the
distances the argmins search) and of the stored payloads, and
``robustness_dtype`` the dtype of the soft-min / soft-max reductions (cast
where the JAX package casts; the scores come out fp32).  The kernels
require fp32 robustness (``Config.finalize``), so bf16 robustness runs on
the XLA guidance loop only.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pstl_tpu_torch.config import Config
from pstl_tpu_torch.ops import stl

Tensor = torch.Tensor

# stlp component indices and the neighbor row layout (valid, x, y, th, v, L, W)
I_VMIN, I_VMAX, I_DMIN, I_DMAX, I_DSAFE, I_THMAX = 0, 1, 2, 3, 4, 5
I_VAL = 0


def mask_mean(x: Tensor, mask: Tensor, dim=None) -> Tensor:
    """mean(x * mask) / clip(mean(mask), 1e-2)."""
    if dim is None:
        return torch.mean(x * mask) / torch.clamp(torch.mean(mask), min=1e-2)
    return (torch.mean(x * mask, dim=dim)
            / torch.clamp(torch.mean(mask, dim=dim), min=1e-2))


def _lse(x: Tensor, dim: int) -> Tensor:
    return torch.logsumexp(x, dim=dim)


class CandMinorGuidanceLoss:
    """Guidance hinge loss in candidate-minor (bs, T, 2, R) layout; see
    ``pstl_tpu.ops.guidance_loss.CandMinorGuidanceLoss``.  Every geometric
    quantity is recentred per scene at the ego start (exact: it only uses
    coordinate differences)."""

    def __init__(self, batch: Dict[str, Tensor], stlp_dense: Tensor,
                 states: Tensor, valid: Tensor, cfg: Config,
                 n_randoms: Optional[int] = None):
        self.cfg = cfg
        M = n_randoms if n_randoms is not None else cfg.n_randoms
        self.M = M
        R = M * 3
        self.R = R
        bs = batch["currlane_wpts"].shape[0]
        self.bs = bs
        dev = states.device
        cx = states[:, 0][:, None, None]                      # (bs,1,1)
        cy = states[:, 1][:, None, None]
        lanes = torch.stack([batch["currlane_wpts"], batch["leftlane_wpts"],
                             batch["rightlane_wpts"]], dim=1)  # (bs,3,S,3)
        lanes = torch.stack([lanes[..., 0] - states[:, 0][:, None, None],
                             lanes[..., 1] - states[:, 1][:, None, None],
                             lanes[..., 2]], dim=-1)
        self.lanes = lanes                                    # (bs,3,S,3)
        lane_r = torch.movedim(torch.repeat_interleave(lanes, M, dim=1),
                               1, -1)                         # (bs,S,3,R)
        self.lxr = lane_r[:, :, 0]                            # (bs, S, R)
        self.lyr = lane_r[:, :, 1]
        self.lthr = lane_r[:, :, 2]

        nei = batch["neighbor_trajs_aug"]                     # (bs,K,T,7)
        self.nvalid = nei[..., 0]
        nx0, ny0, nth = nei[..., 1] - cx, nei[..., 2] - cy, nei[..., 3]
        Ln, Wn = nei[..., 5], nei[..., 6]
        self.rn = Wn / 2.0
        alpha = torch.linspace(0.0, 1.0, cfg.refined_nL, device=dev)
        axn = ((-Ln / 2 + self.rn)[..., None] * (1 - alpha)
               + (Ln / 2 - self.rn)[..., None] * alpha)       # (bs,K,T,nLn)
        self.nx = nx0[..., None] + axn * torch.cos(nth)[..., None]
        self.ny = ny0[..., None] + axn * torch.sin(nth)[..., None]
        self.re = cfg.ego_W / 2.0
        self.axe = torch.linspace(-cfg.ego_L / 2 + self.re,
                                  cfg.ego_L / 2 - self.re, cfg.refined_nL,
                                  device=dev)

        stlp = stlp_dense.reshape(bs, M, 3, 6)
        self.stlp_r = stlp.permute(0, 3, 2, 1).reshape(bs, 6, R)
        if cfg.norm_stl:
            s = self.stlp_r
            self.vf = torch.clamp(s[:, I_VMAX] - s[:, I_VMIN], min=0.3)[:, None]
            self.df = torch.clamp((s[:, I_DMAX] - s[:, I_DMIN]) * 5,
                                  min=0.3)[:, None]
            self.sf = torch.clamp(s[:, I_DSAFE], min=0.3)[:, None]
        else:
            self.vf = self.df = self.sf = 1.0
        self.valid_r = valid.reshape(bs, M, 3).transpose(1, 2).reshape(bs, R)
        self.th0 = states[:, 2][:, None, None]
        self.v0 = states[:, 3][:, None, None]
        # the selection fields and frozen payloads (freeze_cm) are in the
        # geometry dtype, rounded where pstl_tpu rounds them
        self.gdtype = torch.bfloat16 if cfg.geometry_dtype == "bfloat16" \
            else torch.float32
        # the robustness reductions' dtype (the Adam math stays fp32)
        self.dtype = torch.bfloat16 if cfg.robustness_dtype == "bfloat16" \
            else torch.float32
        self._kernel_operands = None

    # ------------------------------------------------------------------
    def _alw(self, g, tau, dim=1):
        g = g.to(self.dtype)
        return -_lse(-g * tau, dim) / tau

    def _ev_alw(self, g, tau):
        nt2 = self.cfg.nt // 2
        g = g.to(self.dtype)
        suffix = -stl.logcumsumexp(-g * tau, dim=1, reverse=True) / tau
        return _lse(suffix[:, :nt2] * tau, 1) / tau

    def _rollout(self, muT: Tensor):
        """(bs,T,2,R) normalized controls -> recentred ego states."""
        cfg = self.cfg
        bs, R = self.bs, self.R
        w = muT[:, :, 0, :] * cfg.mul_w_max
        a = muT[:, :, 1, :] * cfg.mul_a_max
        th_in = self.th0 + cfg.dt * torch.cumsum(w, dim=1)
        v_in = self.v0 + cfg.dt * torch.cumsum(a, dim=1)
        th_s = torch.cat([self.th0.expand(bs, 1, R), th_in[:, :-1]], dim=1)
        v_s = torch.cat([self.v0.expand(bs, 1, R), v_in[:, :-1]], dim=1)
        cth, sth = torch.cos(th_s), torch.sin(th_s)
        zer = torch.zeros((bs, 1, R), device=muT.device)
        x_s = torch.cat([zer, torch.cumsum(v_s * cth * cfg.dt, 1)[:, :-1]], 1)
        y_s = torch.cat([zer, torch.cumsum(v_s * sth * cfg.dt, 1)[:, :-1]], 1)
        return x_s, y_s, th_s, v_s, cth, sth

    def _lane_select(self, x_s: Tensor, y_s: Tensor) -> Dict[str, Tensor]:
        """Nearest segment per (t, row) and its endpoint payloads (in the
        geometry dtype; ``first`` / ``last`` bool)."""
        S = self.lxr.shape[1]
        gd = self.gdtype
        with torch.no_grad():
            lxg, lyg = self.lxr.to(gd), self.lyr.to(gd)
            pdx = x_s.to(gd)[:, :, None, :] - lxg[:, None]    # (bs,T,S,R)
            pdy = y_s.to(gd)[:, :, None, :] - lyg[:, None]
            pd = torch.sqrt(pdx * pdx + pdy * pdy)
            mi = torch.argmin(pd[:, :, :-1] + pd[:, :, 1:], dim=2)  # (bs,T,R)
            T = x_s.shape[1]
            take = lambda f, off: torch.gather(
                f.to(gd)[:, None].expand(-1, T, -1, -1), 2,
                (mi + off)[:, :, None]).squeeze(2)
            return dict(x2=take(self.lxr, 0), y2=take(self.lyr, 0),
                        th2=take(self.lthr, 0), x3=take(self.lxr, 1),
                        y3=take(self.lyr, 1), first=(mi == 0),
                        last=(mi == S - 2))

    def _lane_terms(self, x_s, y_s, th_s, lsel):
        """Signed lane distance + heading deviation, (bs,T,R)."""
        cfg = self.cfg
        x2, y2, x3, y3 = (lsel[k].float() for k in ("x2", "y2", "x3", "y3"))
        area = x_s * (y2 - y3) + x2 * (y3 - y_s) + x3 * (y_s - y2)
        bottom = torch.sqrt((x2 - x3) ** 2 + (y2 - y3) ** 2)
        l2d = torch.sqrt(torch.clamp((x_s - x2) ** 2 + (y_s - y2) ** 2,
                                     min=1e-3))
        normal = (bottom != 0).float()
        d_all = (normal * area / torch.clamp(bottom, min=1e-7)
                 + (1 - normal) * l2d)
        if cfg.inline:
            l2d1 = torch.sqrt(torch.clamp((x_s - x3) ** 2 + (y_s - y3) ** 2,
                                          min=1e-3))
            behind = ((x_s - x2) * (x3 - x2) + (y_s - y2) * (y3 - y2)) <= 0
            ahead = ((x_s - x3) * (x2 - x3) + (y_s - y3) * (y2 - y3)) <= 0
            behind_all = lsel["first"] & behind
            ahead_all = lsel["last"] & ahead
            norm_c = ~(behind_all | ahead_all)
            sign = torch.sign(d_all)
            d_all = (norm_c * d_all + behind_all * l2d * sign
                     + ahead_all * l2d1 * sign)
        if cfg.clip_dist:
            d_all = torch.clamp(d_all, -5.0, 5.0)
        th_all = 1.0 - torch.cos(lsel["th2"].float() - th_s)
        return d_all, th_all

    def _clear_select(self, x_s, y_s, cth, sth) -> Dict[str, Tensor]:
        """Nearest (ego-disc, neighbor-disc) pair per (k, t, row): exact
        (flat index e*nLn + nn) or, with ``clearance_coarse_pair``, the
        nearest ego disc to the neighbor's disc centroid first, then the
        nearest neighbor disc to it.  Earliest index wins ties."""
        gd = self.gdtype
        with torch.no_grad():
            axg = self.axe.to(gd)
            nxg, nyg = self.nx.to(gd), self.ny.to(gd)         # (bs,K,T,nLn)
            exd = x_s.to(gd)[:, :, None, :] + axg[None, None, :, None] \
                * cth.to(gd)[:, :, None]
            eyd = y_s.to(gd)[:, :, None, :] + axg[None, None, :, None] \
                * sth.to(gd)[:, :, None]
            nLn = nxg.shape[-1]
            bs, T, R = x_s.shape
            K = nxg.shape[1]
            if self.cfg.clearance_coarse_pair:
                ncx = torch.mean(nxg, dim=-1)                 # (bs,K,T)
                ncy = torch.mean(nyg, dim=-1)
                de = ((exd[:, None] - ncx[..., None, None]) ** 2
                      + (eyd[:, None] - ncy[..., None, None]) ** 2)
                ie = torch.argmin(de, dim=3)                  # (bs,K,T,R)
                exk = exd[:, None].expand(bs, K, T, -1, R)
                eyk = eyd[:, None].expand(bs, K, T, -1, R)
                ex_sel = torch.gather(exk, 3, ie[:, :, :, None]).squeeze(3)
                ey_sel = torch.gather(eyk, 3, ie[:, :, :, None]).squeeze(3)
                dn = ((ex_sel[..., None, :] - nxg[..., None]) ** 2
                      + (ey_sel[..., None, :] - nyg[..., None]) ** 2)
                inn = torch.argmin(dn, dim=3)
            else:
                dxp = exd[:, None, :, :, None, :] - nxg[:, :, :, None, :, None]
                dyp = eyd[:, None, :, :, None, :] - nyg[:, :, :, None, :, None]
                d2p = dxp * dxp + dyp * dyp                   # (bs,K,T,e,n,R)
                pi = torch.argmin(d2p.reshape(bs, K, T, -1, R), dim=3)
                ie = pi // nLn
                inn = pi % nLn
            axe_sel = axg[ie]
            nx_sel = torch.gather(nxg[..., None].expand(-1, -1, -1, -1, R), 3,
                                  inn[:, :, :, None]).squeeze(3)
            ny_sel = torch.gather(nyg[..., None].expand(-1, -1, -1, -1, R), 3,
                                  inn[:, :, :, None]).squeeze(3)
            return dict(axe=axe_sel, nx=nx_sel, ny=ny_sel)

    def _clear_mnd(self, x_s, y_s, cth, sth, csel):
        """Min neighbor clearance signal (bs,T,R): exact pairwise min, or
        the frozen pair's distance."""
        if csel is None:
            exd = (x_s[:, :, None, :]
                   + self.axe[None, None, :, None] * cth[:, :, None, :])
            eyd = (y_s[:, :, None, :]
                   + self.axe[None, None, :, None] * sth[:, :, None, :])
            dxp = exd[:, None, :, :, None, :] - self.nx[:, :, :, None, :, None]
            dyp = eyd[:, None, :, :, None, :] - self.ny[:, :, :, None, :, None]
            d2 = torch.amin(dxp * dxp + dyp * dyp, dim=(3, 4))  # (bs,K,T,R)
        else:
            axe = csel["axe"].float()
            exd = x_s[:, None] + axe * cth[:, None]
            eyd = y_s[:, None] + axe * sth[:, None]
            d2 = ((exd - csel["nx"].float()) ** 2
                  + (eyd - csel["ny"].float()) ** 2)
        per = torch.sqrt(d2 + 1e-12) - self.re - self.rn[..., None]
        vk = self.nvalid[..., None]
        masked = torch.clamp(per, -5.0, 20.0) * vk + (1.0 - vk) * 100.0
        return torch.amin(masked, dim=1)                      # (bs,T,R)

    def scores_r(self, muT: Tensor, tau: Optional[float] = None,
                 frozen=None) -> Tensor:
        """muT: (bs, T, 2, R) normalized controls, j-major -> per-row
        robustness (bs, R).  ``frozen`` (from :meth:`freeze_cm`) replaces
        the argmin searches with fixed selections."""
        cfg = self.cfg
        if tau is None:
            tau = cfg.smoothing_factor
        M, R = self.M, self.R
        x_s, y_s, th_s, v_s, cth, sth = self._rollout(muT)
        lsel = frozen["lane"] if frozen is not None \
            else self._lane_select(x_s, y_s)
        d_all, th_all = self._lane_terms(x_s, y_s, th_s, lsel)
        mnd = self._clear_mnd(x_s, y_s, cth, sth,
                              frozen["clear"] if frozen is not None else None)

        P = lambda i: self.stlp_r[:, i][:, None, :]           # (bs,1,R)
        Ps = lambda i, sl: self.stlp_r[:, i, sl][:, None, :]
        sub = lambda f, sl: f[:, :, sl] if torch.is_tensor(f) else f
        smin = lambda rows, dim: -_lse(
            torch.stack(rows, dim=dim).to(self.dtype) * tau, dim) / tau
        alw_vmin = self._alw((v_s - P(I_VMIN)) / self.vf, tau)
        alw_vmax = self._alw((-v_s + P(I_VMAX)) / self.vf, tau)
        alw_safe = self._alw((mnd - P(I_DSAFE)) / self.sf, tau)

        kM, cM = slice(0, M), slice(M, R)
        thk = Ps(I_THMAX, kM)
        g_keep = torch.stack([
            (d_all[..., kM] - Ps(I_DMIN, kM)) / sub(self.df, kM),
            (-d_all[..., kM] + Ps(I_DMAX, kM)) / sub(self.df, kM),
            (thk - th_all[..., kM]) / thk], dim=1)            # (bs,3,T,M)
        alw_keep = self._alw(g_keep, tau, dim=2)              # (bs,3,M)
        s_keep = smin([-alw_vmin[:, kM], -alw_vmax[:, kM], -alw_keep[:, 0],
                       -alw_keep[:, 1], -alw_keep[:, 2], -alw_safe[:, kM]],
                      1)

        d_c = d_all[..., cM]
        dfc = sub(self.df, cM)
        band = smin([-(d_c - Ps(I_DMIN, cM)) / dfc,
                     -(-d_c + Ps(I_DMAX, cM)) / dfc], 1)      # (bs,T,2M)
        ev_d = self._ev_alw(band, tau)
        thc = Ps(I_THMAX, cM)
        ev_th = self._ev_alw((thc - th_all[..., cM]) / thc, tau)
        s_change = smin([-alw_vmin[:, cM], -alw_vmax[:, cM], -ev_d, -ev_th,
                         -alw_safe[:, cM]], 1)
        return torch.cat([s_keep, s_change],
                         dim=1).float()                       # (bs, R)

    def _to_cand_minor(self, mu: Tensor) -> Tensor:
        """(N, nt*2) m-major sampler layout -> (bs, T, 2, R) j-major."""
        muT = mu.reshape(self.bs, self.M, 3, self.cfg.nt, 2)
        return muT.permute(0, 3, 4, 2, 1).reshape(self.bs, self.cfg.nt, 2,
                                                  self.R)

    def _from_cand_minor(self, muT: Tensor) -> Tensor:
        """(bs, T, 2, R) j-major -> (N, nt*2) m-major."""
        x = muT.reshape(self.bs, self.cfg.nt, 2, 3, self.M)
        return x.permute(0, 4, 3, 1, 2).reshape(self.bs * self.M * 3,
                                                self.cfg.nt * 2)

    def freeze_cm(self, muT: Tensor) -> Dict[str, Dict[str, Tensor]]:
        """The discrete argmin selections at ``muT`` (bs,T,2,R) and their
        payloads: ``lane`` x2, y2, th2, x3, y3 (bs,T,R) in the geometry
        dtype, first / last (bs,T,R) bool; ``clear`` axe, nx, ny
        (bs,K,T,R) in the geometry dtype."""
        x_s, y_s, th_s, v_s, cth, sth = self._rollout(muT)
        return dict(lane=self._lane_select(x_s, y_s),
                    clear=self._clear_select(x_s, y_s, cth, sth))

    def loss_cm(self, muT: Tensor, thres: float,
                tau: Optional[float] = None, frozen=None) -> Tensor:
        """Hinge loss mask_mean(relu(thres - scores), valid) on (bs,T,2,R)."""
        scores = self.scores_r(muT, tau, frozen=frozen)
        return mask_mean(torch.relu(thres - scores), self.valid_r)


def make_guidance_loss(batch: Dict[str, Tensor], dense: Dict[str, Tensor],
                       cfg: Config, states: Tensor, valid: Tensor,
                       n_randoms: Optional[int] = None):
    """The candidate-minor fused guidance loss when enabled, else None: the
    sampler's guidance step then runs the rollout + ``score_rows`` fallback
    loss (``diffusion.make_guidance_ctx``)."""
    if not (cfg.guidance_fused_loss and cfg.tiled_scorer):
        return None
    return CandMinorGuidanceLoss(batch, dense["stlp_dense"], states, valid,
                                 cfg, n_randoms=n_randoms)
