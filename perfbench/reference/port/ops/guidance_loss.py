"""A frozen copy of ``pstl_tpu_torch/ops/guidance_loss.py`` of the PyTorch port, kept as the benchmark's plain
reference: every kernel dispatch runs the plain version.  Do not edit to
follow the program."""


from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench.reference.port.config import Config
from perfbench.reference.port.parallel import mesh

Tensor = torch.Tensor

# stlp component indices and the neighbor row layout (valid, x, y, th, v, L, W)
I_VMIN, I_VMAX, I_DMIN, I_DMAX, I_DSAFE, I_THMAX = 0, 1, 2, 3, 4, 5
I_VAL = 0


def mask_mean(x: Tensor, mask: Tensor, dim=None) -> Tensor:
    """mean(x * mask) / clip(mean(mask), 1e-2).  Over every row (``dim``
    None) under a sharding (``parallel.mesh``) the rows are this rank's
    share: the mask's mean is taken over all ranks, so the mean over ranks
    of the result is the whole batch's value."""
    if dim is None:
        den = mesh.shard_mean(torch.mean(mask))
        return torch.mean(x * mask) / torch.clamp(den, min=1e-2)
    return (torch.mean(x * mask, dim=dim)
            / torch.clamp(torch.mean(mask, dim=dim), min=1e-2))


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


    def _from_cand_minor(self, muT: Tensor) -> Tensor:
        """(bs, T, 2, R) j-major -> (N, nt*2) m-major."""
        x = muT.reshape(self.bs, self.cfg.nt, 2, 3, self.M)
        return x.permute(0, 4, 3, 1, 2).reshape(self.bs * self.M * 3,
                                                self.cfg.nt * 2)


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
