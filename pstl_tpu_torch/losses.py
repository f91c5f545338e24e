"""Training losses (port of ``pstl_tpu/losses.py``): the STL hinge, the
epsilon-prediction MSE (masked to STL-satisfying rows under
``stl_bc_mask``), the DPP diversity loss over candidate shards, the
RefineNet stay-close regularizer, the dense VAE's reconstruction and KL
terms, the BC MSE and the TrafficSim collision loss.

The mono training step (``train.py``) computes its VAE reconstruction and
KL terms inline, as the JAX package does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pstl_tpu_torch.config import Config
from pstl_tpu_torch.ops.guidance_loss import mask_mean

Tensor = torch.Tensor


def stl_hinge(scores: Tensor, valid: Tensor, thres: float,
              weight: float = 1.0) -> Tensor:
    """mask_mean(relu(thres - scores), valid) * weight."""
    return mask_mean(torch.relu(thres - scores), valid) * weight


def diffusion_eps_mse(noise: Tensor, eps_hat: Tensor, dense_scores: Tensor,
                      dense_valids: Tensor, cfg: Config) -> Tensor:
    """Epsilon-prediction MSE; with ``stl_bc_mask`` only the valid rows whose
    target scores satisfy the spec (score > 0) contribute."""
    if cfg.stl_bc_mask:
        m = (dense_scores.reshape(-1) * dense_valids.reshape(-1) > 0)
        return mask_mean(torch.square(noise - eps_hat),
                         m.to(noise.dtype)[:, None])
    return torch.mean(torch.square(noise - eps_hat))


def dpp_diversity(rect_controls: Tensor, scores: Tensor,
                  cfg: Config) -> Tensor:
    """Expected-cardinality DPP diversity loss.

    rect_controls (bs*n_randoms*3, nt, 2) and scores (bs*n_randoms*3,), rows
    m-major.  Candidates group per (scene, maneuver, shard) into
    bs*3*n_shards sets of g = n_randoms / n_shards; an RBF kernel over
    control vectors normalized by the control bounds (with a +1e-12 safe
    norm, whose gradient is finite at the zero diagonal) is weighted by the
    quality exp(q)*(q > 0) (``diverse_detach``: (q > 0), without gradient);
    the loss is -mean(trace(I - inv(L + I))) * diversity_weight."""
    NS, M = cfg.n_shards, cfg.n_randoms
    if M % NS:
        raise ValueError(f"dpp_diversity needs n_randoms ({M}) divisible by "
                         f"n_shards ({NS})")
    bs = rect_controls.shape[0] // (M * 3)
    g = M // NS
    D = cfg.nt * 2
    samples = rect_controls.reshape(bs, M, 3, cfg.nt, 2).transpose(1, 2)
    normal = torch.tensor([cfg.mul_w_max, cfg.mul_a_max],
                          dtype=samples.dtype, device=samples.device)
    samples = (samples.reshape(bs * 3 * NS, g, cfg.nt, 2) / normal).reshape(
        bs * 3 * NS, g, D)
    quality = scores.reshape(bs, M, 3).transpose(1, 2).reshape(bs * 3 * NS, g)
    diff = samples[:, :, None] - samples[:, None, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    sim = torch.exp(-cfg.diversity_scale * dist)
    if cfg.diverse_detach:
        q = (quality > 0).to(sim.dtype).detach()
    else:
        q = torch.exp(quality) * (quality > 0).to(sim.dtype)
    L = sim * q[:, :, None] * q[:, None, :]
    eye = torch.eye(g, dtype=L.dtype, device=L.device)
    inv = torch.linalg.inv(L + eye)
    diversity = torch.diagonal(eye[None] - inv, dim1=-2, dim2=-1).sum(-1)
    return -torch.mean(diversity) * cfg.diversity_weight


def rect_reg(rect_controls: Tensor, nn_controls: Tensor, scores: Tensor,
             cfg: Config) -> Tuple[Tensor, Tensor]:
    """RefineNet stay-close regularizer; returns (loss_reg, extra_loss_reg).
    With ``diverse_loss``: the squared move from the (detached) pre-rect
    controls, masked to rows whose ``scores`` are >= 0.  Otherwise the move
    normalized by the control bounds, times ``rect_reg_loss``, and under
    ``extra_rect_reg`` a penalty on controls beyond their bounds."""
    base = nn_controls.detach()
    zero = rect_controls.new_zeros(())
    if cfg.diverse_loss:
        m = (scores[:, None, None] >= 0).to(rect_controls.dtype)
        return mask_mean(torch.square(rect_controls - base), m), zero
    reg = (torch.mean(torch.square((rect_controls[..., 0] - base[..., 0])
                                   / cfg.mul_w_max))
           + torch.mean(torch.square((rect_controls[..., 1] - base[..., 1])
                                     / cfg.mul_a_max)))
    reg = reg * cfg.rect_reg_loss
    if cfg.extra_rect_reg is None:
        return reg, zero
    extra = (torch.mean(torch.relu(
                 (rect_controls[..., 0] / cfg.mul_w_max) ** 2 - 1))
             + torch.mean(torch.relu(
                 (rect_controls[..., 1] / cfg.mul_a_max) ** 2 - 1)))
    return reg, extra * cfg.extra_rect_reg


def _target_mse(nn_controls: Tensor, dense_controls: Tensor,
                dense_scores: Tensor, dense_valids: Tensor,
                cfg: Config) -> Tensor:
    """The squared control error to the trajopt targets over the first
    nt - 1 steps, averaged over every row or, under ``stl_bc_mask``, over
    the valid rows whose targets satisfy the spec (score > 0)."""
    nnf = nn_controls.reshape(-1, cfg.nt, 2)
    dcf = dense_controls.reshape(-1, cfg.nt, 2)
    sq = torch.square(nnf[:, :-1, :2] - dcf[:, :-1, :2])
    if cfg.stl_bc_mask:
        m = (dense_scores.reshape(-1) * dense_valids.reshape(-1) > 0)
        return mask_mean(sq, m.to(sq.dtype)[:, None, None])
    return torch.mean(sq)


def vae_losses(nn_controls: Tensor, dense_controls: Tensor, latent_stats,
               dense_scores: Tensor, dense_valids: Tensor,
               cfg: Config) -> Tuple[Tensor, Tensor]:
    """The dense VAE's (reconstruction, KL): the target MSE times
    ``weight_vae_bc`` and ``bc_weight``, and the KL of the latent's
    (mean, logstd, std) to N(0, 1) times ``weight_vae_kl``."""
    mean, logstd, std = latent_stats
    recon = _target_mse(nn_controls, dense_controls, dense_scores,
                        dense_valids, cfg) * cfg.weight_vae_bc
    recon = recon * cfg.bc_weight
    kl = (-0.5 * torch.mean(1 + 2 * logstd - mean * mean - std * std)
          ) * cfg.weight_vae_kl
    return recon, kl


def bc_mse(nn_controls: Tensor, dense_controls: Tensor, dense_scores: Tensor,
           dense_valids: Tensor, cfg: Config) -> Tensor:
    """The BC head's target MSE times ``bc_weight``."""
    return _target_mse(nn_controls, dense_controls, dense_scores,
                       dense_valids, cfg) * cfg.bc_weight


def collision(min_centroid_d: Tensor, radius_sum: Tensor,
              cfg: Config) -> Tensor:
    """TrafficSim-style collision loss on the masked centre distances and
    radius sums (n, K, T) of ``geometry.min_neighbor_distance(full=True)``."""
    coll = torch.relu(1 - min_centroid_d / torch.clamp(radius_sum, min=1e-1))
    return (torch.mean(torch.clamp(torch.sum(coll, dim=-1), max=1.0))
            * (cfg.collision_loss or 0.0))
