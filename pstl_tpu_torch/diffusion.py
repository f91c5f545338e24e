"""DDPM reverse sampler with fused STL guidance (port of the
candidate-minor path of ``pstl_tpu/diffusion.py``).

The reverse loop is a Python loop over the T-1 denoise steps; it makes no
host synchronisation (coefficients are device tensors, the trigger schedule
is static), so the whole loop can later be captured in a CUDA graph.  Each
guided step is one launch of the fused guidance kernel
(``ops/guidance_kernel.py``).  Noise is injectable for parity tests: a
(T, bs, nt, 2, R) tensor holds x0 and then one draw per step.

Under ``guidance_pallas_superstep`` the loop is :func:`_reverse_superstep`
instead: one launch of the superstep kernel (``ops/superstep_kernel.py``:
eps MLP, posterior, guidance, noise) per denoise step.

Not ported yet: the DDIM and DPM++ samplers, the row-major (non-cm) path,
the frozen-payload kernel path (``guidance_pallas_fuse_freeze=False``), the
scene-folded kernels (``guidance_pallas_fold``) and the
``guidance_sel_every`` carry.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pstl_tpu_torch.config import Config
from pstl_tpu_torch.ops import dynamics as dyn
from pstl_tpu_torch.ops import guidance_kernel, superstep_kernel

Tensor = torch.Tensor


class Coeffs(NamedTuple):
    beta: Tensor
    alpha: Tensor
    alpha_hat: Tensor


def get_coeffs(cfg: Config, device=None) -> Coeffs:
    """Noise schedule: cosine with the reference's x0.2 beta scaling
    (``cfg.cos`` is forced on by ``Config.finalize``), in float32."""
    T = cfg.diffusion_steps
    if cfg.cos:
        t = torch.linspace(0.0, 1.0, T + 1, device=device)
        alpha_bar = torch.cos((t + 0.008) / 1.008 * torch.pi / 2) ** 2
        beta = torch.clamp(1 - alpha_bar[1:] / alpha_bar[:-1], 0, 0.999) * 0.2
    else:
        beta = torch.linspace(cfg.beta_start, cfg.beta_end, T, device=device)
    alpha = 1.0 - beta
    return Coeffs(beta, alpha, torch.cumprod(alpha, dim=0))


def denormalize_controls(x: Tensor, cfg: Config,
                         clip: Optional[bool] = None) -> Tensor:
    """Diffusion space -> physical controls.  x: (n, nt*2) or (n, nt, 2)."""
    if clip is None:
        clip = cfg.diffusion_clip
    x = x.reshape(x.shape[0], cfg.nt, 2)
    w = x[..., 0] * cfg.mul_w_max
    a = x[..., 1] * cfg.mul_a_max
    if clip:
        w = torch.clamp(w, -cfg.mul_w_max, cfg.mul_w_max)
        a = torch.clamp(a, -cfg.mul_a_max, cfg.mul_a_max)
    return torch.stack([w, a], dim=-1)


def _trigger_schedule(cfg: Config) -> np.ndarray:
    """Static guidance triggers; entry j is denoise step i = T-1-j."""
    T = cfg.diffusion_steps
    trig = np.zeros(T - 1, dtype=bool)
    if cfg.guidance:
        for j, i in enumerate(range(T - 1, 0, -1)):
            i_val = (T - 1 - i) if cfg.guidance_reverse else i
            if cfg.guidance_sets is not None:
                trig[j] = i_val in cfg.guidance_sets
            elif cfg.guidance_freq is not None:
                trig[j] = (i_val % cfg.guidance_freq) == 0
            else:
                trig[j] = i <= cfg.guidance_before
    return trig


def check_supported(cfg: Config) -> None:
    """Raise for sampler configurations the port does not run yet."""
    if cfg.sampler != "ddpm":
        raise NotImplementedError(f"sampler={cfg.sampler!r}: only the DDPM "
                                  "sampler is ported")
    if not cfg.cm_sampler:
        raise NotImplementedError("cm_sampler=False (the row-major sampler) "
                                  "is not ported")
    if cfg.guidance:
        if not (cfg.guidance_pallas and cfg.guidance_pallas_fuse_freeze):
            raise NotImplementedError(
                "guidance runs through the fused guidance kernel only: set "
                "guidance_pallas_fuse_freeze=True (the frozen-payload and "
                "XLA-loop guidance paths are not ported)")
        if cfg.guidance_pallas_fold:
            raise NotImplementedError(
                "guidance_pallas_fold (the scene-folded kernels) is not "
                "ported")


def _guidance_step(mu_cm: Tensor, beta_t: Tensor, fused_loss, cfg: Config,
                   maximize: bool) -> Tensor:
    """One guided update of the candidate-minor posterior mean: the fused
    freeze + Adam + trust-region-clip kernel (no gradient flows out)."""
    thres = 100.0 if maximize else cfg.stl_nn_thres
    with torch.no_grad():
        return guidance_kernel.guidance_adam_cm(fused_loss, mu_cm, beta_t,
                                                thres, cfg)


def reverse_sample(cm_fn: Callable, fused_loss, cfg: Config, coeffs: Coeffs,
                   maximize: bool = False, noise: Optional[Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """Full reverse DDPM in candidate-minor (bs, nt, 2, R) layout.

    cm_fn(x_cm, t) -> epsilon; ``fused_loss`` is the scene batch's
    ``CandMinorGuidanceLoss`` (layout and guidance operands).  ``noise``
    (T, bs, nt, 2, R) pins x0 and the per-step draws; otherwise they come
    from ``generator`` on the device.  Returns (controls (n, nt, 2),
    all_steps (T, n, nt, 2)) with all_steps the denormalized decodings
    [x0, x_1, ..., x_{T-1}] (``diff_full``; only the last step otherwise).
    """
    check_supported(cfg)
    T = cfg.diffusion_steps
    trig = _trigger_schedule(cfg)
    bs, R = fused_loss.bs, fused_loss.R
    shape = (bs, cfg.nt, 2, R)
    dev = fused_loss.valid_r.device
    if noise is not None and tuple(noise.shape) != (T,) + shape:
        raise ValueError(f"noise must be {(T,) + shape}, got "
                         f"{tuple(noise.shape)}")
    draw = (lambda j: noise[j]) if noise is not None else (
        lambda j: torch.randn(shape, generator=generator, device=dev))
    if (cfg.guidance_pallas_superstep and trig.any()
            and hasattr(cm_fn, "operands")):
        return _reverse_superstep(cm_fn, fused_loss, cfg, coeffs, trig,
                                  maximize, draw)
    x = draw(0)
    hist = [x]
    for j, t in enumerate(range(T - 1, 0, -1)):
        eps = cm_fn(x, t)
        alpha, alpha_hat, beta = (coeffs.alpha[t], coeffs.alpha_hat[t],
                                  coeffs.beta[t])
        mu = (x - ((1 - alpha) / torch.sqrt(1 - alpha_hat)) * eps) \
            / torch.sqrt(alpha)
        if trig[j]:
            mu = _guidance_step(mu, beta, fused_loss, cfg, maximize)
        z = draw(j + 1)
        if t <= 1:
            z = torch.zeros_like(z)
        x = mu + cfg.sample_noise_scale * torch.sqrt(beta) * z
        if cfg.diff_full:
            hist.append(x)
    return _decodings(x, hist, fused_loss, cfg)


def _reverse_superstep(cm_fn: Callable, fused_loss, cfg: Config,
                       coeffs: Coeffs, trig: np.ndarray, maximize: bool,
                       draw: Callable):
    """The reverse pass as one superstep launch per denoise step (eps MLP,
    posterior, guidance when ``trig`` says so, noise), the port of
    ``pstl_tpu/diffusion.py:_reverse_superstep``.  Every draw is made
    before the loop, in ``reverse_sample``'s order and shapes (x0, then one
    per step, the last one zeroed: t = 1), and so are the per-step tables;
    the loop body is the launch and the history append only."""
    T = cfg.diffusion_steps
    x = draw(0)
    z_all = torch.stack([draw(j + 1) for j in range(T - 1)])
    z_all[-1].zero_()                      # the last step (t = 1) adds none
    gops = guidance_kernel.kernel_operands(fused_loss, cfg)
    p = guidance_kernel.kernel_params(cfg, fused_loss)
    mlp = superstep_kernel.mlp_operands(cm_fn.operands)
    te_all, gvec_all = superstep_kernel.step_tables(
        cfg, coeffs, cm_fn.operands, gops.gscale, maximize)
    hist = [x]
    for j in range(T - 1):
        x = superstep_kernel.superstep(x, z_all[j], te_all[j], gvec_all[j],
                                       mlp, gops, p, bool(trig[j]))
        if cfg.diff_full:
            hist.append(x)
    return _decodings(x, hist, fused_loss, cfg)


def _decodings(x: Tensor, hist, fused_loss, cfg: Config):
    """(controls (n, nt, 2), all_steps) from the last sample and the
    history (see ``reverse_sample``)."""
    conv = fused_loss._from_cand_minor
    if not cfg.diff_full:
        final = denormalize_controls(conv(x), cfg)
        return final, final[None]
    full = torch.stack(hist)                               # (T, bs,nt,2,R)
    all_steps = torch.stack([denormalize_controls(conv(v), cfg)
                             for v in full])
    return all_steps[-1], all_steps


def select_multi_cands(all_steps: Tensor, k: int, states_flat: Tensor,
                       score_rows: Callable, cfg: Config):
    """Score the last k decodings and take the per-row argmax (earliest on
    ties).  all_steps: (S, n, nt, 2) -> (best (n, nt, 2), best_scores (n,))."""
    cands = all_steps[-k:]
    scores = torch.stack([score_rows(dyn.rollout(states_flat, u, cfg.dt)
                                     [:, :-1]) for u in cands])  # (k, n)
    best_i = torch.argmax(scores, dim=0)
    best_scores = torch.amax(scores, dim=0)
    best = torch.gather(cands, 0, best_i[None, :, None, None].expand(
        1, *cands.shape[1:]))[0]
    return best, best_scores
