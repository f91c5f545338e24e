"""A frozen copy of ``pstl_tpu_torch/diffusion.py`` of the PyTorch port, kept as the benchmark's plain
reference: every kernel dispatch runs the plain version.  Do not edit to
follow the program."""


from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from perfbench.reference.port.config import HELD, Config
from perfbench.reference.port.ops import dynamics as dyn
from perfbench.reference.port.ops import guidance_kernel
from perfbench.reference.port.parallel import mesh

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


#: the fast samplers of ``cfg.sampler``; any other name runs the DDPM chain
FAST_SAMPLERS = ("ddim", "dpmpp")


class GuidanceCtx(NamedTuple):
    """What the in-sampler guidance reads (``make_guidance_ctx``)."""
    score_rows: Optional[Callable]
    valid: Optional[Tensor]
    states_flat: Optional[Tensor]
    fused_loss: Optional[object] = None


def make_guidance_ctx(score_rows: Optional[Callable], valid: Optional[Tensor],
                      states_flat: Optional[Tensor],
                      fused_loss=None) -> GuidanceCtx:
    """The guidance context (``pstl_tpu/diffusion.py:make_guidance_ctx``): a
    per-row robustness function (``specs.make_score_rows``), the validity
    mask (n,), the dense initial states (n, 4) and optionally the
    candidate-minor fused loss (``specs.make_guidance_loss``).  Without the
    fused loss the guidance runs the row-major fallback loss on the first
    three."""
    return GuidanceCtx(score_rows, valid, states_flat, fused_loss)


def _as_ctx(guide) -> Optional[GuidanceCtx]:
    """A sampler's ``guide``: None, a :class:`GuidanceCtx`, or a fused loss
    alone (the candidate-minor path needs nothing else)."""
    if guide is None or isinstance(guide, GuidanceCtx):
        return guide
    return GuidanceCtx(None, None, None, guide)


def n_draws(cfg: Config) -> int:
    """How many draws the configured sampler takes: DDPM T (x0, then one a
    denoise step, the last zeroed), DDIM S + 1 (x0, one a step; the last is
    multiplied by 0), DPM++ 1 (x0)."""
    return cfg.diffusion_steps


def cand_minor_pass(cfg: Config) -> bool:
    """Whether a caller that passes ``cm_fn`` wherever ``cm_sampler`` and the
    fused loss allow (``sim.make_planner``, ``eval_openloop``) gets the
    candidate-minor DDPM chain: a denoise step is guided and the loss is
    the fused one."""
    return (cfg.sampler not in FAST_SAMPLERS and cfg.guidance
            and cfg.cm_sampler and cfg.guidance_fused_loss
            and cfg.tiled_scorer and bool(_trigger_schedule(cfg).any()))


def draw_layout(cfg: Config, bs: int, R: int):
    """One draw's shape for ``bs`` scenes of R candidates each: (bs, nt, 2,
    R) on the candidate-minor chain, else (bs*R, nt*2)."""
    if cand_minor_pass(cfg):
        return (bs, cfg.nt, 2, R)
    return (bs * R, cfg.nt * 2)


def check_supported(cfg: Config) -> None:
    """Raise for sampler configurations the port does not run: the guidance
    kernels compute fp32 robustness, so bf16 robustness runs on the XLA
    loop only (``Config.finalize`` refuses the pair too)."""
    if (cfg.guidance and cfg.guidance_pallas
            and cfg.robustness_dtype != "float32"):
        raise NotImplementedError(
            "robustness_dtype=bfloat16 with guidance_pallas: the guidance "
            "kernels compute fp32 robustness; bf16 runs on the XLA loop "
            "(guidance_pallas=False)")
    if (cfg.sampler != "ddpm" or cfg.guidance_pallas_superstep
            or (cfg.guidance_reuse_selection and cfg.guidance_sel_every > 1)):
        raise NotImplementedError(f"{HELD}: the DDPM sampler, selections "
                                  "refreshed every guided step")


def _guidance_step(mu: Tensor, beta_t: Tensor, guide, cfg: Config,
                   maximize: bool) -> Tensor:
    """One guided update of the candidate-minor (bs, T, 2, R) posterior
    mean (``pstl_tpu/diffusion.py:_guidance_step``): Adam on the fused
    guidance loss, each step followed by the beta_t trust-region clip, by
    kernel 1's plain version (selections frozen in the kernel).  No
    gradient flows out."""
    ctx = _as_ctx(guide)
    thres = 100.0 if maximize else cfg.stl_nn_thres
    if (ctx.fused_loss is None or mu.dim() != 4 or not cfg.guidance_pallas
            or not cfg.guidance_pallas_fuse_freeze):
        raise NotImplementedError(f"{HELD}: guidance by kernel 1")
    with torch.no_grad():
        return guidance_kernel.guidance_adam_cm(ctx.fused_loss, mu, beta_t,
                                                thres, cfg)


def _drawer(noise: Optional[Tensor], count: int, shape, generator, dev):
    """draw(j) -> the j-th of ``count`` draws of ``shape``: ``noise[j]`` when
    pinned (checked against (count, *shape)), else a fresh normal draw.
    Under a sharding (``parallel.mesh``) ``shape`` is this rank's part: the
    draw (and a pinned ``noise``) is the whole one, of which the rank keeps
    its scenes and candidates (``constrain_candidates``; the candidate axis
    is the last of a (bs, nt, 2, R) draw, else the dense rows)."""
    cm = len(shape) == 4
    part = ((lambda x: mesh.constrain_candidates(x, -1, batch_dim=0)) if cm
            else (lambda x: mesh.constrain_candidates(x, 0)))
    if noise is not None:
        whole = (count,) + mesh.whole_shape(shape, 0, -1 if cm else None)
        if tuple(noise.shape) != whole:
            raise ValueError(f"noise must be {whole}, got "
                             f"{tuple(noise.shape)}")
        return lambda j: part(noise[j])
    return lambda j: mesh.draw(
        lambda s: torch.randn(s, generator=generator, device=dev), shape, 0,
        -1 if cm else None)


def reverse_sample(cm_fn: Optional[Callable], guide, cfg: Config,
                   coeffs: Coeffs, maximize: bool = False,
                   noise: Optional[Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   eps_fn: Optional[Callable] = None,
                   n: Optional[int] = None):
    """Full reverse DDPM (``pstl_tpu/diffusion.py:reverse_sample``).

    ``guide``: None, the guidance context (:func:`make_guidance_ctx`) or
    the scene batch's ``CandMinorGuidanceLoss`` alone.  When a denoise step
    is guided, ``cm_fn`` is given and the context has the fused loss: the
    candidate-minor (bs, nt, 2, R) layout with cm_fn(x_cm, t) -> epsilon.
    Otherwise row-major (n, nt*2) with eps_fn(x, t) -> epsilon (n, nt*2),
    the network's diffusion forward, guided (m-major, transposed around
    the fused loss, or on the fallback loss) where the schedule says.
    ``noise`` (T, *layout) pins x0 and the per-step draws; otherwise they
    come from ``generator`` on the coefficients' device.  Returns (controls
    (n, nt, 2), all_steps (T, n, nt, 2)) with all_steps the denormalized
    decodings [x0, x_1, ..., x_{T-1}] (``diff_full``; only the last step
    otherwise).
    """
    check_supported(cfg)
    ctx = _as_ctx(guide)
    T = cfg.diffusion_steps
    trig = _trigger_schedule(cfg)
    use_guidance = ctx is not None and bool(trig.any())
    fused_loss = ctx.fused_loss if ctx is not None else None
    use_cm = cm_fn is not None and fused_loss is not None and use_guidance
    if use_cm:
        shape = (fused_loss.bs, cfg.nt, 2, fused_loss.R)
    else:
        if eps_fn is None or n is None:
            raise ValueError("the row-major pass needs eps_fn and n")
        shape = (n, cfg.nt * 2)
    draw = _drawer(noise, T, shape, generator, coeffs.beta.device)
    eps_of = cm_fn if use_cm else eps_fn
    x = draw(0)
    hist = [x]
    for j, t in enumerate(range(T - 1, 0, -1)):
        eps = eps_of(x, t)
        alpha, alpha_hat, beta = (coeffs.alpha[t], coeffs.alpha_hat[t],
                                  coeffs.beta[t])
        mu = (x - ((1 - alpha) / torch.sqrt(1 - alpha_hat)) * eps) \
            / torch.sqrt(alpha)
        if use_guidance and trig[j]:
            mu = _guidance_step(mu, beta, ctx, cfg, maximize)
        z = draw(j + 1)
        if t <= 1:
            z = torch.zeros_like(z)
        x = mu + cfg.sample_noise_scale * torch.sqrt(beta) * z
        if cfg.diff_full:
            hist.append(x)
    conv = fused_loss._from_cand_minor if use_cm else (lambda v: v)
    return _decodings(x, hist, conv, cfg)


def sample(apply_fn: Callable, highlevel: Tensor, cfg: Config,
           coeffs: Coeffs, n: int, mono: bool = False,
           tmp_stlp: Optional[Tensor] = None,
           noise: Optional[Tensor] = None,
           generator: Optional[torch.Generator] = None,
           stlp_dense: Optional[Tensor] = None, guide=None,
           maximize: bool = False, cm_fn: Optional[Callable] = None):
    """The configured sampler (``pstl_tpu/diffusion.py:sample``) with eps
    from the network: ``apply_fn(ext)`` is the diffusion forward on ext =
    {timestep (n, 1), highlevel, noise (n, nt*2), stlp [, gt_stlp]}.  With
    ``mono`` the ext carries ``tmp_stlp`` as both ``stlp`` and ``gt_stlp``
    (the per-scene pSTL parameters); otherwise the n dense rows'
    ``stlp_dense`` as ``stlp``.  ``guide``, ``maximize``, ``noise`` and
    ``generator`` as in :func:`reverse_sample`; ``cm_fn`` goes to the DDPM
    chain only (the candidate-minor layout is a DDPM-chain optimization).
    Returns (controls (n, nt, 2), all_steps)."""
    if mono:
        extra = {"stlp": tmp_stlp, "gt_stlp": tmp_stlp}
    else:
        if stlp_dense is None:
            raise ValueError("the dense pass needs the rows' stlp_dense")
        extra = {"stlp": stlp_dense}
    dev = coeffs.beta.device

    def eps_fn(x, t):
        ext = {"timestep": torch.full((n, 1), float(t), device=dev),
               "highlevel": highlevel, "noise": x, **extra}
        return apply_fn(ext).reshape(n, cfg.nt * 2)

    return reverse_sample(cm_fn, guide, cfg, coeffs, maximize=maximize,
                          noise=noise, generator=generator, eps_fn=eps_fn,
                          n=n)


def _decodings(x: Tensor, hist, conv: Callable, cfg: Config):
    """(controls (n, nt, 2), all_steps) from the last sample and the
    history (see ``reverse_sample``); ``conv`` maps the loop's layout to
    (n, nt*2)."""
    if not cfg.diff_full:
        final = denormalize_controls(conv(x), cfg)
        return final, final[None]
    full = torch.stack(hist)
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
