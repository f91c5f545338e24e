"""DDPM reverse sampler with STL guidance (port of the DDPM path of
``pstl_tpu/diffusion.py``).

When any denoise step is guided, the reverse loop runs in candidate-minor
(bs, nt, 2, R) layout and each guided step is :func:`_guidance_step`: under
``guidance_pallas`` one launch of a guidance kernel
(``ops/guidance_kernel.py``: ``guidance_fused`` freezes the selections
in-kernel, ``guidance_frozen`` reads those ``freeze_cm`` froze), otherwise
the XLA guidance loop (Adam on autograd gradients of the guidance loss, in
plain torch ops, as the JAX package computes it outside any kernel).
``guidance_sel_every > 1`` carries the frozen selections across denoise
steps.  When no step is guided, the loop runs row-major on (n, nt*2) with
eps from the network's diffusion forward, as the JAX package does.

The loop is a Python loop over the T-1 denoise steps; the trigger and
refresh schedules are static, so it makes no host synchronisation of its
own.  Noise is injectable for parity tests: a (T, *shape) tensor holds x0
and then one draw per step, with shape (bs, nt, 2, R) on the
candidate-minor path and (n, nt*2) on the row-major one.

Under ``guidance_pallas_superstep`` the loop is :func:`_reverse_superstep`
instead: one launch of the superstep kernel (``ops/superstep_kernel.py``:
eps MLP, posterior, guidance, noise) per denoise step.

For training, :func:`prep` noises controls and :func:`sample` runs the
unguided row-major pass, on the per-scene (mono) rows or on the dense
multi-candidate rows.

Not ported yet: the DDIM and DPM++ samplers, and guidance on the row-major
path (``cm_sampler=False`` or the row-major guidance loss), which is also
what a guided training sampler would take.
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


def normalize_controls(controls: Tensor, cfg: Config) -> Tensor:
    """Physical controls -> normalized diffusion space."""
    return torch.stack([controls[..., 0] / cfg.mul_w_max,
                        controls[..., 1] / cfg.mul_a_max], dim=-1)


def prep(dense_controls: Tensor, cfg: Config, coeffs: Coeffs,
         n_randoms: Optional[int] = None, mono: bool = False,
         noise: Optional[Tensor] = None, t: Optional[Tensor] = None,
         generator: Optional[torch.Generator] = None):
    """Forward noising for training (``pstl_tpu/diffusion.py:prep``).

    dense_controls: (bs, M, 3, nt, 2) physical controls, or (bs, nt, 2) GT
    controls when ``mono`` (each repeated n_randoms times).  ``noise``
    (n, nt*2) and ``t`` (n,) integer steps in [1, diffusion_steps) are the
    draws; those not given come from ``generator`` on the controls' device.
    Returns (noise (n, nt*2), t (n, 1), x_t (n, nt*2))."""
    if n_randoms is None:
        n_randoms = cfg.n_randoms
    if mono:
        n = dense_controls.shape[0] * n_randoms
        cmd = torch.repeat_interleave(dense_controls, n_randoms, 0)
    else:
        n = dense_controls.shape[0] * n_randoms * 3
        cmd = dense_controls
    cmd = normalize_controls(cmd.reshape(n, cfg.nt, 2),
                             cfg).reshape(n, cfg.nt * 2)
    dev = dense_controls.device
    if noise is None:
        noise = torch.randn((n, cfg.nt * 2), generator=generator, device=dev)
    if t is None:
        t = torch.randint(1, cfg.diffusion_steps, (n,), generator=generator,
                          device=dev)
    sa = torch.sqrt(coeffs.alpha_hat[t])[:, None]
    sb = torch.sqrt(1 - coeffs.alpha_hat[t])[:, None]
    return noise, t[:, None], sa * cmd + sb * noise


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
    if cfg.guidance:
        if not cfg.cm_sampler:
            raise NotImplementedError("guidance with cm_sampler=False (the "
                                      "row-major guided sampler) is not "
                                      "ported")
        if not (cfg.guidance_fused_loss and cfg.tiled_scorer):
            raise NotImplementedError(
                "the row-major guidance loss (guidance_fused_loss=False) is "
                "not ported; guidance runs on the candidate-minor loss only")
        if cfg.robustness_dtype != "float32":
            raise NotImplementedError(
                "robustness_dtype=bfloat16 (bf16 robustness in the XLA "
                "guidance loop) is not ported")


def _refresh_schedule(trig: np.ndarray, k: int) -> np.ndarray:
    """Static refresh mask for ``guidance_sel_every=k``: True on the 1st,
    (k+1)-th, ... GUIDED step (counting only steps where ``trig`` is True),
    where the frozen selections are recomputed; reused in between."""
    refresh = np.zeros_like(trig)
    cnt = 0
    for j in range(len(trig)):
        if trig[j]:
            refresh[j] = (cnt % k) == 0
            cnt += 1
    return refresh


def _guidance_step(mu_cm: Tensor, beta_t: Tensor, fused_loss, cfg: Config,
                   maximize: bool, frozen=None) -> Tensor:
    """One guided update of the candidate-minor (bs, T, 2, R) posterior
    mean (``pstl_tpu/diffusion.py:_guidance_step`` with ``cm_io``): Adam on
    the guidance loss, each step followed by the beta_t trust-region clip.
    ``frozen``: the selections (``fused_loss.freeze_cm``) the caller
    carries; with ``guidance_reuse_selection`` they are frozen at ``mu_cm``
    when not given.  No gradient flows out."""
    thres = 100.0 if maximize else cfg.stl_nn_thres
    fuse = cfg.guidance_pallas and cfg.guidance_pallas_fuse_freeze
    with torch.no_grad():
        # the fused kernel freezes in-kernel: pstl_tpu computes freeze_cm
        # here too, but nothing reads it
        if frozen is None and cfg.guidance_reuse_selection and not fuse:
            frozen = fused_loss.freeze_cm(mu_cm)
        if cfg.guidance_pallas:
            return guidance_kernel.guidance_adam_cm(
                fused_loss, frozen, mu_cm, beta_t, thres, cfg,
                fuse_freeze=cfg.guidance_pallas_fuse_freeze)

    # the XLA guidance loop: frozen=None re-selects in every iteration
    lr, b1, b2, eps = cfg.guidance_lr, 0.9, 0.999, 1e-8
    mu_opt = mu_cm
    m = torch.zeros_like(mu_cm)
    v = torch.zeros_like(mu_cm)
    for it in range(cfg.guidance_niters):
        with torch.enable_grad():
            x = mu_opt.detach().requires_grad_(True)
            g, = torch.autograd.grad(
                fused_loss.loss_cm(x, thres, frozen=frozen), x)
        with torch.no_grad():
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh = m / (1 - b1 ** (it + 1))
            vh = v / (1 - b2 ** (it + 1))
            mu_opt = mu_opt - lr * mh / (torch.sqrt(vh) + eps)
            if cfg.guidance_positive_offset_quirk:
                delta = torch.minimum(torch.abs(mu_opt - mu_cm), beta_t)
            else:
                delta = torch.maximum(torch.minimum(mu_opt - mu_cm, beta_t),
                                      -beta_t)
            mu_opt = mu_cm + delta
    return mu_opt


def reverse_sample(cm_fn: Optional[Callable], fused_loss, cfg: Config,
                   coeffs: Coeffs, maximize: bool = False,
                   noise: Optional[Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   eps_fn: Optional[Callable] = None,
                   n: Optional[int] = None):
    """Full reverse DDPM (``pstl_tpu/diffusion.py:reverse_sample``).

    When ``fused_loss`` (the scene batch's ``CandMinorGuidanceLoss``) is
    given and any denoise step is guided: candidate-minor (bs, nt, 2, R)
    layout with cm_fn(x_cm, t) -> epsilon.  Otherwise row-major (n, nt*2)
    with eps_fn(x, t) -> epsilon (n, nt*2), the network's diffusion forward.
    ``noise`` (T, *layout) pins x0 and the per-step draws; otherwise they
    come from ``generator`` on the coefficients' device.  Returns (controls
    (n, nt, 2), all_steps (T, n, nt, 2)) with all_steps the denormalized
    decodings [x0, x_1, ..., x_{T-1}] (``diff_full``; only the last step
    otherwise).
    """
    check_supported(cfg)
    T = cfg.diffusion_steps
    trig = _trigger_schedule(cfg)
    use_guidance = fused_loss is not None and bool(trig.any())
    if use_guidance:
        if cm_fn is None:
            raise ValueError("guided sampling runs candidate-minor: pass "
                             "cm_fn")
        shape = (fused_loss.bs, cfg.nt, 2, fused_loss.R)
    else:
        if eps_fn is None or n is None:
            raise ValueError("the unguided (row-major) pass needs eps_fn "
                             "and n")
        shape = (n, cfg.nt * 2)
    dev = coeffs.beta.device
    if noise is not None and tuple(noise.shape) != (T,) + shape:
        raise ValueError(f"noise must be {(T,) + shape}, got "
                         f"{tuple(noise.shape)}")
    draw = (lambda j: noise[j]) if noise is not None else (
        lambda j: torch.randn(shape, generator=generator, device=dev))
    if (use_guidance and cfg.guidance_pallas_superstep
            and hasattr(cm_fn, "operands")):
        return _reverse_superstep(cm_fn, fused_loss, cfg, coeffs, trig,
                                  maximize, draw)
    # guidance_sel_every > 1: the frozen selections ride across denoise
    # steps, refreshed on every k-th guided step (the first guided step
    # always refreshes, so nothing stale is read)
    carry_sel = (use_guidance and cfg.guidance_reuse_selection
                 and cfg.guidance_sel_every > 1)
    refresh = _refresh_schedule(trig, cfg.guidance_sel_every) \
        if carry_sel else None
    frozen = None
    eps_of = cm_fn if use_guidance else eps_fn
    x = draw(0)
    hist = [x]
    for j, t in enumerate(range(T - 1, 0, -1)):
        eps = eps_of(x, t)
        alpha, alpha_hat, beta = (coeffs.alpha[t], coeffs.alpha_hat[t],
                                  coeffs.beta[t])
        mu = (x - ((1 - alpha) / torch.sqrt(1 - alpha_hat)) * eps) \
            / torch.sqrt(alpha)
        if use_guidance and trig[j]:
            if carry_sel and refresh[j]:
                with torch.no_grad():
                    frozen = fused_loss.freeze_cm(mu)
            mu = _guidance_step(mu, beta, fused_loss, cfg, maximize,
                                frozen=frozen)
        z = draw(j + 1)
        if t <= 1:
            z = torch.zeros_like(z)
        x = mu + cfg.sample_noise_scale * torch.sqrt(beta) * z
        if cfg.diff_full:
            hist.append(x)
    conv = fused_loss._from_cand_minor if use_guidance else (lambda v: v)
    return _decodings(x, hist, conv, cfg)


def sample(apply_fn: Callable, highlevel: Tensor, cfg: Config,
           coeffs: Coeffs, n: int, mono: bool = False,
           tmp_stlp: Optional[Tensor] = None,
           noise: Optional[Tensor] = None,
           generator: Optional[torch.Generator] = None,
           stlp_dense: Optional[Tensor] = None):
    """The unguided row-major DDPM pass with eps from the network
    (``pstl_tpu/diffusion.py:sample`` without guidance): ``apply_fn(ext)``
    is the network's diffusion forward on ext = {timestep (n, 1),
    highlevel, noise (n, nt*2), stlp [, gt_stlp]}.  With ``mono`` the ext
    carries ``tmp_stlp`` as both ``stlp`` and ``gt_stlp`` (the per-scene
    pSTL parameters); otherwise the n dense rows' ``stlp_dense`` as
    ``stlp``.  ``noise`` / ``generator`` as in :func:`reverse_sample`.
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

    return reverse_sample(None, None, cfg, coeffs, noise=noise,
                          generator=generator, eps_fn=eps_fn, n=n)


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
    return _decodings(x, hist, fused_loss._from_cand_minor, cfg)


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
