"""Reverse samplers with STL guidance (port of ``pstl_tpu/diffusion.py``):
the DDPM chain, DDIM and DPM-Solver++(2M), and the guidance step they share.

:func:`sample` dispatches on ``cfg.sampler`` as the JAX package's does:
"ddim" to :func:`reverse_sample_ddim`, "dpmpp" to
:func:`reverse_sample_dpmpp`, anything else to the DDPM
:func:`reverse_sample`.  The guidance context (:func:`make_guidance_ctx`)
carries the per-row robustness function, the validity mask, the dense
initial states and, optionally, the candidate-minor fused loss
(``CandMinorGuidanceLoss``).

When a denoise step of the DDPM chain is guided and the caller passes
``cm_fn`` (``cm_sampler`` with the fused loss), the chain runs in
candidate-minor (bs, nt, 2, R) layout.  Otherwise it runs row-major on
(n, nt*2) with eps from the network's diffusion forward; the fast samplers
always do.  A guided step is :func:`_guidance_step`: with the fused loss,
under ``guidance_pallas`` one launch of a guidance kernel
(``ops/guidance_kernel.py``: ``guidance_fused`` freezes the selections
in-kernel, ``guidance_frozen`` reads those ``freeze_cm`` froze), otherwise
the XLA guidance loop (Adam on autograd gradients of the guidance loss, in
plain torch ops, as the JAX package computes it outside any kernel); a
row-major mean is turned candidate-minor around it.  Without the fused loss
the XLA loop runs on the row-major fallback loss: rollout of the
denormalized mean, ``score_rows`` and the hinge.  ``guidance_sel_every > 1``
carries the frozen selections across DDPM denoise steps.  The fast samplers
guide every step and re-freeze each time, as in the JAX package.

The loops are Python loops over static schedules, so they make no host
synchronisation of their own.  Noise is injectable for parity tests: a
(:func:`n_draws`, *shape) tensor holds x0 and then the per-step draws --
DDPM T (x0, one a denoise step, the last zeroed), DDIM S + 1 (x0, one a
step, the last multiplied by 0), DPM++ 1 (x0 only) -- with shape
(bs, nt, 2, R) on the candidate-minor path and (n, nt*2) on the row-major
ones (:func:`draw_layout`).

Under ``guidance_pallas_superstep`` the DDPM loop is
:func:`_reverse_superstep` instead: one launch of the superstep kernel
(``ops/superstep_kernel.py``: eps MLP, posterior, guidance, noise) per
denoise step.

For training, :func:`prep` noises controls and :func:`sample` runs the
pass on the per-scene (mono) rows or on the dense multi-candidate rows,
guided by the row-major fallback loss where the configuration guides.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pstl_tpu_torch.config import Config
from pstl_tpu_torch.ops import dynamics as dyn
from pstl_tpu_torch.ops import guidance_kernel, superstep_kernel
from pstl_tpu_torch.ops.guidance_loss import row_loss
from pstl_tpu_torch.parallel import mesh
from pstl_tpu_torch.utils.trace import span

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
    # under a data sharding (parallel.mesh) the draws are the whole batch's,
    # of which this rank keeps its rows
    if noise is None:
        noise = mesh.draw(lambda s: torch.randn(s, generator=generator,
                                                device=dev), (n, cfg.nt * 2))
    else:
        noise = mesh.local_part(noise)
    if t is None:
        t = mesh.draw(lambda s: torch.randint(
            1, cfg.diffusion_steps, s, generator=generator, device=dev), (n,))
    else:
        t = mesh.local_part(t)
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


#: the fast samplers of ``cfg.sampler``; any other name runs the DDPM chain
FAST_SAMPLERS = ("ddim", "dpmpp")


def _fast_taus(cfg: Config) -> np.ndarray:
    """Timestep subsequence of the fast samplers (ddim / dpm++), as
    ``pstl_tpu/diffusion.py:_fast_taus`` places it: uniform over [1, T-1]
    by default; with ``fast_guided_focus > 0`` and a band (the banded
    trigger's ``guidance_before``, or ``fast_focus_band``) a ``focus``
    fraction of the S evaluations inside [1, band] and the rest uniformly
    above it, repaired to strictly decreasing."""
    T = cfg.diffusion_steps
    S = min(cfg.ddim_steps, T - 1)
    focus = cfg.fast_guided_focus
    banded = (cfg.guidance and cfg.guidance_sets is None
              and cfg.guidance_freq is None and not cfg.guidance_reverse
              and 0 < cfg.guidance_before < T - 1)
    gb = cfg.fast_focus_band or (cfg.guidance_before if banded else 0)
    if focus <= 0.0 or not 0 < gb < T - 1:
        return np.linspace(T - 1, 1, S).round().astype(np.int32)
    s_lo = int(np.clip(round(S * focus), 1, min(S - 1, gb)))
    s_hi = min(S - s_lo, T - 2 - gb)
    hi = np.linspace(T - 1, gb + 1, s_hi).round()
    lo = np.linspace(gb, 1, s_lo).round()
    taus = np.concatenate([hi, lo]).astype(np.int32)
    # rounding can collide neighbors inside a dense band
    for i in range(1, len(taus)):
        taus[i] = min(taus[i], taus[i - 1] - 1)
    return np.maximum(taus, 1)


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
    if cfg.sampler == "ddim":
        return len(_fast_taus(cfg)) + 1
    if cfg.sampler == "dpmpp":
        return 1
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


def _guidance_step(mu: Tensor, beta_t: Tensor, guide, cfg: Config,
                   maximize: bool, frozen=None,
                   mu_cm: Optional[Tensor] = None) -> Tensor:
    """One guided update of the posterior mean
    (``pstl_tpu/diffusion.py:_guidance_step``): Adam on the guidance loss,
    each step followed by the beta_t trust-region clip.  ``mu`` is
    candidate-minor (bs, T, 2, R) -- the result is too -- or row-major
    (n, nt*2).  With the context's fused loss a row-major ``mu`` is turned
    candidate-minor (or ``mu_cm``, the caller's view of it, is used) for
    the kernel or the XLA loop and back; without it the XLA loop runs on
    the row-major fallback loss.  ``frozen``: the selections
    (``fused_loss.freeze_cm``) the caller carries; with
    ``guidance_reuse_selection`` they are frozen at the candidate-minor
    mean when not given.  No gradient flows out."""
    with span("plan.guidance"):
        ctx = _as_ctx(guide)
        thres = 100.0 if maximize else cfg.stl_nn_thres
        fused_loss = ctx.fused_loss
        if fused_loss is None:
            if cfg.guidance_pallas:
                raise ValueError(
                    "guidance_pallas needs the candidate-minor fused loss "
                    "-- set guidance_fused_loss=True (Config.finalize "
                    "couples this automatically)")

            def loss_fn(mu_flat):
                u = denormalize_controls(mu_flat, cfg, clip=False)
                trajs = dyn.rollout(ctx.states_flat, u, cfg.dt)
                scores = ctx.score_rows(trajs[:, :-1])
                return row_loss(torch.relu(thres - scores), ctx.valid)

            return _adam_loop(mu.detach(), beta_t, loss_fn, cfg)

        cm_io = mu.dim() == 4
        if cm_io:
            mu_init = mu
        else:
            mu_init = mu_cm if mu_cm is not None \
                else fused_loss._to_cand_minor(mu)
        post = (lambda x: x) if cm_io else fused_loss._from_cand_minor
        fuse = cfg.guidance_pallas and cfg.guidance_pallas_fuse_freeze
        with torch.no_grad():
            # the fused kernel freezes in-kernel: pstl_tpu computes
            # freeze_cm here too, but nothing reads it
            if frozen is None and cfg.guidance_reuse_selection and not fuse:
                frozen = fused_loss.freeze_cm(mu_init)
            if cfg.guidance_pallas:
                return post(guidance_kernel.guidance_adam_cm(
                    fused_loss, frozen, mu_init, beta_t, thres, cfg,
                    fuse_freeze=cfg.guidance_pallas_fuse_freeze))
        # the XLA guidance loop: frozen=None re-selects in every iteration
        return post(_adam_loop(
            mu_init.detach(), beta_t,
            lambda x: fused_loss.loss_cm(x, thres, frozen=frozen), cfg))


def _adam_loop(mu0: Tensor, beta_t: Tensor, loss_fn: Callable,
               cfg: Config) -> Tensor:
    """The XLA guidance loop: ``guidance_niters`` Adam steps on autograd
    gradients of ``loss_fn`` from ``mu0``, each followed by the trust-region
    clip around ``mu0`` (the always-positive offset under
    ``guidance_positive_offset_quirk``)."""
    lr, b1, b2, eps = cfg.guidance_lr, 0.9, 0.999, 1e-8
    mu_opt = mu0
    m = torch.zeros_like(mu0)
    v = torch.zeros_like(mu0)
    for it in range(cfg.guidance_niters):
        with torch.enable_grad():
            x = mu_opt.detach().requires_grad_(True)
            g, = torch.autograd.grad(loss_fn(x), x)
        with torch.no_grad():
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh = m / (1 - b1 ** (it + 1))
            vh = v / (1 - b2 ** (it + 1))
            mu_opt = mu_opt - lr * mh / (torch.sqrt(vh) + eps)
            if cfg.guidance_positive_offset_quirk:
                delta = torch.minimum(torch.abs(mu_opt - mu0), beta_t)
            else:
                delta = torch.maximum(torch.minimum(mu_opt - mu0, beta_t),
                                      -beta_t)
            mu_opt = mu0 + delta
    return mu_opt


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
    if (use_cm and cfg.guidance_pallas_superstep
            and hasattr(cm_fn, "operands")):
        return _reverse_superstep(cm_fn, fused_loss, cfg, coeffs, trig,
                                  maximize, draw)
    # guidance_sel_every > 1: the frozen selections ride across denoise
    # steps, refreshed on every k-th guided step (the first guided step
    # always refreshes, so nothing stale is read)
    carry_sel = (use_guidance and cfg.guidance_reuse_selection
                 and fused_loss is not None and cfg.guidance_sel_every > 1)
    refresh = _refresh_schedule(trig, cfg.guidance_sel_every) \
        if carry_sel else None
    frozen = None
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
            m_cm = None
            if carry_sel:
                # the m-major chain freezes its candidate-minor view, which
                # the guidance step then reuses
                m_cm = mu if use_cm else fused_loss._to_cand_minor(mu)
                if refresh[j]:
                    with torch.no_grad():
                        frozen = fused_loss.freeze_cm(m_cm)
            mu = _guidance_step(mu, beta, ctx, cfg, maximize, frozen=frozen,
                                mu_cm=None if use_cm else m_cm)
        z = draw(j + 1)
        if t <= 1:
            z = torch.zeros_like(z)
        x = mu + cfg.sample_noise_scale * torch.sqrt(beta) * z
        if cfg.diff_full:
            hist.append(x)
    conv = fused_loss._from_cand_minor if use_cm else (lambda v: v)
    return _decodings(x, hist, conv, cfg)


def reverse_sample_ddim(eps_fn: Callable, guide, cfg: Config,
                        coeffs: Coeffs, n: int, maximize: bool = False,
                        noise: Optional[Tensor] = None,
                        generator: Optional[torch.Generator] = None):
    """DDIM over the ``_fast_taus`` subsequence
    (``pstl_tpu/diffusion.py:reverse_sample_ddim``), row-major (n, nt*2)
    with eps_fn(x, t) -> epsilon.  With a guidance context every step's
    pre-noise mean is guided (:func:`_guidance_step`; the trigger schedule
    only places the taus).  ``noise`` (S + 1, n, nt*2): x0, then one draw a
    step, the last multiplied by 0 (t_next = 0).  Returns (controls,
    all_steps) with all_steps [x0, S steps] (``diff_full``)."""
    check_supported(cfg)
    ctx = _as_ctx(guide)
    taus = [int(t) for t in _fast_taus(cfg)]
    taus_next = taus[1:] + [0]
    use_guidance = ctx is not None and cfg.guidance
    shape = (n, cfg.nt * 2)
    draw = _drawer(noise, len(taus) + 1, shape, generator,
                   coeffs.beta.device)
    eta = cfg.ddim_eta
    one = torch.ones((), device=coeffs.beta.device)
    x = draw(0)
    hist = [x]
    for j, (t, t_next) in enumerate(zip(taus, taus_next)):
        eps = eps_fn(x, t)
        ab_t = coeffs.alpha_hat[t]
        ab_n = coeffs.alpha_hat[t_next] if t_next > 0 else one
        x0_hat = (x - torch.sqrt(1 - ab_t) * eps) / torch.sqrt(ab_t)
        sigma = (eta * torch.sqrt((1 - ab_n) / (1 - ab_t))
                 * torch.sqrt(1 - ab_t / ab_n))
        dir_coef = torch.sqrt(torch.clamp(1 - ab_n - sigma ** 2, min=0.0))
        mu = torch.sqrt(ab_n) * x0_hat + dir_coef * eps
        if use_guidance:
            mu = _guidance_step(mu, coeffs.beta[t], ctx, cfg, maximize)
        z = draw(j + 1)
        if t_next <= 0:
            z = torch.zeros_like(z)
        x = mu + cfg.sample_noise_scale * sigma * z
        if cfg.diff_full:
            hist.append(x)
    return _decodings(x, hist, lambda v: v, cfg)


def reverse_sample_dpmpp(eps_fn: Callable, guide, cfg: Config,
                         coeffs: Coeffs, n: int, maximize: bool = False,
                         noise: Optional[Tensor] = None,
                         generator: Optional[torch.Generator] = None):
    """DPM-Solver++(2M) over the ``_fast_taus`` subsequence
    (``pstl_tpu/diffusion.py:reverse_sample_dpmpp``): data-prediction
    updates in half log-SNR time, first order on the first step, the 2M
    correction after; deterministic, guided on every step with a guidance
    context.  ``noise`` (1, n, nt*2) is x0.  Returns (controls, all_steps)
    with all_steps [x0, S-1 steps, the final decode at tau_min]."""
    check_supported(cfg)
    ctx = _as_ctx(guide)
    taus = [int(t) for t in _fast_taus(cfg)]
    use_guidance = ctx is not None and cfg.guidance
    draw = _drawer(noise, 1, (n, cfg.nt * 2), generator, coeffs.beta.device)
    ab = coeffs.alpha_hat
    alpha_t = torch.sqrt(ab)
    sigma_t = torch.sqrt(1.0 - ab)
    lam = torch.log(alpha_t) - torch.log(sigma_t)       # half log-SNR

    def x0_pred(x, t):
        return (x - sigma_t[t] * eps_fn(x, t)) / alpha_t[t]

    x = draw(0)
    hist = [x]
    d_prev = torch.zeros_like(x)
    h_prev = torch.ones((), device=x.device)
    for j, (t_prev, t) in enumerate(zip(taus[:-1], taus[1:])):
        d = x0_pred(x, t_prev)
        h = lam[t] - lam[t_prev]
        if j == 0:
            d_used = d            # first step: the first-order update
        else:
            r = h_prev / torch.where(h == 0, torch.ones_like(h), h)
            c = 1 / (2 * torch.clamp(r, min=1e-6))
            d_used = (1 + c) * d - c * d_prev
        x = sigma_t[t] / sigma_t[t_prev] * x \
            - alpha_t[t] * torch.expm1(-h) * d_used
        if use_guidance:
            x = _guidance_step(x, coeffs.beta[t], ctx, cfg, maximize)
        d_prev, h_prev = d, h
        if cfg.diff_full:
            hist.append(x)
    x_final = x0_pred(x, taus[-1])
    if cfg.diff_full:
        hist.append(x_final)
    return _decodings(x_final, hist, lambda v: v, cfg)


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

    with span("plan.sample"):
        if cfg.sampler == "ddim":
            return reverse_sample_ddim(eps_fn, guide, cfg, coeffs, n,
                                       maximize, noise, generator)
        if cfg.sampler == "dpmpp":
            return reverse_sample_dpmpp(eps_fn, guide, cfg, coeffs, n,
                                        maximize, noise, generator)
        return reverse_sample(cm_fn, guide, cfg, coeffs, maximize=maximize,
                              noise=noise, generator=generator,
                              eps_fn=eps_fn, n=n)


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
