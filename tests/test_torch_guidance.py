"""Guidance loss and fused guidance kernel: the torch port against the JAX
package on the CPU.

- ``CandMinorGuidanceLoss``: selections, scores and autograd gradients
  against ``pstl_tpu.ops.guidance_loss`` (exact and coarse pair freeze).
- The kernel's plain version against the XLA frozen-selection Adam loop
  (``freeze_cm`` + ``diffusion._guidance_step``), which the JAX tests hold
  equal to the Pallas kernel (tests/test_pallas_guidance.py).
- The kernel's plain version against the Pallas kernel itself, run in
  interpret mode, with bf16 cumsum and the coarse pair on: the only oracle
  for the bf16 path.
- The torch transcription of the kernel's hand-written VJP
  (tests/torch_guidance_twin.py) against autograd, with what crosses time
  steps as serial loops and as the kernel's warp scans, the latter with the
  kernel's hoisted reciprocals in place of divisions.
- Each warp scan alone (prefix and suffix sums, the doubling ``logaddexp``
  scan of Eventually-Always, the affine-map scan of its backward) against
  its serial form and autograd in float64 to 1e-8, and in float32 against
  ``pallas_guidance._ev_alw`` at that function's own 2e-4.

Tolerances: rtol 2e-4 / atol 2e-5 on guided controls, the tolerance of the
JAX package's own kernel-vs-XLA tests (fp32 sums in another order; the
``_ev_alw`` doubling scan reorders logaddexp sums).  Gradients: rtol 1e-4
with an absolute floor of 1e-5 of the largest entry against JAX; the
hand-written VJP against autograd in float64, to 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff
from pstl_tpu import specs as jspecs
from pstl_tpu.config import Config as JConfig
from pstl_tpu.ops import pallas_guidance
from pstl_tpu_torch import specs as tspecs
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.ops import guidance_kernel as gk

import torch_guidance_twin as twin
from torch_guidance_twin import guidance_fused_twin, score_grad
from torch_parity import guidance_case, np_, to_t

RTOL, ATOL = 2e-4, 2e-5


def _build(seed=0, bs=2, M=4, nt=20, K=3, S=15, **kw):
    flags = dict(diffusion=True, n_randoms=M, n_neighbors=K, nt=nt,
                 n_segs=S, flex=True, guidance=True,
                 guidance_reuse_selection=True, **kw)
    cfg_j = JConfig(**flags).finalize()
    cfg_t = TConfig(**flags).finalize()
    batch, gt_stlp, stlp, states, mu = guidance_case(seed, bs, M, nt, K, S)
    dense_j = jspecs.densify_batch(jax.tree_util.tree_map(jnp.asarray,
                                                          batch),
                                   jnp.asarray(gt_stlp), cfg_j,
                                   stlp_dense=jnp.asarray(stlp))
    valid_j = dense_j["valids_dense"].reshape(-1)
    fj = jspecs.make_guidance_loss(dense_j, dense_j, cfg_j,
                                   jnp.asarray(states), valid_j)
    bt = to_t(batch)
    dense_t = tspecs.densify_batch(bt, torch.as_tensor(gt_stlp), cfg_t,
                                   torch.as_tensor(stlp))
    ft = tspecs.make_guidance_loss(bt, dense_t, cfg_t,
                                   torch.as_tensor(states),
                                   dense_t["valids_dense"].reshape(-1))
    return cfg_j, cfg_t, fj, ft, mu


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np_(a), np_(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("coarse", [False, True])
def test_loss_matches_jax(coarse):
    """Freeze selections, frozen and unfrozen scores, and the autograd
    gradient of loss_cm equal the JAX loss (the kernel's gradient oracle)."""
    cfg_j, cfg_t, fj, ft, mu = _build(seed=3, clearance_coarse_pair=coarse)
    mu_j = fj._to_cand_minor(jnp.asarray(mu))
    mu_t = ft._to_cand_minor(torch.as_tensor(mu))
    _close(mu_t, mu_j, 0, 0)
    frz_j, frz_t = fj.freeze_cm(mu_j), ft.freeze_cm(mu_t)
    for part in ("lane", "clear"):
        for k in frz_j[part]:
            _close(frz_t[part][k], frz_j[part][k], 1e-6, 1e-6)
    _close(ft.scores_r(mu_t), fj.scores_r(mu_j), 1e-5, 1e-5)
    _close(ft.scores_r(mu_t, frozen=frz_t), fj.scores_r(mu_j, frozen=frz_j),
           1e-5, 1e-5)
    g_j = jax.grad(lambda m: fj.loss_cm(m, 100.0, frozen=frz_j))(mu_j)
    m = mu_t.clone().requires_grad_(True)
    g_t, = torch.autograd.grad(ft.loss_cm(m, 100.0, frozen=frz_t), m)
    scale = np.abs(np_(g_j)).max()
    _close(g_t, g_j, 1e-4, 1e-5 * scale)
    assert tuple(ft._from_cand_minor(mu_t).shape) == mu.shape
    _close(ft._from_cand_minor(mu_t), mu, 0, 0)


@pytest.mark.parametrize("coarse", [False, True])
def test_m_major_wrappers_match_jax(coarse):
    """``__call__`` and ``freeze``, the sampler-layout (N, nt*2) wrappers of
    ``loss_cm`` / ``freeze_cm``: against JAX's, and equal to the
    candidate-minor calls on the transposed mean; the loss's gradient
    reaches the m-major mean as loss_cm's, transposed."""
    cfg_j, cfg_t, fj, ft, mu = _build(seed=4, clearance_coarse_pair=coarse)
    mu_t = torch.as_tensor(mu)
    frz_j, frz_t = fj.freeze(jnp.asarray(mu)), ft.freeze(mu_t)
    cm = ft.freeze_cm(ft._to_cand_minor(mu_t))
    for part in ("lane", "clear"):
        for k in frz_j[part]:
            _close(frz_t[part][k], frz_j[part][k], 1e-6, 1e-6)
            assert torch.equal(frz_t[part][k], cm[part][k])
    for frozen_t, frozen_j in ((None, None), (frz_t, frz_j)):
        _close(ft(mu_t, 100.0, frozen=frozen_t),
               fj(jnp.asarray(mu), 100.0, frozen=frozen_j), 1e-5, 1e-6)
        assert torch.equal(ft(mu_t, 0.5, frozen=frozen_t), ft.loss_cm(
            ft._to_cand_minor(mu_t), 0.5, frozen=frozen_t))
    # its gradient is loss_cm's (held to JAX's by test_loss_matches_jax),
    # brought back to the m-major layout
    m = mu_t.clone().requires_grad_(True)
    g_t, = torch.autograd.grad(ft(m, 100.0, frozen=frz_t), m)
    m_cm = ft._to_cand_minor(mu_t).requires_grad_(True)
    g_cm, = torch.autograd.grad(ft.loss_cm(m_cm, 100.0, frozen=frz_t), m_cm)
    assert tuple(g_t.shape) == mu.shape and float(g_t.abs().max()) > 0
    assert torch.equal(g_t, ft._from_cand_minor(g_cm))


@pytest.mark.parametrize("case", [
    dict(), dict(norm_stl=True), dict(guidance_positive_offset_quirk=True),
    dict(inline=True, clip_dist=True), dict(clearance_coarse_pair=True),
    dict(guidance_niters=1, norm_stl=True, clearance_coarse_pair=True)],
    ids=["default", "norm_stl", "quirk", "inline_clip", "coarse",
         "one_iter_norm_coarse"])
def test_plain_matches_xla_frozen_path(case):
    """The kernel's plain version (in-kernel freeze + Adam + clip) equals
    the XLA guidance loop on selections frozen by freeze_cm."""
    cfg_j, cfg_t, fj, ft, mu = _build(seed=11, **case)
    beta = 0.02
    mu_cm_j = fj._to_cand_minor(jnp.asarray(mu))
    frozen = fj.freeze_cm(mu_cm_j)
    ctx = jdiff.make_guidance_ctx(None, fj.valid_r, None, fj)
    xla = jdiff._guidance_step(jnp.asarray(mu), jnp.float32(beta), ctx,
                               cfg_j, maximize=True, frozen=frozen)
    out = gk.guidance_adam_cm(ft, None, ft._to_cand_minor(torch.as_tensor(mu)),
                              torch.tensor(beta), 100.0, cfg_t,
                              fuse_freeze=True)
    got = ft._from_cand_minor(out)
    _close(got, xla)
    assert np.abs(np_(got) - mu).max() > 1e-4     # guidance moved mu


def test_plain_matches_pallas_interpret_bf16_coarse():
    """bf16 cumsum + coarse pair (the main path's flags) against the Pallas
    kernel in interpret mode, at a tiny size."""
    flags = dict(clearance_coarse_pair=True, guidance_pallas_bf16_cumsum=True,
                 guidance_niters=2)
    cfg_j, cfg_t, fj, ft, mu = _build(seed=13, bs=1, M=2, nt=8, K=2, S=5,
                                      **flags)
    beta = 0.05
    mu_cm_j = fj._to_cand_minor(jnp.asarray(mu))
    pal = pallas_guidance.guidance_adam_cm(
        fj, None, mu_cm_j, jnp.float32(beta), 100.0, cfg_j, interpret=True,
        fuse_freeze=True)
    mu_t = ft._to_cand_minor(torch.as_tensor(mu))
    out = gk.guidance_adam_cm(ft, None, mu_t, torch.tensor(beta), 100.0,
                              cfg_t, fuse_freeze=True)
    _close(out, pal)
    # and bf16 really engages: the fp32 plain path differs
    out32 = gk.guidance_adam_cm(
        ft, None, mu_t, torch.tensor(beta), 100.0,
        cfg_t.with_(guidance_pallas_bf16_cumsum=False), fuse_freeze=True)
    assert np.abs(np_(out32) - np_(out)).max() > 0


def _kernel_inputs(seed, **kw):
    cfg_j, cfg_t, fj, ft, mu = _build(seed=seed, **kw)
    ops = gk.kernel_operands(ft, cfg_t)
    p = gk.kernel_params(cfg_t, ft)
    mu_t = ft._to_cand_minor(torch.as_tensor(mu))
    gvec = torch.stack([torch.tensor(0.02), torch.tensor(100.0),
                        ops.gscale])
    return ops, p, mu_t[:, :, 0].contiguous(), mu_t[:, :, 1].contiguous(), \
        gvec


@pytest.mark.parametrize("case", [
    dict(), dict(norm_stl=True, clearance_coarse_pair=True),
    dict(inline=True, clip_dist=True),
    dict(guidance_pallas_bf16_cumsum=True, clearance_coarse_pair=True)],
    ids=["default", "norm_coarse", "inline_clip", "bf16_coarse"])
def test_manual_vjp_matches_autograd(case):
    """The kernel's hand-written backward, transcribed in torch ops, equals
    autograd of the plain forward (scores too).  Compared in float64, where
    both are exact to ~1e-12: in float32 autograd through the tau=100
    softmins is itself off by up to ~2e-4 relative (the hand-written
    backward agrees with the float64 value to ~1e-7), which would hide an
    algebra error of that size."""
    _vjp_against_autograd(case, scan=False)


@pytest.mark.parametrize("case", [
    dict(), dict(norm_stl=True, clearance_coarse_pair=True),
    dict(inline=True, clip_dist=True),
    dict(guidance_pallas_bf16_cumsum=True, clearance_coarse_pair=True),
    dict(nt=12), dict(nt=32)],
    ids=["default", "norm_coarse", "inline_clip", "bf16_coarse", "T12",
         "T32"])
def test_scan_vjp_matches_autograd(case):
    """The same with what crosses time steps in the kernel's warp forms
    (scan-ordered sums, the doubling logaddexp scan, the affine-map scan of
    its backward), at horizons that leave lanes idle and that fill the
    warp."""
    _vjp_against_autograd(case, scan=True)


def _vjp_against_autograd(case, scan):
    ops, p, w, a, gvec = _kernel_inputs(seed=5, **case)
    sel = gk.freeze(w, a, ops.lanes, ops.ndx, ops.ndy, ops.scal, p)
    f64 = torch.float64
    pay = {k: v.to(f64) for k, v in
           gk.payloads(sel, ops.lanes, ops.ndx, ops.ndy, p).items()}
    ops = gk.Operands(*(o.to(f64) for o in ops))
    gvec = gvec.to(f64)
    w2 = (w.to(f64) + 0.01 * torch.sin(
        torch.arange(w.numel(), dtype=f64).reshape(w.shape)))
    a = a.to(f64)
    score, gw, ga = score_grad(w2, a, pay, ops, p, gvec[1], gvec[2],
                               scan=scan)
    wr, ar = w2.clone().requires_grad_(True), a.clone().requires_grad_(True)
    s_ref = gk.scores_frozen(wr, ar, pay, ops.crad, ops.cvalid, ops.stlp,
                             ops.nf, ops.scal, p)
    loss = torch.sum(torch.relu(gvec[1] - s_ref) * ops.valid * gvec[2])
    gw_ref, ga_ref = torch.autograd.grad(loss, (wr, ar))
    _close(score, s_ref, 1e-10, 1e-10)
    for g, ref in ((gw, gw_ref), (ga, ga_ref)):
        scale = float(ref.abs().max())
        assert scale > 0
        _close(g, ref, 1e-8, 1e-10 * scale)


def test_twin_step_matches_plain():
    """The full fused step with the hand-written gradient equals the plain
    version (autograd gradient)."""
    ops, p, w, a, gvec = _kernel_inputs(seed=7, clearance_coarse_pair=True,
                                        guidance_pallas_bf16_cumsum=True)
    args = (w, a, *ops[:-1], gvec, p)
    tw = guidance_fused_twin(*args)
    pl = gk.guidance_fused_plain(*args)
    for x, y in zip(tw, pl):
        _close(x, y)


def test_scan_twin_step_matches_plain():
    """The full fused step with the hand-written gradient in the kernel's
    warp forms equals the plain version (float32, bf16 cumsum: the scan's
    other summation order stays inside the tolerance)."""
    ops, p, w, a, gvec = _kernel_inputs(seed=7, clearance_coarse_pair=True,
                                        guidance_pallas_bf16_cumsum=True)
    args = (w, a, *ops[:-1], gvec, p)
    tw = guidance_fused_twin(*args, scan=True)
    pl = gk.guidance_fused_plain(*args)
    for x, y in zip(tw, pl):
        _close(x, y)


@pytest.mark.parametrize("case", [
    dict(), dict(norm_stl=True, clearance_coarse_pair=True),
    dict(guidance_positive_offset_quirk=True),
    dict(inline=True, clip_dist=True)],
    ids=["default", "norm_coarse", "quirk", "inline_clip"])
def test_scan_twin_step_matches_serial_twin(case):
    """float32 without the bf16 rounding, where nothing hides an ulp: the
    step in the kernel's forms (scan-ordered sums; tau, the norm factors,
    P5, the band's softmin sum and Adam's bias corrections inverted once
    and multiplied) against the step with serial sums and divisions, and
    against the plain version, at the kernel-vs-plain tolerance."""
    ops, p, w, a, gvec = _kernel_inputs(seed=7, **case)
    args = (w, a, *ops[:-1], gvec, p)
    tw = guidance_fused_twin(*args, scan=True)
    serial = guidance_fused_twin(*args)
    pl = gk.guidance_fused_plain(*args)
    assert float((tw[0] - w).abs().max()) > 1e-4    # the step moved mu
    for x, y, z in zip(tw, serial, pl):
        _close(x, y)
        _close(x, z)


def test_adam_reciprocal_form_matches_division():
    """Adam with the bias corrections inverted once and multiplied against
    ``guidance_kernel.adam_clip`` (which divides): float64 to 1e-8, float32
    at the kernel-vs-plain tolerance."""
    ops, p, w, a, gvec = _kernel_inputs(seed=4)
    rng = np.random.RandomState(0)
    for dtype, rtol, atol in ((torch.float64, 1e-8, 1e-12),
                              (torch.float32, RTOL, ATOL)):
        gs = [torch.as_tensor(rng.randn(2, *w.shape), dtype=dtype)
              for _ in range(p.niters)]
        w_, a_ = w.to(dtype), a.to(dtype)
        beta = torch.tensor(0.5, dtype=dtype)

        def run(loop):
            it = iter(gs)
            return loop(w_, a_, lambda *_: tuple(next(it)), beta, p)

        for x, y in zip(run(twin.adam_clip_recip), run(gk.adam_clip)):
            _close(x, y, rtol, atol)


def _scan_case(T, seed, dtype=torch.float64, spread=60.0):
    """z = -g * tau of a clause at tau = 100: spread over +-hundreds, so the
    exps of the scans underflow as they do in the kernel."""
    rng = np.random.RandomState(seed)
    return torch.as_tensor(spread * rng.randn(3, T, 7), dtype=dtype)


@pytest.mark.parametrize("T", [1, 5, 12, 20, 32])
def test_scan_sums_match_serial(T):
    """Hillis-Steele exclusive prefix / suffix sums on 32 lanes against
    cumsum, float64 to 1e-8 (they differ by summation order alone)."""
    x = _scan_case(T, T, spread=1.0)
    np.testing.assert_allclose(np_(twin.excl_prefix_scan(x)),
                               np_(gk._excl_cumsum(x)), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np_(twin.excl_suffix_scan(x)),
                               np_(gk._excl_rev_cumsum(x)), rtol=1e-8,
                               atol=1e-12)


@pytest.mark.parametrize("T,nt2", [(1, 1), (5, 2), (12, 6), (20, 10),
                                   (20, 1), (20, 20), (32, 16)])
def test_ev_scans_match_serial_and_autograd(T, nt2):
    """The doubling logaddexp scan and the affine-map scan of its backward
    against the serial recurrences and against autograd, float64 to 1e-8."""
    tau = 100.0
    g = (_scan_case(T, 10 * T + nt2) / tau).requires_grad_(True)
    z = -g * tau
    suf_s, m_s, S_s, ev_s = twin._ev_fwd(z, nt2)
    suf, m2, S2, ev = twin.ev_fwd_scan(z, nt2)
    np.testing.assert_allclose(np_(suf), np_(suf_s), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np_(ev), np_(ev_s), rtol=1e-8, atol=1e-8)
    gout = torch.as_tensor(np.random.RandomState(T).randn(3, 7))
    got = twin.ev_bwd_scan(z.detach(), suf.detach(), nt2, m2.detach(),
                           S2.detach(), gout)
    serial = twin._ev_bwd(z.detach(), suf_s.detach(), nt2, m_s.detach(),
                          S_s.detach(), gout)
    ref, = torch.autograd.grad(torch.sum(ev_s / tau * gout), g)
    scale = float(ref.abs().max())
    assert scale > 0
    np.testing.assert_allclose(np_(got), np_(serial), rtol=1e-8,
                               atol=1e-10 * scale)
    np.testing.assert_allclose(np_(got), np_(ref), rtol=1e-8,
                               atol=1e-10 * scale)


@pytest.mark.parametrize("T,nt2,tau", [(20, 10, 100.0), (20, 10, 1.0),
                                       (12, 6, 100.0), (32, 16, 5.0)])
def test_ev_scan_matches_pallas_ev_alw(T, nt2, tau):
    """float32, against the TPU kernel's own helper at its own tolerance
    (``_ev_alw``: "equality tests use 2e-4")."""
    g = _scan_case(T, 3, dtype=torch.float32, spread=0.6)[0]       # (T, R)
    ref = pallas_guidance._ev_alw(jnp.asarray(np_(g)), tau, nt2)   # (1, R)
    ev = twin.ev_fwd_scan((-g * tau)[None], nt2)[3] / tau          # (1, R)
    np.testing.assert_allclose(np_(ev), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_wrapper_routes_cpu_to_plain():
    """A CPU tensor runs the plain version and is not counted as a kernel
    launch; an unsupported device raises instead of falling back."""
    ops, p, w, a, gvec = _kernel_inputs(seed=2)
    before = gk.launches
    out = gk.guidance_fused(w, a, *ops[:-1], gvec, p)
    ref = gk.guidance_fused_plain(w, a, *ops[:-1], gvec, p)
    assert gk.launches == before
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        gk.guidance_fused(w.to("meta"), a, *ops[:-1], gvec, p)


def test_launch_checks_reject_bad_operands():
    """The kernel wrapper's operand checks (device, dtype, shape,
    contiguity) run before any launch."""
    ops, p, w, a, gvec = _kernel_inputs(seed=2)
    dev = w.device
    gk._check("w", w, w.shape, dev)
    with pytest.raises(TypeError):
        gk._check("w", w.double(), w.shape, dev)
    with pytest.raises(ValueError):
        gk._check("w", w[:, :-1], w.shape, dev)
    with pytest.raises(ValueError):
        gk._check("w", w.transpose(1, 2).contiguous().transpose(1, 2),
                  w.shape, dev)
