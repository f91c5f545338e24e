"""Guidance on the row-major sampler layout: the torch port against
``pstl_tpu.diffusion`` on the CPU.

- ``_guidance_step`` on an m-major (n, nt*2) mean: with the fused loss
  (turned candidate-minor around the XLA loop or the kernel's route) and
  with the row-major fallback loss (``denormalize_controls(clip=False)``,
  ``dynamics.rollout``, ``score_rows``, the hinge), for both hinge
  thresholds and both offset clamps;
- ``make_guidance_loss`` returns None without the fused loss, and
  ``guidance_pallas`` without it raises, in both packages;
- the m-major guided DDPM chain (``cm_sampler=False``) through ``sample``
  with the JAX key chain's draws: the fused loss on the XLA loop and on
  kernel 1's route, the fallback loss, and the selection carry
  (``guidance_sel_every=2``) on the XLA loop and on kernel 2's route;
- bf16 robustness (``robustness_dtype="bfloat16"``) in the fused loss's
  scores, the fallback loss's ``score_rows`` and the XLA guidance loop on
  both losses.

Case: ``torch_sampler_case.Case`` (2 scenes, M = 4, width-32 nets, fp32
nets, 10 denoise steps).  Tolerances: a guidance step rtol 2e-4 / atol
2e-5 (``tests/test_torch_guidance.py``'s); a reverse pass 1e-4
(``tests/test_torch_diffusion.py``'s), x0 exactly.  bf16: see
``BF16_SCORE_ULPS`` and ``test_bf16_guidance_step_within_trust_region``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff
from pstl_tpu_torch import diffusion as tdiff
from pstl_tpu_torch import specs as tspecs

from torch_parity import np_
from torch_sampler_case import Case

#: bf16 scores: XLA's CPU backend keeps a fusion's intermediates in fp32
#: and rounds to bf16 where a fusion ends, PyTorch rounds after every op;
#: each soft-min / soft-max of the clause tree (three levels deep) can
#: therefore round a bf16 step (2^-8 of its value) apart, and the scores
#: agree to this many bf16 steps of the largest score's magnitude
BF16_SCORE_ULPS = 4
BF16_EPS = 2.0 ** -8


def _close(a, b, rtol=2e-4, atol=2e-5):
    np.testing.assert_allclose(np_(a), np_(b), rtol=rtol, atol=atol)


def _mu(case, seed=2):
    return (np.random.RandomState(seed).randn(case.n, 40) * 0.5).astype(
        np.float32)


def _step_both(case, mu, beta, maximize, fused=True, cfg_j=None, cfg_t=None):
    cfg_j = cfg_j or case.cfg_j
    cfg_t = cfg_t or case.cfg_t
    ctx_j = case.jax_ctx(cfg_j)
    ctx_t = case.torch_ctx(cfg_t)
    if not fused:
        ctx_j = ctx_j[:3] + (None,)
        ctx_t = ctx_t._replace(fused_loss=None)
    out_j = jax.jit(lambda m: jdiff._guidance_step(
        m, jnp.float32(beta), ctx_j, cfg_j, maximize))(jnp.asarray(mu))
    out_t = tdiff._guidance_step(torch.as_tensor(mu), torch.tensor(beta),
                                 ctx_t, cfg_t, maximize)
    return out_j, out_t


@pytest.mark.parametrize("maximize", [True, False])
@pytest.mark.parametrize("quirk", [True, False])
def test_fallback_guidance_step_matches_jax(maximize, quirk):
    """The row-major fallback loss (no fused loss in the context), 3 Adam
    iterations."""
    case = Case(guidance_fused_loss=False,
                guidance_positive_offset_quirk=quirk)
    assert tspecs.make_guidance_loss(case.dt, case.dt, case.cfg_t,
                                     torch.as_tensor(case.states),
                                     case.dt["valids_dense"]) is None
    mu = _mu(case)
    out_j, out_t = _step_both(case, mu, 0.05, maximize)
    assert not out_t.requires_grad and out_t.shape == mu.shape
    _close(out_t, out_j)
    assert np.abs(np_(out_t) - mu).max() > 1e-3        # it moved mu


@pytest.mark.parametrize("route", ["xla", "kernel"])
def test_mmajor_fused_guidance_step_matches_jax(route):
    """An m-major mean with the fused loss: JAX's XLA loop on reused
    selections against the port's XLA loop or kernel 1's route (its plain
    version here), transposed candidate-minor and back."""
    torch_kw = (dict(guidance_pallas_fuse_freeze=True)
                if route == "kernel" else {})
    case = Case(torch_kw=torch_kw)
    mu = _mu(case, 4)
    out_j, out_t = _step_both(case, mu, 0.05, True)
    _close(out_t, out_j)
    assert np.abs(np_(out_t) - mu).max() > 1e-3


def test_pallas_needs_the_fused_loss():
    """``guidance_pallas`` with no fused loss in the context raises
    ValueError, in both packages."""
    case = Case()
    mu = _mu(case)
    cfg_j = case.cfg_j.with_(guidance_pallas=True)
    cfg_t = case.cfg_t.with_(guidance_pallas=True)
    with pytest.raises(ValueError, match="fused loss"):
        jdiff._guidance_step(jnp.asarray(mu), jnp.float32(0.05),
                             case.jax_ctx(cfg_j)[:3] + (None,), cfg_j, True)
    with pytest.raises(ValueError, match="fused loss"):
        tdiff._guidance_step(torch.as_tensor(mu), torch.tensor(0.05),
                             case.torch_ctx(cfg_t)._replace(fused_loss=None),
                             cfg_t, True)


@pytest.mark.parametrize("route", [
    "fused-xla", "fused-kernel", "fallback", "sel2-xla", "sel2-frozen"])
def test_mmajor_guided_ddpm_matches_jax(route):
    """``cm_sampler=False``: the DDPM chain in (n, nt*2) layout, guided on
    the last 6 of 9 denoise steps."""
    kw = dict(cm_sampler=False, guidance_before=6)
    torch_kw = {}
    if route == "fused-kernel":
        torch_kw = dict(guidance_pallas_fuse_freeze=True)
    elif route == "fallback":
        kw.update(guidance_fused_loss=False, guidance_reuse_selection=False)
    elif route.startswith("sel2"):
        kw.update(guidance_sel_every=2)
        if route == "sel2-frozen":
            torch_kw = dict(guidance_pallas=True)
    case = Case(torch_kw=torch_kw, **kw)
    key = jax.random.PRNGKey(9)
    ctrl_j, steps_j = case.run_jax(key)
    noise = case.noise(key)
    assert noise.shape == (10, case.n, 40)           # the row-major layout
    ctrl_t, steps_t = case.run_torch(noise)
    assert steps_t.shape == steps_j.shape == (10, case.n, 20, 2)
    _close(steps_t[0], steps_j[0], 0, 0)
    _close(steps_t, steps_j, 1e-4, 1e-4)
    _close(ctrl_t, ctrl_j, 1e-4, 1e-4)
    ctrl_u, _ = case.run_torch(noise, guided=False)
    assert float((ctrl_u - ctrl_t).abs().max()) > 1e-4


def test_mmajor_carry_freezes_per_refresh(monkeypatch):
    """The m-major chain's selection carry freezes its candidate-minor view
    on every second guided step only."""
    case = Case(cm_sampler=False, guidance_before=6, guidance_sel_every=2)
    calls = []
    real = tspecs.CandMinorGuidanceLoss.freeze_cm
    monkeypatch.setattr(tspecs.CandMinorGuidanceLoss, "freeze_cm",
                        lambda self, m: calls.append(m.shape) or
                        real(self, m))
    case.run_torch(case.noise(jax.random.PRNGKey(0)))
    assert calls == [(2, 20, 2, 12)] * 3            # refreshes of 6 guided


# ---------------------------------------------------------------------------
# bf16 robustness
# ---------------------------------------------------------------------------

def _bf16_scores_close(got, want, what):
    """Within BF16_SCORE_ULPS bf16 steps of the largest magnitude."""
    got = np_(got.float()).astype(np.float64)
    want = np.asarray(want).astype(np.float64)
    tol = BF16_SCORE_ULPS * BF16_EPS * max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: {err:.3e} > {tol:.3e}"


def test_bf16_scores_match_jax():
    """The fused loss's candidate-minor scores and the fallback loss's
    ``score_rows`` in bf16 robustness, at an m-major mean."""
    case = Case(guidance_pallas=False, robustness_dtype="bfloat16")
    mu = _mu(case, 6)
    ctx_j, ctx_t = case.jax_ctx(), case.torch_ctx()
    assert ctx_t.fused_loss.dtype == torch.bfloat16
    s_j = jax.jit(lambda m: ctx_j[3].scores_r(ctx_j[3]._to_cand_minor(m)))(
        jnp.asarray(mu))
    s_t = ctx_t.fused_loss.scores_r(ctx_t.fused_loss._to_cand_minor(
        torch.as_tensor(mu)))
    assert s_t.dtype == torch.float32
    _bf16_scores_close(s_t, s_j, "fused loss scores")
    u = np.asarray(jdiff.denormalize_controls(jnp.asarray(mu), case.cfg_j,
                                              clip=False))
    from pstl_tpu.ops import dynamics as jdyn
    from pstl_tpu_torch.ops import dynamics as tdyn
    sr_j = jax.jit(lambda v: ctx_j[0](jdyn.rollout(
        ctx_j[2], v, case.cfg_j.dt)[:, :-1]))(jnp.asarray(u))
    tr_t = tdyn.rollout(ctx_t.states_flat, torch.as_tensor(u.copy()),
                        case.cfg_t.dt)
    _bf16_scores_close(ctx_t.score_rows(tr_t[:, :-1]), sr_j, "score_rows")


@pytest.mark.parametrize("fused", [True, False])
def test_bf16_guidance_step_within_trust_region(fused):
    """The XLA guidance loop with bf16 robustness on the fused loss and on
    the fallback loss, against JAX's bf16 run.  The bf16 gradients of the
    two backends differ by their rounding order (``BF16_SCORE_ULPS``), and
    Adam's first step normalizes each gradient entry to +-lr, so a sign
    flip of a near-zero entry moves that control by up to 2 lr a step;
    the clip holds every control within beta_t of the posterior mean, so
    the two runs agree within the trust region: |port - JAX| <= beta_t
    (one step's whole correction).  Most controls see no flip and agree to
    the fp32 tolerance: 89-99 % of them on these inputs (seeds 8, 9, both
    clamps, both losses), held at 80 %."""
    beta = 0.05
    case = Case(guidance_pallas=False, robustness_dtype="bfloat16",
                guidance_positive_offset_quirk=False)
    mu = _mu(case, 8)
    out_j, out_t = _step_both(case, mu, beta, True, fused=fused)
    err = np.abs(np_(out_t) - np_(out_j))
    assert err.max() <= beta + 1e-6, err.max()
    assert np.mean(err <= 2e-4 + 2e-4 * np.abs(np_(out_j))) >= 0.8
    assert np.abs(np_(out_t) - mu).max() > 1e-3
