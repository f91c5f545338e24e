"""The fast samplers, DDIM and DPM-Solver++(2M): the torch port against
``pstl_tpu.diffusion`` on the CPU, and the port's mirrors of
``tests/test_ddim.py``.

``_fast_taus`` is held equal to JAX's over a grid of configurations.  The
samplers run through each package's ``sample`` dispatch on
``torch_sampler_case.Case`` (2 scenes, M = 4, width-32 nets, fp32, 10
denoise steps) with the JAX key chain's draws: ``k_init, k_loop =
split(key)``, x0 from k_init, then ``k, k_z = split(k)`` a DDIM step (S + 1
draws, the last multiplied by 0); DPM++ draws x0 only.  Guided, both
packages guide every step (the trigger schedule only places the taus) on
the context's fused loss: JAX's XLA loop on reused selections against the
port's XLA loop, and JAX's Pallas kernel in interpret mode against the
fused kernel's plain version (the port's CPU route of kernel 1).

Tolerances: controls and every decoding rtol 2e-4 / atol 2e-5 (fp32 sums
in another order through a few guided steps; each step's guidance is
bounded by the beta_t trust region), x0 exactly.
"""

import jax
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff
from pstl_tpu.config import Config as JConfig
from pstl_tpu_torch import diffusion as tdiff
from pstl_tpu_torch import eval_openloop as teval
from pstl_tpu_torch.config import Config as TConfig

from torch_parity import np_
from torch_sampler_case import Case

RTOL, ATOL = 2e-4, 2e-5


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np_(a), np_(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("steps", [5, 20, 99])
@pytest.mark.parametrize("kw", [
    dict(), dict(guidance=True, guidance_before=10),
    dict(guidance=True, guidance_before=10, fast_guided_focus=0.3),
    dict(guidance=True, guidance_before=10, fast_guided_focus=0.7),
    dict(guidance=True, guidance_before=40, fast_guided_focus=0.7),
    dict(guidance=True, fast_guided_focus=0.3),
    dict(guidance=True, fast_guided_focus=0.7, fast_focus_band=10),
    dict(guidance=True, fast_guided_focus=0.3, fast_focus_band=3),
    dict(guidance=True, guidance_freq=3, fast_guided_focus=0.5),
    dict(fast_guided_focus=0.7, fast_focus_band=25)])
def test_fast_taus_equal_jax(kw, steps):
    base = dict(diffusion=True, diffusion_steps=100, ddim_steps=steps, **kw)
    got = tdiff._fast_taus(TConfig(**base).finalize())
    want = jdiff._fast_taus(JConfig(**base).finalize())
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got) < 0).all() and got[-1] >= 1


@pytest.fixture(scope="module")
def case():
    return Case()


@pytest.mark.parametrize("sampler,eta", [("ddim", 0.0), ("ddim", 0.5),
                                         ("dpmpp", 0.0)])
def test_unguided_fast_sampler_matches_jax(case, sampler, eta):
    cfg_j = case.cfg_j.with_(sampler=sampler, ddim_steps=5, ddim_eta=eta)
    cfg_t = case.cfg_t.with_(sampler=sampler, ddim_steps=5, ddim_eta=eta)
    key = jax.random.PRNGKey(3)
    ctrl_j, steps_j = case.run_jax(key, cfg_j, guided=False)
    noise = case.noise(key, cfg_t)
    assert noise.shape[0] == (6 if sampler == "ddim" else 1)
    ctrl_t, steps_t = case.run_torch(noise, cfg_t, guided=False)
    assert steps_t.shape == steps_j.shape == (6, case.n, 20, 2)
    _close(steps_t[0], steps_j[0], 0, 0)
    _close(steps_t, steps_j)
    _close(ctrl_t, ctrl_j)


@pytest.mark.parametrize("route", ["xla", "kernel", "interpret"])
@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
def test_guided_fast_sampler_matches_jax(sampler, route):
    """Guided on every step with 3 Adam iterations on the fused loss:
    "xla" both packages' XLA loop on reused selections; "kernel" JAX's XLA
    loop against the port's kernel-1 route (its plain version here);
    "interpret" JAX's Pallas kernel (interpret mode) against the same."""
    fuse = dict(guidance_pallas_fuse_freeze=True)
    jax_kw = dict(fuse, pallas_interpret=True) if route == "interpret" \
        else {}
    torch_kw = {} if route == "xla" else fuse
    c = Case(sampler=sampler, ddim_steps=4, ddim_eta=0.5,
             jax_kw=jax_kw, torch_kw=torch_kw)
    key = jax.random.PRNGKey(5)
    ctrl_j, steps_j = c.run_jax(key)
    ctrl_t, steps_t = c.run_torch(c.noise(key))
    _close(steps_t[0], steps_j[0], 0, 0)
    _close(steps_t, steps_j)
    _close(ctrl_t, ctrl_j)
    # the guidance moved the sample
    ctrl_u, _ = c.run_torch(c.noise(key), guided=False)
    assert float((ctrl_u - ctrl_t).abs().max()) > 1e-4


def test_fast_samplers_launch_kernel_once_a_step(case, monkeypatch):
    """Under ``guidance_pallas`` every DDIM step and every DPM++ update
    goes through ``guidance_adam_cm`` once (kernel 1 on the card)."""
    from pstl_tpu_torch.ops import guidance_kernel
    calls = []
    real = guidance_kernel.guidance_adam_cm
    monkeypatch.setattr(guidance_kernel, "guidance_adam_cm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = case.cfg_t.with_(guidance_pallas_fuse_freeze=True).finalize()
    for sampler, want in (("ddim", 6), ("dpmpp", 5)):
        calls.clear()
        case.run_torch(None, cfg.with_(sampler=sampler, ddim_steps=6),
                       generator=torch.Generator().manual_seed(0))
        assert len(calls) == want, sampler


# ---------------------------------------------------------------------------
# the port's mirrors of tests/test_ddim.py
# ---------------------------------------------------------------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_ddim_shapes_and_determinism(case):
    cfg = case.cfg_t.with_(sampler="ddim", ddim_steps=5)
    c, all_steps = case.run_torch(None, cfg, guided=False, generator=_gen(0))
    assert c.shape == (case.n, cfg.nt, 2)
    assert all_steps.shape == (5 + 1, case.n, cfg.nt, 2)
    _close(all_steps[-1], c, 0, 1e-6)
    # eta = 0: the same x0 gives the same sample, whatever the later draws
    noise = torch.randn((6, case.n, 40), generator=_gen(1))
    other = noise.clone()
    other[1:] = torch.randn((5, case.n, 40), generator=_gen(2))
    c1, _ = case.run_torch(noise, cfg, guided=False)
    c2, _ = case.run_torch(other, cfg, guided=False)
    _close(c1, c2, 0, 0)


def test_ddim_eta_adds_noise(case):
    cfg = case.cfg_t.with_(sampler="ddim", ddim_steps=5, ddim_eta=1.0)
    c1, _ = case.run_torch(None, cfg, guided=False, generator=_gen(1))
    c2, _ = case.run_torch(None, cfg, guided=False, generator=_gen(2))
    assert float((c1 - c2).abs().max()) > 1e-4
    assert bool(torch.isfinite(c1).all())
    # with the same x0, eta > 0 makes the later draws matter
    noise = torch.randn((6, case.n, 40), generator=_gen(1))
    other = noise.clone()
    other[1:] = torch.randn((5, case.n, 40), generator=_gen(2))
    a, _ = case.run_torch(noise, cfg, guided=False)
    b, _ = case.run_torch(other, cfg, guided=False)
    assert float((a - b).abs().max()) > 1e-4


def test_dpmpp_shapes_determinism_and_quality(case):
    cfg = case.cfg_t.with_(sampler="dpmpp", ddim_steps=6)
    c, all_steps = case.run_torch(None, cfg, guided=False, generator=_gen(0))
    assert c.shape == (case.n, cfg.nt, 2)
    # S-1 steps + the initial noise + the final decode
    assert all_steps.shape[0] == 6 + 1
    _close(all_steps[-1], c, 0, 1e-6)
    assert bool(torch.isfinite(c).all())
    c2, _ = case.run_torch(None, cfg, guided=False, generator=_gen(0))
    _close(c2, c, 0, 0)
    # the deterministic solver tracks the same model as DDIM(eta=0)
    cd, _ = case.run_torch(None, cfg.with_(sampler="ddim"), guided=False,
                           generator=_gen(0))
    assert float((c - cd).abs().mean()) < float(cd.abs().mean()) + 1.0


def test_sample_dispatch(case):
    cfg = case.cfg_t.with_(sampler="ddim", ddim_steps=4)
    _, steps = case.run_torch(None, cfg, guided=False, generator=_gen(0))
    assert steps.shape[0] == 4 + 1
    cfg2 = cfg.with_(sampler="ddpm")
    c2, steps2 = case.run_torch(None, cfg2, guided=False, generator=_gen(0))
    assert steps2.shape[0] == cfg.diffusion_steps
    # diff_full off: only the final decode is kept
    c3, steps3 = case.run_torch(None, cfg2.with_(diff_full=False),
                                guided=False, generator=_gen(0))
    assert steps3.shape[0] == 1
    _close(c3, c2, 0, 1e-6)
    # the fast samplers drop cm_fn: the same sample with and without it
    cfg_g = case.cfg_t.with_(sampler="ddim", ddim_steps=4)
    a, _ = case.run_torch(None, cfg_g, cm=True, generator=_gen(3))
    b, _ = case.run_torch(None, cfg_g, cm=False, generator=_gen(3))
    _close(a, b, 0, 0)
    assert tdiff.n_draws(cfg) == 5 and tdiff.n_draws(cfg2) == 10
    assert tdiff.n_draws(cfg.with_(sampler="dpmpp")) == 1
    # the evaluation's draws: row-major for the fast samplers, whatever
    # cm_sampler says; candidate-minor for the guided DDPM chain
    S = 3 * cfg.sampling_size
    assert teval.draw_shape(cfg_g, 2) == (5, 2 * S, 40)
    assert teval.draw_shape(cfg_g.with_(sampler="dpmpp"), 2) == (1, 2 * S,
                                                                  40)
    assert teval.draw_shape(cfg_g.with_(sampler="ddpm"), 2) == (10, 2, 20,
                                                                2, S)
    assert teval.draw_shape(cfg_g.with_(sampler="ddpm", cm_sampler=False),
                            2) == (10, 2 * S, 40)


def test_fast_taus_guided_focus():
    base = dict(diffusion=True, diffusion_steps=100, ddim_steps=20)
    uni = tdiff._fast_taus(TConfig(**base).finalize())
    assert len(uni) == 20 and uni[0] == 99 and uni[-1] == 1
    assert (np.diff(uni) < 0).all()
    cfg = TConfig(**base, guidance=True, guidance_before=10,
                  fast_guided_focus=0.5).finalize()
    taus = tdiff._fast_taus(cfg)
    assert len(taus) == 20 and taus[0] == 99 and taus[-1] == 1
    assert (np.diff(taus) < 0).all()
    assert int((taus <= 10).sum()) == 10
    cfg_all = TConfig(**base, guidance=True, guidance_before=1000,
                      fast_guided_focus=0.5).finalize()
    np.testing.assert_array_equal(tdiff._fast_taus(cfg_all), uni)


def test_ddim_runs_with_guided_focus(case):
    cfg = case.cfg_t.with_(sampler="ddim", ddim_steps=6, guidance_before=3,
                           guidance_niters=1, fast_guided_focus=0.5)
    c, _ = case.run_torch(None, cfg, generator=_gen(0))
    assert bool(torch.isfinite(c).all())


def test_fast_taus_explicit_band():
    cfg = TConfig(diffusion=True, diffusion_steps=100, ddim_steps=20,
                  guidance=True, guidance_before=1000,
                  fast_guided_focus=0.4, fast_focus_band=10).finalize()
    taus = tdiff._fast_taus(cfg)
    assert len(taus) == 20 and (np.diff(taus) < 0).all()
    assert int((taus <= 10).sum()) == 8
