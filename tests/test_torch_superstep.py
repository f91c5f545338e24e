"""The superstep kernel's module on the CPU: one denoise step of
``superstep_kernel.superstep_plain`` against the Pallas
``pallas_guidance.superstep_call`` in interpret mode, on the same seeded
numpy inputs (MLP weights, x, z, the timestep term and the per-step
scalars), guided and unguided, fp32 and bf16, nmid 1 and 0; and the
wrapper's routing and operand checks.  The TPU layout folds scenes into
(T, bs*R) columns; the port keeps (bs, T, 2, R) and the test converts at
the boundary.

Tolerances.  fp32: 1e-5 on x_next (sums in another order; the guided
update's Adam steps end in the beta_t clip on most elements).  bf16: both
sides round every hidden activation to bf16 after an fp32 sum; a sum taken
in another order can round one activation one bf16 step (2^-8 relative)
the other way, which moves eps by about that step times an output weight
and x_next by c1/c2 of it: 1e-4.  Guided steps add the guidance tolerance
of tests/test_torch_guidance.py (rtol 2e-4 / atol 2e-5) to it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu.ops import pallas_guidance as pg
from pstl_tpu_torch import diffusion as tdiff
from pstl_tpu_torch.ops import guidance_kernel as gk
from pstl_tpu_torch.ops import superstep_kernel as sk

from test_torch_guidance import _build as guidance_build
from torch_parity import F32, np_

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _fold(x):
    """(bs, ..., R) numpy -> (..., bs*R) (``pallas_guidance._fold``)."""
    y = np.moveaxis(x, 0, -2)
    return y.reshape(y.shape[:-2] + (y.shape[-2] * y.shape[-1],))


def _mlp_weights(rng, hiddens, T, bs, R):
    """Random split-MLP operands as numpy float32 (``eps_cm.operands``
    layout)."""
    h1 = hiddens[0]
    n = lambda *s: rng.randn(*s).astype(F32)
    w = dict(base=n(bs, h1, R) * 0.5, te=n(h1) * 0.5,
             WnwT=n(h1, T) / np.sqrt(2 * T), WnaT=n(h1, T) / np.sqrt(2 * T),
             mid=[(n(k, h) / np.sqrt(h), n(k, 1) * 0.1)
                  for h, k in zip(hiddens[:-1], hiddens[1:])],
             WowT=n(T, hiddens[-1]) / np.sqrt(hiddens[-1]),
             WoaT=n(T, hiddens[-1]) / np.sqrt(hiddens[-1]),
             bow=n(T, 1) * 0.1, boa=n(T, 1) * 0.1)
    return w


@pytest.mark.parametrize("hiddens", [(32, 32), (32,)], ids=["nmid1", "nmid0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("guided", [True, False], ids=["guided", "unguided"])
def test_superstep_call_matches_pallas_interpret(hiddens, dtype, guided):
    cfg_j, cfg_t, fj, ft, _ = guidance_build(
        seed=21, clearance_coarse_pair=True, guidance_pallas_superstep=True,
        compute_dtype=dtype, hiddens=hiddens)
    assert cfg_j.guidance_pallas_fold2 and cfg_t.guidance_pallas_fold2
    bs, R, T = ft.bs, ft.R, cfg_t.nt
    rng = np.random.RandomState(5)
    w = _mlp_weights(rng, hiddens, T, bs, R)
    x = rng.randn(bs, T, 2, R).astype(F32)
    z = rng.randn(bs, T, 2, R).astype(F32)
    coeffs = tdiff.get_coeffs(cfg_t)
    t = 7
    beta, alpha, ahat = (float(coeffs.beta[t]), float(coeffs.alpha[t]),
                         float(coeffs.alpha_hat[t]))
    gops = gk.kernel_operands(ft, cfg_t)
    gvec = np.array([beta, 100.0, float(gops.gscale),
                     (1 - alpha) / np.sqrt(1 - ahat), np.sqrt(alpha),
                     np.sqrt(beta), 0, 0], F32)

    jd = JDT[dtype]
    jops = dict(base_f=jnp.asarray(_fold(w["base"]), jd),
                WnwT=jnp.asarray(w["WnwT"], jd), WnaT=jnp.asarray(w["WnaT"], jd),
                mid=[(jnp.asarray(W, jd), jnp.asarray(b, jd))
                     for W, b in w["mid"]],
                WowT=jnp.asarray(w["WowT"], jd), WoaT=jnp.asarray(w["WoaT"], jd),
                bow=jnp.asarray(w["bow"], jd), boa=jnp.asarray(w["boa"], jd),
                dt=jd, bs=bs, R=R, nt=T)
    pg.warm_invariants(fj, cfg_j)
    ow, oa = pg.superstep_call(
        fj, jops, jnp.asarray(_fold(x[:, :, 0])), jnp.asarray(_fold(x[:, :, 1])),
        jnp.asarray(_fold(z[:, :, 0])), jnp.asarray(_fold(z[:, :, 1])),
        jnp.asarray(w["te"], jd)[:, None], jnp.asarray(gvec)[None], cfg_j,
        guided=guided, interpret=True)
    unfold = lambda o: np.moveaxis(np_(o).reshape(T, bs, R), 1, 0)
    ref = np.stack([unfold(ow), unfold(oa)], axis=2)

    td = TDT[dtype]
    c = lambda a: torch.as_tensor(a).to(td)
    mlp = sk.MlpOperands(
        base=c(w["base"]), WnwT=c(w["WnwT"]), WnaT=c(w["WnaT"]),
        mid=tuple((c(W), c(b)) for W, b in w["mid"]), WowT=c(w["WowT"]),
        WoaT=c(w["WoaT"]), bow=c(w["bow"]), boa=c(w["boa"]))
    got = sk.superstep_plain(torch.as_tensor(x), torch.as_tensor(z),
                             c(w["te"]), torch.as_tensor(gvec), mlp, gops,
                             gk.kernel_params(cfg_t, ft), guided)
    assert got.shape == (bs, T, 2, R)
    tol = 1e-5 if dtype == "float32" else 1e-4
    rtol, atol = (2e-4, 2e-5 + tol) if guided else (tol, tol)
    np.testing.assert_allclose(np_(got), ref, rtol=rtol, atol=atol)
    # the step did work: the output is neither x nor the unguided step
    assert np.abs(ref - x).max() > 1e-2
    if guided:
        plain = sk.superstep_plain(torch.as_tensor(x), torch.as_tensor(z),
                                   c(w["te"]), torch.as_tensor(gvec), mlp,
                                   gops, gk.kernel_params(cfg_t, ft), False)
        assert np.abs(np_(plain) - ref).max() > 1e-4


def test_superstep_wrapper_routes_cpu_to_plain():
    """A CPU tensor runs the plain version and counts no launch; another
    device raises instead of falling back."""
    cfg_j, cfg_t, fj, ft, _ = guidance_build(
        seed=2, guidance_pallas_superstep=True, hiddens=(16,))
    bs, R, T = ft.bs, ft.R, cfg_t.nt
    rng = np.random.RandomState(0)
    w = _mlp_weights(rng, (16,), T, bs, R)
    c = lambda a: torch.as_tensor(a).to(torch.bfloat16)
    mlp = sk.MlpOperands(c(w["base"]), c(w["WnwT"]), c(w["WnaT"]), (),
                         c(w["WowT"]), c(w["WoaT"]), c(w["bow"]),
                         c(w["boa"]))
    x = torch.as_tensor(rng.randn(bs, T, 2, R).astype(F32))
    gvec = torch.tensor([0.01, 100.0, 0.05, 0.02, 0.99, 0.1, 0, 0])
    args = (x, torch.zeros_like(x), c(w["te"]), gvec, mlp,
            gk.kernel_operands(ft, cfg_t), gk.kernel_params(cfg_t, ft), True)
    before = (sk.launches, sk.guided_launches)
    out = sk.superstep(*args)
    assert (sk.launches, sk.guided_launches) == before
    assert torch.equal(out, sk.superstep_plain(*args))
    with pytest.raises(ValueError):
        sk.superstep(x.to("meta"), *args[1:])


def test_launch_checks_reject_bad_operands():
    """The kernel wrapper's checks (dtype, shape, contiguity, widths) run
    before any library is loaded."""
    cfg_j, cfg_t, fj, ft, _ = guidance_build(
        seed=2, guidance_pallas_superstep=True, hiddens=(16,))
    bs, R, T = ft.bs, ft.R, cfg_t.nt
    w = _mlp_weights(np.random.RandomState(0), (16,), T, bs, R)
    c = lambda a: torch.as_tensor(a).to(torch.bfloat16)
    mlp = sk.MlpOperands(c(w["base"]), c(w["WnwT"]), c(w["WnaT"]), (),
                         c(w["WowT"]), c(w["WoaT"]), c(w["bow"]),
                         c(w["boa"]))
    x = torch.zeros(bs, T, 2, R)
    gops, p = gk.kernel_operands(ft, cfg_t), gk.kernel_params(cfg_t, ft)
    gvec = torch.zeros(8)
    ok = (x, x, c(w["te"]), gvec, mlp, gops, p, True)
    bad = [
        (x.double(),) + ok[1:],                                # dtype
        ok[:2] + (c(w["te"])[:-1],) + ok[3:],                  # shape
        (x.transpose(0, 1).contiguous().transpose(0, 1),) + ok[1:],
        ok[:4] + (mlp._replace(base=mlp.base.float()),) + ok[5:],
        ok[:4] + (mlp._replace(mid=((c(np.zeros((600, 16), F32)),
                                     c(np.zeros((600, 1), F32))),)),) + ok[5:],
    ]
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            sk._launch(*args)
