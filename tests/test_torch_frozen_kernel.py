"""The frozen-payload guidance kernel (``guidance_frozen``, the port of the
Pallas ``_kernel``) and the scene-folded variants, on the CPU:

- ``guidance_adam_cm(fuse_freeze=False)`` (the plain version on CPU
  tensors) against ``pallas_guidance.guidance_adam_cm`` on the same
  ``freeze_cm`` payloads, the Pallas kernel run in interpret mode;
- ``guidance_pallas_fold`` with and without ``fuse_freeze`` (the Pallas
  ``_kernel_f`` and ``_kernel_fused_f``) against the JAX folded dispatch in
  interpret mode: the port runs both through the per-scene launches;
- the hand-written VJP's torch transcription reading ``freeze_cm``
  payloads (the kernel's PaySel path) against autograd, in float64;
- the wrapper's routing and operand checks.

Tolerances: rtol 2e-4 / atol 2e-5 on guided controls, the JAX package's
own kernel-vs-XLA tolerance (fp32 sums in another order); the VJP to 1e-8
in float64 (see tests/test_torch_guidance.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu.ops import pallas_guidance as pg
from pstl_tpu_torch.ops import guidance_kernel as gk

from test_torch_guidance import _build, _close
from torch_guidance_twin import guidance_frozen_twin, score_grad
from torch_parity import np_

BETA = 0.02


def _frozen_case(seed, **kw):
    """Both losses, configs and the posterior mean in candidate-minor
    layout, with each package's freeze_cm payloads."""
    cfg_j, cfg_t, fj, ft, mu = _build(seed=seed, **kw)
    mu_j = fj._to_cand_minor(jnp.asarray(mu))
    mu_t = ft._to_cand_minor(torch.as_tensor(mu))
    return cfg_j, cfg_t, fj, ft, mu_j, mu_t, fj.freeze_cm(mu_j), \
        ft.freeze_cm(mu_t)


@pytest.mark.parametrize("case", [
    dict(), dict(norm_stl=True), dict(guidance_positive_offset_quirk=True),
    dict(inline=True, clip_dist=True), dict(clearance_coarse_pair=True),
    dict(clearance_coarse_pair=True, guidance_pallas_bf16_cumsum=True),
    dict(guidance_niters=1)],
    ids=["default", "norm_stl", "quirk", "inline_clip", "coarse",
         "bf16_coarse", "one_iter"])
def test_frozen_matches_pallas_interpret(case):
    """The port's frozen-payload step against the Pallas ``_kernel``."""
    cfg_j, cfg_t, fj, ft, mu_j, mu_t, frz_j, frz_t = _frozen_case(11, **case)
    pal = pg.guidance_adam_cm(fj, frz_j, mu_j, jnp.float32(BETA), 100.0,
                              cfg_j, interpret=True, fuse_freeze=False)
    before = (gk.launches, gk.frozen_launches)
    out = gk.guidance_adam_cm(ft, frz_t, mu_t, torch.tensor(BETA), 100.0,
                              cfg_t, fuse_freeze=False)
    assert (gk.launches, gk.frozen_launches) == before   # CPU: plain version
    _close(out, pal)
    assert np.abs(np_(out) - np_(mu_t)).max() > 1e-4      # guidance moved mu


@pytest.mark.parametrize("fuse_freeze", [False, True],
                         ids=["kernel_f", "kernel_fused_f"])
def test_fold_matches_pallas_interpret(fuse_freeze):
    """``guidance_pallas_fold`` (scenes folded into (T, bs*R) tiles on the
    TPU) against the JAX folded dispatch, with the main path's coarse pair
    and bf16 cumsum."""
    cfg_j, cfg_t, fj, ft, mu_j, mu_t, frz_j, frz_t = _frozen_case(
        13, clearance_coarse_pair=True, guidance_pallas_bf16_cumsum=True,
        guidance_pallas_fold=True)
    assert cfg_j.guidance_pallas_fold and cfg_t.guidance_pallas_fold
    pal = pg.guidance_adam_cm(fj, frz_j, mu_j, jnp.float32(BETA), 100.0,
                              cfg_j, interpret=True, fuse_freeze=fuse_freeze)
    out = gk.guidance_adam_cm(ft, frz_t, mu_t, torch.tensor(BETA), 100.0,
                              cfg_t, fuse_freeze=fuse_freeze)
    _close(out, pal)
    assert np.abs(np_(out) - np_(mu_t)).max() > 1e-4


@pytest.mark.parametrize("case", [
    dict(), dict(inline=True, clip_dist=True, norm_stl=True),
    dict(geometry_dtype="bfloat16", clearance_coarse_pair=True,
         guidance_pallas_bf16_cumsum=True)],
    ids=["default", "inline_clip_norm", "geom_bf16_coarse_bf16"])
def test_manual_vjp_payloads_matches_autograd(case):
    """The hand-written backward reading freeze_cm's payloads (PaySel:
    frozen at the fp32 rollout of freeze_cm, so they can differ from the
    in-kernel freeze's; bf16 payloads under geometry_dtype) equals autograd
    of the plain forward, in float64."""
    cfg_j, cfg_t, fj, ft, mu_j, mu_t, frz_j, frz_t = _frozen_case(5, **case)
    f64 = torch.float64
    ops = gk.kernel_operands(ft, cfg_t)
    p = gk.kernel_params(cfg_t, ft)
    pay = dict(zip(gk.FROZEN_KEYS,
                   (x.to(f64) for x in gk.frozen_operands(frz_t))))
    ops = gk.Operands(*(o.to(f64) for o in ops))
    w = mu_t[:, :, 0].to(f64)
    a = mu_t[:, :, 1].to(f64)
    w = w + 0.01 * torch.sin(torch.arange(w.numel(), dtype=f64)
                             ).reshape(w.shape)
    thres, gscale = torch.tensor(100.0, dtype=f64), ops.gscale
    score, gw, ga = score_grad(w, a, pay, ops, p, thres, gscale)
    wr, ar = w.clone().requires_grad_(True), a.clone().requires_grad_(True)
    s_ref = gk.scores_frozen(wr, ar, pay, ops.crad, ops.cvalid, ops.stlp,
                             ops.nf, ops.scal, p)
    loss = torch.sum(torch.relu(thres - s_ref) * ops.valid * gscale)
    gw_ref, ga_ref = torch.autograd.grad(loss, (wr, ar))
    _close(score, s_ref, 1e-10, 1e-10)
    for g, ref in ((gw, gw_ref), (ga, ga_ref)):
        scale = float(ref.abs().max())
        assert scale > 0
        _close(g, ref, 1e-8, 1e-10 * scale)


def _frozen_args(seed, **kw):
    cfg_j, cfg_t, fj, ft, mu_j, mu_t, frz_j, frz_t = _frozen_case(seed, **kw)
    ops = gk.kernel_operands(ft, cfg_t)
    gvec = torch.stack([torch.tensor(BETA), torch.tensor(100.0),
                        ops.gscale])
    args = (mu_t[:, :, 0].contiguous(), mu_t[:, :, 1].contiguous(),
            *gk.frozen_operands(frz_t), *gk.frozen_scene(ops), gvec)
    return args, gk.kernel_params(cfg_t, ft)


def test_twin_frozen_step_matches_plain():
    """The frozen step with the hand-written gradient equals the plain
    version (autograd gradient), on bf16 geometry payloads."""
    args, p = _frozen_args(7, clearance_coarse_pair=True,
                           guidance_pallas_bf16_cumsum=True,
                           geometry_dtype="bfloat16")
    for x, y in zip(guidance_frozen_twin(*args, p),
                    gk.guidance_frozen_plain(*args, p)):
        _close(x, y)


def test_frozen_wrapper_routes_and_checks():
    """CPU tensors run the plain version (not counted as a launch); another
    device raises instead of falling back; the launch checks reject a
    payload of the wrong shape, dtype or layout before any launch; the
    fused plain version is the freeze followed by the frozen one."""
    args, p = _frozen_args(2)
    before = gk.frozen_launches
    out = gk.guidance_frozen(*args, p)
    assert gk.frozen_launches == before
    for x, y in zip(out, gk.guidance_frozen_plain(*args, p)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        gk.guidance_frozen(args[0].to("meta"), *args[1:], p)
    bs, T, R = args[0].shape
    names = gk._FROZEN_NAMES
    assert len(names) == len(args) == 19
    gk.check_operands(args, p, bs, T, R, args[0].device, "t", names)
    i = names.index("axe")
    for bad, err in ((args[i][:, :-1], ValueError),
                     (args[i].double(), TypeError),
                     (args[i].transpose(2, 3).contiguous().transpose(2, 3),
                      ValueError)):
        bad_args = args[:i] + (bad,) + args[i + 1:]
        with pytest.raises(err):
            gk.check_operands(bad_args, p, bs, T, R, args[0].device, "t",
                              names)
    with pytest.raises(ValueError):                  # frozen selections
        gk.guidance_adam_cm(None, None, torch.stack(args[:2], 2), BETA,
                            100.0, None, fuse_freeze=False)
