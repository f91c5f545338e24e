"""The frozen selections and the XLA guidance loop, against the JAX package
on the CPU:

- ``CandMinorGuidanceLoss.freeze_cm`` under ``geometry_dtype="bfloat16"``
  (``BENCH_GEOM_DTYPE``): the selection fields are rounded to bf16 before
  the argmins and the payloads are stored in bf16, at JAX's cast points;
- the XLA-loop branch of ``diffusion._guidance_step`` (``BENCH_GPALLAS=0``)
  with ``guidance_reuse_selection`` on (selections frozen at the posterior
  mean) and off (re-selected in every Adam iteration).

Tolerances.  bf16 freeze: XLA on the CPU may keep bf16 intermediates in
fp32 (excess precision), while torch rounds after every op, so an argmin on
a near-tie can flip; at most 2% of the (t, column) lane selections and of
the (k, t, column) disc selections may differ, and where they agree the
payloads agree to one bf16 step (2^-8 relative).  XLA loop: rtol 2e-4 /
atol 2e-5, the JAX package's kernel-vs-XLA tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff
from pstl_tpu_torch import diffusion as tdiff

from test_torch_guidance import _build, _close
from torch_parity import np_

BF16_REL = 2.0 ** -8
MAX_FLIP_SHARE = 0.02


def _agree(a, b):
    """Elementwise: a and b within one bf16 step of each other."""
    a, b = np_(a.float()) if torch.is_tensor(a) else a, np.asarray(
        b, np.float32)
    return np.abs(a - b) <= BF16_REL * np.maximum(np.abs(b), 1e-3)


@pytest.mark.parametrize("coarse", [False, True])
def test_freeze_cm_geometry_bf16_matches_jax(coarse):
    cfg_j, cfg_t, fj, ft, mu = _build(seed=3, geometry_dtype="bfloat16",
                                      clearance_coarse_pair=coarse)
    frz_j = fj.freeze_cm(fj._to_cand_minor(jnp.asarray(mu)))
    frz_t = ft.freeze_cm(ft._to_cand_minor(torch.as_tensor(mu)))
    for part, keys in (("lane", ("x2", "y2", "th2", "x3", "y3")),
                       ("clear", ("axe", "nx", "ny"))):
        for k in keys:
            assert frz_t[part][k].dtype == torch.bfloat16, (part, k)
            assert frz_j[part][k].dtype == jnp.bfloat16, (part, k)
        same = np.all([_agree(frz_t[part][k], frz_j[part][k].astype(
            jnp.float32)) for k in keys], axis=0)
        share = 1.0 - same.mean()
        assert share <= MAX_FLIP_SHARE, (part, share)
    for k in ("first", "last"):
        assert frz_t["lane"][k].dtype == torch.bool
        agree = np_(frz_t["lane"][k]) == np.asarray(frz_j["lane"][k])
        assert 1.0 - agree.mean() <= MAX_FLIP_SHARE
    # bf16 really engages: the payloads are rounded (fp32 ones are not)
    f32 = _build(seed=3, clearance_coarse_pair=coarse)[3].freeze_cm(
        ft._to_cand_minor(torch.as_tensor(mu)))
    assert f32["lane"]["x2"].dtype == torch.float32
    assert not torch.equal(f32["lane"]["x2"],
                           frz_t["lane"]["x2"].float())


@pytest.mark.parametrize("reuse", [True, False], ids=["frozen", "reselect"])
@pytest.mark.parametrize("case", [
    dict(clearance_coarse_pair=True), dict(guidance_positive_offset_quirk=True,
                                           inline=True, norm_stl=True)],
    ids=["coarse", "quirk_inline_norm"])
def test_xla_loop_matches_jax(reuse, case):
    """The XLA guidance loop (no guidance_pallas) on the candidate-minor
    loss: the port's autograd Adam against JAX's."""
    cfg_j, cfg_t, fj, ft, mu = _build(seed=11, **case)
    cfg_j = cfg_j.with_(guidance_reuse_selection=reuse)
    cfg_t = cfg_t.with_(guidance_reuse_selection=reuse)
    assert not cfg_t.guidance_pallas
    beta = 0.02
    ctx = jdiff.make_guidance_ctx(None, fj.valid_r, None, fj)
    xla = jdiff._guidance_step(jnp.asarray(mu), jnp.float32(beta), ctx,
                               cfg_j, maximize=True)
    calls = []
    real = ft.freeze_cm
    ft.freeze_cm = lambda m: calls.append(1) or real(m)
    out = tdiff._guidance_step(ft._to_cand_minor(torch.as_tensor(mu)),
                               torch.tensor(beta), ft, cfg_t, True)
    assert len(calls) == int(reuse)
    assert not out.requires_grad
    got = ft._from_cand_minor(out)
    _close(got, xla)
    assert np.abs(np_(got) - mu).max() > 1e-4       # guidance moved mu
