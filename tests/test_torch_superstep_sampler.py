"""The reverse pass under ``guidance_pallas_superstep`` on the CPU: the
port's ``reverse_sample`` (one superstep call per denoise step) against
the JAX package's, which runs ``_reverse_superstep`` with the Pallas
superstep kernel in interpret mode.  Same net, scenes and sampler draws
(the JAX key chain replayed and fed to the torch sampler).

Both sides run the superstep's cast points (``_eps_mlp_k``), so the port is
held to JAX's superstep, not to its cm sampler.  Small size and tolerance
as tests/test_torch_diffusion.py: fp32 compute, 1e-4 on controls and every
per-step decoding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff
from pstl_tpu import specs as jspecs
from pstl_tpu.models import net as jnet
from pstl_tpu_torch import diffusion as tdiff
from pstl_tpu_torch import specs as tspecs
from pstl_tpu_torch.models import net as tnet
from pstl_tpu_torch.ops import superstep_kernel as sk

from test_torch_diffusion import _setup as sampler_setup
from torch_parity import jax_cm_noise, np_

SUPERSTEP = dict(guidance_pallas_superstep=True, pallas_interpret=True)


@pytest.mark.parametrize("sched", [{}, {"guidance_before": 4}],
                         ids=["always_guided", "guidance_before_4"])
def test_reverse_superstep_matches_jax(sched, monkeypatch):
    cfg_j, cfg_t, dj, dt, net_j, params, net_t, states = sampler_setup()
    cfg_j = cfg_j.with_(**SUPERSTEP, **sched).finalize()
    cfg_t = cfg_t.with_(**SUPERSTEP, **sched).finalize()
    trig = tdiff._trigger_schedule(cfg_t)
    assert trig.any() and (trig.all() == (not sched))
    bs = states.shape[0]
    n = bs * cfg_j.n_randoms * 3
    hl = dj["highlevel_dense"]
    ext0 = {"timestep": jnp.ones((n, 1)), "highlevel": hl,
            "noise": jnp.zeros((n, 40))}
    _, feat_j = net_j.apply(params, dj, ext0, get_feature=True)
    valid_j = dj["valids_dense"].reshape(-1)
    fj = jspecs.make_guidance_loss(dj, dj, cfg_j, jnp.asarray(states),
                                   valid_j)
    ctx = jdiff.make_guidance_ctx(None, valid_j, None, fj)
    cm_j = jnet.make_cm_eps_fn(params, dj, hl, feat_j, cfg_j)
    key = jax.random.PRNGKey(7)
    ctrl_j, steps_j = jax.jit(lambda k: jdiff.reverse_sample(
        k, None, dj, hl, feat_j, cfg_j, jdiff.get_coeffs(cfg_j), n,
        guidance_ctx=ctx, maximize=True, cm_fn=cm_j))(key)

    ft = tspecs.make_guidance_loss(dt, dt, cfg_t, torch.as_tensor(states),
                                   dt["valids_dense"].reshape(-1))
    guided = []
    real = sk.superstep
    monkeypatch.setattr(sk, "superstep",
                        lambda *a: guided.append(a[-1]) or real(*a))
    monkeypatch.setattr(tdiff, "_guidance_step", None)   # never reached
    with torch.no_grad():
        feat_t = torch.repeat_interleave(net_t.encode(dt),
                                         3 * cfg_t.n_randoms, 0)
        cm_t = tnet.make_cm_eps_fn(net_t, dt, dt["highlevel_dense"], feat_t,
                                   cfg_t)
        noise = jax_cm_noise(key, cfg_t.diffusion_steps,
                             (bs, 20, 2, 3 * cfg_t.n_randoms))
        ctrl_t, steps_t = tdiff.reverse_sample(
            cm_t, ft, cfg_t, tdiff.get_coeffs(cfg_t), maximize=True,
            noise=noise)
    assert guided == list(trig)        # one superstep call per step
    assert steps_t.shape == steps_j.shape == (10, n, 20, 2)
    np.testing.assert_allclose(np_(steps_t[0]), np_(steps_j[0]), 0, 0)
    np.testing.assert_allclose(np_(steps_t), np_(steps_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np_(ctrl_t), np_(ctrl_j), rtol=1e-4,
                               atol=1e-4)
