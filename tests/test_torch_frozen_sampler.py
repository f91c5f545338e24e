"""The reverse pass around the frozen-payload guidance path, against
``pstl_tpu.diffusion`` on the CPU with pinned noise (the JAX key chain's
draws fed to the torch sampler):

- ``_refresh_schedule``, the static refresh mask of the
  ``guidance_sel_every`` carry;
- ``reverse_sample`` with the carry (``guidance_sel_every`` 2 and 3), the
  frozen selections refreshed on every k-th guided step and read by the
  frozen-payload kernel's plain version or the XLA loop; the JAX side runs
  its XLA loop on the carried selections, which the JAX tests hold equal to
  the Pallas frozen-payload kernel;
- the unguided pass (``guidance=False``, ``bench.py``'s ``parity_nog``
  row) at the bf16 compute dtype: row-major, with eps from the network's
  diffusion forward, as in JAX.

Tolerances: 1e-4 on controls with guidance (as tests/test_torch_diffusion.py).
That holds where no freeze argmin sits on a near-tie: the two packages roll
out in fp32 with sums in another order, and a refresh that flips one
column's selection moves it within the trust region (with PRNGKey(11) and
k=3, two of 9600 control values differ by 1.7e-4).  Unguided at bf16: one
bf16 step (2^-8) of the largest |control| (both frameworks round every
matmul output and bias add to bf16, with fp32 sums taken in another order,
so an intermediate can round the other way; see tests/test_torch_net.py);
measured 2.9e-6 on this problem, where the candidate-minor pass the port
ran before (split layer 1) was off by 4.4e-2 against a bound of 2.0e-2.
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
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.models import net as tnet

from test_torch_diffusion import _setup
from torch_parity import jax_cm_noise, np_

BF16_REL = 2.0 ** -8


@pytest.mark.parametrize("sched,k", [
    (dict(), 2), (dict(), 3), (dict(guidance_before=10), 4),
    (dict(guidance_sets=(1, 5, 7, 8, 12)), 2),
    (dict(guidance_freq=3, guidance_reverse=True), 3),
    (dict(guidance=False), 2)])
def test_refresh_schedule_matches_jax(sched, k):
    cfg = TConfig(diffusion=True, guidance=True, diffusion_steps=20).with_(
        **sched)
    trig = tdiff._trigger_schedule(cfg)
    got = tdiff._refresh_schedule(trig, k)
    np.testing.assert_array_equal(got, jdiff._refresh_schedule(trig, k))
    assert got.dtype == np.bool_
    if trig.any():
        assert got[np.argmax(trig)]          # the first guided step refreshes
    assert not (got & ~trig).any()


def _jax_reverse(cfg_j, dj, net_j, params, states, key, guided=True):
    """pstl_tpu.diffusion.reverse_sample on the candidate-minor path (with
    guidance) or row-major (without)."""
    n = states.shape[0] * cfg_j.n_randoms * 3
    hl = dj["highlevel_dense"]
    ext0 = {"timestep": jnp.ones((n, 1)), "highlevel": hl,
            "noise": jnp.zeros((n, cfg_j.nt * 2))}
    _, feat = net_j.apply(params, dj, ext0, get_feature=True)
    if guided:
        valid = dj["valids_dense"].reshape(-1)
        fj = jspecs.make_guidance_loss(dj, dj, cfg_j, jnp.asarray(states),
                                       valid)
        ctx = jdiff.make_guidance_ctx(None, valid, None, fj)
        cm = jnet.make_cm_eps_fn(params, dj, hl, feat, cfg_j)
        apply_fn = None
    else:
        ctx = cm = None
        apply_fn = lambda e: net_j.apply(params, dj, e, prev_feature=feat)
    return jax.jit(lambda k: jdiff.reverse_sample(
        k, apply_fn, dj, hl, feat, cfg_j, jdiff.get_coeffs(cfg_j), n,
        guidance_ctx=ctx, maximize=True, cm_fn=cm))(key)


@pytest.mark.parametrize("k,route", [(2, "frozen"), (3, "xla"), (2, "xla"),
                                     (3, "frozen")])
def test_sel_every_reverse_matches_jax(k, route):
    """The guidance_sel_every carry on pinned noise: the port's frozen
    kernel (plain version) or XLA loop against the JAX XLA loop."""
    cfg_t_kw = dict(guidance_pallas=True) if route == "frozen" else {}
    cfg_j, cfg_t, dj, dt, net_j, params, net_t, states = _setup(
        guidance_sel_every=k, cfg_t_kw=cfg_t_kw)
    assert cfg_t.guidance_sel_every == k
    assert cfg_t.guidance_pallas == (route == "frozen")
    assert not cfg_t.guidance_pallas_fuse_freeze
    key = jax.random.PRNGKey(12)
    ctrl_j, steps_j = _jax_reverse(cfg_j, dj, net_j, params, states, key)

    bs = states.shape[0]
    ft = tspecs.make_guidance_loss(dt, dt, cfg_t, torch.as_tensor(states),
                                   dt["valids_dense"].reshape(-1))
    calls = []
    real = ft.freeze_cm
    ft.freeze_cm = lambda m: calls.append(1) or real(m)
    with torch.no_grad():
        feat = torch.repeat_interleave(net_t.encode(dt),
                                       3 * cfg_t.n_randoms, 0)
        cm = tnet.make_cm_eps_fn(net_t, dt, dt["highlevel_dense"], feat,
                                 cfg_t)
        noise = jax_cm_noise(key, cfg_t.diffusion_steps,
                             (bs, cfg_t.nt, 2, 3 * cfg_t.n_randoms))
        ctrl_t, steps_t = tdiff.reverse_sample(
            cm, ft, cfg_t, tdiff.get_coeffs(cfg_t), maximize=True,
            noise=noise)
    guided = int(tdiff._trigger_schedule(cfg_t).sum())
    assert len(calls) == -(-guided // k)         # one freeze per refresh
    np.testing.assert_allclose(np_(steps_t), np_(steps_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np_(ctrl_t), np_(ctrl_j), rtol=1e-4,
                               atol=1e-4)


def test_unguided_pass_is_row_major_bf16():
    """guidance=False at compute_dtype=bfloat16 (the parity_nog row): the
    port's pass equals JAX's row-major pass with guidance_ctx=None."""
    cfg_j, cfg_t, dj, dt, net_j, params, net_t, states = _setup(
        guidance=False, compute_dtype="bfloat16")
    key = jax.random.PRNGKey(5)
    ctrl_j, steps_j = _jax_reverse(cfg_j, dj, net_j, params, states, key,
                                   guided=False)
    n = states.shape[0] * cfg_t.n_randoms * 3
    D = cfg_t.nt * 2
    with torch.no_grad():
        feat = torch.repeat_interleave(net_t.encode(dt),
                                       3 * cfg_t.n_randoms, 0)

        def eps_fn(x, t):
            ext = {"timestep": torch.full((n, 1), float(t)),
                   "highlevel": dt["highlevel_dense"], "noise": x}
            return net_t(dt, ext, prev_feature=feat).reshape(n, D)

        noise = jax_cm_noise(key, cfg_t.diffusion_steps, (n, D))
        ctrl_t, steps_t = tdiff.reverse_sample(
            None, None, cfg_t, tdiff.get_coeffs(cfg_t), maximize=True,
            noise=noise, eps_fn=eps_fn, n=n)
        with pytest.raises(ValueError):       # noise in the cm layout
            tdiff.reverse_sample(
                None, None, cfg_t, tdiff.get_coeffs(cfg_t),
                noise=noise.reshape(cfg_t.diffusion_steps, 2, 20, 2, -1),
                eps_fn=eps_fn, n=n)
    assert steps_t.shape == steps_j.shape == (cfg_t.diffusion_steps, n,
                                              cfg_t.nt, 2)
    np.testing.assert_array_equal(np_(steps_t[0]), np_(steps_j[0]))
    ref = np_(steps_j)
    np.testing.assert_allclose(np_(steps_t), ref, rtol=0,
                               atol=BF16_REL * np.abs(ref).max())
