"""The baselines' heads of ``pstl_tpu_torch.models.net.Net`` against the
flax ``Net`` on the same converted parameters and inputs (CPU): the VAE on
multi-candidate rows (its trajopt controls encoded) and from a prior latent
(``sample=``), the BC head and the headless policy, each with the init hint
on and off, in fp32 and bf16; the hint term of ``make_cm_eps_fn``; the
converter's state dict for every head.

Small size: 2 scenes, M = 4, K = 3, hiddens (32, 32), vae_dim 8.
Tolerances are ``tests/test_torch_net.py``'s: fp32 rtol / atol 1e-5 (matmul
sums in another order); bf16 one bf16 step (2^-8) of the output's largest
magnitude, as both frameworks round every matmul output and bias add to
bf16 and may round an intermediate the other way after a sum taken in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import specs as jspecs
from pstl_tpu.config import Config as JConfig
from pstl_tpu.models import Net as JNet
from pstl_tpu.models import net as jnet
from pstl_tpu_torch import specs as tspecs
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.models import convert
from pstl_tpu_torch.models import net as tnet

from test_torch_net import BF16_REL, _inputs
from torch_parity import F32, np_, to_t

BASE = dict(n_randoms=4, n_neighbors=3, hiddens=(32, 32), vae_dim=8,
            flex=True)
#: the heads by name: their flags
HEADS = {
    "vae": dict(vae=True),
    "bc": dict(bc=True),
    "headless": dict(gt_data_training=True),
    "diffusion": dict(diffusion=True),
}


def _setup(head, hint, dtype="float32", bs=2, seed=0):
    """Both packages' configs, nets (flax params converted), dense batches
    (the init hint a random control seed a row) and the ext of the head's
    forward with random latent noise and trajopt controls."""
    flags = dict(BASE, compute_dtype=dtype, use_init_hint=hint,
                 **HEADS[head])
    cfg_j = JConfig(**flags).finalize()
    cfg_t = TConfig(**flags).finalize()
    batch, stlp, x_cm, u, _ = _inputs(dict(BASE, diffusion=True), bs, seed)
    rng = np.random.RandomState(seed + 7)
    n = stlp.shape[0]
    rows = n if cfg_j.multi_check else bs
    batch["params_init"] = (rng.randn(rows, cfg_j.nt, 2)
                            * [0.05, 2.0]).astype(F32)
    gt = stlp.reshape(bs, -1, 6)[:, 0]
    dj = jspecs.densify_batch({k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.asarray(gt), cfg_j,
                              stlp_dense=jnp.asarray(stlp))
    dt = tspecs.densify_batch(to_t(batch), torch.as_tensor(gt), cfg_t,
                              torch.as_tensor(stlp))
    hl = np.asarray(dj["highlevel_dense"])
    ext = {"highlevel": hl,
           "noise": rng.randn(n, cfg_j.vae_dim).astype(F32),
           "trajopt_controls": u,
           "timestep": np.full((n, 1), 7.0, F32)}
    if head == "diffusion":
        ext["noise"] = u.reshape(n, -1)
    if head == "headless":
        ext = {"gt_stlp": gt, "highlevel": batch["gt_high_level"]}
    net_j = JNet(cfg_j)
    ext_j = {k: jnp.asarray(v) for k, v in ext.items()}
    params = net_j.init(jax.random.PRNGKey(1), dj, ext_j,
                        method=JNet.init_all)
    net_t = tnet.Net(cfg_t)
    net_t.load_state_dict(convert.from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return (cfg_j, cfg_t, net_j, params, net_t.eval(), dj, dt, ext_j,
            to_t(ext), x_cm)


def _close(got, want, bf16, what):
    want = np_(want)
    if bf16:
        np.testing.assert_allclose(np_(got), want, rtol=0,
                                   atol=BF16_REL * np.abs(want).max(),
                                   err_msg=what)
    else:
        np.testing.assert_allclose(np_(got), want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)


CASES = [(head, hint, dtype) for head in ("vae_encode", "vae_prior", "bc",
                                          "headless")
         for hint in (False, True) for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("case,hint,dtype", CASES)
def test_head_forward_matches_flax(case, hint, dtype):
    """Each head's controls (and the VAE's latent statistics) against the
    flax forward on the same inputs."""
    head = case.split("_")[0]
    (cfg_j, cfg_t, net_j, params, net_t, dj, dt, ext_j, ext_t,
     _) = _setup(head, hint, dtype)
    bf16 = dtype == "bfloat16"
    kw_j, kw_t = {}, {}
    if case == "vae_prior":
        z = np.random.RandomState(3).randn(
            dj["stlp_dense"].shape[0], cfg_j.vae_dim).astype(F32)
        kw_j = {"sample": jnp.asarray(z)}
        kw_t = {"sample": torch.as_tensor(z)}
    with torch.no_grad():
        out_j = net_j.apply(params, dj, ext_j, **kw_j)
        out_t = net_t(dt, ext_t, **kw_t)
    if head == "vae":
        (u_j, stats_j), (u_t, stats_t) = out_j, out_t
        for name, a, b in zip(("mean", "logstd", "std"), stats_t, stats_j):
            if case == "vae_prior":
                assert a is None and b is None
            else:
                _close(a, b, bf16, name)
    else:
        u_j, u_t = out_j, out_t
    rows = dj["stlp_dense"].shape[0] if cfg_t.multi_check \
        else dj["ego_traj"].shape[0]
    assert tuple(u_t.shape) == (rows, cfg_t.nt, 2)
    _close(u_t, u_j, bf16, "controls")
    # tanh-bounded controls, and the hint moves them
    assert float(u_t[..., 0].abs().max()) <= cfg_t.mul_w_max
    assert float(u_t[..., 1].abs().max()) <= cfg_t.mul_a_max
    if hint:
        dt2 = dict(dt, params_init=dt["params_init"] * 0 + 1.0)
        with torch.no_grad():
            out2 = net_t(dt2, ext_t, **kw_t)
        u2 = out2[0] if head == "vae" else out2
        assert float((u2 - u_t).abs().max()) > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cm_eps_with_hint_matches_fused_forward(dtype):
    """The candidate-minor epsilon MLP with the hint term in its base
    against the flax ``make_cm_eps_fn`` and, in fp32, against the port's
    own fused diffusion forward on the same rows."""
    (cfg_j, cfg_t, net_j, params, net_t, dj, dt, ext_j, ext_t,
     x_cm) = _setup("diffusion", True, dtype)
    bf16 = dtype == "bfloat16"
    with torch.no_grad():
        _, fj = net_j.apply(params, dj, ext_j, get_feature=True)
        _, ft = net_t(dt, ext_t, get_feature=True)
        eps_j = jnet.make_cm_eps_fn(params, dj, dj["highlevel_dense"], fj,
                                    cfg_j)(jnp.asarray(x_cm),
                                           jnp.float32(7.0))
        cm = tnet.make_cm_eps_fn(net_t, dt, dt["highlevel_dense"], ft, cfg_t)
        eps_t = cm(torch.as_tensor(x_cm), 7)
        _close(eps_t, eps_j, bf16, "eps_cm")
        # the fused forward on the same x, row r = j*M + m of scene b at
        # dense row (b*M + m)*3 + j; in bf16 the split layer 1 rounds its
        # blocks' partial sums where the fused one rounds their total
        bs, nt, _, R = x_cm.shape
        M = cfg_t.n_randoms
        x_rows = torch.as_tensor(x_cm).reshape(bs, nt * 2, 3, M).permute(
            0, 3, 2, 1).reshape(bs * M * 3, nt * 2)
        fused = net_t(dt, dict(ext_t, noise=x_rows,
                               timestep=torch.full((bs * R, 1), 7.0)),
                      prev_feature=ft)
        fused_cm = fused.reshape(bs, M, 3, nt * 2).permute(
            0, 3, 2, 1).reshape(bs, nt, 2, R)
        if not bf16:
            _close(eps_t, fused_cm, False, "eps_cm vs fused forward")
        # the hint enters the superstep's operands through base_cm only
        no_hint = tnet.make_cm_eps_fn(
            net_t, dict(dt, params_init=dt["params_init"] * 0),
            dt["highlevel_dense"], ft, cfg_t)
        d = (cm.operands["base_cm"] - no_hint.operands["base_cm"]).float()
        assert float(d.abs().max()) > 0
        for k in ("WnwT", "WnaT", "WowT", "WoaT", "bow", "boa"):
            assert torch.equal(cm.operands[k], no_hint.operands[k]), k


@pytest.mark.parametrize("flags", [
    dict(vae=True, use_init_hint=True), dict(vae=True),
    dict(vae=True, collision_loss=1.0), dict(bc=True),
    dict(bc=True, use_init_hint=True), dict(gt_data_training=True)],
    ids=["e3", "vae", "e6", "bc", "bc_hint", "headless"])
def test_converter_maps_every_head(flags):
    """``convert.from_flax`` of a flax head's parameters is the port's
    state dict, key for key and shape for shape; the policy's first layer
    is as wide as ``Config.latent_dim`` says (the hint widens it)."""
    cfg = dict(BASE, **flags)
    head = ("vae" if cfg.get("vae") else "bc" if cfg.get("bc")
            else "headless")
    (cfg_j, cfg_t, _, params, net_t, *_) = _setup(
        head, cfg.get("use_init_hint", False))
    sd = convert.from_flax(jax.tree_util.tree_map(np.asarray, params))
    want = tnet.Net(TConfig(**cfg).finalize()).state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    F = 7 * tnet.Net.FEAT_DIM
    assert want["policy_net.layers.0.weight"].shape[1] == \
        F + cfg_t.latent_dim
    assert ("traj_encoder.layers.0.weight" in want) == bool(cfg.get("vae"))
