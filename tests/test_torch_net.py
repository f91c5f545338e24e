"""Policy network, weight conversion and the committed e7_round5 weights:
the torch port against the flax model on the same inputs (CPU).

Tolerances: fp32 compute dtype, rtol/atol 1e-5 at hidden width 32 and
1e-4 at the e7 width 256 (matmul sums in another order; measured 4e-7
relative).  bf16 compute dtype (the model's default): both frameworks
round every matmul output and every bias add to bf16 (8 significant bits)
and accumulate the products in fp32, so they agree to ~2e-7 of the output
scale here; the bound is one bf16 step (2^-8) of the output's largest
magnitude, which allows an intermediate to round the other way after a
sum taken in another order.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import specs as jspecs
from pstl_tpu.config import Config as JConfig
from pstl_tpu.data import synthetic as jsyn
from pstl_tpu.models import Net as JNet
from pstl_tpu.models import net as jnet
from pstl_tpu_torch import specs as tspecs
from pstl_tpu_torch.config import Config as TConfig, bench_config
from pstl_tpu_torch.models import convert
from pstl_tpu_torch.models import net as tnet

from torch_parity import F32, np_, to_t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_REL = 2.0 ** -8


def _inputs(flags, bs=2, seed=0):
    """Dense batch of synthetic scenes at t=0 with random dense stlp, plus
    a cm noise tensor, rect controls and scores."""
    cfg = JConfig(**flags).finalize()
    data = jsyn.generate_dataset(seed, bs, cfg)
    keys = ("ego_traj", "neighbors", "neighbors_traj", "currlane_wpts",
            "leftlane_wpts", "rightlane_wpts", "curr_id", "left_id",
            "right_id", "gt_high_level")
    batch = {k: data[k] for k in keys}
    batch["neighbor_trajs_aug"] = data["neighbors_traj"]
    M = cfg.n_randoms
    n = bs * M * 3
    rng = np.random.RandomState(seed + 1)
    stlp = np.stack([rng.uniform(0, 2, n), rng.uniform(5, 9, n),
                     rng.uniform(-3, -1, n), rng.uniform(1, 3, n),
                     rng.uniform(0.1, 1, n), rng.uniform(0.2, 0.5, n)],
                    -1).astype(F32)[:, None]
    x_cm = rng.randn(bs, cfg.nt, 2, 3 * M).astype(F32)
    u = (rng.randn(n, cfg.nt, 2) * [0.3, 3.0]).astype(F32)
    scores = rng.randn(n).astype(F32)
    return batch, stlp, x_cm, u, scores


def _both(flags, params=None, bs=2):
    """flax net + params and the torch net loaded from them, and the dense
    batch in both frameworks."""
    batch, stlp, x_cm, u, scores = _inputs(flags, bs)
    cfg_j = JConfig(**flags).finalize()
    cfg_t = TConfig(**flags).finalize()
    gt = stlp.reshape(bs, -1, 6)[:, 0]
    dj = jspecs.densify_batch({k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.asarray(gt), cfg_j,
                              stlp_dense=jnp.asarray(stlp))
    dt = tspecs.densify_batch(to_t(batch), torch.as_tensor(gt), cfg_t,
                              torch.as_tensor(stlp))
    net_j = JNet(cfg_j)
    n = stlp.shape[0]
    ext0 = {"timestep": jnp.ones((n, 1)), "highlevel": dj["highlevel_dense"],
            "noise": jnp.zeros((n, cfg_j.nt * 2))}
    if params is None:
        params = net_j.init(jax.random.PRNGKey(1), dj, ext0,
                            method=JNet.init_all)
    net_t = tnet.Net(cfg_t)
    net_t.load_state_dict(convert.from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return cfg_j, cfg_t, net_j, params, net_t, dj, dt, x_cm, u, scores


def _compare(flags, params=None, rtol=1e-5, atol=1e-5, rel=None):
    """encode, the diffusion forward, the cm epsilon MLP and rect agree;
    with ``rel``, to rel * max|reference| instead."""
    (cfg_j, cfg_t, net_j, params, net_t, dj, dt, x_cm, u,
     scores) = _both(flags, params)

    def close(a, b):
        b = np_(b)
        if rel is None:
            np.testing.assert_allclose(np_(a), b, rtol=rtol, atol=atol)
        else:
            np.testing.assert_allclose(np_(a), b, rtol=0,
                                       atol=rel * np.abs(b).max())

    with torch.no_grad():
        feat_j = net_j.apply(params, dj, method=JNet.encode)
        feat_t = net_t.encode(dt)
        close(feat_t, feat_j)
        n = u.shape[0]
        hl_j = dj["highlevel_dense"]
        ext_j = {"timestep": jnp.full((n, 1), 7.0), "highlevel": hl_j,
                 "noise": jnp.asarray(u.reshape(n, -1))}
        ext_t = to_t({"timestep": np.full((n, 1), 7.0, F32),
                      "highlevel": np.asarray(hl_j),
                      "noise": u.reshape(n, -1)})
        out_j, fj = net_j.apply(params, dj, ext_j, get_feature=True)
        out_t, ft = net_t(dt, ext_t, get_feature=True)
        close(out_t, out_j)
        close(ft, fj)
        eps_j = jnet.make_cm_eps_fn(params, dj, hl_j, fj, cfg_j)(
            jnp.asarray(x_cm), jnp.float32(7.0))
        eps_t = tnet.make_cm_eps_fn(net_t, dt, dt["highlevel_dense"], ft,
                                    cfg_t)(torch.as_tensor(x_cm), 7)
        close(eps_t, eps_j)
        rect_j = net_j.apply(params, fj, hl_j, dj["stlp_dense"][:, 0],
                             jnp.asarray(u), jnp.asarray(scores),
                             method=JNet.rect)
        rect_t = net_t.rect(ft, dt["highlevel_dense"], dt["stlp_dense"][:, 0],
                            torch.as_tensor(u), torch.as_tensor(scores))
        close(rect_t, rect_j)


SMALL = dict(diffusion=True, rect_head=True, diverse_loss=True,
             n_randoms=4, n_neighbors=3, hiddens=(32, 32),
             rect_hiddens=(32, 32), flex=True)


def test_net_matches_flax_fp32():
    _compare(dict(SMALL, compute_dtype="float32"))


def test_net_matches_flax_fp32_cat_fuse():
    _compare(dict(SMALL, compute_dtype="float32", diverse_fuse_type="cat",
                  interval=False))


def test_net_matches_flax_bf16():
    _compare(dict(SMALL, compute_dtype="bfloat16"), rel=BF16_REL)


def _load_export_script():
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights",
        os.path.join(REPO, "scripts", "export_torch_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def e7_params():
    """The e7_round5 params as bench.py restores them (orbax)."""
    return _load_export_script().restore_params(
        os.path.join(REPO, "checkpoints", "e7_round5"))


def test_committed_weights_equal_checkpoint(e7_params):
    """pstl_tpu_torch/weights/e7_round5.npz is bit-for-bit what
    train.load_params_only restores, and loads strictly into the torch
    net of the heavy config."""
    flat = convert.flatten(jax.tree_util.tree_map(np.asarray, e7_params))
    with np.load(os.path.join(convert.WEIGHTS_DIR, "e7_round5.npz")) as f:
        assert sorted(f.files) == sorted(flat)
        for k in f.files:
            assert f[k].dtype == np.float32
            np.testing.assert_array_equal(f[k], flat[k], err_msg=k)
    net = tnet.Net(bench_config("heavy"))
    convert.load_weights(net, "e7_round5")


E7 = dict(diffusion=True, rect_head=True, diverse_loss=True, n_randoms=4,
          n_neighbors=8, flex=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_e7_net_matches_flax(e7_params, dtype):
    """Net.encode, the diffusion forward, the split-layer-1 epsilon MLP and
    rect with the e7_round5 weights (width 256)."""
    if dtype == "float32":
        _compare(dict(E7, compute_dtype=dtype), e7_params, 1e-4, 1e-4)
    else:
        _compare(dict(E7, compute_dtype=dtype), e7_params, rel=BF16_REL)
