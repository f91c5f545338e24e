"""Around the superstep kernel, on the CPU: ``make_cm_eps_fn``'s
``operands`` against the JAX package's key for key, the per-step tables
against ``pstl_tpu/diffusion.py:_reverse_superstep``'s, and
``guidance_adam_cm`` under ``guidance_pallas_fold2`` (the fused kernel's
launch on the port) against the Pallas column-grid kernel
``_kernel_fused_f2`` in interpret mode (guidance tolerance of
tests/test_torch_guidance.py: rtol 2e-4 / atol 2e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff
from pstl_tpu.models import net as jnet
from pstl_tpu.models.net import Net as JNet
from pstl_tpu.ops import pallas_guidance as pg
from pstl_tpu_torch import diffusion as tdiff
from pstl_tpu_torch.models import net as tnet
from pstl_tpu_torch.ops import guidance_kernel as gk
from pstl_tpu_torch.ops import superstep_kernel as sk

from test_torch_guidance import _build as guidance_build
from test_torch_net import SMALL, _both
from torch_parity import F32, np_

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cm_eps_operands_match_jax(dtype):
    """``eps_cm.operands`` equals the JAX package's, key for key: the
    weight slices exactly, ``base_cm`` (a matmul) to 1e-5 in fp32 and one
    bf16 step of its scale in bf16."""
    flags = dict(SMALL, compute_dtype=dtype, hiddens=(32, 24, 16))
    (cfg_j, cfg_t, net_j, params, net_t, dj, dt, *_rest) = _both(flags)
    with torch.no_grad():
        fj = net_j.apply(params, dj, method=JNet.encode)
        fj = jnp.repeat(fj, cfg_j.n_randoms * 3, axis=0)
        ft = torch.repeat_interleave(net_t.encode(dt), cfg_t.n_randoms * 3, 0)
        oj = jnet.make_cm_eps_fn(params, dj, dj["highlevel_dense"], fj,
                                 cfg_j).operands
        ot = tnet.make_cm_eps_fn(net_t, dt, dt["highlevel_dense"], ft,
                                 cfg_t).operands
    assert sorted(oj) == sorted(ot)
    assert ot["dt"] == TDT[dtype] and oj["dt"] == JDT[dtype]
    for k in ("bs", "R", "nt"):
        assert ot[k] == oj[k], k
    for k in ("Wt", "WnwT", "WnaT", "WowT", "WoaT", "bow", "boa"):
        assert tuple(ot[k].shape) == tuple(oj[k].shape), k
        np.testing.assert_array_equal(np_(ot[k].float()),
                                      np.asarray(oj[k], F32), err_msg=k)
    assert len(ot["mid"]) == len(oj["mid"]) == 2
    for (Wt_, bt), (Wj, bj) in zip(ot["mid"], oj["mid"]):
        np.testing.assert_array_equal(np_(Wt_.float()), np.asarray(Wj, F32))
        np.testing.assert_array_equal(np_(bt.float()), np.asarray(bj, F32))
    bj = np.asarray(oj["base_cm"], F32)
    assert tuple(ot["base_cm"].shape) == bj.shape
    atol = 1e-5 if dtype == "float32" else 2.0 ** -8 * np.abs(bj).max()
    np.testing.assert_allclose(np_(ot["base_cm"].float()), bj, rtol=1e-5,
                               atol=atol)


@pytest.mark.parametrize("maximize", [True, False])
def test_step_tables_match_jax(maximize):
    """te_all and gvec_all as ``pstl_tpu/diffusion.py:_reverse_superstep``
    builds them."""
    flags = dict(SMALL, compute_dtype="float32", diffusion_steps=12,
                 guidance=True, sample_noise_scale=0.7)
    (cfg_j, cfg_t, net_j, params, net_t, dj, dt, *_rest) = _both(flags)
    fj = jnp.repeat(net_j.apply(params, dj, method=JNet.encode),
                    cfg_j.n_randoms * 3, axis=0)
    oj = jnet.make_cm_eps_fn(params, dj, dj["highlevel_dense"], fj,
                             cfg_j).operands
    with torch.no_grad():
        ft = torch.repeat_interleave(net_t.encode(dt), cfg_t.n_randoms * 3, 0)
        ot = tnet.make_cm_eps_fn(net_t, dt, dt["highlevel_dense"], ft,
                                 cfg_t).operands
    gscale = 0.0125
    te_t, gv_t = sk.step_tables(cfg_t, tdiff.get_coeffs(cfg_t), ot,
                                torch.tensor(gscale), maximize)
    T = cfg_j.diffusion_steps
    ts = jnp.arange(T - 1, 0, -1)
    te_j = jnet.pos_encoding(ts[:, None].astype(jnp.float32),
                             JNet.TIME_DIM).astype(oj["dt"]) @ oj["Wt"]
    co = jdiff.get_coeffs(cfg_j)
    beta, alpha, ahat = co.beta[ts], co.alpha[ts], co.alpha_hat[ts]
    ones = jnp.ones_like(beta)
    thres = 100.0 if maximize else cfg_j.stl_nn_thres
    gv_j = jnp.stack([beta, thres * ones, gscale * ones,
                      (1 - alpha) / jnp.sqrt(1 - ahat), jnp.sqrt(alpha),
                      cfg_j.sample_noise_scale * jnp.sqrt(beta),
                      0 * ones, 0 * ones], axis=1)
    np.testing.assert_allclose(np_(te_t), np.asarray(te_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np_(gv_t), np.asarray(gv_j), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("cols", [0, 12])
def test_fold2_matches_pallas_interpret(cols):
    """``guidance_adam_cm`` under ``guidance_pallas_fold2`` (the port runs
    the fused kernel's launch) against the Pallas column-grid kernel
    ``_kernel_fused_f2`` in interpret mode; cols=12 cuts the TPU grid
    through scene 0's columns, which the port ignores."""
    cfg_j, cfg_t, fj, ft, mu = guidance_build(
        seed=13, clearance_coarse_pair=True, guidance_pallas_bf16_cumsum=True,
        guidance_pallas_fold2=True, guidance_pallas_cols=cols)
    assert cfg_t.guidance_pallas_fold2 and cfg_t.guidance_pallas_fuse_freeze
    beta = 0.02
    pal = pg.guidance_adam_cm(fj, None, fj._to_cand_minor(jnp.asarray(mu)),
                              jnp.float32(beta), 100.0, cfg_j, interpret=True,
                              fuse_freeze=True)
    before = gk.launches
    out = gk.guidance_adam_cm(ft, None,
                              ft._to_cand_minor(torch.as_tensor(mu)),
                              torch.tensor(beta), 100.0, cfg_t,
                              fuse_freeze=cfg_t.guidance_pallas_fuse_freeze)
    assert gk.launches == before           # CPU tensors: the plain version
    np.testing.assert_allclose(np_(out), np_(pal), rtol=2e-4, atol=2e-5)
    assert np.abs(np_(ft._from_cand_minor(out)) - mu).max() > 1e-4


def _random_ops(hiddens, T, dtype, seed=0, bs=2, R=6):
    """``eps_cm.operands``-shaped random MLP pieces with the given hidden
    widths (each matrix the first bf16 values from 1.0 up, shuffled: exact
    and all different, so a permutation shows)."""
    rng = np.random.RandomState(seed)

    def mat(*shape):
        n = int(np.prod(shape))
        bits = torch.arange(n, dtype=torch.int16) + 0x3f80   # 1.0 upwards
        vals = bits.view(torch.bfloat16)[torch.as_tensor(rng.permutation(n))]
        return vals.reshape(shape).to(dtype)

    dims = list(hiddens)
    return dict(
        base_cm=torch.zeros((bs, dims[0], R), dtype=dtype),
        WnwT=mat(dims[0], T), WnaT=mat(dims[0], T),
        mid=[(mat(b, a), torch.zeros((b, 1), dtype=dtype))
             for a, b in zip(dims, dims[1:])],
        WowT=mat(T, dims[-1]), WoaT=mat(T, dims[-1]),
        bow=torch.zeros((T, 1), dtype=dtype),
        boa=torch.zeros((T, 1), dtype=dtype))


def _fragment_order(W, n_mult):
    """The B operand of ``mma.sync.aligned.m16n8k16.row.col`` for W^T
    (n_out, n_in), written out lane by lane from the instruction's fragment
    layout: lane = 4*g + q holds, in register b_r of a 16-deep k-step, the
    pair k = 8*r + 2*q + {0, 1} of output n = g."""
    n_out, n_in = W.shape
    Np = -(-n_out // n_mult) * n_mult
    Kp = -(-n_in // 32) * 32
    Wp = np.zeros((Np, Kp), np.float32)
    Wp[:n_out, :n_in] = W
    out = []
    for nt in range(Np // 8):
        for kk in range(Kp // 32):              # two k-steps per 16 bytes
            for lane in range(32):
                g, q = lane // 4, lane % 4
                for kstep in range(2):
                    for r in range(2):
                        for h in range(2):
                            out.append(Wp[nt * 8 + g, kk * 32 + kstep * 16
                                          + r * 8 + q * 2 + h])
    return np.array(out, np.float32), Wp


@pytest.mark.parametrize("hiddens,T", [((32,), 20), ((7, 5), 3),
                                       ((9, 3, 5), 4), ((33,), 12)],
                         ids=["nmid0", "nmid1_odd", "nmid2_odd", "odd_33"])
def test_packed_weights_are_a_permutation(hiddens, T):
    """``mlp_operands`` packs every bf16 matrix into the tensor-core
    kernel's fragment order: the zero-padded operand, permuted, nothing
    lost and nothing twice; float32 weights are not packed."""
    ops = _random_ops(hiddens, T, torch.bfloat16)
    mlp = sk.mlp_operands(ops)
    assert mlp.packed is not None and len(mlp.packed.mid) == len(mlp.mid)
    pairs = [(mlp.WnwT, mlp.packed.Wnw, 32), (mlp.WnaT, mlp.packed.Wna, 32),
             (torch.cat([mlp.WowT, mlp.WoaT]), mlp.packed.Wo, 8)]
    pairs += [(W, P, 32) for (W, _), P in zip(mlp.mid, mlp.packed.mid)]
    for W, P, n_mult in pairs:
        assert P.dtype == torch.bfloat16 and P.is_contiguous()
        want, Wp = _fragment_order(np_(W.float()), n_mult)
        np.testing.assert_array_equal(np_(P.float()), want)
        np.testing.assert_array_equal(np.sort(np_(P.float())),
                                      np.sort(Wp.reshape(-1)))
        assert P.numel() % (32 * 8) == 0       # whole 16-byte lanes
        assert int((P != 0).sum()) == W.numel()
    assert sk.mlp_operands(_random_ops(hiddens, T, torch.float32)
                           ).packed is None


def test_no_hidden_layer_is_refused():
    """``hiddens=()`` is not a configuration of the split MLP: layer 1 would
    be the output layer, and the operands ``make_cm_eps_fn`` then makes do
    not chain.  ``mlp_operands`` (which the superstep sampler calls once per
    plan) refuses them by name, before the plain version or the kernel sees
    them."""
    import chip_smoke
    from pstl_tpu_torch.config import bench_config
    cfg = bench_config("heavy", gpallas="4").with_(hiddens=(), n_randoms=2)
    torch.manual_seed(0)
    net = tnet.Net(cfg).eval()
    scenes = chip_smoke.scene_batch(cfg, torch.device("cpu"), n_scenes=1)
    with pytest.raises(ValueError, match="at least one hidden layer"):
        chip_smoke.superstep_inputs(cfg, scenes, net)
    ops = _random_ops((32,), 20, torch.float32)
    ops["WowT"] = ops["WowT"][:, :-1]
    with pytest.raises(ValueError, match="at least one hidden layer"):
        sk.mlp_operands(ops)
