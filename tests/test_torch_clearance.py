"""The clearance kernels' plain versions (``pstl_tpu_torch/ops/
clearance_kernel.py``) against the Pallas kernels of
``pstl_tpu/ops/pallas_kernels.py`` in interpret mode, and the port's
``geometry.min_neighbor_distance`` against JAX's, on the same seeded numpy
inputs.

Tolerances: the forward to 1e-5 (the same float32 ops in the same order,
up to 1-ulp differences of cos / sin / sqrt between the libraries); the
VJP to rtol 1e-4 (one routed cotangent per (row, t), the same chain of
float32 products and quotients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pstl_tpu.ops import geometry as jgeom
from pstl_tpu.ops import pallas_kernels as pk
from pstl_tpu_torch.ops import clearance_kernel as ck
from pstl_tpu_torch.ops import geometry as tgeom

from torch_parity import np_

L, W = 4.084, 1.73


def make_inputs(seed=0, n=37, K=8, T=20, clip_region=False):
    """chip_smoke's clearance inputs (tests/test_pallas_kernels.py's, about
    30 % invalid neighbors; ``clip_region`` puts clearances on both sides of
    the clip bound) as numpy arrays."""
    return tuple(x.numpy() for x in chip_smoke.clearance_random_inputs(
        n, K, T, seed=seed, clip_region=clip_region))


@pytest.mark.parametrize("n,block_n,clip_region", [
    (37, 16, False), (9, 8, False), (40, 8, True)],
    ids=["pad37", "pad9", "clip_region"])
def test_forward_matches_pallas(n, block_n, clip_region):
    """Also the padding sizes: n not a multiple of the TPU block."""
    ego, nei = make_inputs(seed=n, n=n, clip_region=clip_region)
    want = pk.min_clearance(jnp.asarray(ego), jnp.asarray(nei), L, W, 4,
                            block_n=block_n, interpret=True)
    got = ck.min_clearance_fwd_plain(torch.as_tensor(ego),
                                     torch.as_tensor(nei), L, W, 4)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if clip_region:
        per = np_(got)
        assert (per < 0).any() and (per == 20).any()


@pytest.mark.parametrize("n,clip_region", [(13, False), (24, True)],
                         ids=["random", "clip_region"])
def test_backward_matches_pallas_vjp(n, clip_region):
    ego, nei = make_inputs(seed=10 + n, n=n, clip_region=clip_region)
    g = np.random.RandomState(n).randn(n, 20).astype(np.float32)
    _, vjp = jax.vjp(lambda e: pk.min_clearance(e, jnp.asarray(nei), L, W,
                                                4, block_n=8,
                                                interpret=True),
                     jnp.asarray(ego))
    want, = vjp(jnp.asarray(g))
    got = ck.min_clearance_bwd_plain(torch.as_tensor(ego),
                                     torch.as_tensor(nei),
                                     torch.as_tensor(g), L, W, 4)
    assert np.abs(np.asarray(want)).max() > 0
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


def test_autograd_function_is_the_vjp():
    """MinClearance's backward is the hand-written VJP (on the CPU its plain
    version), and the neighbors get no gradient."""
    ego, nei = make_inputs(seed=5, n=11, clip_region=True)
    e = torch.as_tensor(ego).requires_grad_(True)
    nt = torch.as_tensor(nei).requires_grad_(True)
    out = ck.min_clearance(e, nt, L, W, 4)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    out.backward(g)
    want = ck.min_clearance_bwd_plain(torch.as_tensor(ego),
                                      torch.as_tensor(nei), g, L, W, 4)
    assert torch.equal(e.grad, want)
    assert nt.grad is None
    assert ck.fwd_launches == 0 and ck.bwd_launches == 0


def test_all_invalid_neighbors():
    ego, nei = make_inputs(seed=2, n=5)
    nei[..., 0] = 0.0
    e = torch.as_tensor(ego).requires_grad_(True)
    out = ck.min_clearance(e, torch.as_tensor(nei), L, W, 4)
    want = pk.min_clearance(jnp.asarray(ego), jnp.asarray(nei), L, W, 4,
                            block_n=8, interpret=True)
    np.testing.assert_array_equal(np_(out), np.asarray(want))
    np.testing.assert_allclose(np_(out), 100.0)
    out.sum().backward()
    assert torch.equal(e.grad, torch.zeros_like(e))


def test_dropin_matches_jax_dropin():
    """min_neighbor_distance_fused builds the 7-column neighbor rows as the
    JAX drop-in does, forward and gradient."""
    ego, nei = make_inputs(seed=4, n=8, clip_region=True)
    ego4 = np.concatenate([ego, np.ones_like(ego[..., :1])], -1)

    def jax_loss(e):
        return jnp.sum(jnp.tanh(pk.min_neighbor_distance_fused(
            e, jnp.asarray(nei[..., 1:7]), jnp.asarray(nei[..., 0]), L, W, 4,
            1, block_n=8, interpret=True)))

    want, g_want = jax.value_and_grad(jax_loss)(jnp.asarray(ego4))
    e = torch.as_tensor(ego4).requires_grad_(True)
    got = torch.sum(torch.tanh(ck.min_neighbor_distance_fused(
        e, torch.as_tensor(nei[..., 1:7]), torch.as_tensor(nei[..., 0]),
        L, W, 4)))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(np_(e.grad), np.asarray(g_want), rtol=1e-4,
                               atol=1e-6)
    assert float(e.grad[..., 3].abs().max()) == 0.0


@pytest.mark.parametrize("full", [False, True])
def test_min_neighbor_distance_matches_jax(full):
    """The XLA path JAX takes with use_pallas_clearance off (and the
    calibration's clearance)."""
    ego, nei = make_inputs(seed=7, n=12, clip_region=True)
    ego4 = np.concatenate([ego, np.ones_like(ego[..., :1])], -1)
    want = jgeom.min_neighbor_distance(
        jnp.asarray(ego4), jnp.asarray(nei[..., 1:7]),
        jnp.asarray(nei[..., 0]), L, W, 4, 1, full=full)
    got = tgeom.min_neighbor_distance(
        torch.as_tensor(ego4), torch.as_tensor(nei[..., 1:7]),
        torch.as_tensor(nei[..., 0]), L, W, 4, 1, full=full)
    if not full:
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_allclose(np_(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_wrapper_dispatch_and_checks():
    """CPU tensors run the plain version; the launch path's checks refuse a
    wrong dtype, shape or layout before anything is built."""
    ego, nei = make_inputs(seed=8, n=4)
    e, nt = torch.as_tensor(ego), torch.as_tensor(nei)
    assert torch.equal(ck.min_clearance_fwd(e, nt, L, W, 4),
                       ck.min_clearance_fwd_plain(e, nt, L, W, 4))
    with pytest.raises(TypeError):
        ck._sizes(e.double(), nt, 4)
    with pytest.raises(ValueError):
        ck._sizes(e, nt[:, :, :-1], 4)
    with pytest.raises(ValueError):
        ck._sizes(e.transpose(0, 1), nt, 4)
    with pytest.raises(ValueError):
        ck._sizes(e, nt, 9)
    with pytest.raises(ValueError):
        ck.min_clearance_fwd(e.to("meta"), nt.to("meta"), L, W, 4)


def test_card_gate_allows_only_near_ties():
    """chip_smoke's kernel-vs-plain gate: every forward element within
    tolerance; a backward element beyond it only where the plain version
    routes the cotangent by a near-tie (here: row 0's neighbors all one
    track, a tie over K at every t)."""
    ego, nei = (torch.as_tensor(x) for x in make_inputs(seed=9, n=64,
                                                         clip_region=True))
    nei[0] = nei[0, :1]
    nei[0, :, :, 0] = 1.0
    nei[0, :, :, 1:3] = ego[0, :, :2] + 1.0
    near = chip_smoke.clearance_near_ties(ego, nei, L, W, 4,
                                          chip_smoke.CLEAR_TIE_M)
    assert near[0].all() and not near[1:].all()
    g = torch.randn((64, 20), generator=torch.Generator().manual_seed(0))
    ref = ck.min_clearance_bwd_plain(ego, nei, g, L, W, 4)
    check = lambda got: chip_smoke.clearance_check(
        "backward", got, ref, chip_smoke.CLEAR_BWD_RTOL, near)
    assert check(ref.clone()) == 0.0
    got = ref.clone()
    got[0, 0, 0] += 1.0
    assert check(got) == 1.0
    far = int(torch.nonzero(~near)[0, 0]), int(torch.nonzero(~near)[0, 1])
    got[far[0], far[1], 1] += 1e-3
    with pytest.raises(RuntimeError):
        check(got)
    out = ck.min_clearance_fwd_plain(ego, nei, L, W, 4)
    assert float(out[0].abs().max()) < 5
    bumped = out.clone()
    bumped[0, 0] += 1e-3
    with pytest.raises(RuntimeError):
        chip_smoke.clearance_check("forward", bumped, out,
                                   chip_smoke.CLEAR_FWD_RTOL)
