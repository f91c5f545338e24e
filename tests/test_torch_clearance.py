"""The clearance kernels' plain versions (``pstl_tpu_torch/ops/
clearance_kernel.py``) against the Pallas kernels of
``pstl_tpu/ops/pallas_kernels.py`` in interpret mode, and the port's
``geometry.min_neighbor_distance`` against JAX's, on the same seeded numpy
inputs.

Tolerances: the forward to 1e-5 (the same float32 ops in the same order,
up to 1-ulp differences of cos / sin / sqrt between the libraries); the
VJP to rtol 1e-4 (one routed cotangent per (row, t), the same chain of
float32 products and quotients).  Per-scene neighbors (``rows_per_scene``)
against the repeated layout, and the backward kernel's two-pass routing
(``bwd_twin``) against the plain version: exactly, bit for bit.
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


# --------------------------------------------------------------------------
# per-scene neighbors (rows_per_scene = m)
# --------------------------------------------------------------------------

def scene_inputs(m, scenes=5, K=4, seed=0):
    """Ego rows for ``scenes`` scenes x m, per-scene neighbors placed around
    each scene's first row, their copy repeated per row, and a cotangent."""
    ego, rep = (torch.as_tensor(x) for x in make_inputs(
        seed=seed + m, n=scenes * m, K=K, clip_region=True))
    nei = rep[::m].contiguous()
    g = torch.randn((scenes * m, 20),
                    generator=torch.Generator().manual_seed(seed))
    return ego, nei, torch.repeat_interleave(nei, m, 0), g


@pytest.mark.parametrize("m", [1, 3, 8])
def test_shared_neighbors_equal_repeated(m):
    """Plain forward, plain backward and MinClearance: per-scene neighbors
    with rows_per_scene = m give the repeated layout's bits."""
    ego, nei, rep, g = scene_inputs(m)
    out = ck.min_clearance_fwd(ego, nei, L, W, 4, m)
    assert torch.equal(out, ck.min_clearance_fwd_plain(ego, rep, L, W, 4))
    assert (out < 20).any()
    d_rep = ck.min_clearance_bwd_plain(ego, rep, g, L, W, 4)
    assert float(d_rep.abs().max()) > 0
    assert torch.equal(ck.min_clearance_bwd(ego, nei, g, L, W, 4, m), d_rep)
    e = ego.clone().requires_grad_(True)
    auto = ck.min_clearance(e, nei, L, W, 4, m)
    auto.backward(g)
    assert torch.equal(auto.detach(), out) and torch.equal(e.grad, d_rep)
    e4 = torch.cat([ego, torch.ones_like(ego[..., :1])], -1)
    assert torch.equal(ck.min_neighbor_distance_fused(
        e4, nei[..., 1:7], nei[..., 0], L, W, 4, m), out)


@pytest.mark.parametrize("m", [1, 3, 8])
def test_shared_neighbors_match_pallas(m):
    """Both layouts against the Pallas kernel and its VJP on the repeated
    neighbors."""
    ego, nei, rep, g = scene_inputs(m, seed=1)
    want, vjp = jax.vjp(lambda e: pk.min_clearance(
        e, jnp.asarray(rep.numpy()), L, W, 4, block_n=8, interpret=True),
        jnp.asarray(ego.numpy()))
    d_want, = vjp(jnp.asarray(g.numpy()))
    for n_, m_ in ((nei, m), (rep, 1)):
        np.testing.assert_allclose(
            np_(ck.min_clearance_fwd_plain(ego, n_, L, W, 4, m_)),
            np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            np_(ck.min_clearance_bwd_plain(ego, n_, g, L, W, 4, m_)),
            np.asarray(d_want), rtol=1e-4, atol=1e-6)


def test_wrapper_refuses_rows_and_shared_memory():
    """By name: ego rows that are no multiple of rows_per_scene, a scene
    count that does not match, and a scene whose discs exceed a block's
    shared memory; the plain versions refuse the first two as well."""
    ego, nei, _, g = scene_inputs(3)
    assert ck._sizes(ego, nei, 4, 3) == (15, 20, 4)
    with pytest.raises(ValueError, match="no multiple of rows_per_scene"):
        ck._sizes(ego, nei, 4, 2)
    with pytest.raises(ValueError, match="nei holds 5 scenes"):
        ck._sizes(ego, nei, 4, 5)
    with pytest.raises(ValueError, match="nei holds 5 scenes"):
        ck._sizes(ego, nei, 4, 1)
    with pytest.raises(ValueError, match="no multiple of rows_per_scene"):
        ck.min_clearance_fwd(ego, nei, L, W, 4, 2)
    with pytest.raises(ValueError, match="nei holds 5 scenes"):
        ck.min_clearance_bwd(ego, nei, g, L, W, 4, 5)
    # K = 64, nL = 8: 147,456 bytes at T = 32 fit, T = 64 does not
    big = lambda T: (torch.zeros(2, T, 3), torch.zeros(2, 64, T, 7))
    assert ck._sizes(*big(32), 8) == (2, 32, 64)
    with pytest.raises(ValueError, match="shared memory"):
        ck._sizes(*big(64), 8)


def bwd_twin(ego, nei, g, nL, m):
    """The backward kernel's routing as torch ops over (n, T), k by k as
    its threads walk: pass 1 keeps the minimum over k, its tie count (a
    smaller value resets it, an equal one adds one) and, among the ties,
    the number whose gate is open and the first such k; pass 2 recomputes
    each neighbor's masked clearance from that k on and routes the
    cotangent where it equals the minimum and the gate is open, until all
    of them are met.  Disc geometry from the plain version, per-scene
    neighbors repeated.  Also returns the tie counts."""
    _, (ex, ey, nx, ny, _, _, _, _, valid, ax, cth, sth) = ck._disc_geometry(
        ego, torch.repeat_interleave(nei, m, 0), L, W, nL)
    rn = torch.swapaxes(torch.repeat_interleave(nei, m, 0), 1, 2)[..., 6] / 2
    re = W / 2.0
    K = nx.shape[2]

    def clearance(k):
        d2 = [[(ex[..., i] - nx[:, :, k, j]) ** 2
               + (ey[..., i] - ny[:, :, k, j]) ** 2 for j in range(nL)]
              for i in range(nL)]
        d2min = torch.stack([d for row in d2 for d in row]).amin(0)
        dist = torch.sqrt(d2min + 1e-12)
        per = dist - re - rn[:, :, k]
        masked = (torch.clamp(per, -5.0, 20.0) * valid[:, :, k]
                  + (1 - valid[:, :, k]) * 100.0)
        gate = (per > -5.0) & (per < 20.0) & (valid[:, :, k] != 0)
        return d2, d2min, dist, gate, masked

    best = torch.full_like(g, float("inf"))
    ties = torch.zeros_like(g, dtype=torch.int64)
    routes, kroute = torch.zeros_like(ties), torch.zeros_like(ties)
    for k in range(K):
        *_, gate, masked = clearance(k)
        less, same = masked < best, masked == best
        ties = torch.where(less, 1, ties + same.long())
        routes = torch.where(less, 0, routes)
        best = torch.where(less, masked, best)
        opens = (less | same) & gate
        kroute = torch.where(opens & (routes == 0), k, kroute)
        routes = routes + opens.long()
    gk = g * (1.0 / ties.clamp(min=1).to(g.dtype))
    g_ex = [torch.zeros_like(g) for _ in range(nL)]
    g_ey = [torch.zeros_like(g) for _ in range(nL)]
    for k in range(K):
        d2, d2min, dist, gate, masked = clearance(k)
        route = (k >= kroute) & (routes > 0) & (masked == best) & gate
        routes = routes - route.long()
        gate = gk * valid[:, :, k]
        cnt = sum((d == d2min).long() for row in d2 for d in row)
        gkn = gate / cnt.clamp(min=1).to(g.dtype) / dist
        for i in range(nL):
            sx, sy = torch.zeros_like(g), torch.zeros_like(g)
            for j in range(nL):
                hit = d2[i][j] == d2min
                sx = torch.where(hit, sx + (ex[..., i] - nx[:, :, k, j]), sx)
                sy = torch.where(hit, sy + (ey[..., i] - ny[:, :, k, j]), sy)
            g_ex[i] = torch.where(route, g_ex[i] + sx * gkn, g_ex[i])
            g_ey[i] = torch.where(route, g_ey[i] + sy * gkn, g_ey[i])
    assert int(routes.abs().max()) == 0        # pass 2 met every open tie
    gx, gy, gth = (torch.zeros_like(g) for _ in range(3))
    for i in range(nL):
        gx, gy = gx + g_ex[i], gy + g_ey[i]
        gth = gth + (g_ex[i] * (-ax[i] * sth) + g_ey[i] * (ax[i] * cth))
    return torch.stack([gx, gy, gth], -1), ties


@pytest.mark.parametrize("m,nL", [(1, 4), (3, 4), (2, 3)])
def test_two_pass_backward_twin_equals_plain(m, nL):
    """Forced ties: neighbors 0 and 1 identical in every scene (a tie over
    k wherever they are the closest), neighbor 2 a copy that is invalid,
    and scene 0 without a valid neighbor (all K tied at 100, nothing
    routed)."""
    ego, nei, _, g = scene_inputs(m, scenes=6, seed=7)
    nei[:, 1] = nei[:, 0]
    nei[:, 2] = nei[:, 0]
    nei[:, :2, :, 0] = 1.0
    nei[:, 2, :, 0] = 0.0
    nei[0, :, :, 0] = 0.0
    got, n_ties = bwd_twin(ego, nei, g, nL, m)
    want = ck.min_clearance_bwd_plain(ego, nei, g, L, W, nL, m)
    routed = want.abs().sum(-1) > 0
    assert (routed & (n_ties == 2)).any() and (routed & (n_ties == 1)).any()
    assert (n_ties[:m] == 4).all() and not routed[:m].any()
    assert torch.equal(got, want)
