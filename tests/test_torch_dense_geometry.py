"""``geometry.min_clearance_tiled``'s recompute VJP (``MinClearanceTiled``)
against ``jax.vjp`` of ``pstl_tpu.ops.geometry.min_clearance_tiled``: random
scenes, invalid neighbors, neighbors tied over K, disc
pairs tied (boxes whose discs all sit at their centres) and clearances
exactly at the clip bounds -5 and 20, where the JAX gate is strict and
``torch.clamp``'s own gradient is not.  Values and gradients to 1e-6;
what the forward saves; ``min_clearance_pre``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu.ops import geometry as jgeom
from pstl_tpu_torch.ops import geometry as tgeom

import torch_parity  # noqa: F401  (torch thread count)

L, W, NL = 4.084, 1.73, 4


def random_case(seed, bs=2, R=5, K=3, T=6):
    rng = np.random.RandomState(seed)
    ego = np.stack([rng.uniform(-10, 10, (bs, R, T)),
                    rng.uniform(-10, 10, (bs, R, T)),
                    rng.uniform(-np.pi, np.pi, (bs, R, T)),
                    rng.uniform(0, 10, (bs, R, T))], -1).astype(np.float32)
    nei = np.zeros((bs, K, T, 7), np.float32)
    nei[..., 0] = rng.rand(bs, K, T) > 0.25
    nei[..., 1:3] = rng.uniform(-12, 12, (bs, K, T, 2))
    nei[..., 3] = rng.uniform(-np.pi, np.pi, (bs, K, T))
    nei[..., 5] = rng.uniform(3.5, 5.5, (bs, K, T))
    nei[..., 6] = rng.uniform(1.5, 2.2, (bs, K, T))
    return ego, nei, L, W


def tie_case():
    """Boxes whose nL discs all sit at the centre (L = W: every disc pair
    ties), a row with two neighbors 4 m away in two directions (a tie over
    K), and neighbors at clearance -5 and 20 exactly: ego radius 4,
    neighbor radius 2, centres 1 m and 26 m apart (sqrt(1 + 1e-12) and
    sqrt(676 + 1e-12) round to 1 and 26 in float32)."""
    ego = np.zeros((1, 3, 1, 3), np.float32)      # rows 0, 1 at the origin
    ego[0, 1, 0, 2] = 0.3
    ego[0, 2, 0, :2] = (0.0, 14.0)
    nei = np.zeros((1, 4, 1, 7), np.float32)
    nei[..., 0] = 1.0
    nei[..., 5] = nei[..., 6] = 4.0               # L = W = 4: r = 2
    nei[0, 0, 0, 1:3] = (1.0, 0.0)                # rows 0, 1: 1 - 6 = -5
    nei[0, 1, 0, 1:3] = (0.0, 26.0)               # rows 0, 1: 26 - 6 = 20
    nei[0, 2, 0, 1:3] = (0.0, 10.0)               # row 2: 4 - 6 = -2, and
    nei[0, 3, 0, 1:3] = (4.0, 14.0)               # the same, a K tie
    return ego, nei, 8.0, 8.0                     # ego L = W = 8: r = 4


def both(ego, nei, ego_L, ego_W, g):
    """(JAX value, JAX VJP, port value, port gradient)."""
    jd = jgeom.precompute_neighbor_discs(jnp.asarray(nei[..., 1:7]),
                                         jnp.asarray(nei[..., 0]), NL)
    out_j, vjp = jax.vjp(lambda e: jgeom.min_clearance_tiled(
        e, jd, ego_L, ego_W, NL), jnp.asarray(ego))
    gj, = vjp(jnp.asarray(g))
    # the port on the JAX discs: the VJP is held, not the disc geometry
    td = tgeom.NeighborDiscs(*(torch.as_tensor(np.array(x)) for x in jd))
    e = torch.as_tensor(ego).requires_grad_(True)
    out_t = tgeom.min_clearance_tiled(e, td, ego_L, ego_W, NL)
    out_t.backward(torch.as_tensor(g))
    return np.asarray(out_j), np.asarray(gj), out_t.detach().numpy(), \
        e.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vjp_matches_jax_random(seed):
    ego, nei, el, ew = random_case(seed)
    g = np.random.RandomState(seed + 10).randn(*ego.shape[:3]).astype(
        np.float32)
    oj, gj, ot, gt = both(ego, nei, el, ew, g)
    np.testing.assert_allclose(ot, oj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gt, gj, rtol=1e-6, atol=1e-6)
    assert np.abs(gj).max() > 0 and not gt[..., 3].any()


def test_vjp_ties_and_clip_bounds_match_jax():
    ego, nei, el, ew = tie_case()
    g = np.ones(ego.shape[:3], np.float32)
    oj, gj, ot, gt = both(ego, nei, el, ew, g)
    np.testing.assert_array_equal(ot, oj)
    assert ot[0, 0, 0] == -5.0 and ot[0, 2, 0] == -2.0
    np.testing.assert_allclose(gt, gj, rtol=1e-6, atol=1e-6)
    # at -5 the strict gate routes nothing; at row 2's K tie the two
    # neighbors take half each (16 tied disc pairs a sixteenth of that):
    # d/d(x, y) = 0.5 * (0, 1) + 0.5 * (-1, 0), the unit vectors from each
    assert not gj[0, 0].any() and not gt[0, 0].any()
    np.testing.assert_allclose(gt[0, 2, 0, :2], (-0.5, 0.5), rtol=1e-6)
    # torch.clamp's own gradient passes at the bound: autograd through the
    # plain forward differs from the VJP exactly there
    e = torch.as_tensor(ego).requires_grad_(True)
    jd = jgeom.precompute_neighbor_discs(jnp.asarray(nei[..., 1:7]),
                                         jnp.asarray(nei[..., 0]), NL)
    d = tgeom.NeighborDiscs(*(torch.as_tensor(np.array(x)) for x in jd))
    re, axe = tgeom._ego_axes(el, ew, NL, "cpu")
    dx, dy, _, _ = tgeom._pairs(e, d.nx, d.ny, axe)
    _, masked = tgeom._masked_clearance(
        torch.amin(dx * dx + dy * dy, dim=(-2, -1)), re, d.r, d.valid)
    torch.amin(masked, dim=-2).backward(torch.as_tensor(g))
    assert e.grad[0, 0].abs().max() > 0


def test_vjp_at_the_upper_clip_bound():
    """A row whose only neighbor sits at clearance 20 exactly: 20 is the
    minimum, the gate is closed, no gradient (JAX and port)."""
    ego, nei, el, ew = tie_case()
    nei = nei[:, 1:2]
    g = np.ones(ego.shape[:3], np.float32)
    oj, gj, ot, gt = both(ego, nei, el, ew, g)
    assert ot[0, 0, 0] == 20.0 and oj[0, 0, 0] == 20.0
    np.testing.assert_allclose(gt, gj, rtol=1e-6, atol=1e-6)
    assert not gt[0, 0].any() and not gj[0, 0].any()


def test_forward_saves_no_pair_tensor():
    """The forward keeps the ego states and the discs only: no saved
    tensor as large as one (bs, R, K, T, nL, nL) pair tensor."""
    ego, nei, el, ew = random_case(0, bs=2, R=8, K=4, T=10)
    d = tgeom.precompute_neighbor_discs(torch.as_tensor(nei[..., 1:7]),
                                        torch.as_tensor(nei[..., 0]), NL)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        tgeom.min_clearance_tiled(torch.as_tensor(ego).requires_grad_(True),
                                  d, el, ew, NL)
    pair = 2 * 8 * 4 * 10 * NL * NL
    assert saved and max(saved) < pair


def test_min_clearance_pre_matches_jax():
    ego, nei, el, ew = random_case(3, bs=6, R=1)
    ego = ego[:, 0]
    g = np.random.RandomState(4).randn(*ego.shape[:2]).astype(np.float32)
    jd = jgeom.precompute_neighbor_discs(jnp.asarray(nei[..., 1:7]),
                                         jnp.asarray(nei[..., 0]), NL)
    oj, vjp = jax.vjp(lambda e: jgeom.min_clearance_pre(e, jd, el, ew, NL),
                      jnp.asarray(ego))
    td = tgeom.NeighborDiscs(*(torch.as_tensor(np.array(x)) for x in jd))
    e = torch.as_tensor(ego).requires_grad_(True)
    ot = tgeom.min_clearance_pre(e, td, el, ew, NL)
    ot.backward(torch.as_tensor(g))
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(vjp(
        jnp.asarray(g))[0]), rtol=1e-6, atol=1e-6)
