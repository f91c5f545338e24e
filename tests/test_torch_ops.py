"""Rollout, soft STL reductions, geometry and the tiled scorer: the torch
port against the JAX package on the same seeded inputs (CPU).

Tolerances: fp32 throughout; rtol 1e-5 / atol 1e-5 where both sides run
the same operations (sums may be taken in another order), 1e-4 where a
long prefix sum or a tau=100 logsumexp amplifies that order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import specs as jspecs
from pstl_tpu.config import Config as JConfig
from pstl_tpu.ops import dynamics as jdyn
from pstl_tpu.ops import geometry as jgeom
from pstl_tpu.ops import stl as jstl
from pstl_tpu_torch import specs as tspecs
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.ops import dynamics as tdyn
from pstl_tpu_torch.ops import geometry as tgeom
from pstl_tpu_torch.ops import stl as tstl

from torch_parity import F32, guidance_case, np_, to_t


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np_(a), np_(b), rtol=rtol, atol=atol)


def test_rollout_matches_jax_and_scan():
    rng = np.random.RandomState(0)
    s0 = rng.randn(6, 4).astype(F32)
    us = (rng.randn(6, 20, 2) * [0.3, 2.0]).astype(F32)
    tr = tdyn.rollout(torch.as_tensor(s0), torch.as_tensor(us), 0.5)
    _close(tr, jdyn.rollout(jnp.asarray(s0), jnp.asarray(us), 0.5), 1e-5,
           1e-4)
    _close(tr, tdyn.rollout_scan(torch.as_tensor(s0), torch.as_tensor(us),
                                 0.5), 1e-5, 1e-4)
    u = torch.as_tensor(us[:, 0])
    _close(tdyn.dynamics(torch.as_tensor(s0), u),
           jdyn.dynamics(jnp.asarray(s0), jnp.asarray(us[:, 0])), 0, 1e-6)


def test_bbox_corners_matches_jax():
    """Oriented box corners (..., 4, 2) of boxes with any leading shape."""
    rng = np.random.RandomState(3)
    x, y = (rng.uniform(-30, 30, (4, 5)).astype(F32) for _ in range(2))
    th = rng.uniform(-np.pi, np.pi, (4, 5)).astype(F32)
    L, W = rng.uniform(3.5, 5.5, (4, 5)).astype(F32), \
        rng.uniform(1.5, 2.2, (4, 5)).astype(F32)
    got = tgeom.bbox_corners(*(torch.as_tensor(v) for v in (x, y, th, L, W)))
    want = jgeom.bbox_corners(*(jnp.asarray(v) for v in (x, y, th, L, W)))
    assert tuple(got.shape) == (4, 5, 4, 2)
    _close(got, want, 1e-6, 1e-5)
    # the corners lie L and W apart around the centre
    g = np_(got)
    np.testing.assert_allclose(np.linalg.norm(g[..., 0, :] - g[..., 3, :],
                                              axis=-1), L, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(g[..., 0, :] - g[..., 1, :],
                                              axis=-1), W, rtol=1e-5)
    np.testing.assert_allclose(g.mean(-2), np.stack([x, y], -1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("hard", [False, True])
def test_soft_reductions_match_jax(hard):
    rng = np.random.RandomState(1)
    x = (rng.randn(5, 20) * 2).astype(F32)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    _close(tstl.soft_max(xt, 100.0, hard=hard),
           jstl.soft_max(xj, 100.0, hard=hard))
    _close(tstl.soft_min(xt, 10.0, dim=0, hard=hard),
           jstl.soft_min(xj, 10.0, axis=0, hard=hard))
    _close(tstl.logcumsumexp(xt * 50, dim=1, reverse=True),
           jstl.logcumsumexp(xj * 50, axis=1, reverse=True), 1e-5, 1e-4)
    _close(tstl.cumulative(torch.minimum, xt, dim=-1, reverse=True),
           jstl.cumulative(jnp.minimum, xj, axis=-1, reverse=True), 0, 0)


@pytest.mark.parametrize("clip,inline", [(False, False), (True, True)])
def test_point_to_polyline_matches_jax(clip, inline):
    rng = np.random.RandomState(2)
    pts = (rng.randn(3, 4, 20, 3) * 4).astype(F32)
    lanes = np.cumsum(rng.randn(3, 1, 15, 3), axis=2).astype(F32)
    lanes[1] = 0.0                      # an invalid (all-zero) lane
    d_t, th_t = tgeom.point_to_polyline(torch.as_tensor(pts),
                                        torch.as_tensor(lanes), clip=clip,
                                        with_angle=True, inline=inline)
    d_j, th_j = jgeom.point_to_polyline(jnp.asarray(pts), jnp.asarray(lanes),
                                        clip=clip, with_angle=True,
                                        inline=inline)
    _close(d_t, d_j, 1e-5, 1e-4)
    _close(th_t, th_j, 1e-5, 1e-5)


def test_clearance_matches_jax():
    rng = np.random.RandomState(3)
    ego = (rng.randn(2, 6, 20, 3) * 6).astype(F32)
    nei = (rng.randn(2, 5, 20, 7) * 6).astype(F32)
    nei[..., 5:7] = np.abs(nei[..., 5:7]) / 2 + 1.5
    valid = (rng.rand(2, 5, 20) > 0.3).astype(F32)
    dt = tgeom.precompute_neighbor_discs(torch.as_tensor(nei[..., 1:7]),
                                         torch.as_tensor(valid), 4)
    dj = jgeom.precompute_neighbor_discs(jnp.asarray(nei[..., 1:7]),
                                         jnp.asarray(valid), 4)
    for a, b in zip(dt, dj):
        _close(a, b, 1e-6, 1e-5)
    _close(tgeom.min_clearance_tiled(torch.as_tensor(ego), dt, 4.084, 1.73),
           jgeom.min_clearance_tiled(jnp.asarray(ego), dj, 4.084, 1.73),
           1e-5, 1e-4)
    xa, xb = ego[:, :1, 0], nei[:, :, 0, 1:4]
    _close(tgeom.car_clearance(torch.as_tensor(xa), 4.084, 1.73,
                               torch.as_tensor(xb),
                               torch.as_tensor(nei[:, :, 0, 5]),
                               torch.as_tensor(nei[:, :, 0, 6])),
           jgeom.car_clearance(jnp.asarray(xa), 4.084, 1.73, jnp.asarray(xb),
                               jnp.asarray(nei[:, :, 0, 5]),
                               jnp.asarray(nei[:, :, 0, 6])), 1e-5, 1e-4)


@pytest.mark.parametrize("norm_stl", [False, True])
def test_densify_and_tiled_scorer_match_jax(norm_stl):
    """densify_batch with the planner's stlp_dense, then TiledScorer on
    random rollouts (soft and hard), against the JAX package."""
    bs, M, nt = 2, 4, 20
    flags = dict(n_randoms=M, n_neighbors=3, nt=nt, norm_stl=norm_stl,
                 inline=norm_stl, clip_dist=norm_stl)
    batch, gt_stlp, stlp, states, _ = guidance_case(4, bs, M, nt, 3, 15)
    dj = jspecs.densify_batch({k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.asarray(gt_stlp), JConfig(**flags),
                              stlp_dense=jnp.asarray(stlp))
    dt = tspecs.densify_batch(to_t(batch), torch.as_tensor(gt_stlp),
                              TConfig(**flags), torch.as_tensor(stlp))
    assert sorted(dj) == sorted(dt)
    for k in dj:
        _close(dt[k], dj[k], 0, 0)
    rng = np.random.RandomState(5)
    us = (rng.randn(bs * M * 3, nt, 2) * [0.2, 1.5]).astype(F32)
    s0 = np.repeat(states, M * 3, axis=0)
    tr = jdyn.rollout(jnp.asarray(s0), jnp.asarray(us), 0.5)[:, :-1]
    sj = jspecs.make_score_rows(dj, dj, JConfig(**flags))
    st = tspecs.make_score_rows(dt, dt, TConfig(**flags))
    trt = torch.as_tensor(np.array(tr))
    _close(st(trt), sj(tr), 1e-4, 1e-4)
    _close(st(trt, hard=True), sj(tr, hard=True), 1e-5, 1e-4)
    m = (rng.rand(7) > 0.5).astype(F32)
    x = rng.randn(7).astype(F32)
    _close(tspecs.mask_mean(torch.as_tensor(x), torch.as_tensor(m)),
           jspecs.mask_mean(jnp.asarray(x), jnp.asarray(m)), 1e-6, 1e-7)
