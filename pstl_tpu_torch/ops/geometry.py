"""Differentiable geometry (port of ``pstl_tpu/ops/geometry.py``): signed
point-to-polyline distance, anchor-disc car clearance, and the tiled
minimum clearance of candidate rollouts against a scene's neighbor discs.

The JAX package selects polyline segments with a one-hot einsum because
TPU gathers are slow; here it is an argmin plus ``gather``.  The custom VJP
of ``min_clearance_tiled`` is not ported: autograd through the forward
below is used instead (it differs only in how exact ties split).  The fused
kernel that replaces ``min_neighbor_distance`` under
``cfg.use_pallas_clearance`` is ``ops/clearance_kernel.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


def point_to_polyline(points: Tensor, lanes: Tensor, clip: bool = False,
                      with_angle: bool = False, inline: bool = False):
    """Signed distance from trajectory points to a lane centerline.

    points: (..., T, 2|3); lanes: (..., n_segs, 3), leading dims
    broadcastable.  Selects the segment minimizing d(p, w_i) + d(p, w_{i+1})
    (earliest index on ties) and returns the signed triangle-area distance
    to it (left of travel positive), [and 1 - cos(dtheta)].
    """
    points = points.float()
    lanes = lanes.float()
    n_segs = lanes.shape[-2]
    pd = torch.linalg.vector_norm(points[..., None, :2]
                                  - lanes[..., None, :, :2], dim=-1)
    min_idx = torch.argmin(pd[..., :-1] + pd[..., 1:], dim=-1)    # (..., T)
    lead = torch.broadcast_shapes(points.shape[:-2], lanes.shape[:-2])
    lanes_b = lanes.expand(*lead, n_segs, 3)
    idx = min_idx.expand(*lead, points.shape[-2])[..., None].expand(
        *lead, points.shape[-2], 3)
    p2 = torch.gather(lanes_b, -2, idx)
    p3 = torch.gather(lanes_b, -2, idx + 1)

    x1, y1 = points[..., 0], points[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    x3, y3 = p3[..., 0], p3[..., 1]

    area = x1 * (y2 - y3) + x2 * (y3 - y1) + x3 * (y1 - y2)
    bottom_l = torch.linalg.vector_norm((p2 - p3)[..., :2], dim=-1)
    l2_dist = torch.sqrt(torch.clamp((x1 - x2) ** 2 + (y1 - y2) ** 2,
                                     min=1e-3))
    normal_case = (bottom_l != 0).float()
    dist = (normal_case * area / torch.clamp(bottom_l, min=1e-7)
            + (1 - normal_case) * l2_dist)
    if inline:
        l2_dist1 = torch.sqrt(torch.clamp((x1 - x3) ** 2 + (y1 - y3) ** 2,
                                          min=1e-3))
        behind = ((x1 - x2) * (x3 - x2) + (y1 - y2) * (y3 - y2)) <= 0
        ahead = ((x1 - x3) * (x2 - x3) + (y1 - y3) * (y2 - y3)) <= 0
        behind_all = (min_idx == 0) & behind
        ahead_all = (min_idx == n_segs - 2) & ahead
        normal = ~(behind_all | ahead_all)
        sign = torch.sign(dist)
        dist = (normal * dist + behind_all * l2_dist * sign
                + ahead_all * l2_dist1 * sign)
    if clip:
        dist = torch.clamp(dist, -5.0, 5.0)
    if with_angle:
        return dist, 1.0 - torch.cos(p2[..., 2] - points[..., 2])
    return dist


def anchor_points(x: Tensor, y: Tensor, th: Tensor, L: Tensor, W: Tensor,
                  num_L: int, num_W: int):
    """Cover an oriented box with num_L x num_W discs.  Returns centers
    (..., num_L*num_W, 2) and radius (...,)."""
    r = torch.minimum(torch.maximum(L / num_L / 2.0, W / num_W / 2.0),
                      W / 2.0)
    alpha = torch.linspace(0.0, 1.0, num_L, device=x.device)
    beta = torch.linspace(0.0, 1.0, num_W, device=x.device)
    xs = (-L / 2 + r)[..., None] * (1 - alpha) + (L / 2 - r)[..., None] * alpha
    ys = (-W / 2 + r)[..., None] * (1 - beta) + (W / 2 - r)[..., None] * beta
    xs = xs[..., :, None].expand(*xs.shape, num_W)
    ys = ys[..., None, :].expand(*ys.shape[:-1], num_L, num_W)
    xs = xs.reshape(*xs.shape[:-2], num_L * num_W)
    ys = ys.reshape(*ys.shape[:-2], num_L * num_W)
    c, s = torch.cos(th)[..., None], torch.sin(th)[..., None]
    gx = xs * c - ys * s + x[..., None]
    gy = xs * s + ys * c + y[..., None]
    return torch.stack([gx, gy], dim=-1), r


def car_clearance(xyth_a: Tensor, L_a, W_a, xyth_b: Tensor, L_b, W_b,
                  num_L: int = 4, num_W: int = 1, full: bool = False):
    """Min disc-to-disc clearance between two oriented boxes; leading dims
    of a and b broadcast.  Returns (...,); with ``full`` also the min
    centre distance and the radius sum."""
    ones = torch.ones_like(xyth_a[..., 0])
    xys1, r1 = anchor_points(xyth_a[..., 0], xyth_a[..., 1], xyth_a[..., 2],
                             L_a * ones, W_a * ones, num_L, num_W)
    onesb = torch.ones_like(xyth_b[..., 0])
    xys2, r2 = anchor_points(xyth_b[..., 0], xyth_b[..., 1], xyth_b[..., 2],
                             L_b * onesb, W_b * onesb, num_L, num_W)
    diff = xys1[..., :, None, :] - xys2[..., None, :, :]
    d = torch.linalg.vector_norm(diff, dim=-1)
    min_dist = torch.amin(d, dim=(-2, -1))
    if full:
        return min_dist - r1 - r2, min_dist, r1 + r2
    return min_dist - r1 - r2


def min_neighbor_distance(ego_traj: Tensor, nei_traj: Tensor,
                          nei_valid: Tensor, ego_L: float, ego_W: float,
                          num_L: int = 4, num_W: int = 1,
                          full: bool = False):
    """Masked min clearance to any neighbor per timestep: clearance clipped
    to [-5, 20], invalid neighbors 100, min over K.  ego_traj (n, T, >=3);
    nei_traj (n, K, T, >=6) rows (x, y, th, ..., L, W); nei_valid (n, K, T).
    Returns (n, T); with ``full`` also the masked min centre distance and
    the radius sums (n, K, T)."""
    res = car_clearance(ego_traj[..., None, :, :3], ego_L, ego_W,
                        nei_traj[..., :3], nei_traj[..., -2],
                        nei_traj[..., -1], num_L, num_W, full=full)
    car_dist = res[0] if full else res
    masked = (torch.clamp(car_dist, -5.0, 20.0) * nei_valid
              + (1 - nei_valid) * 100.0)
    min_d = torch.amin(masked, dim=-2)
    if full:
        return (min_d, res[1] * nei_valid + (1 - nei_valid) * 100.0,
                res[2])
    return min_d


class NeighborDiscs(NamedTuple):
    """Per-plan neighbor anchor-disc geometry: nx, ny (n, K, T, nL) disc
    centers; r (n, K, T) radius; valid (n, K, T) mask."""
    nx: Tensor
    ny: Tensor
    r: Tensor
    valid: Tensor


def precompute_neighbor_discs(nei_traj: Tensor, nei_valid: Tensor,
                              num_L: int) -> NeighborDiscs:
    """nei_traj: (n, K, T, >=6) rows (x, y, th, ..., L, W)."""
    nx0, ny0, nth = nei_traj[..., 0], nei_traj[..., 1], nei_traj[..., 2]
    Ln, Wn = nei_traj[..., -2], nei_traj[..., -1]
    r = Wn / 2.0
    alpha = torch.linspace(0.0, 1.0, num_L, device=nei_traj.device)
    ax = (-Ln / 2 + r)[..., None] * (1 - alpha) \
        + (Ln / 2 - r)[..., None] * alpha
    nx = nx0[..., None] + ax * torch.cos(nth)[..., None]
    ny = ny0[..., None] + ax * torch.sin(nth)[..., None]
    return NeighborDiscs(nx, ny, r, nei_valid)


def min_clearance_tiled(ego_xyth: Tensor, discs: NeighborDiscs,
                        ego_L: float, ego_W: float, num_L: int = 4) -> Tensor:
    """Masked min clearance of R candidate rollouts per scene against the
    scene's neighbor discs.  ego_xyth: (bs, R, T, >=3); discs fields
    (bs, K, T, ...).  Clearance clipped to [-5, 20], invalid neighbors 100,
    min over K.  Returns (bs, R, T)."""
    re = ego_W / 2.0
    axe = torch.linspace(-ego_L / 2 + re, ego_L / 2 - re, num_L,
                         device=ego_xyth.device)
    x, y, th = ego_xyth[..., 0], ego_xyth[..., 1], ego_xyth[..., 2]
    ex = x[..., None] + axe * torch.cos(th)[..., None]      # (bs, R, T, nLe)
    ey = y[..., None] + axe * torch.sin(th)[..., None]
    dx = ex[:, :, None, :, :, None] - discs.nx[:, None, :, :, None, :]
    dy = ey[:, :, None, :, :, None] - discs.ny[:, None, :, :, None, :]
    d2 = torch.amin(dx * dx + dy * dy, dim=(-2, -1))         # (bs, R, K, T)
    per = torch.sqrt(d2 + 1e-12) - re - discs.r[:, None]
    valid = discs.valid[:, None]
    masked = torch.clamp(per, -5.0, 20.0) * valid + (1.0 - valid) * 100.0
    return torch.amin(masked, dim=-2)
