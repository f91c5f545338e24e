"""A frozen copy of ``pstl_tpu_torch/ops/geometry.py`` of the PyTorch port, kept as the benchmark's plain
reference: every kernel dispatch runs the plain version.  Do not edit to
follow the program."""


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


def _ego_axes(ego_L: float, ego_W: float, num_L: int, device):
    re = ego_W / 2.0
    return re, torch.linspace(-ego_L / 2 + re, ego_L / 2 - re, num_L,
                              device=device)


def _pairs(ego_xyth: Tensor, nx: Tensor, ny: Tensor, axe: Tensor):
    """Ego disc centres against the scene's neighbor discs: (dx, dy) of
    shape (bs, R, K, T, nLe, nLn), and the ego's cos / sin (bs, R, T)."""
    x, y, th = ego_xyth[..., 0], ego_xyth[..., 1], ego_xyth[..., 2]
    cth, sth = torch.cos(th), torch.sin(th)
    ex = x[..., None] + axe * cth[..., None]               # (bs, R, T, nLe)
    ey = y[..., None] + axe * sth[..., None]
    dx = ex[:, :, None, :, :, None] - nx[:, None, :, :, None, :]
    dy = ey[:, :, None, :, :, None] - ny[:, None, :, :, None, :]
    return dx, dy, cth, sth


def _masked_clearance(d2: Tensor, re: float, r: Tensor, valid: Tensor):
    """Per-neighbor clearance from the pair minimum d2 (bs, R, K, T):
    (per, masked) with ``masked`` clipped to [-5, 20] and 100 where the
    neighbor is invalid."""
    per = torch.sqrt(d2 + 1e-12) - re - r[:, None]
    v = valid[:, None]
    return per, torch.clamp(per, -5.0, 20.0) * v + (1.0 - v) * 100.0


class MinClearanceTiled(torch.autograd.Function):
    """``min_clearance_tiled`` with the JAX package's custom VJP
    (``pstl_tpu/ops/geometry.py:_min_clearance_tiled_bwd``): the forward
    saves the ego states and the discs only; the backward recomputes the
    pairs and routes the cotangent through the min over K (ties split
    evenly), a strict (-5, 20) gate times the validity (``torch.clamp``'s
    own gradient passes at the bounds), the min over disc pairs (ties split
    evenly) and d sqrt(d2) = dx / dist.  The discs get no gradient."""

    @staticmethod
    def forward(ctx, ego_xyth, nx, ny, r, valid, ego_L, ego_W, num_L):
        ctx.save_for_backward(ego_xyth, nx, ny, r, valid)
        ctx.consts = (ego_L, ego_W, num_L)
        re, axe = _ego_axes(ego_L, ego_W, num_L, ego_xyth.device)
        dx, dy, _, _ = _pairs(ego_xyth, nx, ny, axe)
        d2 = torch.amin(dx * dx + dy * dy, dim=(-2, -1))   # (bs, R, K, T)
        _, masked = _masked_clearance(d2, re, r, valid)
        return torch.amin(masked, dim=-2)

    @staticmethod
    def backward(ctx, g):
        ego_xyth, nx, ny, r, valid = ctx.saved_tensors
        ego_L, ego_W, num_L = ctx.consts
        re, axe = _ego_axes(ego_L, ego_W, num_L, ego_xyth.device)
        dx, dy, cth, sth = _pairs(ego_xyth, nx, ny, axe)
        d2p = dx * dx + dy * dy                          # (bs,R,K,T,nLe,nLn)
        d2 = torch.amin(d2p, dim=(-2, -1))
        dist = torch.sqrt(d2 + 1e-12)
        per, masked = _masked_clearance(d2, re, r, valid)
        out = torch.amin(masked, dim=-2, keepdim=True)     # (bs, R, 1, T)
        eqK = (masked == out).to(g.dtype)
        wK = eqK / torch.clamp(eqK.sum(-2, keepdim=True), min=1.0)
        gate = ((per > -5.0) & (per < 20.0)).to(g.dtype) * valid[:, None]
        gK = g[:, :, None] * wK * gate                     # (bs, R, K, T)
        eqP = (d2p == d2[..., None, None]).to(g.dtype)
        wP = eqP / torch.clamp(eqP.sum((-2, -1), keepdim=True), min=1.0)
        coef = (gK / dist)[..., None, None] * wP
        g_ex = torch.sum(coef * dx, dim=(-4, -1))          # (bs, R, T, nLe)
        g_ey = torch.sum(coef * dy, dim=(-4, -1))
        gth = torch.sum(g_ex * (-axe * sth[..., None])
                        + g_ey * (axe * cth[..., None]), dim=-1)
        g_ego = torch.stack([g_ex.sum(-1), g_ey.sum(-1), gth], dim=-1)
        if ego_xyth.shape[-1] > 3:
            g_ego = torch.cat([g_ego, g_ego.new_zeros(
                ego_xyth.shape[:-1] + (ego_xyth.shape[-1] - 3,))], dim=-1)
        return g_ego, None, None, None, None, None, None, None


def min_clearance_tiled(ego_xyth: Tensor, discs: NeighborDiscs,
                        ego_L: float, ego_W: float, num_L: int = 4) -> Tensor:
    """Masked min clearance of R candidate rollouts per scene against the
    scene's neighbor discs.  ego_xyth: (bs, R, T, >=3); discs fields
    (bs, K, T, ...).  Clearance clipped to [-5, 20], invalid neighbors 100,
    min over K.  Returns (bs, R, T); differentiable w.r.t. the ego states
    only, through :class:`MinClearanceTiled`."""
    return MinClearanceTiled.apply(ego_xyth, discs.nx, discs.ny, discs.r,
                                   discs.valid, ego_L, ego_W, num_L)


