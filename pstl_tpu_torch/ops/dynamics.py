"""Unicycle-with-acceleration dynamics and differentiable rollout
(port of ``pstl_tpu/ops/dynamics.py``).

State s = (x, y, theta, v); control u = (omega, a); dt seconds per step.
``neighbor_rollout`` predicts neighbor tracks at constant velocity.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def dynamics(s: Tensor, u: Tensor) -> Tensor:
    """Continuous-time derivative. s: (..., 4), u: (..., 2) -> (..., 4)."""
    th, v = s[..., 2], s[..., 3]
    return torch.stack([v * torch.cos(th), v * torch.sin(th),
                        u[..., 0], u[..., 1]], dim=-1)


def rollout_scan(s0: Tensor, us: Tensor, dt: float) -> Tensor:
    """Explicit-Euler rollout as a sequential loop — the oracle for
    :func:`rollout`.  s0: (..., 4); us: (..., T, 2) -> (..., T+1, 4)."""
    traj = [s0]
    s = s0
    for t in range(us.shape[-2]):
        s = s + dynamics(s, us[..., t, :]) * dt
        traj.append(s)
    return torch.stack(traj, dim=-2)


def rollout(s0: Tensor, us: Tensor, dt: float) -> Tensor:
    """Explicit-Euler rollout in closed form via prefix sums: theta_t and
    v_t are prefix sums of the controls, x_t / y_t prefix sums of
    v_t * cos/sin(theta_t).  s0: (..., 4); us: (..., T, 2).  Returns
    (..., T+1, 4) incl. s0."""
    w, a = us[..., 0], us[..., 1]
    th0 = s0[..., 2:3]
    v0 = s0[..., 3:4]
    th = th0 + dt * torch.cumsum(w, dim=-1)
    v = v0 + dt * torch.cumsum(a, dim=-1)
    th_full = torch.cat([th0, th], dim=-1)
    v_full = torch.cat([v0, v], dim=-1)
    dx = v_full[..., :-1] * torch.cos(th_full[..., :-1]) * dt
    dy = v_full[..., :-1] * torch.sin(th_full[..., :-1]) * dt
    x = s0[..., 0:1] + torch.cumsum(dx, dim=-1)
    y = s0[..., 1:2] + torch.cumsum(dy, dim=-1)
    tail = torch.stack([x, y, th, v], dim=-1)
    return torch.cat([s0[..., None, :], tail], dim=-2)


def neighbor_rollout(neighbors: Tensor, nt: int, dt: float,
                     full: bool = False) -> Tensor:
    """Constant-velocity neighbor prediction: each neighbor's current state
    rolled out with zero controls.  neighbors: (..., k, 7) rows (valid, x,
    y, th, v, L, W).  Returns (..., k, nt, 5) of (valid, x, y, th, v), or
    (..., k, nt, 7) with (L, W) appended when ``full``."""
    zeros = neighbors.new_zeros(neighbors.shape[:-1] + (nt - 1, 2))
    trajs = rollout(neighbors[..., 1:5], zeros, dt)     # (..., k, nt, 4)
    valid = neighbors[..., None, 0:1].expand(trajs.shape[:-1] + (1,))
    if full:
        lw = neighbors[..., None, 5:7].expand(trajs.shape[:-1] + (2,))
        return torch.cat([valid, trajs, lw], dim=-1)
    return torch.cat([valid, trajs], dim=-1)
