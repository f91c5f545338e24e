"""A frozen copy of ``pstl_tpu_torch/ops/dynamics.py`` of the PyTorch port, kept as the benchmark's plain
reference: every kernel dispatch runs the plain version.  Do not edit to
follow the program."""


from __future__ import annotations

import torch

Tensor = torch.Tensor


def dynamics(s: Tensor, u: Tensor) -> Tensor:
    """Continuous-time derivative. s: (..., 4), u: (..., 2) -> (..., 4)."""
    th, v = s[..., 2], s[..., 3]
    return torch.stack([v * torch.cos(th), v * torch.sin(th),
                        u[..., 0], u[..., 1]], dim=-1)


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


