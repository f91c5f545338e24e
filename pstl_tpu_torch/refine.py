"""Test-time gradient refinement and the backup safety controller (port of
``pstl_tpu/refine.py``).

- ``convex_refinement``: 50 Adam steps on softmax weights over the current
  controls and a set of cached denoise steps; only the candidates that
  violate their spec are replaced;
- ``raw_refinement``: a few Adam steps on a control residual of the
  violating candidates;
- ``solve_backup``: 500 Adam steps on a (2, 2) control residual that
  restores the neighbor clearance of the next two steps.

The JAX package runs each as a ``lax.scan`` of ``optax.adam`` steps; here
each is a Python loop of ``torch.autograd.grad`` on a detached leaf and an
``optim.Adam`` update.  The loops turn autograd on themselves, so callers
may run them under ``torch.no_grad()`` (the planner does).  The scores
reach the ego states through ``score_rows`` (the planner's
``TiledScorer``, whose clearance has ``geometry.MinClearanceTiled``'s VJP:
ties split evenly, as ``jnp.min``'s do); the backup loss through
``geometry.car_clearance``, a ``torch.amin``, which splits ties evenly too.

``solve_backup`` takes a leading scene axis where the JAX package vmaps
one scene at a time: the summed loss gives each scene its own gradient and
Adam is elementwise, so the batched solve is the vmapped one.
"""

from __future__ import annotations

from typing import Callable

import torch

from pstl_tpu_torch import optim
from pstl_tpu_torch.config import Config
from pstl_tpu_torch.ops import dynamics as dyn
from pstl_tpu_torch.ops import geometry as geom
from pstl_tpu_torch.ops.guidance_loss import row_loss

Tensor = torch.Tensor

#: denoise-step index sets per K (nusc_train.py:1053-1056)
K_D_LIST = {
    2: [0], 3: [80, 95], 4: [80, 90, 95], 6: [0, 50, 80, 90, 95],
    8: [0, 50, 80, 85, 90, 95, 98], 10: [0, 50, 80, 85, 90, 95, 96, 97, 98],
    20: [0, 10, 30, 50, 60, 70, 75, 80, 85, 90, 91, 92, 93, 94, 95, 96, 97,
         98, 99],
}


def _adam_loop(x0: Tensor, loss_fn: Callable[[Tensor], Tensor], lr: float,
               n_iters: int) -> Tensor:
    """``n_iters`` steps of ``optax.adam(lr)`` on ``loss_fn`` from x0."""
    adam = optim.Adam(x0, lr, n_iters)
    x = x0
    for i in range(n_iters):
        with torch.enable_grad():
            leaf = x.detach().requires_grad_(True)
            g, = torch.autograd.grad(loss_fn(leaf), leaf)
        with torch.no_grad():
            x = adam.update(x, g, i)
    return x


def _violated(nn_controls: Tensor, score: Callable[[Tensor], Tensor],
              valid: Tensor) -> Tensor:
    """(N, 1, 1) mask of the valid rows whose controls score <= 0."""
    with torch.no_grad():
        s0 = score(nn_controls)
    return ((s0 <= 0) & (valid > 0)).to(nn_controls.dtype)[:, None, None]


def convex_refinement(nn_controls: Tensor, all_steps: Tensor,
                      states_flat: Tensor, score_rows, valid: Tensor,
                      cfg: Config, K: int = 8, n_iters: int = 50,
                      lr: float = 0.3, stl_thres: float = 0.0005) -> Tensor:
    """Optimize softmax weights over {current controls} U {the cached
    denoise steps ``K_D_LIST[K]`` of ``all_steps`` (S, N, nt, 2)}; replace
    only the violating candidates.  An index past the cache's depth reads
    its last entry, as the JAX package's clamped static index does."""
    N = nn_controls.shape[0]
    depth = all_steps.shape[0]
    idx = [min(i, depth - 1) for i in K_D_LIST[K]]
    base = nn_controls.detach()
    cands = torch.stack([base] + [all_steps[i].detach() for i in idx],
                        dim=-1)                           # (N, nt, 2, K)

    def score(u):
        return score_rows(dyn.rollout(states_flat, u, cfg.dt)[:, :-1])

    violated = _violated(base, score, valid)

    def combine(lamdas):
        ratios = torch.softmax(lamdas, dim=-1)            # (N, K)
        mix = torch.einsum("ntck,nk->ntc", cands, ratios)
        return base * (1 - violated) + violated * mix

    def loss_fn(lamdas):
        return row_loss(torch.relu(stl_thres - score(combine(lamdas))),
                        valid)

    lam0 = torch.ones((N, len(idx) + 1), device=base.device)
    lam = _adam_loop(lam0, loss_fn, lr, n_iters)
    with torch.no_grad():
        return combine(lam)


def raw_refinement(nn_controls: Tensor, states_flat: Tensor, score_rows,
                   valid: Tensor, cfg: Config, n_iters: int = 5,
                   lr: float = 3e-2, stl_thres: float = 0.0005) -> Tensor:
    """Adam on a raw control residual of the violating candidates
    (nusc_sim.py:627-666)."""

    def score(u):
        return score_rows(dyn.rollout(states_flat, u, cfg.dt)[:, :-1])

    base = nn_controls.detach()
    violated = _violated(base, score, valid)

    def loss_fn(res):
        return row_loss(torch.relu(stl_thres - score(base + violated * res)),
                        valid)

    res = _adam_loop(torch.zeros_like(base), loss_fn, lr, n_iters)
    return base + violated * res


def solve_backup(ego_traj: Tensor, ego_ctrls: Tensor, nei_traj: Tensor,
                 cfg: Config, n_iters: int = 500, lr: float = 1e-2,
                 d_safe: float = 0.1) -> Tensor:
    """The backup safety controller (``solve_bak``, nusc_sim.py:757-781)
    for a batch of scenes: a (2, 2) control residual per scene so that the
    next 2 steps keep anchor-disc clearance above d_safe, with an L2
    residual penalty; each scene's loss is ``mean(relu(1.01 d_safe -
    clearance)) + mean(u_res ** 2)``.

    ego_traj: (bs, >=3, >=4) planned states; ego_ctrls: (bs, >=2, 2);
    nei_traj: (bs, >=3, >=7) neighbor rows (valid, x, y, th, v, L, W).
    Returns the residuals (bs, 2, 2)."""
    base_u = ego_ctrls[:, 0:2].detach()
    s0 = ego_traj[:, 0, 0:4].detach()
    nei = nei_traj[:, 1:3].detach()

    def loss_fn(u_res):
        new_traj = dyn.rollout(s0, base_u + u_res, cfg.dt)   # (bs, 3, 4)
        clear = geom.car_clearance(
            new_traj[:, 1:3, :3], cfg.ego_L, cfg.ego_W, nei[..., 1:4],
            nei[..., 5], nei[..., 6], cfg.refined_nL, cfg.refined_nW)
        loss_d = torch.mean(torch.relu(d_safe * 1.01 - clear), dim=-1)
        return torch.sum(loss_d + torch.mean(torch.square(u_res),
                                             dim=(-2, -1)))

    u0 = torch.zeros((s0.shape[0], 2, 2), device=s0.device)
    return _adam_loop(u0, loss_fn, lr, n_iters)
