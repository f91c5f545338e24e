"""A frozen copy of ``pstl_tpu_torch/ops/stl.py`` of the PyTorch port, kept as the benchmark's plain
reference: every kernel dispatch runs the plain version.  Do not edit to
follow the program."""


from __future__ import annotations


import torch

Tensor = torch.Tensor


def soft_max(x: Tensor, tau: float, dim: int = -1, hard: bool = False,
             keepdim: bool = False, dtype=torch.float32) -> Tensor:
    """Soft maximum; all -inf inputs along ``dim`` give -inf."""
    if hard:
        return torch.amax(x, dim=dim, keepdim=keepdim)
    x = x.to(dtype)
    return torch.logsumexp(x * tau, dim=dim, keepdim=keepdim) / tau


def soft_min(x: Tensor, tau: float, dim: int = -1, hard: bool = False,
             keepdim: bool = False, dtype=torch.float32) -> Tensor:
    if hard:
        return torch.amin(x, dim=dim, keepdim=keepdim)
    return -soft_max(-x, tau, dim=dim, hard=False, keepdim=keepdim,
                     dtype=dtype)


def cumulative(op, x: Tensor, dim: int = -1, reverse: bool = False) -> Tensor:
    """Inclusive cumulative reduction with a binary ``op`` along ``dim``
    (``torch.minimum``, ``torch.maximum`` or ``torch.logaddexp``)."""
    dim = dim % x.ndim
    xs = list(torch.unbind(x, dim=dim))
    order = range(len(xs) - 1, -1, -1) if reverse else range(len(xs))
    out = [None] * len(xs)
    acc = None
    for i in order:
        acc = xs[i] if acc is None else op(xs[i], acc)
        out[i] = acc
    return torch.stack(out, dim=dim)


def logcumsumexp(x: Tensor, dim: int = -1, reverse: bool = False) -> Tensor:
    """Numerically stable cumulative logsumexp."""
    if reverse:
        return torch.flip(torch.logcumsumexp(torch.flip(x, (dim,)), dim),
                          (dim,))
    return torch.logcumsumexp(x, dim)


# ---------------------------------------------------------------------------
# timed windows
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the formula tree
# ---------------------------------------------------------------------------


