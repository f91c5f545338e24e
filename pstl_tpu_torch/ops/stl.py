"""Differentiable Signal Temporal Logic robustness (port of
``pstl_tpu/ops/stl.py``): the soft reductions the scorers use and the
formula tree (``AP``, ``Not``, ``And``, ``Or``, ``Imply``, ``ListAnd``,
``Eventually``, ``Always``, ``Once``, ``UntimedUntil``, ``Until``) that
``specs.build_formulas`` builds.

``soft_max(x) = logsumexp(x * tau) / tau``; ``soft_min(x) = -soft_max(-x)``;
``hard=True`` swaps in the exact max / min (``torch.amax`` / ``amin``,
which split a tie's gradient evenly, as ``jnp.max`` / ``jnp.min`` do).
A soft max over an empty window is -inf, a soft min +inf.  A timed window
[t+ts, t+te) is one masked reduction against a (T, T) mask built once per
(T, ts, te) with numpy and kept per device; a suffix window
(``ts == 0 and te >= T``) is a reverse cumulative reduction instead.
Robustness is computed in float32 whatever the signals' dtype.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import numpy as np
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

@functools.lru_cache(maxsize=256)
def _window_mask(T: int, ts: int, te: int, device: torch.device) -> Tensor:
    """(T, T) bool on ``device``: row t selects columns [clip(t+ts, 0, T),
    clip(t+te, 0, T)); built with numpy once per (T, ts, te, device)."""
    t = np.arange(T)[:, None]
    j = np.arange(T)[None, :]
    mask = (j >= np.clip(t + ts, 0, T)) & (j < np.clip(t + te, 0, T))
    return torch.as_tensor(mask, device=device)


def _masked_soft_max(x: Tensor, mask: Tensor, tau: float,
                     hard: bool) -> Tensor:
    """Soft max over the last dim restricted to ``mask`` (False: ignored);
    an empty mask gives -inf (and no gradient)."""
    neg = torch.where(mask, x.float(), -torch.inf)
    if hard:
        return torch.amax(neg, dim=-1)
    return torch.logsumexp(neg * tau, dim=-1) / tau


def window_soft_max(s: Tensor, ts: int, te: int, tau: float,
                    hard: bool = False) -> Tensor:
    """For each t: the soft max of s over [t+ts, t+te) (clipped).
    s: (..., T) -> (..., T)."""
    T = s.shape[-1]
    if ts == 0 and te >= T:
        if hard:
            return cumulative(torch.maximum, s.float(), dim=-1, reverse=True)
        return logcumsumexp(s.float() * tau, dim=-1, reverse=True) / tau
    mask = _window_mask(T, ts, te, s.device)
    return _masked_soft_max(s[..., None, :], mask, tau, hard)


def window_soft_min(s: Tensor, ts: int, te: int, tau: float,
                    hard: bool = False) -> Tensor:
    return -window_soft_max(-s, ts, te, tau, hard)


# ---------------------------------------------------------------------------
# the formula tree
# ---------------------------------------------------------------------------

class STLFormula:
    """A node.  ``node(signals, tau, hard)`` maps a signal dict to an (n, T)
    robustness trace; the run's robustness is ``trace[..., 0]``.  Nodes
    hold no parameters."""

    symbol = "?"

    def __call__(self, signals, tau: float, hard: bool = False) -> Tensor:
        raise NotImplementedError

    def robustness(self, signals, tau: float, hard: bool = False) -> Tensor:
        return self(signals, tau, hard)[..., 0]

    def __str__(self):
        return self.symbol


class AP(STLFormula):
    """Atomic predicate: ``expr(signals) -> (n, T)`` margin, in float32."""

    def __init__(self, expr: Callable, comment: str = ""):
        self.expr = expr
        self.comment = comment
        self.symbol = comment or "AP"

    def __call__(self, signals, tau, hard=False):
        return self.expr(signals).float()


class Not(STLFormula):
    def __init__(self, node: STLFormula):
        self.node = node
        self.symbol = f"¬({node})"

    def __call__(self, signals, tau, hard=False):
        return -self.node(signals, tau, hard)


class And(STLFormula):
    def __init__(self, lhs: STLFormula, rhs: STLFormula):
        self.lhs, self.rhs = lhs, rhs
        self.symbol = f"({lhs}) & ({rhs})"

    def __call__(self, signals, tau, hard=False):
        v = torch.stack([self.lhs(signals, tau, hard),
                         self.rhs(signals, tau, hard)], dim=-1)
        return soft_min(v, tau, dim=-1, hard=hard)


class Or(STLFormula):
    def __init__(self, lhs: STLFormula, rhs: STLFormula):
        self.lhs, self.rhs = lhs, rhs
        self.symbol = f"({lhs}) | ({rhs})"

    def __call__(self, signals, tau, hard=False):
        v = torch.stack([self.lhs(signals, tau, hard),
                         self.rhs(signals, tau, hard)], dim=-1)
        return soft_max(v, tau, dim=-1, hard=hard)


class Imply(STLFormula):
    def __init__(self, lhs: STLFormula, rhs: STLFormula):
        self.eval = Or(Not(lhs), rhs)
        self.symbol = f"({lhs}) -> ({rhs})"

    def __call__(self, signals, tau, hard=False):
        return self.eval(signals, tau, hard)


class ListAnd(STLFormula):
    """n-ary conjunction; ``full=True`` also returns the clauses' traces
    (n, n_clauses, T)."""

    def __init__(self, nodes: Sequence[STLFormula]):
        self.nodes = list(nodes)
        self.symbol = " & ".join(f"|{n}|" for n in nodes)

    def __call__(self, signals, tau, hard=False, full=False):
        v = torch.stack([n(signals, tau, hard) for n in self.nodes], dim=-2)
        s = soft_min(v, tau, dim=-2, hard=hard)
        if full:
            return s, v
        return s


class Eventually(STLFormula):
    def __init__(self, ts: int, te: int, node: STLFormula):
        self.ts, self.te, self.node = ts, te, node
        self.symbol = f"♢[{ts}:{te}]({node})"

    def __call__(self, signals, tau, hard=False):
        return window_soft_max(self.node(signals, tau, hard), self.ts,
                               self.te, tau, hard)


class Always(STLFormula):
    def __init__(self, ts: int, te: int, node: STLFormula):
        self.ts, self.te, self.node = ts, te, node
        self.symbol = f"◻[{ts}:{te}]({node})"

    def __call__(self, signals, tau, hard=False):
        return window_soft_min(self.node(signals, tau, hard), self.ts,
                               self.te, tau, hard)


class Once(STLFormula):
    """Past-time eventually, ts < 0 and ts <= te <= 0."""

    def __init__(self, ts: int, te: int, node: STLFormula):
        assert ts < 0 and te >= ts and te <= 0
        self.ts, self.te, self.node = ts, te, node
        self.symbol = f"O[{ts}:{te}]({node})"

    def __call__(self, signals, tau, hard=False):
        return window_soft_max(self.node(signals, tau, hard), self.ts,
                               self.te, tau, hard)


class UntimedUntil(STLFormula):
    """scores[t] = softmax_{t' >= t} softmin(rhs[t'], softmin_{s <= t'}
    lhs[s]): a prefix soft min of lhs, then a suffix soft max."""

    def __init__(self, lhs: STLFormula, rhs: STLFormula):
        self.lhs, self.rhs = lhs, rhs
        self.symbol = f"({lhs}) U ({rhs})"

    def __call__(self, signals, tau, hard=False):
        ls = self.lhs(signals, tau, hard).float()
        rs = self.rhs(signals, tau, hard).float()
        if hard:
            inf_ls = cumulative(torch.minimum, ls, dim=-1)
            mn = torch.minimum(rs, inf_ls)
            return cumulative(torch.maximum, mn, dim=-1, reverse=True)
        inf_ls = -logcumsumexp(-ls * tau, dim=-1) / tau
        mn = soft_min(torch.stack([rs, inf_ls], dim=-1), tau, dim=-1)
        return logcumsumexp(mn * tau, dim=-1, reverse=True) / tau


class Until(STLFormula):
    """Timed until: ``UntimedUntil`` for ts = 0, else
    ``And(Eventually(ts, te, rhs), Always(0, ts, UntimedUntil(lhs, rhs)))``
    as the JAX package decomposes it."""

    def __init__(self, ts: int, te: int, lhs: STLFormula, rhs: STLFormula):
        if ts == 0:
            self.eval = UntimedUntil(lhs, rhs)
        else:
            self.eval = And(Eventually(ts, te, rhs),
                            Always(0, ts, UntimedUntil(lhs, rhs)))
        self.symbol = f"({lhs}) U[{ts}:{te}] ({rhs})"

    def __call__(self, signals, tau, hard=False):
        return self.eval(signals, tau, hard)
