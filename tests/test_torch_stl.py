"""The port's STL formula tree (``pstl_tpu_torch/ops/stl.py``) against the
JAX package's (``pstl_tpu/ops/stl.py``) on the same numpy-seeded signals,
mirroring ``tests/test_stl.py`` test for test, and against its numpy
oracles where that test has one.

Tolerances.  Values: rtol / atol 1e-5 where both sides run the same
reductions; the scans (a reverse ``logcumsumexp``: an associative scan of
``logaddexp`` in JAX, ``torch.logcumsumexp`` here) add in another order,
and a tau = 100 soft value carries an fp32 rounding of x * tau (|x| ~ 6,
so ~4e-5 of x * tau) divided by tau back: atol 2e-5.  Gradients: rtol
1e-4 with an atol of 1e-6 (the tau = 100 softmax weights are exponentials
of differences ~100 apart, whose fp32 rounding reaches ~1e-5 relative).
Hard values and gradients are exact selections: equal to the bit, with
ties split evenly on both sides (``torch.amax`` / ``amin`` as ``jnp.max`` /
``min``).  The numpy oracles: ``tests/test_stl.py``'s tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu.ops import stl as jstl
from pstl_tpu_torch.ops import stl as tstl

from torch_parity import F32, np_
from test_stl import np_softmax, np_softmin, np_window_reduce

VAL = dict(rtol=1e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
EXACT = dict(rtol=0, atol=0)


@pytest.fixture
def sig():
    rng = np.random.RandomState(0)
    return rng.randn(7, 20).astype(F32) * 2.0


def _pair(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(7, 20).astype(F32)


def both(make, signals, tau, hard=False):
    """(port, jax) traces of the formula ``make(stl_module)`` on the numpy
    ``signals``."""
    t = make(tstl)({k: torch.as_tensor(v) for k, v in signals.items()}, tau,
                   hard)
    j = make(jstl)({k: jnp.asarray(v) for k, v in signals.items()}, tau, hard)
    return np_(t), np.asarray(j)


def grads(make, signals, tau, hard=False, t_sel=0):
    """d sum(trace[:, t_sel]) / d signals on both sides (finite entries
    only), as {name: (port, jax)}."""
    tin = {k: torch.as_tensor(v).requires_grad_(True)
           for k, v in signals.items()}
    out = make(tstl)(tin, tau, hard)[:, t_sel]
    torch.where(torch.isfinite(out), out, 0.0).sum().backward()

    def jloss(jin):
        out = make(jstl)(jin, tau, hard)[:, t_sel]
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0))

    jg = jax.grad(jloss)({k: jnp.asarray(v) for k, v in signals.items()})
    return {k: (np_(tin[k].grad), np.asarray(jg[k])) for k in signals}


def test_soft_max_matches_jax_and_oracle(sig):
    for tau in [1.0, 10.0, 100.0]:
        got = tstl.soft_max(torch.as_tensor(sig), tau, dim=-1)
        np.testing.assert_allclose(np_(got), np.asarray(
            jstl.soft_max(jnp.asarray(sig), tau, axis=-1)), **VAL)
        np.testing.assert_allclose(np_(got), np_softmax(sig, tau),
                                   rtol=2e-5, atol=2e-5)


def test_hard_mode_is_exact_max(sig):
    got = tstl.soft_max(torch.as_tensor(sig), 100.0, dim=-1, hard=True)
    np.testing.assert_array_equal(np_(got), sig.max(-1))
    np.testing.assert_array_equal(np_(got), np.asarray(
        jstl.soft_max(jnp.asarray(sig), 100.0, axis=-1, hard=True)))


def test_soft_converges_to_hard(sig):
    got = tstl.soft_max(torch.as_tensor(sig), 1e4, dim=-1)
    np.testing.assert_allclose(np_(got), sig.max(-1), atol=1e-2)
    np.testing.assert_allclose(np_(got), np.asarray(
        jstl.soft_max(jnp.asarray(sig), 1e4, axis=-1)), **VAL)


#: every kind of window: the suffix fast path (0, T) and one past T, inner,
#: clipped at both ends, past-time (Once's), empty at early t, and empty at
#: every t
WINDOWS = [(0, 20), (0, 40), (0, 10), (3, 8), (-5, 0), (-3, -1), (15, 40),
           (25, 30)]


@pytest.mark.parametrize("ts,te", WINDOWS)
@pytest.mark.parametrize("hard", [False, True])
def test_window_ops_match_jax(sig, ts, te, hard):
    for tau in [10.0, 100.0]:
        for name in ("window_soft_max", "window_soft_min"):
            got = getattr(tstl, name)(torch.as_tensor(sig), ts, te, tau,
                                      hard)
            want = getattr(jstl, name)(jnp.asarray(sig), ts, te, tau, hard)
            np.testing.assert_allclose(np_(got), np.asarray(want),
                                       **(EXACT if hard else VAL))
            if not hard:
                kind = "max" if name.endswith("max") else "min"
                np.testing.assert_allclose(
                    np_(got), np_window_reduce(sig, ts, te, tau, kind),
                    rtol=2e-4, atol=2e-4)


def test_always_eventually_formulas(sig):
    for make in (lambda m: m.Always(0, 20, m.AP(lambda s: s["x"])),
                 lambda m: m.Eventually(0, 10, m.AP(lambda s: s["x"]))):
        for hard in (False, True):
            got, want = both(make, {"x": sig}, 100.0, hard)
            np.testing.assert_allclose(got, want, **(EXACT if hard else VAL))


def test_nested_eventually_always(sig):
    """♢[0:10] ◻[0:20] x: the lane-change clauses' structure."""
    make = lambda m: m.Eventually(0, 10, m.Always(0, 20, m.AP(
        lambda s: s["x"])))
    got, want = both(make, {"x": sig}, 100.0)
    np.testing.assert_allclose(got, want, **VAL)
    inner = np_window_reduce(sig, 0, 20, 100.0, "min")
    np.testing.assert_allclose(got, np_window_reduce(inner, 0, 10, 100.0,
                                                     "max"),
                               rtol=2e-4, atol=2e-4)
    got, want = both(make, {"x": sig}, 100.0, hard=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hard", [False, True])
def test_and_or_not_imply(sig, hard):
    signals = {"a": sig, "b": _pair(1)}
    a = lambda m: m.AP(lambda s: s["a"])
    b = lambda m: m.AP(lambda s: s["b"])
    for make in (lambda m: m.And(a(m), b(m)), lambda m: m.Or(a(m), b(m)),
                 lambda m: m.Not(a(m)), lambda m: m.Imply(a(m), b(m))):
        got, want = both(make, signals, 100.0, hard)
        np.testing.assert_allclose(got, want, **(EXACT if hard else VAL))
    got, _ = both(lambda m: m.Imply(a(m), b(m)), signals, 100.0, hard)
    if not hard:
        np.testing.assert_allclose(
            got, np_softmax(np.stack([-sig, signals["b"]], -1), 100.0),
            rtol=2e-4, atol=2e-4)


def test_listand_full(sig):
    signals = {"a": sig, "b": _pair(2)}
    nodes = lambda m: [m.AP(lambda s: s["a"]), m.AP(lambda s: s["b"])]
    for hard in (False, True):
        s, v = tstl.ListAnd(nodes(tstl))(
            {k: torch.as_tensor(x) for k, x in signals.items()}, 100.0,
            hard, full=True)
        js, jv = jstl.ListAnd(nodes(jstl))(
            {k: jnp.asarray(x) for k, x in signals.items()}, 100.0, hard,
            full=True)
        assert tuple(v.shape) == (7, 2, 20)
        np.testing.assert_array_equal(np_(v), np.asarray(jv))
        np.testing.assert_allclose(np_(s), np.asarray(js),
                                   **(EXACT if hard else VAL))
    soft, _ = tstl.ListAnd(nodes(tstl))(
        {k: torch.as_tensor(x) for k, x in signals.items()}, 100.0,
        full=True)
    np.testing.assert_allclose(
        np_(soft), np_softmin(np.stack([sig, signals["b"]], 1), 100.0,
                              axis=1), rtol=2e-4, atol=2e-4)


def _until(m):
    return m.UntimedUntil(m.AP(lambda s: s["l"]), m.AP(lambda s: s["r"]))


def test_untimed_until_soft(sig):
    signals = {"l": sig, "r": _pair(3)}
    got, want = both(_until, signals, 10.0)
    np.testing.assert_allclose(got, want, **VAL)
    # the oracle of tests/test_stl.py: suffix soft max of the soft min of
    # rhs and lhs's full prefix soft min
    ls, rs = sig, signals["r"]
    n, T = ls.shape
    oracle = np.zeros((n, T))
    for t in range(T):
        vals = [np_softmin(np.stack([rs[:, t2], np_softmin(ls[:, :t2 + 1],
                                                           10.0)], -1), 10.0)
                for t2 in range(t, T)]
        oracle[:, t] = np_softmax(np.stack(vals, -1), 10.0)
    np.testing.assert_allclose(got, oracle, rtol=5e-4, atol=5e-4)


def test_untimed_until_hard(sig):
    signals = {"l": sig, "r": _pair(4)}
    got, want = both(_until, signals, 10.0, hard=True)
    np.testing.assert_array_equal(got, want)
    ls, rs = sig, signals["r"]
    oracle = np.stack([np.stack([np.minimum(rs[:, t2], ls[:, :t2 + 1].min(-1))
                                 for t2 in range(t, 20)], -1).max(-1)
                       for t in range(20)], -1)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ts,te", [(0, 8), (3, 8), (5, 40)])
@pytest.mark.parametrize("hard", [False, True])
def test_until_timed(sig, ts, te, hard):
    """Until with ts > 0 is And(Eventually(ts, te, rhs), Always(0, ts,
    UntimedUntil)); with ts = 0 it is UntimedUntil: values at tau 10 and
    100, gradients at tau 10 (and hard)."""
    signals = {"l": sig, "r": _pair(5)}
    make = lambda m: m.Until(ts, te, m.AP(lambda s: s["l"]),
                             m.AP(lambda s: s["r"]))
    for tau in (10.0, 100.0):
        got, want = both(make, signals, tau, hard)
        np.testing.assert_allclose(got, want, **(EXACT if hard else VAL))
    for k, (g, w) in grads(make, signals, 10.0, hard).items():
        assert np.all(np.isfinite(w))
        np.testing.assert_allclose(g, w, **(EXACT if hard else GRAD),
                                   err_msg=k)


def test_until_gradient_where_jax_overflows(sig):
    """A fault of the reference, pinned: where Eventually(ts, te) runs past
    the horizon (every Until with ts > 0: -inf at its last ts steps), the
    And's soft min sees an infinite entry, JAX's logsumexp then shifts by 0
    instead of the max, and exp(tau * x) of the other entry overflows for
    tau * |x| > 88: 0 * inf gives NaN gradients at tau = 100, which spread
    over the whole signal.  ``torch.logsumexp``'s gradient, exp(x - out),
    does not overflow: the port's gradients are finite, and equal JAX's
    wherever JAX's are."""
    signals = {"l": sig, "r": _pair(5)}
    make = lambda m: m.Until(3, 8, m.AP(lambda s: s["l"]),
                             m.AP(lambda s: s["r"]))
    g = grads(make, signals, 100.0)
    assert any(np.isnan(w).any() for _, w in g.values())
    for k, (gt, w) in g.items():
        assert np.all(np.isfinite(gt)), k
        ok = np.isfinite(w)
        np.testing.assert_allclose(gt[ok], w[ok], **GRAD, err_msg=k)
    # at tau = 10 nothing overflows, and every gradient agrees (above)


@pytest.mark.parametrize("hard", [False, True])
def test_once_empty_window_value_and_gradient(sig, hard):
    """Once(-3, 0) at t = 0 looks at an empty window: -inf, and no gradient
    (``torch.where`` + ``logsumexp`` as ``jnp.where`` + JAX's logsumexp);
    later t see 1-3 past steps."""
    make = lambda m: m.Once(-3, 0, m.AP(lambda s: s["x"]))
    got, want = both(make, {"x": sig}, 100.0, hard)
    assert np.all(np.isneginf(got[:, 0])) and np.all(np.isneginf(want[:, 0]))
    np.testing.assert_allclose(got, want, **(EXACT if hard else VAL))
    for t_sel in (0, 1, 5):
        (g, w), = grads(make, {"x": sig}, 100.0, hard, t_sel).values()
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, **(EXACT if hard else GRAD))
        if t_sel == 0:
            assert not np.any(g)


@pytest.mark.parametrize("hard", [False, True])
def test_gradients_match_jax(sig, hard):
    """autograd against jax.grad: the lane-change clause's nested window,
    a ListAnd over every operator, at t = 0 and t = 4."""
    signals = {"a": sig, "b": _pair(6)}

    def make(m):
        a, b = m.AP(lambda s: s["a"]), m.AP(lambda s: s["b"])
        return m.ListAnd([
            m.Eventually(0, 10, m.Always(0, 20, m.And(a, b))),
            m.Always(2, 9, m.Or(a, m.Not(b))),
            m.Imply(a, m.Eventually(0, 20, b)),
            m.UntimedUntil(a, b)])

    for t_sel in (0, 4):
        g = grads(make, signals, 100.0, hard, t_sel)
        assert sum(np.abs(w).sum() for _, w in g.values()) > 0
        for k, (gt, w) in g.items():
            np.testing.assert_allclose(gt, w, **(EXACT if hard else GRAD),
                                       err_msg=k)


def test_window_mask_built_once_per_device():
    """The (T, T) masks are made with numpy once per (T, ts, te) and kept
    on each device: a second evaluation builds nothing."""
    x = torch.as_tensor(_pair(7))
    tstl.window_soft_max(x, 3, 8, 100.0)
    built = tstl._window_mask.cache_info().misses
    tstl.window_soft_max(x * 2, 3, 8, 100.0, hard=True)
    assert tstl._window_mask.cache_info().misses == built
    mask = tstl._window_mask(20, 3, 8, torch.device("cpu"))
    assert mask.dtype == torch.bool and tuple(mask.shape) == (20, 20)
    np.testing.assert_array_equal(np_(mask), np.asarray(
        jstl._window_mask(20, 3, 8)))


def test_large_tau_stability(sig):
    """tau = 100 on O(100) magnitudes stays finite in fp32; at tau = 1e4 a
    formula's soft value is within 1e-2 of its hard one."""
    x = np.array([[50.0, -80.0, 99.0]], F32)
    got = tstl.soft_max(torch.as_tensor(x), 100.0, dim=-1)
    assert np.isfinite(float(got[0]))
    np.testing.assert_allclose(np_(got), 99.0, atol=1e-3)
    make = lambda m: m.Eventually(0, 10, m.Always(0, 20, m.AP(
        lambda s: s["x"])))
    soft, jsoft = both(make, {"x": sig}, 1e4)
    hard, _ = both(make, {"x": sig}, 1e4, hard=True)
    assert np.all(np.isfinite(soft))
    np.testing.assert_allclose(soft, jsoft, **VAL)
    np.testing.assert_allclose(soft, hard, atol=1e-2)
