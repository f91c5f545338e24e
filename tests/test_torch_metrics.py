"""``pstl_tpu_torch.metrics`` against ``pstl_tpu.metrics`` on the same
numpy-seeded inputs, on the CPU.

Tolerances: counts, masks and anything decided by a comparison (histogram
bins, hull edges, occupied cells, the host monotone chain) must agree
exactly; float32 sums taken in another order (means, stds, the hull's sum
of edge crosses) to rtol 1e-5 / atol 1e-6.  The hull cases with ties
(collinear and duplicate points) are exact in both packages: the edge
test's crosses are products of the same float32 operands.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pstl_tpu import metrics as jm
from pstl_tpu_torch import metrics as tm

from torch_parity import F32, np_

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, err_msg=""):
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=err_msg)


def both(fn_name, *args, **kw):
    """(port result, JAX result) of ``metrics.<fn_name>`` on numpy args."""
    t = getattr(tm, fn_name)(*[torch.as_tensor(a) for a in args], **kw)
    j = getattr(jm, fn_name)(*[jnp.asarray(a) for a in args], **kw)
    return t, j


def test_masked_std():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 8, 3).astype(F32)
    mask = (rng.rand(5, 8, 3) > 0.4).astype(F32)
    mask[0] = 0.0          # a column with no valid entry gives 0
    mask[1, :, 0] = 0.0
    for dim in (0, 1, 2):
        t = tm.masked_std(torch.as_tensor(x), torch.as_tensor(mask), dim)
        j = jm.masked_std(jnp.asarray(x), jnp.asarray(mask), axis=dim)
        close(t, j, f"dim {dim}")


def _hull_case(name, rng):
    m = {"m64": 64, "m130": 130}.get(name, 12)
    pts = rng.randn(4, 3, m, 2).astype(F32) * rng.uniform(0.5, 5)
    mask = np.ones((4, 3, m), F32)
    if name == "masked":
        mask = (rng.rand(4, 3, m) > 0.5).astype(F32)
        mask[0, 0] = 0.0                       # no valid point
        mask[0, 1, :] = 0.0
        mask[0, 1, :2] = 1.0                   # two points: no area
    elif name == "collinear":
        s = rng.randn(4, 3, m, 1).astype(F32)
        pts = np.concatenate([s, 2 * s + 1], -1).astype(F32)
        pts[1:, :, -1] = (10.0, -3.0)          # one point off the line
    elif name == "duplicates":
        pts[..., m // 2:, :] = pts[..., :m - m // 2, :]
        pts[0, 0] = pts[0, 0, :1]              # one point, m copies
    elif name in ("m64", "m130"):
        mask = (rng.rand(4, 3, m) > 0.3).astype(F32)
    return pts, mask


@pytest.mark.parametrize("name", ["random", "masked", "collinear",
                                  "duplicates", "m64", "m130"])
def test_hull_area(name):
    """The exact edge test (m <= 128) and the host monotone chain (m=130:
    bit for bit, the same numpy code)."""
    pts, mask = _hull_case(name, np.random.RandomState(len(name)))
    t, j = both("hull_area", pts, mask)
    assert t.shape == j.shape == pts.shape[:2]
    if name == "m130":
        np.testing.assert_array_equal(np_(t), np.asarray(j))
    else:
        close(t, j)
    if name == "collinear":
        assert float(t[0].abs().max()) == 0.0 and float(t[1:].min()) > 0


def test_hull_area_chunking_changes_nothing(monkeypatch):
    """The port runs the edge test over chunks of the leading cells; a chunk
    of one cell gives the same areas to the bit as one chunk of all."""
    pts, mask = _hull_case("masked", np.random.RandomState(4))
    whole = tm.hull_area(torch.as_tensor(pts), torch.as_tensor(mask))
    monkeypatch.setattr(tm, "HULL_CHUNK_ELEMS", 1)
    one = tm.hull_area(torch.as_tensor(pts), torch.as_tensor(mask))
    assert torch.equal(whole, one)


def _div_case(seed, bs=3, m=16, nt=6):
    rng = np.random.RandomState(seed)
    trajs = (rng.randn(bs, m, 3, nt * 4) * 2).astype(F32)
    scores = rng.randn(bs, m, 3).astype(F32)
    valids = np.broadcast_to((rng.rand(bs, 1, 3) > 0.3).astype(F32),
                             (bs, m, 3)).copy()
    controls = np.stack([rng.uniform(-0.6, 0.6, (bs, m, 3, nt)),
                         rng.uniform(-6, 6, (bs, m, 3, nt))],
                        -1).reshape(bs, m, 3, nt * 2).astype(F32)
    return trajs, scores, valids, controls, nt


def test_measure_diversity():
    trajs, scores, valids, _, nt = _div_case(1)
    xy = trajs.reshape(*trajs.shape[:3], nt, 4)[..., :2].reshape(
        *trajs.shape[:3], nt * 2)
    t = tm.measure_diversity(torch.as_tensor(xy), torch.as_tensor(scores),
                             torch.as_tensor(valids), nt)
    j = jm.measure_diversity(jnp.asarray(xy), jnp.asarray(scores),
                             jnp.asarray(valids), nt)
    assert sorted(t) == sorted(j)
    for k in j:
        close(t[k], j[k], k)


def _entropy_case(name, rng):
    x = rng.uniform(-1, 1, (6, 9)).astype(F32)
    mask = (rng.rand(6, 9) > 0.3).astype(F32)
    kw = {}
    if name == "bounds":
        kw = dict(x_min=-0.5, x_max=0.5)
    elif name == "edge_0.9":
        # x_min 0, x_max 1: bin edge 9 is alphas[9], 0.9 in float32 (the
        # ulp torch.linspace gets wrong); values on and beside it
        kw = dict(x_min=0.0, x_max=1.0)
        edge = np.float32(0.9)
        x[:, :3] = (edge, np.nextafter(edge, F32(0)),
                    np.nextafter(edge, F32(1)))
        mask[:, :3] = 1.0
    elif name == "all_masked":
        mask[0] = 0.0          # +-inf masks: NaN edges, entropy 0
    return x, mask, kw


@pytest.mark.parametrize("name", ["free", "bounds", "edge_0.9",
                                  "all_masked"])
def test_entropy(name):
    x, mask, kw = _entropy_case(name, np.random.RandomState(7))
    t, j = both("entropy", x, mask, **kw)
    close(t, j)
    if name == "all_masked":
        assert float(t[0]) == 0.0


def test_entropy_bin_edges_are_jax_linspace():
    """arange(11) * 0.1 in float32 is jnp.linspace(0, 1, 11) to the bit;
    torch.linspace is not (an ulp at 0.9)."""
    want = np.asarray(jnp.linspace(0.0, 1.0, 11))
    got = (torch.arange(11, dtype=torch.float32) * (1.0 / 10)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(torch.linspace(0, 1, 11).numpy(), want)


def test_occupancy_area():
    rng = np.random.RandomState(3)
    x = (rng.randn(5, 8, 6) * 4).astype(F32)
    y = (rng.randn(5, 8, 6) * 2).astype(F32)
    th = rng.uniform(-np.pi, np.pi, (5, 8, 6)).astype(F32)
    val = (rng.rand(5, 8, 6) > 0.4).astype(F32)
    val[0] = 0.0           # every point at the origin: a zero-area row
    t, j = both("occupancy_area", x, y, th, val)
    close(t, j)


def test_measure_extra_diversity():
    trajs, scores, valids, controls, nt = _div_case(2)
    args = [torch.as_tensor(a) for a in (trajs, scores, valids)]
    t = tm.measure_extra_diversity(*args, nt, torch.as_tensor(controls),
                                   -0.5, 0.5, -5.0, 5.0)
    j = jm.measure_extra_diversity(
        *[jnp.asarray(a) for a in (trajs, scores, valids)], nt,
        jnp.asarray(controls), -0.5, 0.5, -5.0, 5.0)
    assert sorted(t) == sorted(j)
    for k in j:
        close(t[k], j[k], k)


def test_label_score_breakdown():
    """Outlier labels (3) are left out of every rate."""
    rng = np.random.RandomState(5)
    scores = rng.randn(6, 4, 3).astype(F32)
    labels = np.array([0, 1, 2, 3, 1, 3], F32)
    valids = (rng.rand(6, 4, 3) > 0.2).astype(F32)
    t, j = both("label_score_breakdown", scores, labels, valids)
    assert sorted(t) == sorted(j)
    for k in j:
        close(t[k], j[k], k)
    # the outliers' scores do not move any rate
    s2 = scores.copy()
    s2[labels == 3] *= -1
    t2 = tm.label_score_breakdown(torch.as_tensor(s2),
                                  torch.as_tensor(labels),
                                  torch.as_tensor(valids))
    for k in t:
        assert torch.equal(t[k], t2[k]), k


def test_ade_fde():
    rng = np.random.RandomState(6)
    gt = rng.randn(3, 6, 4).astype(F32)
    est = rng.randn(3, 4, 3, 6, 4).astype(F32)
    mask = (rng.rand(3, 12) > 0.3).astype(F32)
    t, j = both("ade_fde", gt, est, mask)
    for a, b in zip(t, j):
        close(a, b)
