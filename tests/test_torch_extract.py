"""The port's NuScenes extraction (``pstl_tpu_torch.data.extract``) against
``pstl_tpu.data.extract``.

Every case of ``tests/test_extract.py`` runs through both modules' functions
on the same inputs (``MockMap``, the analytic three-lane road, built on
each module's own ``MapAdapter``) and the outputs must be equal, array for
array and bit for bit: the module is numpy only, copied line for line.  The
golden capsule of the devkit path (``tests/golden/``) is replayed through
the port within the JAX test's atol 1e-6 (it reads 0 on one platform),
through the jax-free fake devkit of ``tests/torch_devkit_shim.py``, which
``chip_smoke.py`` uses on the card's host as well.
"""

import numpy as np
import pytest

from pstl_tpu.config import Config as JConfig
from pstl_tpu.data import extract as jextract
from pstl_tpu_torch import cli
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.data import extract as textract
from pstl_tpu_torch.data.dataset import SceneDataset

import torch_devkit_shim as shim
from test_extract import LANE_OFF, MockMap, _lane_pts, straight_ego

#: MockMap on the port's adapter (its default drivable_mask)
TMockMap = type("TMockMap", (textract.MapAdapter,), {
    k: v for k, v in vars(MockMap).items()
    if k == "__init__" or not k.startswith("__")})


def _cfg(Config):
    return Config(n_neighbors=2, n_randoms=2)


def _mock_scene(Map, cfg, L=40):
    """``test_extract._mock_scene`` on ``Map``."""
    m = Map(intersection=(1e9, 1e9))
    ego = straight_ego(L)
    nei = np.zeros((cfg.n_neighbors, L, 7), np.float32)
    nei[0, :, 0] = 1.0
    nei[0, :, 1] = 30.0 + np.arange(L) * 2.0 * 0.5
    nei[0, :, 2] = LANE_OFF
    nei[0, :, 4] = 2.0
    nei[0, :, 5] = 4.0
    nei[0, :, 6] = 2.0
    return m, ego, nei


def _helpers(ex, Map, Config):
    lane = np.stack([np.linspace(0, 30, 15), np.zeros(15), np.zeros(15)], -1)
    straight = np.stack([np.linspace(0, 20, 20), np.zeros(20),
                         np.zeros(20), np.full(20, 4.0)], -1)
    left = straight.copy()
    left[:, 1] = np.linspace(0, 3.5, 20)
    rows = [np.array([1, d, 0, 0, 1, 4, 2], np.float32)
            for d in (5.0, 1.0, 3.0)]
    kf3 = {0: 0.0, 10: 1.0, 30: 2.0}
    rng = np.random.RandomState(0)
    q = rng.randn(4, 4)
    return {
        "heading": [ex.heading_from_quaternion(v)
                    for v in [[1.0, 0, 0, 0]] + list(q)],
        "resample_wpts": ex.resample_wpts(
            _lane_pts(0.0, 0.0, 10.0, step=1.0), 5),
        "resample_polyline": ex.resample_polyline(
            np.stack([np.linspace(0, 10, 7), rng.randn(7)], -1), 15),
        "knn_pad": [ex.knn_pad_neighbors(np.zeros(2), rows, k=k)
                    for k in (2, 4)],
        "interp_track": ex.interp_track(
            np.array([0.0, 1.0, 2.5]),
            np.array([[0, 0, 0, 2.0], [2, 0.5, 0.1, 2.0], [5, 1, 0.3, 3.0]]),
            np.array([-0.5, 0.5, 1.0, 2.0, 4.0])),
        "label_high_level": [ex.label_high_level(t, lane)
                             for t in (straight, left)],
        "keyframes": [ex.high_level_from_keyframes(kf3, ti, h)
                      for ti, h in ((35, 20), (15, 10), (25, 10), (0, 5))],
        "angle_traj_len": [ex.angle_penalty(0.3, 2.0),
                           ex.traj_len(straight)],
    }


def _lanes(ex, Map, Config):
    m = Map()
    ego = straight_ego(40)
    cur = ex.current_lane_search(m, ego, 4, 15)
    gated = straight_ego(20)
    gated[:, 2] = np.pi
    ego20 = straight_ego(20)
    _, cid, _, cfull = ex.current_lane_search(m, ego20, 4, 15)
    sides = [ex.side_lane_search(m, ego20, s, cid, cfull, 4, 15)
             for s in ("left", "right")]
    mi = Map(intersection=(-5.0, 5.0))
    _, cid_i, _, cfull_i = ex.current_lane_search(mi, ego20, 4, 15)
    supp = [ex.side_lane_search(mi, ego20, "left", cid_i, cfull_i, 4, 15,
                                highlevel=hl) for hl in (-1, 1)]
    return {"current": cur, "gate": ex.current_lane_search(m, gated, 4, 15),
            "sides": sides, "dedup": ex.same_lane_dedup(cfull, cfull + 0.1),
            "suppression": supp,
            "lane_select": ex.select_current_lane(
                m.lanes_near(0.0, 0.0, 10.0), ego20)}


def _uturn(ex, Map, Config):
    m = Map()
    curr = _lane_pts(0.0, 0.0, 30.0)
    oppo = _lane_pts(LANE_OFF, 0.0, 30.0, heading=np.pi)
    same = _lane_pts(LANE_OFF, 0.0, 30.0)
    far = _lane_pts(10.0, 0.0, 30.0, heading=np.pi)
    slow = np.array([0.0, 0.0, 0.0, 2.0])
    fast = np.array([0.0, 0.0, 0.0, 6.0])
    m2 = Map(hole=(3.5, 4.5, 0.0, 3.5))
    return {"gate": [ex.uturn_gate(mm, st, curr, side, True, "left", -1)
                     for mm, st, side in ((m, slow, oppo), (m, fast, oppo),
                                          (m2, slow, oppo), (m, slow, same))],
            "feasible": [ex.uturn_feasible(m, slow, curr, far),
                         ex.uturn_feasible(m, slow, curr, oppo)]}


def _scene(ex, Map, Config):
    cfg = _cfg(Config)
    m, ego, nei = _mock_scene(Map, cfg)
    out = {}
    for stride in (1, 4):
        samples, rec = ex.extract_scene(m, ego, nei, cfg,
                                        sample_stride=stride)
        out[stride] = (samples, rec, ex.pack_samples(samples, [rec]))
    ks = ex.extract_scene(m, ego, nei, cfg, sample_stride=4,
                          keyframes={0: 0.0, 12: 1.0})
    return {"scene": out, "keyframed": ks,
            "mask": m.drivable_mask([10.0, 0.0], 8.0, 0.5)}


CASES = {"helpers": _helpers, "lanes": _lanes, "uturn": _uturn,
         "scene": _scene}


def assert_same(got, want, path="out"):
    """Equal structure, and equal values bit for bit."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and (got == want or (
            got != got and want != want)), (path, got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cases_equal_jax(case):
    """The mock-map cases of tests/test_extract.py, both modules, equal."""
    want = CASES[case](jextract, MockMap, JConfig)
    got = CASES[case](textract, TMockMap, TConfig)
    assert_same(got, want)


def test_golden_capsule_replays(tmp_path):
    """The committed capsule through the port's devkit path (the fake
    devkit), every array within atol 1e-6 and of the same dtype."""
    cfg = TConfig(**shim.GOLDEN_CFG).finalize()
    out = str(tmp_path / "cache.npz")
    with shim.fake_devkit_ctx():
        textract.extract_dataset(cfg, version="v1.0-mini", dataroot=None,
                                 out_path=out,
                                 sample_stride=shim.GOLDEN_STRIDE,
                                 table_cache_path=None)
    got = dict(np.load(out, allow_pickle=False))
    want = dict(np.load(shim.GOLDEN, allow_pickle=False))
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(
            np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
            rtol=0, atol=1e-6, err_msg=k)


def test_table_cache_skips_devkit_reparse(tmp_path):
    """A second extraction reads the pickled tables, not the devkit DB."""
    cfg = TConfig(**shim.GOLDEN_CFG).finalize()
    out, tbl = str(tmp_path / "c.npz"), str(tmp_path / "tables.pkl")
    with shim.fake_devkit_ctx():
        for _ in range(2):
            textract.extract_dataset(cfg, version="v1.0-mini",
                                     dataroot=str(tmp_path), out_path=out,
                                     sample_stride=10, table_cache_path=tbl)
        assert shim.FakeNuScenes.constructed == 1
    assert np.load(out)["ego_traj"].shape[0] >= 2


def test_extract_dataset_raises_without_devkit(tmp_path):
    assert not textract.HAVE_NUSCENES
    with pytest.raises(RuntimeError, match="nuscenes-devkit is not "
                                           "installed"):
        textract.extract_dataset(TConfig().finalize(), version="v1.0-mini",
                                 dataroot=str(tmp_path),
                                 out_path=str(tmp_path / "x.npz"))


def test_cli_data_real_writes_a_loadable_cache(tmp_path, capsys):
    """``cli data --real`` through the fake devkit: the cache it writes
    loads as a ``SceneDataset`` with the per-sample and scene arrays."""
    out = str(tmp_path / "real.npz")
    with shim.fake_devkit_ctx():
        cli.main(["data", "--real", "--out", out, "--version", "v1.0-mini",
                  "--dataroot", str(tmp_path), "--t-stride", "6",
                  "--set", "n_neighbors=2"])
    assert "extracted NuScenes cache" in capsys.readouterr().out
    cfg = TConfig(n_neighbors=2).finalize()
    ds = SceneDataset.load(out, cfg)
    assert len(ds) >= 6
    data = np.load(out)
    assert data["ego_traj"].shape[1:] == (cfg.nt, 6)
    assert data["scene_drivable"].shape[0] == 2
