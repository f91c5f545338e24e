"""The scene store: a store written by ``pstl_tpu.data.dataset`` loads in
``pstl_tpu_torch.data.dataset`` bit for bit and the reverse, its split file
included; ``load_trajopt_sidecar`` attaches the same columns in both
packages, with the seed axis resampled when M != n_randoms.  Exact: the
store is numpy through and through."""

import os

import numpy as np
import pytest

from pstl_tpu.config import Config as JConfig
from pstl_tpu.data.dataset import SceneDataset as JDataset
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.data.dataset import SceneDataset as TDataset

KW = dict(n_randoms=3, n_neighbors=2, diffusion=True, flex=True)


def _cfgs(**kw):
    return JConfig(**KW, **kw), TConfig(**KW, **kw)


def _same(a, b):
    """Two datasets hold the same columns, scene columns and splits, dtype
    and bits."""
    for x, y in ((a.data, b.data), (a.scene_data, b.scene_data),
                 (a.splits, b.splits)):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def _sidecar_columns(ds, rng, M):
    """Random trajopt columns with M seeds."""
    n, nt = len(ds), ds.cfg.nt
    return {"params": rng.randn(n, M, 3, nt, 2).astype(np.float32),
            "params_init": rng.randn(n, M, 3, nt, 2).astype(np.float32),
            "pre_stlp": rng.randn(n, M, 3, 1, 6).astype(np.float32),
            "tj_scores_prior": rng.randn(n, M, 3).astype(np.float32)}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_round_trip_between_packages(writer, tmp_path):
    """Written by one package (trajopt columns, per-scene columns and a
    split that is not the default permutation), loaded by the other."""
    cj, ct = _cfgs()
    src_cls, dst_cls, src_cfg, dst_cfg = (
        (JDataset, TDataset, cj, ct) if writer == "jax"
        else (TDataset, JDataset, ct, cj))
    src = src_cls.from_synthetic(src_cfg, seed=0, n_scenes=10,
                                 scene_len=12)
    src.ensure_random_params(1)
    for k, v in _sidecar_columns(src, np.random.RandomState(2),
                                 src_cfg.n_randoms).items():
        if k not in ("params", "params_init"):
            src.attach(k, v)
    src.splits = {"train": np.arange(0, 10, 2), "val": np.arange(1, 10, 2)}
    path = str(tmp_path / "sub" / "store.npz")
    src.save(path)
    assert os.path.exists(path + ".split.txt")
    assert src.scene_data, "the synthetic store carries per-scene columns"
    got = dst_cls.load(path, dst_cfg)
    _same(got, src)
    assert got.has("pre_stlp") and not got.has("missing")


def test_split_on_the_fly_ignores_the_file(tmp_path):
    """generate_split_on_the_fly: both packages ignore the split file and
    draw the default permutation."""
    cj, ct = _cfgs(generate_split_on_the_fly=True)
    ds = TDataset.from_synthetic(ct, seed=0, n_scenes=8)
    default = {k: v.copy() for k, v in ds.splits.items()}
    ds.splits = {"train": np.arange(4), "val": np.arange(4, 8)}
    path = str(tmp_path / "store.npz")
    ds.save(path)
    got_t, got_j = TDataset.load(path, ct), JDataset.load(path, cj)
    for k in default:
        np.testing.assert_array_equal(got_t.splits[k], default[k])
        np.testing.assert_array_equal(got_j.splits[k], default[k])


@pytest.mark.parametrize("M", [3, 5, 2])
def test_trajopt_sidecar(M, tmp_path):
    """The columns of another store, M seeds resampled to n_randoms = 3
    with RandomState(0) where M differs; equal in both packages."""
    cj, ct = _cfgs()
    dj = JDataset.from_synthetic(cj, seed=0, n_scenes=6)
    dt = TDataset.from_synthetic(ct, seed=0, n_scenes=6)
    side = _sidecar_columns(dt, np.random.RandomState(3), M)
    del side["params_init"]          # a column the sidecar lacks stays out
    path = str(tmp_path / "side.npz")
    np.savez(path, **side)
    dj.load_trajopt_sidecar(path)
    dt.load_trajopt_sidecar(path)
    _same(dt, dj)
    assert dt.data["params"].shape[1] == 3 and not dt.has("params_init")
    if M == 3:
        np.testing.assert_array_equal(dt.data["params"], side["params"])


def test_trajopt_sidecar_row_mismatch_raises(tmp_path):
    _, ct = _cfgs()
    dt = TDataset.from_synthetic(ct, seed=0, n_scenes=6)
    path = str(tmp_path / "side.npz")
    np.savez(path, params=np.zeros((5, 3, 3, ct.nt, 2), np.float32))
    with pytest.raises(ValueError, match="5 rows"):
        dt.load_trajopt_sidecar(path)
