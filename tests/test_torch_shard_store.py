"""The port's native shard store (``pstl_tpu_torch/runtime``) and its use by
``train.train``: mirrors of ``tests/test_runtime.py`` (gather, dtype,
bounds check, prefetch, reuse, the ``SceneDataset`` round trip), stores
written by either package read by the other, batches equal to
``batch_iterator``'s bit for bit, and one small epoch of
``train.train(use_shard_store=True, time_profile=True)`` on the CPU, whose
per-batch metrics equal the run on ``batch_iterator``'s batches."""

import os

import numpy as np
import pytest

from pstl_tpu.runtime import ShardStore as JShardStore
from pstl_tpu.runtime import write_store as jwrite_store
from pstl_tpu_torch import train
from pstl_tpu_torch.config import mono_config
from pstl_tpu_torch.data.dataset import (SceneDataset, batch_iterator,
                                         shard_store_iterator, to_shard_store)
from pstl_tpu_torch.ops._build import BUILD_ROOT
from pstl_tpu_torch.runtime import ShardStore, shard_store, write_store

import torch_parity  # noqa: F401  (torch thread count)


def _data(seed=0, n=64):
    rng = np.random.RandomState(seed)
    return {"ego_traj": rng.randn(n, 20, 6).astype(np.float32),
            "neighbors": rng.randn(n, 8, 7).astype(np.float32),
            "labels": rng.randint(0, 4, (n, 1)).astype(np.int64)}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("store"))
    data = _data()
    write_store(path, data)
    ss = ShardStore(path, n_threads=4)
    yield ss, data
    ss.close()


def test_library_builds_into_build_dir(store):
    path = shard_store.lib_path()
    assert path.startswith(BUILD_ROOT + os.sep)
    assert os.path.exists(path)
    assert not os.path.exists(os.path.join(
        os.path.dirname(shard_store.__file__), "_shardstore.so"))


def test_gather_matches_numpy(store):
    ss, data = store
    idx = np.asarray([5, 0, 63, 17, 17, 2])
    out = ss.gather(idx)
    for k in data:
        np.testing.assert_array_equal(out[k], data[k][idx])


def test_gather_dtype_and_shape(store):
    ss, _ = store
    out = ss.gather(np.asarray([1, 2]), columns=["labels"])
    assert out["labels"].dtype == np.int64
    assert out["labels"].shape == (2, 1)


def test_gather_bounds_check(store):
    ss, _ = store
    with pytest.raises(RuntimeError):
        ss.gather(np.asarray([999]))


def test_prefetch_iterator(store):
    ss, data = store
    idx = np.random.RandomState(1).permutation(64)
    batches = list(ss.iter_batches(idx, batch_size=16))
    assert len(batches) == 4
    for bi, b in enumerate(batches):
        sel = idx[bi * 16:(bi + 1) * 16]
        for k in data:
            np.testing.assert_array_equal(b[k], data[k][sel])


def test_prefetch_reuse(store):
    """The iterator can be restarted (the worker thread survives)."""
    ss, data = store
    for _ in range(2):
        bs = list(ss.iter_batches(np.arange(64), batch_size=32))
        assert len(bs) == 2
        np.testing.assert_array_equal(bs[0]["ego_traj"],
                                      data["ego_traj"][:32])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_reads_in_the_other_package(tmp_path, writer):
    """A store written by either package gathers the same rows in both."""
    data = _data(3, 40)
    path = str(tmp_path / "store")
    (jwrite_store if writer == "jax" else write_store)(path, data)
    idx = np.random.RandomState(2).permutation(40)
    a, b = JShardStore(path, n_threads=2), ShardStore(path, n_threads=2)
    try:
        assert a.columns == b.columns and a.n_rows == b.n_rows == 40
        ga, gb = a.gather(idx), b.gather(idx)
        for k in data:
            np.testing.assert_array_equal(gb[k], data[k][idx])
            np.testing.assert_array_equal(ga[k], gb[k])
        for x, y in zip(a.iter_batches(idx, 8), b.iter_batches(idx, 8)):
            for k in data:
                np.testing.assert_array_equal(x[k], y[k])
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("split,shuffle", [("train", True), ("val", False)])
def test_scene_dataset_batches_equal_batch_iterator(tmp_path, split,
                                                    shuffle):
    """SceneDataset -> shard store -> iterator: one epoch's batches equal
    ``batch_iterator``'s bit for bit, column for column (the same
    permutation, the ragged tail dropped)."""
    cfg = mono_config("e2_vae_mono", n_randoms=2, n_neighbors=2)
    ds = SceneDataset.from_synthetic(cfg, n_scenes=23)
    ds.ensure_random_params(0)
    path = str(tmp_path / "store")
    to_shard_store(ds, path)
    store = ShardStore(path)
    try:
        for epoch in (0, 1):
            got = list(shard_store_iterator(store, ds, split, 4,
                                            shuffle=shuffle, seed=1,
                                            epoch=epoch))
            want = list(batch_iterator(ds, split, 4, shuffle=shuffle,
                                       seed=1, epoch=epoch))
            assert len(got) == len(want) == ds.split_len(split) // 4
            for g, w in zip(got, want):
                assert sorted(g) == sorted(w)
                for k in w:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    finally:
        store.close()


def test_train_epoch_via_shard_store(tmp_path, monkeypatch):
    """``use_shard_store``: one epoch served by the native gather and
    prefetch path, its store under exps/_tmp/shard_store (restricted to the
    step's columns); its per-batch metrics equal those of the run on
    ``batch_iterator``.  ``time_profile`` logs the four sections a pass."""
    monkeypatch.chdir(tmp_path)
    cfg = mono_config("e2_vae_mono", hiddens=(32, 32), vae_dim=8,
                      n_randoms=4, batch_size=4, n_neighbors=3)

    def run(**kw):
        ds = SceneDataset.from_synthetic(cfg, n_scenes=14)
        hist, logs = [], []
        state = train.train(cfg.with_(**kw), ds, epochs=1, device="cpu",
                            log=logs.append, history=hist)
        return state, hist, logs

    state, hist, logs = run(use_shard_store=True, time_profile=True)
    assert os.path.exists(os.path.join("exps", "_tmp", "shard_store",
                                       "meta.json"))
    assert state.step == 2 and [m for _, m, _ in hist] == ["train"] * 2 + [
        "val"]
    prof = [ln for ln in logs if ln.startswith("profile[")]
    assert len(prof) == 2
    for ln in prof:
        for sec in ("data->h2d", "h2d->step", "step->log"):
            assert sec in ln, ln
    _, ref, _ = run()
    assert hist == ref
