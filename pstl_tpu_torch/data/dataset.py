"""Fixed-shape scene dataset and batch iterator — a numpy mirror of
``pstl_tpu/data/dataset.py`` (``SceneDataset`` with its npz store and
train/val split file, and ``batch_iterator``; the shard store is not
ported).

Everything lives in one dict of stacked arrays; a batch is an index
shuffle plus a gather.  The trajopt sidecars (``params``, ``params_init``,
``pre_stlp``, ``tj_scores_prior``) are columns of the same store, keyed by
sample.  The same ``np.random.RandomState`` draws in the same order give
the JAX package's splits, shuffles and random control seeds bit for bit
(``tests/test_torch_mono_specs.py``), and a store written by either
package loads in the other bit for bit (``tests/test_torch_store.py``).
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Iterator, Optional

import numpy as np

from pstl_tpu_torch.config import Config


class SceneDataset:
    """Dict-of-arrays dataset with a train/val split and the trajopt
    columns."""

    def __init__(self, data: Dict[str, np.ndarray], cfg: Config,
                 split_seed: int = 1007):
        # scene_* rows are per-scene closed-loop tensors, kept out of the
        # per-sample store
        self.scene_data = {k: v for k, v in data.items()
                           if k.startswith("scene_")}
        self.data = {k: v for k, v in data.items()
                     if not k.startswith("scene_")}
        self.cfg = cfg
        self.n = self.data[next(iter(self.data))].shape[0]
        perm = np.random.RandomState(split_seed).permutation(self.n)
        n_train = int(self.n * cfg.train_ratio)
        self.splits = {"train": perm[:n_train], "val": perm[n_train:]}

    @classmethod
    def from_synthetic(cls, cfg: Config, seed: Optional[int] = None,
                       n_scenes: Optional[int] = None,
                       scene_len: Optional[int] = None) -> "SceneDataset":
        from pstl_tpu_torch.data import synthetic
        if n_scenes is None:
            n_scenes = cfg.n_synth_scenes
            if cfg.mini:
                n_scenes = max(n_scenes // 8, 16)
        return cls(synthetic.generate_dataset(
            seed if seed is not None else cfg.seed, n_scenes, cfg,
            scene_len=scene_len), cfg)

    @classmethod
    def load(cls, path: str, cfg: Config) -> "SceneDataset":
        """A store written by :meth:`save`; its ``.split.txt`` split is
        authoritative unless ``cfg.generate_split_on_the_fly``."""
        with np.load(path, allow_pickle=False) as f:
            data = {k: f[k] for k in f.files}
        ds = cls(data, cfg)
        split_path = path + ".split.txt"
        if not cfg.generate_split_on_the_fly and os.path.exists(split_path):
            ds.load_split(split_path)
        return ds

    def save(self, path: str):
        """The per-sample and per-scene columns as one compressed npz, and
        the split beside it (``<path>.split.txt``)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(path, **self.data, **self.scene_data)
        self.save_split(path + ".split.txt")

    TRAJOPT_COLUMNS = ("params", "params_init", "pre_stlp",
                       "tj_scores_prior")

    def load_trajopt_sidecar(self, path: str):
        """Attach the trajopt columns of another store (an augmentation
        run's params / stlp / scores for a dataset that lacks them).  A seed
        axis of M != n_randoms is resampled to n_randoms seeds drawn with
        ``RandomState(0)``."""
        with np.load(path, allow_pickle=False) as f:
            for k in self.TRAJOPT_COLUMNS:
                if k not in f.files:
                    continue
                v = f[k]
                if v.shape[0] != self.n:
                    raise ValueError(f"{path}: {k} has {v.shape[0]} rows, "
                                     f"expected {self.n}")
                M = v.shape[1]
                if M != self.cfg.n_randoms:
                    idx = np.random.RandomState(0).randint(
                        0, M, self.cfg.n_randoms)
                    v = v[:, idx]
                self.data[k] = v

    def __len__(self):
        return self.n

    def split_len(self, split: str) -> int:
        return len(self.splits[split])

    def attach(self, key: str, values: np.ndarray):
        """Attach a derived column aligned to the samples."""
        if values.shape[0] != self.n:
            raise ValueError(f"{key}: {values.shape[0]} rows, expected "
                             f"{self.n}")
        self.data[key] = values

    def has(self, key: str) -> bool:
        return key in self.data

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.data.items()}

    def save_split(self, path: str):
        """The train/val split as text, one ``split index`` line per
        sample."""
        with open(path, "w") as f:
            for split, idx in self.splits.items():
                for i in idx:
                    f.write(f"{split} {int(i)}\n")

    def load_split(self, path: str):
        d = collections.defaultdict(list)
        with open(path) as f:
            for line in f:
                split, i = line.split()
                d[split].append(int(i))
        self.splits = {k: np.asarray(v) for k, v in d.items()}

    def ensure_random_params(self, seed: int = 0):
        """Random control seeds when no trajopt params exist:
        w ~ 0.1*U(-w_max, w_max), a ~ U(-a_max, a_max)."""
        if "params" in self.data:
            return
        cfg = self.cfg
        rng = np.random.RandomState(seed)
        shape = (self.n, cfg.n_randoms, 3, cfg.nt)
        w = rng.uniform(-cfg.mul_w_max, cfg.mul_w_max, shape) * 0.1
        a = rng.uniform(-cfg.mul_a_max, cfg.mul_a_max, shape)
        params = np.stack([w, a], axis=-1).astype(np.float32)
        self.data["params"] = params
        self.data["params_init"] = params.copy()


def batch_iterator(ds: SceneDataset, split: str, batch_size: int,
                   shuffle: bool, seed: int = 0, drop_last: bool = True,
                   epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-shape batches.  ``drop_last=True`` drops the ragged tail;
    otherwise the tail wraps around so every sample is seen."""
    idx = ds.splits[split].copy()
    if shuffle:
        np.random.RandomState(seed * 100003 + epoch).shuffle(idx)
    n = len(idx)
    if n == 0:
        return
    if not drop_last and n % batch_size != 0:
        pad = batch_size - n % batch_size
        idx = np.concatenate([idx, np.tile(idx, -(-pad // n))[:pad]])
        n = len(idx)
    for i in range(0, n - batch_size + 1, batch_size):
        yield ds.gather(idx[i:i + batch_size])
