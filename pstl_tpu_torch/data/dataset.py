"""Fixed-shape scene dataset and batch iterator — a numpy mirror of
``pstl_tpu/data/dataset.py`` (``SceneDataset`` without its npz / shard-store
persistence, and ``batch_iterator``).

Everything lives in one dict of stacked arrays; a batch is an index
shuffle plus a gather.  The same ``np.random.RandomState`` draws in the
same order give the JAX package's splits, shuffles and random control
seeds bit for bit (``tests/test_torch_mono_specs.py``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from pstl_tpu_torch.config import Config


class SceneDataset:
    """Dict-of-arrays dataset with a train/val split."""

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

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.data.items()}

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
