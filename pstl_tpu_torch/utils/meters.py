"""Running-average meters and a named-interval wall-clock profiler, a copy
of ``pstl_tpu/utils/meters.py`` (``import pstl_tpu`` imports jax, so the
port keeps its own)."""

from __future__ import annotations

import time
from typing import Dict


class MeterDict:
    """Last value and running mean per metric."""

    def __init__(self):
        self.cur: Dict[str, float] = {}
        self.sum: Dict[str, float] = {}
        self.count: Dict[str, int] = {}

    def update(self, key: str, val: float, n: int = 1):
        self.cur[key] = val
        self.sum[key] = self.sum.get(key, 0.0) + val * n
        self.count[key] = self.count.get(key, 0) + n

    def avg(self, key: str) -> float:
        return self.sum[key] / max(self.count[key], 1)

    def __contains__(self, key):
        return key in self.cur

    def __getitem__(self, key):
        return self.cur[key]

    def __call__(self, key):
        return self.avg(key)

    def summary(self, keys=None) -> str:
        keys = keys or sorted(self.cur)
        return " ".join(f"{k}:{self.cur[k]:.3f}({self.avg(k):.3f})"
                        for k in keys)


class EtaEstimator:
    """Remaining time from separate per-batch time models for the train,
    val and viz passes."""

    def __init__(self, epochs: int, n_train: int, n_val: int,
                 viz_freq: int = 50):
        self.epochs = epochs
        self.n_train = n_train
        self.n_val = n_val
        self.viz_freq = max(viz_freq, 1)
        self.t_train = self.t_val = self.t_viz = 0.0
        self.c_train = self.c_val = self.c_viz = 0
        self.start = time.time()
        self.done_epochs = 0

    def update(self, mode: str, duration: float, n: int = 1):
        if mode == "train":
            self.t_train += duration
            self.c_train += n
        elif mode == "val":
            self.t_val += duration
            self.c_val += n
        else:
            self.t_viz += duration
            self.c_viz += n

    def epoch_done(self):
        self.done_epochs += 1

    def eta_seconds(self) -> float:
        per_tr = self.t_train / max(self.c_train, 1)
        per_va = self.t_val / max(self.c_val, 1)
        per_vz = self.t_viz / max(self.c_viz, 1)
        remaining = max(self.epochs - self.done_epochs, 0)
        return remaining * (per_tr * self.n_train + per_va * self.n_val
                            + per_vz / self.viz_freq)

    @staticmethod
    def _fmt(s: float) -> str:
        s = int(s)
        return f"{s//3600:02d}:{(s%3600)//60:02d}:{s%60:02d}"

    def elapsed_str(self) -> str:
        return self._fmt(time.time() - self.start)

    def eta_str(self) -> str:
        return self._fmt(self.eta_seconds())


class Timer:
    """Accumulates average durations between named marks."""

    def __init__(self):
        self.stamp: Dict[str, float] = {}
        self.total: Dict[str, float] = {}
        self.count: Dict[str, int] = {}
        self.last = None

    def add(self, key: str):
        now = time.time()
        if self.last is not None:
            name = f"{self.last}->{key}"
            self.total[name] = (self.total.get(name, 0.0)
                                + now - self.stamp[self.last])
            self.count[name] = self.count.get(name, 0) + 1
        self.stamp[key] = now
        self.last = key

    def report(self) -> str:
        return " ".join(f"{k}:{self.total[k]/self.count[k]:.3f}s"
                        for k in self.total)
