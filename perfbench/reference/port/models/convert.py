"""A frozen copy of ``pstl_tpu_torch/models/convert.py`` of the PyTorch port, kept as the benchmark's plain
reference: every kernel dispatch runs the plain version.  Do not edit to
follow the program."""


from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

#: the committed weight files, a raw input that the program and this
#: reference both read
WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))),
    "pstl_tpu_torch", "weights")


def flatten(params: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested flax params (optionally under a top-level "params") -> flat
    {"module/Dense_i/kernel": array}."""
    if prefix == "" and set(params) == {"params"}:
        params = params["params"]
    out = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (nested, or flat "/"-joined) -> ``Net`` state dict."""
    flat = flatten(params_np) if any(isinstance(v, Mapping)
                                     for v in params_np.values()) \
        else dict(params_np)
    sd = {}
    for key, arr in flat.items():
        module, dense, leaf = key.split("/")
        i = int(dense.split("_")[1])
        t = torch.as_tensor(np.array(arr, np.float32))
        if leaf == "kernel":
            sd[f"{module}.layers.{i}.weight"] = t.t().contiguous()
        elif leaf == "bias":
            sd[f"{module}.layers.{i}.bias"] = t
        else:
            raise KeyError(f"unexpected flax parameter {key}")
    return sd


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    with np.load(path) as f:
        return from_flax({k: f[k] for k in f.files})


def load_weights(net: torch.nn.Module, name: str = "e7_round5") -> None:
    """Load a committed weight file into ``net`` (strict)."""
    net.load_state_dict(load_npz(os.path.join(WEIGHTS_DIR, f"{name}.npz")))
