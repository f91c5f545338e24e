"""Flax parameters -> ``Net`` state dict.

Flax ``Dense`` kernels are (in, out); a torch ``Linear`` weight is their
transpose.  Parameters travel as a flat ``.npz`` whose keys are the flax
paths joined by "/" (``ego_encoder/Dense_0/kernel``); the committed
``pstl_tpu_torch/weights/e7_round5.npz`` is written by
``scripts/export_torch_weights.py``.  :func:`cast_once` keeps what a
forward reads of a module's parameters (cast, laid out) while they stay.
"""

from __future__ import annotations

import os
import weakref
from typing import Callable, Dict, Mapping

import numpy as np
import torch

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights")


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


#: module -> (the key its entry was made at, the entry)
_CAST: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def cast_once(module: torch.nn.Module, key: tuple, make: Callable):
    """``make()``, kept (one entry a module) while ``key`` stays and the
    module's parameters stay the same tensors at the same versions (an
    in-place write, as an optimizer step's, bumps the version).  Made
    afresh while autograd records, so each call's graph reaches them."""
    params = list(module.parameters())
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return make()
    key = key + tuple((p.data_ptr(), p._version) for p in params)
    hit = _CAST.get(module)
    if hit is None or hit[0] != key:
        hit = _CAST[module] = (key, make())
    return hit[1]
