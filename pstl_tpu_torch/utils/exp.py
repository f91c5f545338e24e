"""Experiment directories and a stdout tee, a copy of
``pstl_tpu/utils/exp.py`` for the port.

``setup_exp_dir`` makes ``<root>/<exp_name>/{viz,torch_models,src}``:
``torch_models``, not the JAX package's ``models``, so that the port's
checkpoints never meet the orbax ones of an experiment of the same name.
It snapshots the port's sources and the config, and tees stdout to a
timestamped log file.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from datetime import datetime

from pstl_tpu_torch.config import Config

#: the checkpoint directory of an experiment, under ``<root>/<exp_name>``
MODELS_DIR = "torch_models"


class TeeLogger:
    """A stdout stand-in that writes to stdout and appends to a file."""

    def __init__(self, path: str):
        self.file = open(path, "a")
        self.stdout = sys.stdout

    def write(self, s):
        self.stdout.write(s)
        self.file.write(s)

    def flush(self):
        self.stdout.flush()
        self.file.flush()


def setup_exp_dir(cfg: Config, root: str = "exps", tee: bool = True,
                  snapshot_src: bool = True) -> str:
    """Make the experiment's directory (named ``cfg.exp_name``, or by the
    time), snapshot the package's ``.py`` sources, the config and the
    command line; with ``tee``, stdout also goes to ``log-<time>.txt``
    there.  Returns the directory."""
    name = cfg.exp_name or datetime.now().strftime("exp_%m%d_%H%M%S")
    full = os.path.join(root, name)
    for sub in ("viz", MODELS_DIR, "src"):
        os.makedirs(os.path.join(full, sub), exist_ok=True)
    if snapshot_src:
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        for dirpath, _, files in os.walk(pkg):
            rel = os.path.relpath(dirpath, os.path.dirname(pkg))
            for f in files:
                if f.endswith(".py"):
                    dst = os.path.join(full, "src", rel)
                    os.makedirs(dst, exist_ok=True)
                    shutil.copy2(os.path.join(dirpath, f), dst)
    with open(os.path.join(full, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f, indent=2, default=str)
    with open(os.path.join(full, "cmd.txt"), "w") as f:
        f.write(" ".join(sys.argv) + "\n")
    if tee:
        ts = datetime.now().strftime("%m%d-%H%M%S")
        sys.stdout = TeeLogger(os.path.join(full, f"log-{ts}.txt"))
    return full
