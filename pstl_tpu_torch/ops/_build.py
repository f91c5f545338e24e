"""Build and load the port's CUDA kernels.

Each kernel is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes`` (no PyTorch headers: a build takes
seconds).  Libraries land in ``build/pstl_tpu_torch/<hash of the sources and
flags>/`` under the repository root, so a changed source rebuilds and an
unchanged one is loaded as it is.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(REPO_DIR, "build", "pstl_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
#: per library: seconds the build took (0.0 when it was already built) and
#: the compiler's report (registers, shared memory and spills per kernel)
BUILD_INFO: Dict[str, dict] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return nvcc


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as ``lib<name>.so``."""
    if name in _LIBS:
        return _LIBS[name]
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    lib_path = os.path.join(out_dir, f"lib{name}.so")
    log_path = os.path.join(out_dir, f"{name}.log")
    t0 = time.time()
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        with open(log_path, "w") as f:
            f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} "
                               f"(rc {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)
    build_s = time.time() - t0
    report = open(log_path).read() if os.path.exists(log_path) else ""
    BUILD_INFO[name] = {"build_s": build_s, "report": report,
                        "path": lib_path}
    lib = ctypes.CDLL(lib_path)
    _LIBS[name] = lib
    return lib
