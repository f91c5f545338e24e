"""Build and load the port's CUDA kernels.

Each kernel is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes`` (no PyTorch headers: a build takes
seconds).  Libraries land in ``build/pstl_tpu_torch/<hash>/`` under the
repository root, where the hash covers the flags, ``csrc/<name>.cu`` and
every header under ``csrc/`` (a ``.cu`` may include any of them), so a
changed source or header rebuilds and an unchanged one is loaded as it is.
:func:`load_all` starts one ``nvcc`` per library at once.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Iterable

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(REPO_DIR, "build", "pstl_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HEADER_SUFFIXES = (".cuh", ".h")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: per library: seconds the build took (0.0 when it was already built) and
#: the compiler's report (registers, shared memory and spills per kernel)
BUILD_INFO: Dict[str, dict] = {}


def source_macros(name: str) -> Dict[str, int]:
    """The integer ``#define``s of ``csrc/<name>.cu``: macro -> value."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu")) as f:
        return {k: int(v) for k, v in
                re.findall(r"^#define (\w+) +(\d+)$", f.read(), re.M)}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return nvcc


def source_hash(name: str, csrc_dir: str = CSRC_DIR) -> str:
    """Hash of what ``lib<name>.so`` is built from: the nvcc flags, the
    ``.cu`` and every header in ``csrc_dir`` (file names and contents)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    files = [f"{name}.cu"] + sorted(
        f for f in os.listdir(csrc_dir) if f.endswith(HEADER_SUFFIXES))
    for fname in files:
        h.update(fname.encode() + b"\0")
        with open(os.path.join(csrc_dir, fname), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _paths(name: str):
    out_dir = os.path.join(BUILD_ROOT, source_hash(name))
    return (os.path.join(out_dir, f"lib{name}.so"),
            os.path.join(out_dir, f"{name}.log"))


def load_all(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """Build (one concurrent ``nvcc`` per missing library) and load
    ``csrc/<name>.cu`` as ``lib<name>.so`` for every name."""
    names = list(names)
    t0 = time.time()
    procs = {}
    for name in names:
        if name in _LIBS:
            continue
        lib_path, _ = _paths(name)
        if os.path.exists(lib_path):
            continue
        os.makedirs(os.path.dirname(lib_path), exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        out, err = proc.communicate()
        lib_path, log_path = _paths(name)
        with open(log_path, "w") as f:
            f.write(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (rc {proc.returncode}):"
                          f"\n{err}")
        else:
            os.replace(tmp, lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))
    build_s = time.time() - t0
    for name in names:
        if name in _LIBS:
            continue
        lib_path, log_path = _paths(name)
        report = open(log_path).read() if os.path.exists(log_path) else ""
        BUILD_INFO[name] = {"build_s": build_s if name in procs else 0.0,
                            "report": report, "path": lib_path}
        _LIBS[name] = ctypes.CDLL(lib_path)
    return {name: _LIBS[name] for name in names}


def ptxas_summary(report: str) -> list:
    """Per kernel of a ``-Xptxas -v`` report, one line: its (mangled) name,
    its stack frame and spill bytes, its registers and shared memory."""
    out, row = [], None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            row = [ln.split("'")[1]]
        elif row and "bytes stack frame" in ln and len(row) == 1:
            row.append(ln.strip())
        elif row and "registers" in ln:
            row.append(ln.split(":", 1)[1].strip())
            out.append(" | ".join(row))
            row = None
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as ``lib<name>.so``."""
    return load_all([name])[name]
