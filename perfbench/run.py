"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from a ``torch.profiler`` trace
of a short window.  Either way the timed path's outputs are compared with
the plain reference after the window (``reference/``), and each number
compared is printed beside its limit.  The run needs as many CUDA devices
as the cell asks for; without them it exits with code 3 and prints no
result.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel caches inside the checkout, at fixed paths, so that only a
# checkout's first run builds; set before torch is imported
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(ROOT, "build", "perfbench", _sub)
# keep a library that could load JAX from doing so
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one host thread: the timed path is the host's dispatch to the card, and
# idle worker threads only take cores from it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    import torch
    torch.set_num_threads(1)
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
