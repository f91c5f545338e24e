"""The benchmark of the PyTorch port (``pstl_tpu_torch``) on one H100.

``run.py`` is the entry point.  Everything that belongs to one model
configuration, one cell or one per-layer metric sits in a file of its own
(``configs/``, ``workloads/``, ``metrics/``), found by the name that
``BENCHMARK.json`` gives it; ``drivers/`` holds one module per kind of
timed path, ``roofline/`` the operation and byte counts and the peaks, and
``reference/`` the plain reference that decides ``correct``.  Nothing here
imports ``jax`` or the JAX package.
"""
