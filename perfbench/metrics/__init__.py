"""Per-layer metric readers: ``<metric>.py`` holds ``read(ctx)`` for the
metric of that name in ``BENCHMARK.json``.  ``ctx`` has ``kernels``
((name, start us, duration us) of every device operation of the traced
window), ``busy_s`` and ``window_s`` (the union of their intervals and the
window's length), ``steps`` (steps in the traced window), ``step_s`` (the mean seconds a
step of as many steps run just before without the profiler), ``fields`` (the
cell's ``Config`` fields) and ``shapes`` (``bs``, ``rows``).  A reader that
finds nothing to read returns None."""
