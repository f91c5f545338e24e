"""One module per kind of timed path; a cell's traffic file names its driver
(``"driver": "<module>"``) and the module's ``Driver`` runs it.

A ``Driver(cell, fields, device, seed, impl=None)`` has ``setup()`` (build
and warm up the cell's own shapes), ``window(seconds)`` (the measured
window: its end-to-end metrics), ``timed_steps()`` (untraced steps
before the trace: their mean seconds), ``trace_steps()`` (the short
traced window: the number of steps it ran), ``shapes()`` (what the
per-layer readers need), ``release()`` (free the program's state once
the window has closed) and ``check()`` (the comparison with the reference: a list of
``{"name", "value", "limit", "ok"}``), and counts ``attempted`` and
``failed``.  ``impl`` puts another implementation in the program's place
(the control; the tests' broken programs).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

#: seconds of untraced steps a traced run times first: the step time that
#: the mfu readers divide by
UNTRACED_S = 5.0


def sub_seed(seed: int, *keys: int) -> int:
    """A 32-bit seed derived from the run's seed and ``keys``; any whole
    number is a valid run seed."""
    return int(np.random.SeedSequence(
        [int(seed) % (1 << 64), *keys]).generate_state(1)[0])


def program():
    """The program under test: the PyTorch port's modules the drivers call."""
    from pstl_tpu_torch import diffusion, sim
    from pstl_tpu_torch.config import Config
    from pstl_tpu_torch.models import convert
    from pstl_tpu_torch.models.net import Net
    return SimpleNamespace(name="program", Config=Config, sim=sim,
                           diffusion=diffusion, convert=convert, Net=Net)


def reference():
    """The plain reference: the frozen copy under ``reference/port``."""
    from perfbench.reference.port import diffusion, sim
    from perfbench.reference.port.config import Config
    from perfbench.reference.port.models import convert
    from perfbench.reference.port.models.net import Net
    return SimpleNamespace(name="reference", Config=Config, sim=sim,
                           diffusion=diffusion, convert=convert, Net=Net)


def check(name: str, value: float, limit: float) -> dict:
    """A number compared with its limit (at most the limit passes)."""
    value = float(value)
    return {"name": name, "value": value, "limit": float(limit),
            "ok": bool(np.isfinite(value) and value <= limit)}
