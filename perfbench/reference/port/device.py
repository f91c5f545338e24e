"""A frozen copy of ``pstl_tpu_torch/device.py`` of the PyTorch port, kept as the benchmark's plain
reference: every kernel dispatch runs the plain version.  Do not edit to
follow the program."""


from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given; by default the card (this process's current
    one: ``parallel.init_multihost`` selects it under ``torchrun``), and an
    error without one (pass ``device="cpu"`` to run the plain versions on
    the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "the argument device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
