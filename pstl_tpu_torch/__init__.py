"""pstl_tpu_torch — the PyTorch + CUDA port of ``pstl_tpu``.

Everything the JAX package runs, ported to PyTorch for an NVIDIA H100:
``cli`` (the command line, ``python -m pstl_tpu_torch.cli``), ``sim`` (the
closed-loop planner and the Table-II evaluation), ``train`` (every
preset's train step and the epoch loop, checkpoints), ``trajopt`` (the
augmentation that writes the training targets into the scene store),
``eval_openloop`` with ``metrics`` (the open-loop Table-I evaluation),
``diffusion`` (the DDPM, DDIM and DPM-Solver++ samplers with STL
guidance), ``models`` (the policy net's heads and the RefineNet),
``specs`` (robustness scorers, pSTL calibration), ``refine``, ``losses``,
``viz`` (matplotlib figures, imported only when drawing), ``runtime``
(the native shard store), ``parallel`` (data-parallel training and
scene- or candidate-sharded planning over ``torch.distributed``),
``data`` (the scene store, the synthetic generator and the NuScenes
extraction) and ``ops`` (rollout, geometry, soft STL, the guidance loss,
and the kernels in ``csrc/``).

The package imports torch and numpy only — never jax or ``pstl_tpu``; the
flag table and presets (``config``), the synthetic scene generator and the
scene dataset (``data``) are mirrored from the JAX package and
parity-tested against it.
"""

__version__ = "0.1.0"

from pstl_tpu_torch.config import Config  # noqa: F401,E402
