"""pstl_tpu_torch — the PyTorch + CUDA port of ``pstl_tpu``.

The closed-loop planning step of the JAX package, ported to PyTorch for an
NVIDIA H100: ``sim`` (observe -> plan -> env step), ``diffusion`` (DDPM
reverse pass with fused STL guidance), ``models`` (policy net + RefineNet),
``specs`` (tiled robustness scorer), ``ops`` (rollout, geometry, soft STL,
the guidance loss and the fused guidance kernel in ``csrc/``).

The package imports torch and numpy only — never jax or ``pstl_tpu``; the
flag table (``config``) and the synthetic scene generator (``data``) are
mirrored from the JAX package and parity-tested against it.
"""

__version__ = "0.1.0"

from pstl_tpu_torch.config import Config  # noqa: F401,E402
