"""pstl_tpu_torch — the PyTorch + CUDA port of ``pstl_tpu``.

The closed-loop planning step and the mono training step of the JAX
package, ported to PyTorch for an NVIDIA H100: ``sim`` (observe -> plan ->
env step), ``train`` (the ``gt_data_training`` step of ``e2_vae_mono`` /
``e4_ddpm_mono`` and its epoch loop), ``diffusion`` (DDPM reverse pass
with fused STL guidance, training-time noising), ``models`` (policy net
with diffusion and VAE heads, RefineNet), ``specs`` (tiled robustness
scorer, clause bank, pSTL calibration), ``losses``, ``ops`` (rollout,
geometry, soft STL, the guidance loss, and the kernels in ``csrc/``),
and the offline pipeline's two ends: ``trajopt`` (the augmentation that
writes the training targets into the scene store) and ``eval_openloop``
with ``metrics`` (the open-loop Table-I evaluation).

The package imports torch and numpy only — never jax or ``pstl_tpu``; the
flag table and presets (``config``), the synthetic scene generator and the
scene dataset (``data``) are mirrored from the JAX package and
parity-tested against it.
"""

__version__ = "0.1.0"

from pstl_tpu_torch.config import Config  # noqa: F401,E402
