"""The port's mono train step on ``e4_ddpm_mono`` (5 denoise steps)
against ``pstl_tpu.train.make_train_step``, fp32 and bf16: the diffusion
forward, the row-major sampler on the JAX step's own draws, and the scores
of the sampled controls (the forward clearance kernel, no VJP).  The case
and its tolerances: ``tests/torch_mono_case.py``."""

import pytest

from torch_mono_case import run_train_steps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_e4_train_steps_match_jax(dtype):
    run_train_steps("e4_ddpm_mono", dict(diffusion_steps=6), dtype)
