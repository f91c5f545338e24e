"""The port's mono train step on ``e2_vae_mono`` against
``pstl_tpu.train.make_train_step``: stl_weight 0 (the clearance VJP runs
with a zero cotangent) and 1 on scenes where the safety clause binds (a
nonzero one), fp32 and bf16.  The case and its tolerances:
``tests/torch_mono_case.py``."""

import pytest

from torch_mono_case import run_train_steps


@pytest.mark.parametrize("kw,dtype", [
    (dict(stl_weight=0.0), "float32"),
    (dict(stl_weight=1.0, straight=True), "float32"),
    (dict(stl_weight=1.0, straight=True), "bfloat16")],
    ids=["stl0", "stl1", "stl1_bf16"])
def test_e2_train_steps_match_jax(kw, dtype):
    run_train_steps("e2_vae_mono", kw, dtype)
