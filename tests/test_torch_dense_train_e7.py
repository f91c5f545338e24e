"""The port's dense train step on ``e7_ours`` (RefineNet-only updates,
DPP diversity on the best of the last decodings of the full sampler) and
with ``e8_stl``'s flags (the STL hinge, no diversity) against
``pstl_tpu.train``, fp32 and bf16.  "flip" puts rows the RefineNet head
turns from violating to satisfying, so the DPP loss reaches the head; the
case and its tolerances: ``tests/torch_dense_case.py``."""

import pytest

from torch_dense_case import run_train_steps


@pytest.mark.parametrize("preset,case,dtype", [
    ("e7_ours", "flip", "float32"), ("e7_ours", "flip", "bfloat16"),
    ("e8_stl", "flex", "float32"), ("e8_stl", "flex", "bfloat16")])
def test_rect_train_steps_match_jax(preset, case, dtype, monkeypatch):
    # the hinge reaches the lane-change rows in e8 (tests/torch_dense_case.py)
    first = run_train_steps(preset, dtype, monkeypatch, case,
                            grad_floor=1e-5 if preset == "e8_stl" else 1e-6)
    if preset == "e7_ours":
        assert first["loss_diversity"] < 0 and first["loss_stl"] == 0
    else:
        assert first["loss_stl"] > 0 and first["loss_diversity"] == 0
