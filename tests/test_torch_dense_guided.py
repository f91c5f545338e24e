"""The port's dense train step under ``ours_guidance`` (``e7_ours`` with
guidance in the training sampler, one Adam iteration a guided step,
multi_cands 10) against ``pstl_tpu.train``.  As in the JAX step, the
guidance context carries no fused loss, so the guidance runs the row-major
fallback loss (rollout of the denormalized mean, ``score_rows``, the hinge
at ``stl_nn_thres``: ``maximize=False``) under the step's ``no_grad``.

The preset guides the last 10 denoise steps at lr 0.01; on the "flip"
case that turns every sampled row satisfying, the RefineNet's violation
gate then passes them through and no gradient reaches the head.  The test
guides the last 3 of the 7 denoise steps at lr 3e-3: the guidance moves
the samples (the DPP loss differs from the unguided e7 step's) and leaves
rows for the head to flip.  The case, the draws and the tolerances:
``tests/torch_dense_case.py``."""

import pytest

from torch_dense_case import run_train_steps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_guided_train_steps_match_jax(dtype, monkeypatch):
    first = run_train_steps("ours_guidance", dtype, monkeypatch, "flip",
                            guidance_before=3, guidance_lr=3e-3)
    assert first["loss_diversity"] < 0 and first["loss_stl"] == 0
