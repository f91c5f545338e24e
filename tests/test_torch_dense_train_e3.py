"""The port's dense train step on ``e3_vae`` (the VAE on the trajopt
targets with the init hint: each row's random control seed joins the
policy's input) against ``pstl_tpu.train``, fp32 and bf16, with the
targets scored by the step or given as ``tj_scores_prior``, and without
the hint.  The case and its tolerances: ``tests/torch_dense_case.py``."""

import pytest

from torch_dense_case import run_train_steps


@pytest.mark.parametrize("case,dtype,hint", [
    ("flex", "float32", True), ("flex", "bfloat16", True),
    ("tj_prior", "float32", True), ("flex", "float32", False)])
def test_e3_train_steps_match_jax(case, dtype, hint, monkeypatch):
    first = run_train_steps("e3_vae", dtype, monkeypatch, case,
                            bf16_step_metrics=True, vae_dim=8,
                            use_init_hint=hint)
    # stl_weight 0 and no collision loss: reconstruction and KL train it
    assert first["loss_stl"] == 0 and first["loss_coll"] == 0
    assert first["loss_vae_bc"] > 0 and first["loss_vae_kl"] > 0
    assert 0 < first["tj_acc"] < 1
