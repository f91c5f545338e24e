"""The port's dense train step on the BC head against ``pstl_tpu.train``.
The JAX package has no BC preset, nor does the port: BC is
``PRESETS["e3_vae"].with_(vae=False, bc=True, use_init_hint=False)`` (the
baselines' recipe, the policy mapping the scene straight to controls), fp32
and bf16, the targets scored by the step or given as ``tj_scores_prior``,
and with stl_weight 1 (the hinge's gradient through the ``TiledScorer``,
e8's gradient floor 1e-5).  The case and its tolerances:
``tests/torch_dense_case.py``."""

import pytest

from torch_dense_case import run_train_steps

BC = dict(vae=False, bc=True, use_init_hint=False)


@pytest.mark.parametrize("case,dtype,stl_weight", [
    ("flex", "float32", 0.0), ("flex", "bfloat16", 0.0),
    ("tj_prior", "float32", 0.0), ("flex", "float32", 1.0)])
def test_bc_train_steps_match_jax(case, dtype, stl_weight, monkeypatch):
    first = run_train_steps("e3_vae", dtype, monkeypatch, case,
                            grad_floor=1e-5 if stl_weight else 1e-6,
                            bf16_step_metrics=True, stl_weight=stl_weight,
                            **BC)
    assert first["loss_bc"] > 0 and "loss_vae_bc" not in first
    assert (first["loss_stl"] > 0) == (stl_weight > 0)
