"""The port's dense train step on ``e6_trafficsim`` (the VAE with the STL
hinge and the TrafficSim collision loss, whose full geometry route gives
the centre distances and radius sums) against ``pstl_tpu.train``, fp32 and
bf16; and the collision term alone (every other weight 0) with neighbor 0
1.5 m beside the ego, so that its gradient is not zero.  The case and its
tolerances: ``tests/torch_dense_case.py`` (the hinge reaches the
lane-change rows, so the gradients' floor is e8's 1e-5)."""

import pytest

from torch_dense_case import run_train_steps

#: the collision term alone
COLL_ONLY = dict(stl_weight=0.0, bc_weight=0.0, weight_vae_kl=0.0)


@pytest.mark.parametrize("case,dtype,kw", [
    ("flex", "float32", {}), ("flex", "bfloat16", {}),
    ("near", "float32", COLL_ONLY)], ids=["flex-fp32", "flex-bf16",
                                          "near-coll-only"])
def test_e6_train_steps_match_jax(case, dtype, kw, monkeypatch):
    first = run_train_steps("e6_trafficsim", dtype, monkeypatch, case,
                            grad_floor=1e-5, bf16_step_metrics=True,
                            vae_dim=8, **kw)
    if case == "near":
        assert first["loss"] == first["loss_coll"] > 0
    else:
        assert first["loss_stl"] > 0 and first["loss_vae_bc"] > 0
