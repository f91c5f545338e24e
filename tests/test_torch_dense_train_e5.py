"""The port's dense train step on ``e5_ddpm`` (plain DDPM on the trajopt
targets) against ``pstl_tpu.train``: the targets scored by the step (the
flex pSTL draws, the hoisted discs) or given as ``tj_scores_prior``, fp32
and bf16.  The case and its tolerances: ``tests/torch_dense_case.py``."""

import pytest

from torch_dense_case import run_train_steps


@pytest.mark.parametrize("case,dtype", [
    ("flex", "float32"), ("flex", "bfloat16"), ("tj_prior", "float32")])
def test_e5_train_steps_match_jax(case, dtype, monkeypatch, capsys):
    first = run_train_steps("e5_ddpm", dtype, monkeypatch, case,
                            tight=dtype == "float32")
    # stl_bc_mask is forced on: the eps-MSE keeps only the valid rows whose
    # target satisfies the spec (tj_acc of them)
    with capsys.disabled():
        print(f"\ne5 {case} {dtype}: stl_bc_mask keeps {first['tj_acc']:.4f}"
              f" of the valid rows; loss_diffusion "
              f"{first['loss_diffusion']:.5f}")
    assert 0 < first["tj_acc"] < 1
    assert first["loss_diffusion"] > 0
