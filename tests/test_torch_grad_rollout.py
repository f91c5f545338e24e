"""Training through the whole reverse sampler (``grad_rollout``) in the
port against ``pstl_tpu.train``: the dense ``e5_ddpm`` step
(``_dense_forward_and_loss``'s grad_rollout branch: the STL hinge of the
sampled controls, weight 1, added to the eps-MSE), unguided and guided by
the row-major fallback loss on one middle denoise step, and the mono
``e4_ddpm_mono`` step, each at 4 denoise steps, fp32, with the JAX step's
own draws (``tests/torch_dense_case.py``, ``tests/torch_mono_case.py``: the
JAX reference compiled at ``xla_backend_optimization_level`` 0); then one
``train.train`` epoch with grad_rollout, ``tests/test_train.py``'s slow
case at a tier-1 size.

A guided step carries no gradient in either package (``stop_gradient`` of
the guided mean in JAX; the guidance loop's result is cut from the graph
here): guiding denoise step 2 of 1..3 leaves the gradient of the last
step only, and the guided case's gradients differ from the unguided
case's.

Tolerances: the cases' own for the loss, the metrics (rtol 1e-5) and the
parameters (within 2*lr a step); the gradients rtol 1e-4 with the floor
that ``torch_dense_case`` gives the e8 step, 1e-5 of each tensor's largest
entry (not the 1e-6 of the steps whose hinge stops before the encoders).
Here the STL hinge of every row's sampled controls reaches every
parameter, the lane-change rows' included: their Eventually-Always
clauses run a reverse logcumsumexp of values x100 (sequential here,
associative in JAX) whose cotangents agree to ~1e-4 of each row's size,
and four differentiated denoise steps carry that through four chained MLP
backward passes into sums over rows that cancel.  Measured: 2.4e-4
relative on 2 of 192 entries of an encoder weight (e4, 2.7e-5 against a
largest entry of 2.7) and 1.9e-4 on 1 of 224 (guided e5, 1.9e-7 against
3.2e-2).  At 99 steps the card-vs-CPU check of ``chip_smoke.py`` phase 36
states its own.
"""

#: the gradients' floor (see the module docstring)
GRAD_FLOOR = 1e-5

import numpy as np
import pytest
import torch

from pstl_tpu_torch import train as ttrain
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.data.dataset import SceneDataset

import torch_dense_case
import torch_mono_case

GRAD_KW = dict(grad_rollout=True, stl_weight=1.0, diffusion_steps=4,
               n_randoms=2)


@pytest.mark.parametrize("guided", [False, True], ids=["unguided", "guided"])
def test_dense_e5_grad_rollout_matches_jax(guided, monkeypatch):
    kw = dict(GRAD_KW)
    if guided:
        kw.update(guidance=True, guidance_sets=(2,), guidance_niters=2,
                  guidance_lr=3e-3)
    first = torch_dense_case.run_train_steps(
        "e5_ddpm", "float32", monkeypatch, "flex", grad_floor=GRAD_FLOOR,
        **kw)
    # the sampled controls' hinge is in the loss, with a gradient
    assert first["loss_stl"] > 0
    np.testing.assert_allclose(
        first["loss"], first["loss_stl"] + first["loss_diffusion"]
        + first.get("loss_coll", 0.0), rtol=1e-6)


def test_mono_e4_grad_rollout_matches_jax():
    """The mono branch's grad_rollout (``_mono_forward_and_loss``) on
    ``straight_scenes``, where the safety clause binds, the sampler's draws
    x0.05 so that the sampled rollouts stay near the GT line: the clearance
    VJP runs once a step through the sampled controls, with a nonzero
    cotangent."""
    torch_mono_case.run_train_steps(
        "e4_ddpm_mono", dict(grad_rollout=True, stl_weight=1.0,
                             diffusion_steps=4, straight=True), "float32",
        grad_floor=GRAD_FLOOR, sample_scale=0.05)


def test_grad_rollout_trains_through_sampler():
    """``tests/test_train.py::test_grad_rollout_trains_through_sampler`` in
    the port, small: one epoch of the dense DDPM with grad_rollout and no
    RefineNet head; every parameter the sampler reaches gets a gradient."""
    cfg = TConfig(diffusion=True, grad_rollout=True, diffusion_steps=4,
                  n_randoms=2, n_neighbors=2, batch_size=4,
                  compute_dtype="float32", train_ratio=0.5,
                  hiddens=(32, 32)).finalize()
    ds = SceneDataset.from_synthetic(cfg, n_scenes=8)
    ds.ensure_random_params(0)
    hist = []
    state = ttrain.train(cfg, ds, log=lambda *a: None, epochs=1,
                         device="cpu", history=hist)
    assert state.step > 0
    train_vals = [v for _, m, v in hist if m == "train"]
    assert train_vals and all(np.isfinite(v["loss"]) for _, _, v in hist)
    assert all(v["loss_stl"] > 0 for v in train_vals)
    grads = {k: p.grad for k, p in state.net.named_parameters()}
    assert all(g is not None and bool(torch.isfinite(g).all())
               for k, g in grads.items() if k.startswith("policy_net"))
