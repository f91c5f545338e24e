"""CTG's closed-loop Table-II episode on the scene where the port's CTG row
collided on the H100: ``pstl_tpu_torch.sim`` against ``pstl_tpu.sim`` on
the CPU, with the same weights (``checkpoints/e5b_round5``) and the JAX key
chain's draws.

The scene: ``scripts/closed_loop_eval.py``'s protocol (synthetic seed 777,
2 x 25 scenes at scene_len 38, the first 25 with mean GT speed >= 1 m/s),
index ``SCENE`` of the kept ones, the one ``chip_smoke.py``'s phase 28
reports colliding under CTG with the port's own draws.  CTG at the heavy
width (M = 64, K = 8, all 99 denoise steps guided, 3 Adam iterations, no
RefineNet), fp32, 36 steps, ``record=True``.  The JAX planner guides with
its XLA loop on reused selections, the port with the fused guidance
kernel's plain version (the pairing of
``tests/test_torch_baseline_plan.py``).  Draws: the episode key's chain
(each step splits (next, plan), the plan (dense, sample), the sampler's
chain from the sample key).

With these draws neither package collides, and both run the 36 steps.
The ego histories agree to ``EGO_TOL`` (the 1e-4 of
``tests/test_torch_closed_loop.py``'s 3-step episodes) for the first
``SPLIT_STEP`` steps and then split: the plan is chaotic in its inputs at
this width (99 guided steps of 3 Adam iterations each, whose first
iteration moves every control by +-lr on the sign of its gradient, and
near-tie argmins inside the guidance), so a 1e-7 relative change of the
port's own weights moves the first plan's candidates by more than 1e-2
(``test_ctg_plan_is_chaotic_in_its_inputs``), as the two packages' fp32
sums in another order do.  Slow (minutes: the port's plain kernel runs
99 x 36 times on the CPU);
``python -m pytest -m slow tests/test_torch_ctg_episode.py``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff, sim as jsim, specs as jspecs
from pstl_tpu import train as jtrain
from pstl_tpu.config import PRESETS as JPRESETS
from pstl_tpu.data import synthetic as jsyn
from pstl_tpu.data.dataset import SceneDataset, batch_iterator
from pstl_tpu.models import Net as JNet
from pstl_tpu_torch import diffusion as tdiff, sim as tsim
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.models import convert
from pstl_tpu_torch.models.net import Net as TNet

from torch_parity import jax_plan_noise, np_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the held-out scene (index into the 25 kept) that collided under CTG
SCENE = 7
STEPS = 36
EGO_TOL = 1e-4
#: the steps whose ego states agree to EGO_TOL before the chaos shows
SPLIT_STEP = 3


def table2_scene(cfg, index):
    """``closed_loop_eval.py``'s held-out scenes, only scene ``index`` of
    the 25 kept."""
    data = jsyn.generate_dataset(777, 50, cfg, scene_len=38)
    keep = np.where(data["scene_ego_full"][:, :, 3].mean(-1)
                    >= 1.0)[0][:25]
    return {k: (v[keep[index:index + 1]] if k.startswith("scene_") else v)
            for k, v in data.items()}


def episode_draws(key, cfg, steps):
    """The sampler's draws of each step of ``pstl_tpu.sim``'s episode from
    ``key``, in the port planner's layout."""
    out, k = [], key
    for _ in range(steps):
        k, k_plan = jax.random.split(k)
        out.append({"noise": jax_plan_noise(
            k_plan, cfg.diffusion_steps, (1, cfg.nt, 2, 3 * cfg.n_randoms))})
    return out


def first_split(a, b, tol):
    """The first step whose ego states differ by more than ``tol``, or
    None."""
    d = np.abs(np.stack(a) - np.stack(b)).reshape(len(a), -1).max(-1)
    over = np.nonzero(d > tol)[0]
    return (int(over[0]) if len(over) else None), d


def ctg_configs():
    cfg_j = JPRESETS["ctg"].with_(exp_name=None, compute_dtype="float32",
                                  guidance_reuse_selection=True)
    cfg_t = TConfig(**cfg_j.to_dict()).with_(
        guidance_pallas_fuse_freeze=True).finalize()
    return cfg_j, cfg_t


@pytest.mark.slow
def test_ctg_episode_matches_jax():
    cfg_j, cfg_t = ctg_configs()
    data = table2_scene(cfg_j, SCENE)
    sc_j = jsim.scenes_from_dataset(data)
    sc_t = tsim.scenes_from_dataset(data, device="cpu")
    net_j = JNet(cfg_j)
    ds = SceneDataset({k: v for k, v in data.items()
                       if not k.startswith("scene_")}, cfg_j)
    sample = next(batch_iterator(ds, "val", 8, shuffle=False,
                                 drop_last=False))
    state = jtrain.init_state(cfg_j, net_j, sample, jax.random.PRNGKey(0))
    params = jtrain.load_params_only(
        os.path.join(REPO, "checkpoints", "e5b_round5"), state).params
    net_t = TNet(cfg_t)
    net_t.load_state_dict(convert.from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    net_t.eval()

    key = jax.random.PRNGKey(0)
    oj = jsim.run_closed_loop_host(
        key, sc_j, cfg_j, net_j, params, jspecs.build_scorer(cfg_j),
        jdiff.get_coeffs(cfg_j), max_steps=STEPS, record=True)
    ot = tsim.run_closed_loop_host(
        0, sc_t, cfg_t, net_t, tdiff.get_coeffs(cfg_t), max_steps=STEPS,
        record=True, noise=episode_draws(key, cfg_t, STEPS))
    hj, ht = oj["history"]["ego"], ot["history"]["ego"]
    split, d = first_split(ht, hj, EGO_TOL)
    print(f"scene {SCENE}: collide JAX {np_(oj['collide']).tolist()} port "
          f"{np_(ot['collide']).tolist()}; traj_len JAX "
          f"{np_(oj['traj_len']).tolist()} port {np_(ot['traj_len']).tolist()}"
          f"; first step beyond {EGO_TOL}: {split}; ego differences by step "
          + " ".join(f"{x:.2e}" for x in d))
    assert len(ht) == len(hj) == STEPS + 1
    for k in ("collide", "out_of_lane", "traj_len"):
        np.testing.assert_array_equal(np_(ot[k]), np_(oj[k]), err_msg=k)
    assert float(np_(ot["collide"]).max()) == 0
    assert split is None or split >= SPLIT_STEP, split


@pytest.mark.slow
def test_ctg_plan_is_chaotic_in_its_inputs():
    """The port's first plan on the scene, and the same plan with every
    weight scaled by 1 +- 1e-7: candidate rows move by more than 1e-2."""
    _, cfg_t = ctg_configs()
    sc_t = tsim.scenes_from_dataset(table2_scene(cfg_t, SCENE), device="cpu")
    obs = tsim.observe(sc_t, sc_t.ego_full[:, 0],
                       torch.zeros(1, dtype=torch.long), cfg_t)
    draws = episode_draws(jax.random.PRNGKey(0), cfg_t, 1)[0]
    out = []
    for scale in (0.0, 1e-7, -1e-7):
        net = TNet(cfg_t)
        convert.load_weights(net, "e5b_round5")
        net.eval()
        with torch.no_grad():
            for p in net.parameters():
                p.mul_(1 + scale)
            _, info = tsim.make_planner(cfg_t, net, tdiff.get_coeffs(
                cfg_t))(obs, **draws)
        out.append(info["controls"])
    for other in out[1:]:
        assert float((other - out[0]).abs().max()) > 1e-2
