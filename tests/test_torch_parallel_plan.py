"""Sharded planning of the port (``pstl_tpu_torch.parallel``) on the CPU:
``tests/test_parallel.py``'s scene-sharded and candidate-sharded closed
loops against the JAX package's unsharded run, and the candidate-sharded
plan on every guidance route against the port's unsharded plan.

Two ranks of a gloo group run in processes of ``tests/torch_parallel_case.py``
(one run for the file); the JAX package runs here, and hands the port the
draws of its key chain (whole-batch tensors: each rank keeps its scenes'
or its candidates' part).

Tolerances.  The closed loops keep test_parallel.py's rtol 1e-4 / atol
1e-5 on the per-scene metrics after 2 steps (the collision, lane and step
counts agree exactly).  The candidate-sharded plan runs the unsharded
plan's arithmetic column for column (the guidance kernels' plain versions
and the eps MLP on fewer columns), so its controls, scores and plan are
held to 1e-5 of the unsharded plan's, and the chosen first control and
the compliance exactly.
"""

import jax
import numpy as np
import pytest
import torch

from pstl_tpu import diffusion as jdiff, sim as jsim, specs as jspecs
from pstl_tpu import train as jtrain
from pstl_tpu.config import Config as JConfig
from pstl_tpu.data import synthetic as jsyn
from pstl_tpu.data.dataset import SceneDataset, batch_iterator
from pstl_tpu.models import Net as JNet
from pstl_tpu_torch.config import Config as TConfig, bench_config
from pstl_tpu_torch.models import convert

from torch_parallel_case import run_ranks
from torch_parity import jax_episode_noise

WORLD = 2
STEPS = 2
KEYS = ("collide", "out_of_lane", "traj_len", "progress", "stl_acc")


def jax_case(bs, n_randoms, blend=False):
    """test_parallel.py's closed-loop configuration and weights, and the
    JAX package's unsharded run of STEPS steps: (port config, data, port
    weights, the port's pinned draws, JAX metrics)."""
    cfg = JConfig(diffusion=True, rect_head=True, diverse_loss=True,
                  multi_cands=2, n_randoms=n_randoms, n_neighbors=2,
                  n_shards=2, diffusion_steps=5, guidance=True,
                  guidance_niters=1, compute_dtype="float32",
                  guidance_blend_scores=blend,
                  flex=True).finalize().with_(epochs=1, test=True)
    data = jsyn.generate_dataset(3, bs, cfg, scene_len=26)
    scenes = jsim.scenes_from_dataset(data)
    net = JNet(cfg)
    ds = SceneDataset({k: v for k, v in data.items()
                       if not k.startswith("scene_")}, cfg)
    sample = next(batch_iterator(ds, "val", min(bs, 2), shuffle=False,
                                 drop_last=False))
    params = jtrain.init_state(cfg, net, sample,
                               jax.random.PRNGKey(0)).params
    init_carry, step = jsim.make_closed_loop_step(
        scenes, cfg, net, params, jspecs.build_scorer(cfg),
        jdiff.get_coeffs(cfg))
    key = jax.random.PRNGKey(1)
    c = init_carry(key)
    for _ in range(STEPS):
        c = step(c)
    want = {k: np.asarray(v) for k, v in jsim._carry_metrics(c).items()}
    noise = jax_episode_noise(key, STEPS, cfg.diffusion_steps,
                              (bs, cfg.nt, 2, 3 * n_randoms))
    state = convert.from_flax(jax.device_get(params))
    return (TConfig(**cfg.to_dict()).to_dict(), data, state, noise,
            dict(want, ego=np.asarray(c.ego)))


#: the candidate-sharded plan's routes: bench.py's heavy contract at a
#: small width on BENCH_GPALLAS "2" (kernel 1), "4" (kernel 5), "1"
#: (kernel 2), the folded "1f", "2f" and "3" (launches of kernels 2 and 1),
#: and the row-major samplers on "2": DDIM, DPM++ and the m-major DDPM
#: chain
ROUTES = {"2": ("2", {}), "4": ("4", {}), "1": ("1", {}), "1f": ("1f", {}),
          "2f": ("2f", {}), "3": ("3", {}),
          "ddim": ("2", {"sampler": "ddim", "ddim_steps": 4}),
          "dpmpp": ("2", {"sampler": "dpmpp", "ddim_steps": 4}),
          "m_major": ("2", {"cm_sampler": False})}
#: each route's kernel wrapper (the plain version runs here)
ROUTE_CALL = {"2": "fused", "4": "superstep", "1": "frozen", "1f": "frozen",
              "2f": "fused", "3": "fused", "ddim": "fused", "dpmpp": "fused",
              "m_major": "fused"}


def route_cfg(name, n_randoms=4):
    gp, kw = ROUTES[name]
    return bench_config("heavy", gp).with_(
        n_randoms=n_randoms, n_neighbors=3, hiddens=(32, 32),
        rect_hiddens=(32, 32), diffusion_steps=8, multi_cands=3, n_rolls=2,
        compute_dtype="float32", **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on two ranks (one run), with the JAX references."""
    scene = jax_case(bs=8, n_randoms=2)
    cands = {b: jax_case(bs=1, n_randoms=4, blend=b) for b in (False, True)}
    cases = []
    for chunk in (1, 2):
        cfg, data, state, noise, _ = scene
        cases.append(("scene_loop", dict(chunk=chunk, cfg=cfg, data=data,
                                         state=state, noise=noise)))
    for b in (False, True):
        cfg, data, state, noise, _ = cands[b]
        cases.append(("cand_loop", dict(cfg=cfg, data=data, state=state,
                                        noise=noise)))
    plan_data = jsyn.generate_dataset(5, 2, JConfig(n_neighbors=3),
                                      scene_len=14)
    for name in ROUTES:
        cases.append(("cand_plan", dict(cfg=route_cfg(name).to_dict(),
                                        data=plan_data)))
    cases.append(("cand_refuses", dict(
        cfg=route_cfg("2", 3).with_(n_shards=3).to_dict(), data=plan_data)))
    outs, wall = run_ranks(cases, tmp_path_factory.mktemp("ranks"), WORLD)
    print(f"two gloo ranks: {wall:.1f} s")
    return scene, cands, outs


def _held_to_jax(got, want):
    for k in KEYS:
        np.testing.assert_allclose(got["metrics"][k].numpy(), want[k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("collide", "out_of_lane", "traj_len"):
        np.testing.assert_array_equal(got["metrics"][k].numpy(), want[k],
                                      err_msg=k)
    np.testing.assert_allclose(got["ego"].numpy(), want["ego"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("chunk", [1, 2])
def test_closed_loop_sharded_matches_unsharded(runs, chunk):
    """8 scenes over two ranks (4 each), 2 steps in one-step or two-step
    calls: every scene's metrics, gathered on both ranks, equal the JAX
    package's unsharded run on the same draws."""
    scene, _, outs = runs
    for o in outs:
        _held_to_jax(o[chunk - 1], scene[4])


@pytest.mark.parametrize("blend", [False, True])
def test_closed_loop_candidate_sharded_matches_unsharded(runs, blend):
    """One scene, its n_randoms = 4 seeds split 2 a rank (6 of the 12
    candidate columns each), 2 steps, guidance_blend_scores off and on:
    the metrics equal the JAX package's unsharded run, on both ranks."""
    _, cands, outs = runs
    for o in outs:
        _held_to_jax(o[2 + int(blend)], cands[blend][4])


@pytest.mark.parametrize("route", list(ROUTES))
def test_candidate_sharded_plan_per_route(runs, route):
    """One plan on two scenes, candidate-sharded (2 of 4 seeds a rank),
    against the unsharded plan: every rank returns every row; the
    route's kernel wrapper ran on each rank as often as unsharded (once a
    guided denoise step)."""
    outs = runs[2]
    i = 4 + list(ROUTES).index(route)
    for o in outs:
        r = o[i]
        for k, want in r["one"].items():
            got = r["sharded"][k]
            assert got.shape == want.shape, k
            if k == "stl_acc":
                assert torch.equal(got, want), k
            else:
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=k)
        assert torch.equal(r["u"], outs[0][i]["u"])
        np.testing.assert_allclose(r["u"].numpy(), r["u_one"].numpy(),
                                   rtol=1e-5, atol=1e-5)
        call = ROUTE_CALL[route]
        assert r["calls"] == r["calls_one"] and r["calls"][call] > 0, r


def test_candidate_sharding_needs_divisible_seeds(runs):
    """n_randoms = 3 seeds do not split over two ranks: ValueError."""
    for o in runs[2]:
        assert "must divide" in o[-1]
