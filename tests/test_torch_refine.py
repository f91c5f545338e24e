"""``pstl_tpu_torch.refine`` and ``pstl_tpu_torch.optim`` against
``pstl_tpu.refine`` and ``optax.adam`` on the CPU.

The scenes (``torch_parity.refine_case``): two straight lane scenes
(``test_specs.make_batch``'s) with a neighbor driving beside the ego in the
left lane, inside the clearance's (-5, 20) gate, so the safety clause's
gradient reaches the refinement through ``MinClearanceTiled``'s VJP; dense
stlp rows from seeded flex draws; the candidates start from the GT states
with small random controls, and the lane-keep rows of seed 0 drive the GT
controls, so they satisfy their spec and the others do not.  The controls are small (heading
rates 0.01, accelerations 0.2) so that the rollouts stay within the lanes'
extent with small headings: beyond a lane's end or across a heading wrap
the robustness has kinks, and Adam at lr 0.3 stepping across one takes the
side that the last bit of the gradient decides (with rates 0.05 and
accelerations 0.5 the two packages' refined controls part by up to 0.08
after 50 steps, while their first gradients agree to 3e-5 of the
largest).
The cache ``all_steps`` holds 100 random decodings, as deep as the 100-step
sampler's.  The backup cases (``torch_parity.backup_case``) put a neighbor
across the plan's 2-step-ahead pose at different lateral offsets and
headings, so its clearance hinge is active and the residual moves.

Tolerances.  Refined controls to 1e-4 (the plan tests'): both packages
score the same rollouts in float32 and take the same Adam steps, which
carry a gradient's rounding at most a part of the learning rate, through
softmax weights that mix controls of size ~1.  The violated masks, and the
rows left as they were, exactly.  The backup residual to 1e-4 after 50
iterations.  After the full 500, to the learning rate, 1e-2: near the
optimum the residual's gradient is the difference of the clearance hinge's
and the L2 penalty's, which cancel, and Adam's update g / (sqrt(v) + eps)
stays a step of up to ~lr whatever the size of g, so an ulp of difference
in g flips the sign of single steps.  Each package's iterates then circle
the optimum: here one scene's first heading rate reads -0.2046, -0.2126,
-0.2020, -0.2152 in JAX after 400, 500, 510, 520 iterations.  The two
packages agree to 1e-7 through 400 iterations and part by 1.5e-3 at 500
(2.9e-3 at 510).  The Adam helper against ``optax.adam`` on the same
gradient sequence to 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pstl_tpu import refine as jrefine, specs as jspecs
from pstl_tpu.config import Config as JConfig
from pstl_tpu_torch import optim, refine as trefine, specs as tspecs
from pstl_tpu_torch.config import Config as TConfig

from torch_dense_case import jit_fast
import torch_parity
from torch_parity import backup_case, np_, to_t

TOL = 1e-4
F32 = np.float32


def refine_case(seed=0, bs=2, M=4):
    """(cfg_j, cfg_t, batch, stlp_dense, states_flat, valid, controls,
    all_steps) as numpy (``torch_parity.refine_case``)."""
    cfg_t = TConfig(diffusion=True, n_randoms=M, n_neighbors=3,
                    compute_dtype="float32", flex=True).finalize()
    cfg_j = JConfig(**cfg_t.to_dict())
    return (cfg_j, cfg_t) + torch_parity.refine_case(cfg_t, bs, seed)


def _scorers(case):
    cfg_j, cfg_t, batch, stlp, *_ = case
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return (jspecs.TiledScorer(jb, jnp.asarray(stlp), cfg_j),
            tspecs.TiledScorer(to_t(batch), torch.as_tensor(stlp), cfg_t))


def _violated(score_rows, rollout, states, u, valid, dt):
    s = np_(score_rows(rollout(states, u, dt)[:, :-1]))
    return (s <= 0) & (np_(valid) > 0), s


@pytest.fixture(scope="module")
def case():
    return refine_case()


@pytest.mark.parametrize("K", [6, 8])
def test_convex_refinement(case, K):
    """50 Adam steps on the softmax weights: controls to 1e-4, the violated
    masks equal, the other rows untouched."""
    from pstl_tpu.ops import dynamics as jdyn
    from pstl_tpu_torch.ops import dynamics as tdyn
    cfg_j, cfg_t, _, _, states, valid, u, all_steps = case
    sj, st = _scorers(case)
    want = jit_fast(lambda a, b: jrefine.convex_refinement(
        a, b, jnp.asarray(states), sj, jnp.asarray(valid), cfg_j, K=K),
        jnp.asarray(u), jnp.asarray(all_steps))
    with torch.no_grad():   # the planner's context: the loop turns grad on
        got = trefine.convex_refinement(
            torch.as_tensor(u), torch.as_tensor(all_steps),
            torch.as_tensor(states), st, torch.as_tensor(valid), cfg_t, K=K)
    vj, s_j = _violated(sj, jdyn.rollout, jnp.asarray(states),
                        jnp.asarray(u), jnp.asarray(valid), cfg_j.dt)
    vt, s_t = _violated(st, tdyn.rollout, torch.as_tensor(states),
                        torch.as_tensor(u), torch.as_tensor(valid), cfg_t.dt)
    np.testing.assert_array_equal(vt, vj)
    assert vj.any() and (~vj & (valid > 0)).any()
    np.testing.assert_array_equal(np_(got)[~vt], u[~vt])
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0, atol=TOL)
    assert float(np.abs(np.asarray(want) - u).max()) > 0.05


def test_raw_refinement(case):
    """The residual's 5 Adam steps: controls to 1e-4."""
    cfg_j, cfg_t, _, _, states, valid, u, _ = case
    sj, st = _scorers(case)
    want = jit_fast(lambda a: jrefine.raw_refinement(
        a, jnp.asarray(states), sj, jnp.asarray(valid), cfg_j),
        jnp.asarray(u))
    with torch.no_grad():
        got = trefine.raw_refinement(
            torch.as_tensor(u), torch.as_tensor(states), st,
            torch.as_tensor(valid), cfg_t)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0, atol=TOL)
    assert float(np.abs(np.asarray(want) - u).max()) > 0.05


@pytest.mark.parametrize("n_iters,tol", [(50, 1e-4), (500, 1e-2)])
def test_solve_backup_batched_equals_vmap(n_iters, tol):
    """The batched solve against the JAX package's vmap of its one-scene
    solve (see the module docstring for the tolerance at 500)."""
    cfg_j = JConfig().finalize()
    cfg_t = TConfig(**cfg_j.to_dict())
    plan, u01, nei = backup_case()
    want = jit_fast(lambda p, u, n: jax.vmap(
        lambda pt, uu, nn: jrefine.solve_backup(
            pt[None, 0:3], uu[None], nn[None, 0:3], cfg_j,
            n_iters=n_iters))(p, u, n),
        jnp.asarray(plan), jnp.asarray(u01), jnp.asarray(nei))
    got = trefine.solve_backup(torch.as_tensor(plan[:, 0:3]),
                               torch.as_tensor(u01),
                               torch.as_tensor(nei[:, 0:3]), cfg_t,
                               n_iters=n_iters)
    assert got.shape == (4, 2, 2)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0, atol=tol)
    assert (np.abs(np.asarray(want)).max(axis=(1, 2)) > 0.1).sum() >= 3


@pytest.mark.parametrize("lr", [0.3, "schedule"])
def test_adam_matches_optax(lr):
    """``optim.Adam`` against ``optax.adam`` on one seeded gradient
    sequence (gradients of mixed sign and scale, some exactly 0), with a
    constant learning rate and with a per-step one."""
    rng = np.random.RandomState(1)
    iters = 40
    grads = (rng.randn(iters, 6, 5) * 10.0 ** rng.uniform(-6, 1, (iters, 6,
                                                               5))
             ).astype(F32)
    grads[:, 0] = 0.0
    x0 = rng.randn(6, 5).astype(F32)
    if lr == "schedule":
        sched = optax.cosine_decay_schedule(0.3, iters, alpha=0.02)
        table = np.asarray(jax.vmap(sched)(jnp.arange(iters)))
        opt = optax.adam(sched)
    else:
        table = lr
        opt = optax.adam(lr)
    x, st = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    for g in grads:
        upd, st = opt.update(jnp.asarray(g), st, x)
        x = optax.apply_updates(x, upd)
    adam = optim.Adam(torch.as_tensor(x0), table, iters)
    p = torch.as_tensor(x0)
    for i, g in enumerate(grads):
        p = adam.update(p, torch.as_tensor(g), i)
    np.testing.assert_allclose(np_(p), np.asarray(x), rtol=1e-6, atol=1e-7)
    assert float(np.abs(np.asarray(x) - x0).max()) > 1.0


def test_refinement_gradient_splits_ties_like_jax(case):
    """The refinement's loss gradient through the scorer's clearance where
    its minima tie: every candidate drives its scene's GT controls, and the
    neighbor drives level with the ego 1.8 m to its left in the ego's own
    box, so at every step its 4 disc pairs (i, i) are equally far and the
    VJP splits the cotangent over them, as ``jnp.min``'s does; the safety
    clause binds (clearance ~0.07 m).  Gradients to rtol 1e-4 with a floor
    of 1e-5 of the largest entry (``test_torch_trajopt``'s)."""
    from pstl_tpu.ops import dynamics as jdyn
    from pstl_tpu_torch.ops import dynamics as tdyn
    from pstl_tpu_torch.ops import geometry as tgeom
    from pstl_tpu_torch.ops.guidance_loss import mask_mean
    cfg_j, cfg_t, batch, stlp, states, valid, u, _ = case
    bs, nt = batch["ego_traj"].shape[:2]
    R = u.shape[0] // bs
    u = np.repeat(u.reshape(bs, R, nt, 2)[:, :1], R, axis=1).reshape(
        u.shape)                                   # seed 0's GT controls
    ego = tdyn.rollout(torch.as_tensor(states), torch.as_tensor(u),
                       cfg_t.dt)[:, :-1]
    batch = dict(batch)
    nei = batch["neighbor_trajs_aug"].copy()
    nei[:, 1, :, 1:5] = np_(ego[::R])
    nei[:, 1, :, 2] += 1.8
    nei[:, 1, :, 5:7] = [cfg_t.ego_L, cfg_t.ego_W]
    batch["neighbor_trajs_aug"] = nei
    sj, st = _scorers((cfg_j, cfg_t, batch, stlp))
    _, axe = tgeom._ego_axes(cfg_t.ego_L, cfg_t.ego_W, cfg_t.refined_nL,
                             "cpu")
    dx, dy, _, _ = tgeom._pairs(ego[..., :3].reshape(bs, R, nt, 3),
                                st.discs.nx, st.discs.ny, axe)
    d2 = (dx * dx + dy * dy)[:, :, 1]              # the tied neighbor
    ties = (d2 == d2.amin(dim=(-2, -1), keepdim=True)).sum((-2, -1))
    assert bool((ties == 4).all())

    def loss_j(x):
        s = sj(jdyn.rollout(jnp.asarray(states), x, cfg_j.dt)[:, :-1])
        return jspecs.mask_mean(jax.nn.relu(5e-4 - s), jnp.asarray(valid))

    def loss_t(x):
        s = st(tdyn.rollout(torch.as_tensor(states), x, cfg_t.dt)[:, :-1])
        return mask_mean(torch.relu(5e-4 - s), torch.as_tensor(valid))

    gj = np.asarray(jit_fast(jax.grad(loss_j), jnp.asarray(u)))
    x = torch.as_tensor(u).requires_grad_(True)
    gt, = torch.autograd.grad(loss_t(x), x)
    floor = 1e-5 * np.abs(gj).max()
    np.testing.assert_allclose(np_(gt), gj, rtol=1e-4, atol=floor)
    assert np.abs(gj).max() > 0
