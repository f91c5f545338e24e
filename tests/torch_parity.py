"""Shared helpers of the torch-port parity tests (``tests/test_torch_*.py``):
seeded numpy inputs handed to both packages, and small converters.

Every torch parity test runs the JAX function and its ``pstl_tpu_torch``
counterpart on the same numpy arrays, on the CPU.
"""

import numpy as np
import torch

torch.set_num_threads(1)

F32 = np.float32


def to_t(tree):
    """numpy / jax leaves -> torch CPU tensors (dicts and tuples kept)."""
    if isinstance(tree, dict):
        return {k: to_t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_t(v) for v in tree)
    return torch.as_tensor(np.array(tree))


def np_(x):
    """torch / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def guidance_case(seed, bs=2, M=4, nt=20, K=3, S=15):
    """A random guidance problem (the inputs tests/test_pallas_guidance.py
    builds), as numpy: the per-scene batch, dense stlp rows, ego start
    states and an m-major posterior mean mu (N, nt*2)."""
    rng = np.random.RandomState(seed)
    nei = rng.randn(bs, K, nt, 7).astype(F32) * 5
    nei[..., 0] = (rng.rand(bs, K, nt) > 0.3).astype(F32)
    batch = {
        "neighbor_trajs_aug": nei,
        "currlane_wpts": rng.randn(bs, S, 3).astype(F32) * 3,
        "leftlane_wpts": rng.randn(bs, S, 3).astype(F32) * 3,
        "rightlane_wpts": rng.randn(bs, S, 3).astype(F32) * 3,
        "curr_id": np.ones((bs, 1), F32),
        "left_id": (rng.rand(bs, 1) > .5).astype(F32),
        "right_id": (rng.rand(bs, 1) > .5).astype(F32),
        "gt_high_level": rng.randint(0, 3, (bs, 1)).astype(F32),
    }
    N = bs * M * 3
    stlp = np.stack([rng.uniform(0, 2, N), rng.uniform(5, 9, N),
                     rng.uniform(-3, -1, N), rng.uniform(1, 3, N),
                     rng.uniform(0.1, 1, N), rng.uniform(0.2, 0.5, N)],
                    -1).astype(F32)[:, None]
    gt_stlp = stlp.reshape(bs, M * 3, 6)[:, 0]
    states = rng.randn(bs, 4).astype(F32)
    states[:, 3] = np.abs(states[:, 3]) * 3
    mu = (rng.randn(N, nt * 2) * 0.5).astype(F32)
    return batch, gt_stlp, stlp, states, mu


def jax_cm_noise(key, T, shape):
    """The draws ``pstl_tpu.diffusion.reverse_sample`` makes on its
    candidate-minor path from ``key``, as the (T, *shape) tensor the torch
    sampler takes: x0, then one draw per denoise step (the key chain
    ``_reverse_superstep`` replicates)."""
    import jax
    k_init, k = jax.random.split(key)
    out = [np.asarray(jax.random.normal(k_init, shape))]
    for _ in range(T - 1):
        k, k_z = jax.random.split(k)
        out.append(np.asarray(jax.random.normal(k_z, shape)))
    return torch.as_tensor(np.stack(out))


def jax_plan_noise(key, T, shape):
    """The sampler draws of ``pstl_tpu.sim.make_planner``'s plan(key, obs):
    plan splits its key into (densify, sample) keys first."""
    import jax
    _, k_sample = jax.random.split(key)
    return jax_cm_noise(k_sample, T, shape)


def jax_episode_noise(key, steps, T, shape):
    """Per-step planner draws of a ``pstl_tpu.sim`` closed-loop episode
    started from ``key`` (each step splits the carry key into (next,
    plan))."""
    import jax
    out = []
    for _ in range(steps):
        key, k_plan = jax.random.split(key)
        out.append(jax_plan_noise(k_plan, T, shape))
    return out


def refine_case(cfg, bs=2, seed=0, n_steps=100):
    """A well-conditioned refinement problem for ``cfg`` (a port Config),
    as numpy: ``tests/test_specs.make_batch``'s straight lane scenes (the
    GT drives the current lane at ~5 m/s, the right lane invalid) with a
    neighbor driving beside the ego in the left lane, inside the
    clearance's (-5, 20) gate; the dense stlp rows of seeded flex draws;
    candidates from the GT start states with small random controls (heading
    rates 0.01, accelerations 0.2), the lane-keep rows of seed 0 driving the
    GT controls; ``n_steps`` random cached decodings of that size.
    Returns (batch, stlp_dense, states_flat, valid, controls, all_steps)."""
    from pstl_tpu_torch import specs
    from pstl_tpu_torch.ops import dynamics
    rng = np.random.RandomState(seed)
    nt, M = cfg.nt, cfg.n_randoms
    lane = np.stack([np.linspace(-5, 60, cfg.n_segs),
                     np.zeros(cfg.n_segs), np.zeros(cfg.n_segs)], -1)
    batch = {
        "currlane_wpts": np.tile(lane, (bs, 1, 1)).astype(F32),
        "leftlane_wpts": np.tile(lane + [0, 3.5, 0], (bs, 1, 1)).astype(F32),
        "rightlane_wpts": np.tile(lane + [0, -3.5, 0], (bs, 1, 1)).astype(
            F32),
        "curr_id": np.ones((bs, 1), F32),
        "left_id": np.ones((bs, 1), F32),
        "right_id": np.zeros((bs, 1), F32),
        "gt_high_level": np.zeros((bs, 1), F32),
    }
    s0 = np.zeros((bs, 4), F32)
    s0[:, 3] = 5.0 + rng.rand(bs)
    gt_u = np.zeros((bs, nt, 2), F32)
    gt_u[:, :, 1] = rng.randn(bs, nt) * 0.1
    ego = dynamics.rollout(torch.as_tensor(s0), torch.as_tensor(gt_u),
                           cfg.dt).numpy()[:, :-1]
    batch["ego_traj"] = ego
    nei = np.zeros((bs, cfg.n_neighbors, nt, 7), F32)
    nei[:, 0, :, 0] = 1.0
    nei[:, 0, :, 1:3] = [40.0, 3.5]
    nei[:, 0, :, 5:7] = [4.0, 2.0]
    nei[:, 1, :, 0] = 1.0
    nei[:, 1, :, 1] = ego[..., 0] + 2.0
    nei[:, 1, :, 2] = 3.2
    nei[:, 1, :, 4] = ego[..., 3]
    nei[:, 1, :, 5:7] = [4.0, 2.0]
    batch["neighbor_trajs_aug"] = nei
    tb = to_t(batch)
    stlp = specs.calibrate_stlp(tb, tb["ego_traj"][..., :4], cfg)
    g = torch.Generator().manual_seed(seed)
    dense = specs.densify_batch(tb, stlp, cfg,
                                flex=specs.flex_uniforms(bs, g))
    n = bs * M * 3
    scale = np.array([0.01, 0.2], F32)
    controls = (rng.randn(n, nt, 2) * scale).astype(F32)
    gt_u[:, -1] = 0.0
    controls.reshape(bs, M, 3, nt, 2)[:, 0, 0] = gt_u
    all_steps = (rng.randn(n_steps, n, nt, 2) * scale).astype(F32)
    valid = dense["valids_dense"].reshape(-1).numpy().copy()
    valid[3] = 0.0
    return (batch, dense["stlp_dense"].numpy(),
            np.repeat(s0, M * 3, axis=0), valid, controls, all_steps)


def backup_case(bs=4, nt=20, dt=0.5):
    """Backup-controller inputs, as numpy: straight constant-speed plans
    with a car-sized neighbor across the 2-step-ahead pose at lateral
    offsets 1.6-2.4 m and headings 0-0.3 (the clearance hinge active, the
    residual moving).  Returns (plan (bs, nt+1, 4), u01 (bs, 2, 2),
    neighbor rows (bs, nt, 7))."""
    rng = np.random.RandomState(0)
    v = 2.0 + 3.0 * rng.rand(bs)
    ts = np.arange(nt + 1) * dt
    plan = np.zeros((bs, nt + 1, 4), F32)
    plan[:, :, 0] = v[:, None] * ts
    plan[:, :, 3] = v[:, None]
    u01 = (rng.randn(bs, 2, 2) * [0.05, 0.3]).astype(F32)
    nei = np.zeros((bs, nt, 7), F32)
    nei[..., 0] = 1.0
    nei[..., 1] = plan[:, 2:3, 0]
    nei[..., 2] = np.linspace(1.6, 2.4, bs)[:, None]
    nei[..., 3] = np.linspace(0.0, 0.3, bs)[:, None]
    nei[..., 5:7] = [4.5, 2.0]
    return plan, u01, nei
