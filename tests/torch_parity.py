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
