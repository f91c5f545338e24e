"""Export a committed orbax checkpoint to the torch port's weight format.

By default loads the checkpoint exactly as ``bench.py``'s ``measure`` does
— ``Net`` init with ``PRNGKey(1)`` on the heavy closed-loop config, then
``train.load_params_only`` — and writes the merged params as a flat
float32 ``.npz`` keyed by flax path (``ego_encoder/Dense_0/kernel``),
which ``pstl_tpu_torch.models.convert.load_weights`` reads.  With
``--own-modules`` it writes only the modules the checkpoint holds, with no
init at all: a plain DDPM base (``e5b_round5``) has no RefineNet head, and
the port's ``train.load_params_only`` then keeps the net's own.  Needs jax,
flax and orbax; the torch port itself does not.

    python scripts/export_torch_weights.py [--ckpt checkpoints/e7_round5]
        [--out pstl_tpu_torch/weights/e7_round5.npz] [--own-modules]
    python scripts/export_torch_weights.py --own-modules \
        --ckpt checkpoints/e5b_round5 \
        --out pstl_tpu_torch/weights/e5b_round5.npz
"""

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def restore_params(ckpt: str, bs: int = 2):
    """The merged flax params bench.py would run with (init + load)."""
    import jax
    import jax.numpy as jnp

    import bench
    from pstl_tpu import sim, specs, train
    from pstl_tpu.data import synthetic
    from pstl_tpu.models import Net

    cfg = bench.build_cfg("heavy")
    net = Net(cfg)
    data = synthetic.generate_dataset(0, bs, cfg, scene_len=38)
    scenes = sim.scenes_from_dataset(data)
    n = bs * cfg.n_randoms * 3

    @jax.jit
    def init_params(key):
        obs0 = jax.vmap(lambda s, e, t: sim.observe(s, e, t, cfg))(
            scenes, scenes.ego_full[:, 0], jnp.zeros((bs,), jnp.int32))
        gt_stlp = jnp.broadcast_to(jnp.asarray(sim.AGGRESSIVE_STLP), (bs, 6))
        dense0 = specs.densify_batch(
            obs0, gt_stlp, cfg, key=key,
            stlp_dense=jnp.broadcast_to(jnp.asarray(sim.AGGRESSIVE_STLP),
                                        (n, 1, 6)))
        ext0 = {"timestep": jnp.ones((n, 1)),
                "highlevel": dense0["highlevel_dense"],
                "noise": jnp.zeros((n, cfg.nt * 2))}
        return net.init(key, dense0, ext0, method=Net.init_all)

    params = init_params(jax.random.PRNGKey(1))
    state = train.TrainState(params, None, 0)
    return train.load_params_only(ckpt, state).params


def restore_own(ckpt: str):
    """The checkpoint's own params, restored as host numpy (the fallback
    restore of ``train.load_params_only``, which works whatever platform
    wrote the checkpoint)."""
    import jax
    import orbax.checkpoint as ocp

    from pstl_tpu.train import _resolve_ckpt
    path = _resolve_ckpt(ckpt)
    with ocp.PyTreeCheckpointer() as ckptr:
        meta = ckptr.metadata(path)
        tree = getattr(meta, "item_metadata", meta)
        args = jax.tree_util.tree_map(
            lambda _: ocp.RestoreArgs(restore_type=np.ndarray), tree)
        return ckptr.restore(path, restore_args=args)["params"]


def flat_params(params) -> dict:
    from pstl_tpu_torch.models.convert import flatten
    return {k: np.asarray(v, np.float32) for k, v in flatten(params).items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=os.path.join(HERE, "checkpoints",
                                                   "e7_round5"))
    ap.add_argument("--out", default=os.path.join(
        HERE, "pstl_tpu_torch", "weights", "e7_round5.npz"))
    ap.add_argument("--own-modules", action="store_true",
                    help="write only the modules the checkpoint holds")
    args = ap.parse_args()
    flat = flat_params(restore_own(args.ckpt) if args.own_modules
                       else restore_params(args.ckpt))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez(args.out, **flat)
    n = sum(v.size for v in flat.values())
    print(f"wrote {args.out}: {len(flat)} arrays, {n} parameters")


if __name__ == "__main__":
    main()
