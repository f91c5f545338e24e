"""Command-line interface of the port (the counterpart of
``pstl_tpu/cli.py``): the same subcommands, flags and defaults.

  python -m pstl_tpu_torch.cli data    --out cache.npz [--scenes N]
  python -m pstl_tpu_torch.cli trajopt --cache cache.npz --out aug.npz
  python -m pstl_tpu_torch.cli train   --preset e5_ddpm --cache aug.npz
  python -m pstl_tpu_torch.cli eval    --preset e7_ours --cache ... --ckpt ...
  python -m pstl_tpu_torch.cli sim     --preset ours_guidance --ckpt ...
  python -m pstl_tpu_torch.cli check   --cache cache.npz
  python -m pstl_tpu_torch.cli presets

Every Config field is addressable as ``--set key=value`` overrides.

What differs from the JAX command line:

- ``--device`` (``trajopt``, ``train``, ``eval``, ``sim``, ``check``): where
  the command computes; by default the card, and an error without one
  (``--device cpu`` runs the plain versions on the CPU).
- ``--ckpt`` reads what ``train.load_params_only`` reads: a port checkpoint
  (a directory with ``LAST``) or a flat flax ``.npz`` such as
  ``pstl_tpu_torch/weights/e7_round5.npz``.  An orbax directory raises and
  names ``scripts/export_torch_weights.py``.
- ``train`` writes its checkpoints under ``exps/<exp_name>/torch_models``.
- Seeds replace JAX keys: the closed loop runs from seed 0 and the net is
  initialized from ``cfg.seed``.
- ``data --real`` (or ``synthetic=False``) runs the port's own copy of the
  NuScenes extraction (``data/extract.py``; it needs ``nuscenes-devkit``
  and the dataset on that machine).
- ``train --mesh`` trains data-parallel over ``torch.distributed``
  (``parallel``): under ``torchrun --nproc_per_node=N -m
  pstl_tpu_torch.cli train --mesh ...`` one process a card (NCCL; gloo
  with ``--device cpu``), or in one process at world 1, where it computes
  what ``train`` computes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from pstl_tpu_torch.config import Config, PRESETS


def _parse_value(field_type, raw: str):
    if raw.lower() in ("none", "null"):
        return None
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            pass
    if "," in raw:
        return tuple(_parse_value(None, x) for x in raw.split(","))
    return raw


def build_config(args) -> Config:
    cfg = PRESETS[args.preset] if args.preset else Config()
    overrides = {}
    for kv in args.set or []:
        k, v = kv.split("=", 1)
        if not hasattr(cfg, k):
            sys.exit(f"unknown config field: {k}")
        overrides[k] = _parse_value(None, v)
    if args.exp_name:
        overrides["exp_name"] = args.exp_name
    cfg = cfg.with_(**overrides)
    return cfg.finalize() if not args.preset else cfg.with_(**overrides)


def add_common(p, device=True):
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--set", nargs="*", metavar="KEY=VALUE",
                   help="override any Config field")
    p.add_argument("--exp-name", "-e", default=None)
    p.add_argument("--cache", default=None, help="scene dataset npz path")
    p.add_argument("--ckpt", "-P", default=None,
                   help="pretrained weights: a port checkpoint directory or "
                        "a flat flax .npz")
    if device:
        p.add_argument("--device", default=None,
                       help="torch device (default: the card; 'cpu' runs "
                            "the plain versions on the CPU)")


def load_dataset(cfg: Config, args, scene_len=None):
    from pstl_tpu_torch.data.dataset import SceneDataset
    # --cache beats cfg.cache_path (nusc_train.py:156 find_npz_path)
    path = args.cache or (cfg.cache_path
                          if os.path.exists(cfg.cache_path or "") else None)
    if not cfg.offline and not path:
        sys.exit("offline=False requires a collected cache: run "
                 "`python -m pstl_tpu_torch.cli data --out <cache.npz>` "
                 "first")
    ds = (SceneDataset.load(path, cfg) if path
          else SceneDataset.from_synthetic(cfg, scene_len=scene_len))
    # trajopt sidecar reuse (--params_load_path, nusc_dataset.py:209-232)
    if (cfg.load_tj and not ds.has("params") and cfg.params_load_path
            and os.path.exists(cfg.params_load_path)):
        ds.load_trajopt_sidecar(cfg.params_load_path)
    return ds


def _net(cfg: Config, dev, ckpt):
    """The policy net on ``dev``: flax-like parameters drawn from
    ``cfg.seed``, then the ``--ckpt`` weights."""
    import torch
    from pstl_tpu_torch import train
    from pstl_tpu_torch.models.net import Net
    net = Net(cfg).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    state = train.init_state(cfg, net, gen)
    if ckpt:
        state = train.load_params_only(ckpt, state)
    return state.net


def cmd_data(args):
    # collection mode coupling (nusc_train.py:1794-1801): offline=False
    # while the cache is being built
    cfg = build_config(args).with_(collect_data=True).finalize()
    from pstl_tpu_torch.data.dataset import SceneDataset
    if args.real or not cfg.synthetic:
        from pstl_tpu_torch.data import extract
        out = extract.extract_dataset(cfg, version=args.version,
                                      dataroot=args.dataroot,
                                      out_path=args.out,
                                      sample_stride=args.t_stride,
                                      anno_dir=args.anno_dir)
        print(f"extracted NuScenes cache -> {out}")
        return
    from pstl_tpu_torch.data import synthetic
    data = synthetic.generate_dataset(cfg.seed, args.scenes, cfg,
                                      scene_len=args.scene_len,
                                      t_samples=args.t_samples,
                                      t_stride=args.t_stride)
    ds = SceneDataset(data, cfg)
    ds.save(args.out)
    print(f"wrote {len(ds)} samples ({args.scenes} scenes) -> {args.out}")


def cmd_trajopt(args):
    cfg = build_config(args).with_(trajopt_only=True).finalize()
    from pstl_tpu_torch import specs, trajopt
    from pstl_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    ds = load_dataset(cfg, args)
    formulas = specs.build_scorer(cfg)
    trajopt.augment_dataset(ds, cfg, formulas,
                            batch_size=min(cfg.batch_size, len(ds)),
                            iters=args.iters,
                            epochs=max(cfg.opt_epochs, 1), device=dev)
    ds.save(args.out)
    print(f"augmented {len(ds)} scenes -> {args.out}")


def cmd_train(args):
    cfg = build_config(args)
    if args.ckpt:
        cfg = cfg.with_(net_pretrained_path=args.ckpt)
    from pstl_tpu_torch import train
    from pstl_tpu_torch.device import resolve_device
    from pstl_tpu_torch.parallel import init_multihost, make_mesh
    from pstl_tpu_torch.utils.exp import setup_exp_dir
    mesh, rank = None, 0
    if args.mesh:
        # torchrun's environment, when set, makes one process a card
        rank = init_multihost(device=args.device)
    dev = resolve_device(args.device)
    if args.mesh:
        mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axis_names,
                         device_type=dev.type)
    if cfg.exp_name and rank == 0:
        setup_exp_dir(cfg)
    ds = load_dataset(cfg, args)
    train.train(cfg, ds, epochs=args.epochs, device=dev, mesh=mesh)


def cmd_eval(args):
    cfg = build_config(args).with_(test=True, epochs=1)
    from pstl_tpu_torch import eval_openloop
    from pstl_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    ds = load_dataset(cfg, args)
    net = _net(cfg, dev, args.ckpt)
    out = eval_openloop.run(cfg, ds, net, n_trials=args.trials, device=dev)
    print(json.dumps({k: round(v, 4) for k, v in out.items()}, indent=2))


def _read_episode_list(path):
    """Curated closed-loop episode list: lines of ``scene_i ti`` (the
    reference's 25 human-curated [traj, ti] pairs, nusc_dataset.py:38-72).
    ``#`` comments and trailing rationale text are ignored."""
    eps = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            eps.append((int(parts[0]), int(parts[1]) if len(parts) > 1
                        else 0))
    return eps


def cmd_sim(args):
    cfg = build_config(args).with_(test=True, epochs=1)
    from pstl_tpu_torch import diffusion, sim
    from pstl_tpu_torch.data import synthetic
    from pstl_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    stlp_override = None
    t0 = None
    if args.cache:
        # extracted scene cache -> closed-loop (the reference runs the
        # closed loop on the real val loader, nusc_sim.py:356-390)
        raw = dict(np.load(args.cache, allow_pickle=False))
        if "scene_ego_full" not in raw:
            sys.exit(f"--cache {args.cache} carries no scene_* tensors; "
                     "re-extract with scene output (cli data)")
        data = raw
    elif cfg.test_scenes:
        # held-out closed-loop protocol (nusc_dataset.py:38-72's curated 25
        # scenes): a fixed fresh seed never used by training data
        data = synthetic.generate_dataset(777, max(args.scenes, 25) * 2, cfg,
                                          scene_len=args.scene_len)
    else:
        data = synthetic.generate_dataset(cfg.seed, args.scenes * 2, cfg,
                                          scene_len=args.scene_len)
    n_scenes_all = len(data["scene_ego_full"])
    if args.episodes:
        # declared (scene, ti) episode list from the cache
        eps = _read_episode_list(args.episodes)
        keep = np.array([e[0] for e in eps], np.int64)
        if (keep >= n_scenes_all).any():
            sys.exit(f"--episodes references scene >= {n_scenes_all}")
        t0 = np.array([e[1] for e in eps], np.int64)
        lens = np.asarray(data["scene_len"])[keep]
        t0 = np.minimum(t0, np.maximum(lens - 4, 0))
    elif not args.no_pre_check:
        # pre_check: skip slow scenes (mean GT speed < 1, nusc_sim.py:34-39)
        keep = np.where(data["scene_ego_full"][:, :, 3].mean(-1) >= 1.0)[0]
    else:
        keep = np.arange(n_scenes_all)
    if args.episodes is None:
        keep = keep[:max(args.scenes, 25) if cfg.test_scenes
                    else args.scenes]
    scene_data = {k: v[keep] for k, v in data.items()
                  if k.startswith("scene_")}
    if cfg.test_aggressive:
        # --test_aggressive: triple-repeat the first selected scene under
        # the three aggressive stlp presets (nusc_sim.py:444-465, scene
        # 781 x3) — works for cached and synthetic scenes alike
        scene_data = {k: np.repeat(v[:1], 3, axis=0)
                      for k, v in scene_data.items()}
        if t0 is not None:
            t0 = np.repeat(t0[:1], 3, axis=0)
        stlp_override = sim.TEST_AGGRESSIVE_STLPS
    scenes = sim.scenes_from_dataset(scene_data, device=dev)
    net = _net(cfg, dev, args.ckpt)
    coeffs = diffusion.get_coeffs(cfg, device=dev)
    render_dir = None
    if args.render:
        from pstl_tpu_torch.utils.exp import setup_exp_dir
        render_dir = setup_exp_dir(cfg, tee=False) + "/viz"
    out = sim.run_closed_loop_host(
        0, scenes, cfg, net, coeffs, max_steps=args.steps,
        record=bool(render_dir) or args.record, render_dir=render_dir,
        stlp_override=stlp_override, t0=t0)
    res = {k: (float(v.mean()) if hasattr(v, "mean") else float(v))
           for k, v in out.items() if k != "history"}
    print(json.dumps({k: round(v, 4) for k, v in res.items()}, indent=2))
    if render_dir:
        print(f"frames + GIFs -> {render_dir}")


def check_batches(cfg: Config, ds, device):
    """Calibration self-consistency: each train batch's GT trajectories
    scored under their own calibrated spec.  Yields (acc, stlp (bs, 6)) a
    batch."""
    import torch
    from pstl_tpu_torch import specs
    from pstl_tpu_torch.data.dataset import batch_iterator
    from pstl_tpu_torch.train import to_device
    formulas = specs.build_scorer(cfg)
    for b in batch_iterator(ds, "train", cfg.batch_size, shuffle=False,
                            drop_last=False):
        batch = to_device(b, device)
        batch["neighbor_trajs_aug"] = batch["neighbors_traj"]
        gt = batch["ego_traj"][..., :4]
        with torch.no_grad():
            stlp = specs.calibrate_stlp(batch, gt, cfg)
            signals = {
                "ego_traj": gt,
                "neighbors": batch["neighbor_trajs_aug"],
                "currlane_wpts": batch["currlane_wpts"],
                "leftlane_wpts": batch["leftlane_wpts"],
                "rightlane_wpts": batch["rightlane_wpts"],
                "stlp": stlp[:, None, :],
            }
            hl = batch["gt_high_level"][:, 0]
            mask = (hl != 3).float()
            _, _, acc = specs.compute_scores(signals, formulas, hl, mask,
                                             cfg)
        yield acc, stlp


def cmd_check(args):
    """Calibration self-consistency (--check_stl_params,
    nusc_train.py:816-875): GT trajectories scored under their own
    calibrated spec."""
    cfg = build_config(args)
    from pstl_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    ds = load_dataset(cfg, args)
    accs = []
    for bi, (acc, stlp) in enumerate(check_batches(cfg, ds, dev)):
        accs.append(float(acc))
        print(f"{bi:03d} ACC:{float(acc):.3f} "
              f"vmin:{float(stlp[:, 0].min()):.2f} "
              f"vmax:{float(stlp[:, 1].max()):.2f}")
    print(f"ACC:{np.mean(accs):.3f}")


def cmd_presets(args):
    for name, cfg in sorted(PRESETS.items()):
        d = {k: v for k, v in cfg.to_dict().items()
             if v != getattr(Config(), k, None)}
        print(f"{name}: {json.dumps(d, default=str)}")


def main(argv=None):
    p = argparse.ArgumentParser("pstl_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("data", help="generate/extract a scene dataset")
    add_common(d, device=False)
    d.add_argument("--out", required=True)
    d.add_argument("--scenes", type=int, default=512)
    d.add_argument("--scene-len", type=int, default=None)
    d.add_argument("--t-samples", type=int, default=1,
                   help="samples per scene at strided t0 (reference trains "
                        "on multiple (scene, t) rows)")
    d.add_argument("--t-stride", type=int, default=4)
    d.add_argument("--real", action="store_true",
                   help="extract from real NuScenes (needs the devkit)")
    d.add_argument("--version", default="v1.0-trainval")
    d.add_argument("--dataroot", default=None)
    d.add_argument("--anno-dir", default=None,
                   help="reference annotation tool's per-scene high-level "
                        "keyframe pickles (docs/REAL_DATA.md)")
    d.set_defaults(fn=cmd_data)

    t = sub.add_parser("trajopt", help="trajopt data augmentation")
    add_common(t)
    t.add_argument("--out", required=True)
    t.add_argument("--iters", type=int, default=None)
    t.set_defaults(fn=cmd_trajopt)

    tr = sub.add_parser("train", help="train a policy")
    add_common(tr)
    tr.add_argument("--epochs", type=int, default=None)
    tr.add_argument("--mesh", action="store_true",
                    help="shard batches over the processes' cards "
                         "(torch.distributed; one process at world 1)")
    tr.set_defaults(fn=cmd_train)

    ev = sub.add_parser("eval", help="open-loop evaluation")
    add_common(ev)
    ev.add_argument("--trials", type=int, default=None)
    ev.set_defaults(fn=cmd_eval)

    si = sub.add_parser("sim", help="closed-loop simulation")
    add_common(si)
    si.add_argument("--scenes", type=int, default=8)
    si.add_argument("--scene-len", type=int, default=38)
    si.add_argument("--steps", type=int, default=36)
    si.add_argument("--record", action="store_true",
                    help="record histories + per-step area metric")
    si.add_argument("--no-pre-check", action="store_true",
                    help="keep slow scenes (pre_check, nusc_sim.py:34-39)")
    si.add_argument("--episodes", default=None,
                    help="file of 'scene_i ti' lines selecting specific "
                         "episodes from the cache (the reference's curated "
                         "[traj, ti] protocol, nusc_dataset.py:38-72)")
    si.add_argument("--render", action="store_true",
                    help="write per-step frames and episode GIFs")
    si.set_defaults(fn=cmd_sim)

    ck = sub.add_parser("check", help="GT-vs-calibrated-spec consistency")
    add_common(ck)
    ck.set_defaults(fn=cmd_check)

    pr = sub.add_parser("presets", help="list named presets")
    pr.set_defaults(fn=cmd_presets)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
