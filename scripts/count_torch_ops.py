#!/usr/bin/env python3
"""Count the eager PyTorch ops of the port's offline paths on the CPU: a
proxy for the device launches a step makes on the card (each non-view aten
op is about one launch there).

    python scripts/count_torch_ops.py

Counts, under a ``TorchDispatchMode`` that skips views and metadata ops:

- one ``trajopt.optimize`` iteration of ``e1_trajopt`` (K = 4 draws;
  forward, autograd backward and the Adam update);
- the open-loop evaluation's timed region (``eval_openloop._sample_and_score``)
  under ``ours_guidance`` with ``guidance_pallas_fuse_freeze`` (99 denoise
  steps, 10 guided; each guided step's kernel call counts as one op, as it
  launches once on the card), and unguided under ``e7_ours``;
- the untimed rows of one eval batch (``_trajopt_row``, ``_nn_metrics``);
- a closed-loop Table-II step (``sim.run_closed_loop_host(record=True)``)
  under the heavy contract (route "2": 99 guided denoise steps) and under
  ``ref_parity(open_loop=False)`` (10 guided), and one Adam iteration of
  each loop of ``refine.py``: the backup solve (per call, whatever the
  number of scenes), the convex refinement (K = 6) and the raw one;
- the baselines (``e3_vae``, ``e6_trafficsim``, BC: ``e3_vae`` with the BC
  head and no init hint; ``ctg`` with ``guidance_pallas_fuse_freeze``):
  a dense train step (forward, backward, Adam), an eval batch's timed
  region and a closed-loop step with ``record=True`` (not BC's, which no
  Table-II row runs).

Widths are cut (2 scenes, 4 seeds, hidden 32): the op count of these paths
does not depend on the widths, except the hull area's chunk loop, which
runs one chunk here and ``ceil(bs * 3 * nt * m^3 / 2^25)`` at full width
(60 for 128 scenes, m = 64), about 15 ops each.
"""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from pstl_tpu_torch import diffusion, eval_openloop, refine, sim, specs
    from pstl_tpu_torch import train, trajopt
    from pstl_tpu_torch.config import PRESETS, bench_config
    from pstl_tpu_torch.data import synthetic
    from pstl_tpu_torch.data.dataset import SceneDataset
    from pstl_tpu_torch.models.net import Net, init_flax_like
    from pstl_tpu_torch.ops import guidance_kernel as gk
    from pstl_tpu_torch.train import attach_neighbors, to_device

    torch.set_num_threads(1)
    skip = {"view", "_unsafe_view", "alias", "detach", "t", "transpose",
            "permute", "expand", "unsqueeze", "squeeze", "slice", "select",
            "as_strided", "reshape", "split", "unbind", "_reshape_alias",
            "lift_fresh", "empty", "empty_like", "empty_strided", "_to_copy"}

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0
            self.paused = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__.split(".")[0]
            if not self.paused and name not in skip:
                self.n += 1
            return func(*args, **(kwargs or {}))

    def count(fn):
        with Count() as c:
            fn()
        return c.n

    # one trajopt iteration: optimize(iters=2) - optimize(iters=1)
    cfg = PRESETS["e1_trajopt"].with_(exp_name=None, n_randoms=4)
    ds = SceneDataset.from_synthetic(cfg, seed=0, n_scenes=2)
    ds.ensure_random_params(0)
    b = to_device(ds.gather([0, 1]), "cpu")
    b["neighbor_trajs_aug"] = b["neighbors_traj"]
    gt = b["ego_traj"][..., :4]
    K = cfg.trajopt_robust_draws
    d = trajopt.batch_draws(2, K, torch.Generator().manual_seed(0))
    stlp = specs.calibrate_stlp(b, gt, cfg)
    dense = specs.densify_batch(b, stlp, cfg, flex=d["densify"])
    sb = specs.dense_signal_input(dense, cfg=cfg)
    draws = torch.stack([dense["stlp_dense"]] + [
        specs.get_dense_stlp(b["gt_high_level"], stlp, cfg, flex=f)
        for f in d["extra"]])
    form = specs.build_scorer(cfg)

    def opt(iters):
        return lambda: trajopt.optimize(b["params"], gt[:, 0], sb,
                                        dense["highlevel_dense"], form, cfg,
                                        iters=iters, stlp_draws=draws)

    per_iter = count(opt(2)) - count(opt(1))
    print(f"trajopt iteration (e1_trajopt, K={K}): {per_iter} ops")

    # the evaluation's regions
    real = gk.guidance_fused_plain

    def kernel_as_one(c):
        """The plain kernel, counted as the one launch it is on the card."""
        def one_launch(*a):
            c.paused += 1
            try:
                return real(*a)
            finally:
                c.paused -= 1
                c.n += 1
        return one_launch
    for preset, kw in (("ours_guidance",
                        {"guidance_pallas_fuse_freeze": True}),
                       ("e7_ours", {})):
        ecfg = PRESETS[preset].with_(
            exp_name=None, n_randoms=4, sampling_size=4, n_shards=2,
            hiddens=(32, 32), rect_hiddens=(32, 32), batch_size=2,
            **kw).with_(run_sampling_test=True).finalize()
        net = Net(ecfg)
        init_flax_like(net, torch.Generator().manual_seed(0))
        eds = SceneDataset.from_synthetic(ecfg, seed=0, n_scenes=2)
        eds.ensure_random_params(0)
        batch = to_device(eds.gather([0, 1]), "cpu")
        coeffs = diffusion.get_coeffs(ecfg)
        c = Count()
        gk.guidance_fused_plain = kernel_as_one(c)
        try:
            with torch.no_grad(), c:
                out = eval_openloop._sample_and_score(
                    net, batch, ecfg, form, coeffs,
                    generator=torch.Generator().manual_seed(0))
            timed = c.n
            with torch.no_grad():
                rows = count(lambda: eval_openloop._trajopt_row(
                    net, batch, ecfg, form,
                    generator=torch.Generator().manual_seed(1)))
                tail = count(lambda: eval_openloop._nn_metrics(
                    *out, attach_neighbors(batch, ecfg), ecfg))
        finally:
            gk.guidance_fused_plain = real
        print(f"eval batch ({preset}{', fused kernel' if kw else ''}, "
              f"{ecfg.diffusion_steps - 1} denoise steps, "
              f"{int(diffusion._trigger_schedule(ecfg).sum())} guided): "
              f"timed region {timed} ops, trajopt row {rows}, metric tail "
              f"{tail}")


    # the closed-loop Table-II step and the loops of refine.py
    heavy = bench_config("heavy").with_(n_randoms=4, hiddens=(32, 32),
                                        rect_hiddens=(32, 32))
    data = synthetic.generate_dataset(777, 2, heavy, scene_len=38)
    scenes = sim.scenes_from_dataset(data, device="cpu")
    for name, cfg in (("heavy", heavy),
                      ("ref_parity", heavy.ref_parity(open_loop=False))):
        net = Net(cfg)
        init_flax_like(net, torch.Generator().manual_seed(0))
        coeffs = diffusion.get_coeffs(cfg)
        c = Count()
        gk.guidance_fused_plain = kernel_as_one(c)
        try:
            def run(steps):
                return lambda: sim.run_closed_loop_host(
                    0, scenes, cfg, net, coeffs, steps, record=True)
            with c:
                run(1)()
            one = c.n
            c.n = 0
            with c:
                run(2)()
            per_step = c.n - one
        finally:
            gk.guidance_fused_plain = real
        print(f"closed-loop step ({name}, "
              f"{int(diffusion._trigger_schedule(cfg).sum())} of "
              f"{cfg.diffusion_steps - 1} denoise steps guided, record=True):"
              f" {per_step} ops")

    cfg = heavy
    obs = sim.observe(scenes, scenes.ego_full[:, 0],
                      torch.zeros(2, dtype=torch.long), cfg)
    n = 2 * cfg.n_randoms * 3
    stlp = torch.as_tensor(sim.AGGRESSIVE_STLP)
    dense = specs.densify_batch(obs, stlp.expand(2, 6), cfg,
                                stlp.expand(n, 1, 6))
    score_rows = specs.make_score_rows(obs, dense, cfg)
    valid = dense["valids_dense"].reshape(-1)
    states = torch.repeat_interleave(obs["ego_traj"][:, 0, :4],
                                     cfg.n_randoms * 3, 0)
    g = torch.Generator().manual_seed(0)
    u = torch.randn((n, cfg.nt, 2), generator=g) * 0.3
    steps = torch.randn((100, n, cfg.nt, 2), generator=g) * 0.3
    traj = obs["ego_traj"][:, :3, :4]
    nei = obs["neighbor_trajs_aug"][:, 0, :3]
    loops = {
        "backup solve": lambda k: lambda: refine.solve_backup(
            traj, u[:2, :2], nei, cfg, n_iters=k),
        "convex refinement (K=6)": lambda k: lambda: refine.convex_refinement(
            u, steps, states, score_rows, valid, cfg, K=6, n_iters=k),
        "raw refinement": lambda k: lambda: refine.raw_refinement(
            u, states, score_rows, valid, cfg, n_iters=k),
    }
    for name, fn in loops.items():
        print(f"{name}: {count(fn(2)) - count(fn(1))} ops an Adam "
              f"iteration, {count(fn(1)) - (count(fn(2)) - count(fn(1)))} "
              "outside the loop")

    # the baselines: a dense train step, an eval batch's timed region and a
    # closed-loop step of each
    bc = {"vae": False, "bc": True, "use_init_hint": False}
    small = dict(exp_name=None, n_randoms=4, sampling_size=4,
                 hiddens=(32, 32), batch_size=2, vae_dim=8)
    rows = (("e3", "e3_vae", {}), ("e6", "e6_trafficsim", {}),
            ("bc", "e3_vae", bc),
            ("ctg", "ctg", {"guidance_pallas_fuse_freeze": True}))
    for name, preset, kw in rows:
        bcfg = PRESETS[preset].with_(**small, **kw).with_(
            run_sampling_test=True).finalize()
        net = Net(bcfg)
        init_flax_like(net, torch.Generator().manual_seed(0))
        coeffs = diffusion.get_coeffs(bcfg)
        bds = SceneDataset.from_synthetic(bcfg, seed=0, n_scenes=2)
        bds.ensure_random_params(0)
        batch = to_device(bds.gather([0, 1]), "cpu")
        msg = f"{name} ({preset}):"
        if name != "ctg":
            tstep = train.make_train_step(bcfg, net, form, coeffs,
                                          train.make_optimizer(bcfg, net))
            gen = torch.Generator().manual_seed(0)
            n_ops = count(lambda: tstep(batch, generator=gen))
            msg += f" dense train step {n_ops} ops,"
        c = Count()
        gk.guidance_fused_plain = kernel_as_one(c)
        try:
            with torch.no_grad(), c:
                eval_openloop._sample_and_score(
                    net, batch, bcfg, form, coeffs,
                    generator=torch.Generator().manual_seed(0))
            timed = c.n
            if name != "bc":
                def run(steps):
                    return lambda: sim.run_closed_loop_host(
                        0, scenes, bcfg.with_(n_neighbors=8), net, coeffs,
                        steps, record=True)
                c.n = 0
                with c:
                    run(1)()
                one = c.n
                c.n = 0
                with c:
                    run(2)()
                msg += f" closed-loop step {c.n - one} ops,"
        finally:
            gk.guidance_fused_plain = real
        print(f"{msg} eval timed region {timed} ops")


if __name__ == "__main__":
    main()
