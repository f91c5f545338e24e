#!/usr/bin/env python3
"""How far one train step moves when every nonzero weight moves by one
ulp: the scale below which a card-vs-CPU difference of the step is
rounding, not a fault.  Runs on the CPU.

    python scripts/ulp_sensitivity.py [--preset e5_ddpm] [--scenes 8]
        [--set grad_rollout=true stl_weight=1.0]

The step is ``chip_smoke.py``'s phase 16 step (fp32, the synthetic scenes
of seed 5 with the GT controls in seed 0, a flax-like net from seed 2, the
draws of seed 6); the weights are moved by ``torch.nextafter`` towards
+inf (zeros stay: a zero bias moved off zero opens ReLU gates that no
rounding opens).  Prints the largest relative change of a metric and the
largest change of a gradient over its tensor's largest entry
(``chip_smoke.grad_err``), the five worst tensors, and the step's wall.
"""

import argparse
import copy
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="e5_ddpm")
    ap.add_argument("--scenes", type=int, default=8)
    ap.add_argument("--set", nargs="*", default=[],
                    metavar="KEY=VALUE")
    args = ap.parse_args()
    import chip_smoke as cs
    from pstl_tpu_torch.cli import _parse_value
    from pstl_tpu_torch.data.dataset import SceneDataset

    kw = {k: _parse_value(None, v) for k, v in
          (kv.split("=", 1) for kv in args.set)}
    cfg = cs.dense_config(args.preset, compute_dtype="float32",
                          batch_size=args.scenes, **kw)
    ds = SceneDataset.from_synthetic(cfg, seed=5, n_scenes=cfg.batch_size)
    ds.ensure_random_params(cfg.seed)
    batch = cs.with_gt_seed(ds.gather(np.arange(cfg.batch_size)), cfg)
    net = cs.dense_net(cfg, "cpu", seed=2, warm=cfg.rect_head)
    draws = cs.dense_draws(cfg, cfg.batch_size, seed=6)
    t0 = time.time()
    m0, g0 = cs.dense_step(cfg, net, batch, draws, "cpu")
    wall = time.time() - t0
    moved = copy.deepcopy(net)
    with torch.no_grad():
        for p in moved.parameters():
            p.copy_(torch.where(p != 0, torch.nextafter(
                p, torch.full_like(p, np.inf)), p))
    m1, g1 = cs.dense_step(cfg, moved, batch, draws, "cpu")
    m_err = max(abs(m1[k] - m0[k]) / (abs(m0[k]) + 1e-6) for k in m0)
    worst = sorted((float((g1[k] - g0[k]).abs().max())
                    / max(float(g0[k].abs().max()), 1e-30), k) for k in g0)
    print(f"{args.preset} {kw} ({cfg.batch_size} scenes x "
          f"{cfg.n_randoms * 3} rows, fp32, CPU): one-ulp weights move the "
          f"metrics by {m_err:.3e} (relative) and the gradients by "
          f"{cs.grad_err(g1, g0):.3e} of their tensors' largest entries; "
          f"worst " + ", ".join(f"{k} {e:.2e}" for e, k in worst[-5:])
          + f"; a step {wall:.1f} s")


if __name__ == "__main__":
    main()
