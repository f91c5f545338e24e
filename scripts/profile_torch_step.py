"""Profile closed-loop replanning steps, or mono train steps, of the torch
port on one GPU.

Without ``--train``: the heavy ``bench.py`` contract (e7_round5 weights,
synthetic scenes from seed 0) with the guidance route that ``--gpallas``
picks, as ``BENCH_GPALLAS`` does (2: the fused guidance kernel, the default;
3: the fold2 configuration; 4: the superstep kernel; 1 / 1f: the
frozen-payload kernel; 2f: the folded fused kernel; 0: the XLA guidance
loop).  With ``--train e2`` or ``--train e4``: train steps of
``mono_config("e2_vae_mono")`` / ``("e4_ddpm_mono")`` at full width (128
scenes x 64 rows a batch, random initialization from seed 1, synthetic scenes
from seed 0), each on the next train batch; with ``--train e5`` or ``--train
e7``: dense train steps of ``e5_ddpm`` / ``e7_ours`` (128 scenes x 64 x 3 =
24,576 rows; e7 warm-started from the committed e5b_round5 base, its
RefineNet head from seed 1); with ``--train e3``, ``e6`` or ``bc``: the
baselines' dense train steps at that width (``e3_vae``, ``e6_trafficsim``,
and BC: ``e3_vae`` with the BC head and no init hint, as the JAX package
has no BC preset), from seed 1.  Either way ``--warmup`` untimed
steps, then ``--steps`` steps untraced and as many again under
``torch.profiler``; written to ``--out``: the untraced step times, the traced
window's device busy time by kernel name, the device busy share of the
window (sum of kernel times over the window's wall time; one stream, so
kernels do not overlap), the device ms a step by kernel family
(``FAMILIES``, by name) and, for a train step, the device time in the
clearance kernels and in everything else.  ``--repo`` profiles another
checkout's package with this script (parent against change: unpack the
parent under ``build/``).

    python scripts/profile_torch_step.py [--gpallas 0|1|1f|2f|2|3|4]
        [--train e2|e4|e5|e7|e3|e6|bc] [--scenes 16] [--steps 3] [--repo DIR]
        [--out build/profile_step.json]
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: --train: (preset, overrides)
TRAIN_PRESETS = {"e2": ("e2_vae_mono", {}), "e4": ("e4_ddpm_mono", {}),
                 "e5": ("e5_ddpm", {}), "e7": ("e7_ours", {}),
                 "e3": ("e3_vae", {}), "e6": ("e6_trafficsim", {}),
                 "bc": ("e3_vae", {"vae": False, "bc": True,
                                   "use_init_hint": False})}


#: kernel families by name: the first family whose fragment the kernel's
#: name holds (lower case), else "other"
FAMILIES = (("port kernels", ("guidance_fused_kernel",
                              "guidance_frozen_kernel", "superstep_",
                              "min_clearance_")),
            ("gemm", ("gemm", "xmma", "cutlass", "cublas")),
            ("scan", ("scan",)),
            ("reduction", ("reduce",)),
            ("copy / cat", ("copy", "cat", "gather", "scatter", "index")),
            ("elementwise", ("elementwise",)))


def family(name):
    name = name.lower()
    for fam, frags in FAMILIES:
        if any(f in name for f in frags):
            return fam
    return "other"


def closed_loop_step(args, dev):
    """step() -> one closed-loop replanning step of the heavy contract."""
    from pstl_tpu_torch import diffusion, sim
    from pstl_tpu_torch.config import GPALLAS, bench_config
    from pstl_tpu_torch.data import synthetic
    from pstl_tpu_torch.models import convert
    from pstl_tpu_torch.models.net import Net

    if args.gpallas not in GPALLAS:
        sys.exit(f"--gpallas must be one of {GPALLAS}")
    cfg = bench_config("heavy", gpallas=args.gpallas)
    data = synthetic.generate_dataset(0, args.scenes, cfg, scene_len=38)
    scenes = sim.scenes_from_dataset(data, device=dev)
    net = Net(cfg)
    convert.load_weights(net, "e7_round5")
    init_carry, step = sim.make_closed_loop_step(
        scenes, cfg, net.to(dev).eval(), diffusion.get_coeffs(cfg, dev))
    carry = [init_carry(0)]

    def one():
        carry[0] = step(carry[0])

    return one


def train_step(args, dev):
    """step() -> one train step on the next train batch."""
    import torch
    from pstl_tpu_torch import diffusion, specs, train
    from pstl_tpu_torch.config import PRESETS, mono_config
    from pstl_tpu_torch.data.dataset import SceneDataset, batch_iterator
    from pstl_tpu_torch.models import convert
    from pstl_tpu_torch.models.net import Net, init_flax_like

    preset, kw = TRAIN_PRESETS[args.train]
    cfg = (mono_config(preset) if PRESETS[preset].gt_data_training
           else PRESETS[preset].with_(exp_name=None, **kw))
    n_steps = args.warmup + 2 * args.steps
    ds = SceneDataset.from_synthetic(
        cfg, seed=0,
        n_scenes=int(n_steps * cfg.batch_size / cfg.train_ratio) + 1)
    ds.ensure_random_params(cfg.seed)
    net = Net(cfg)
    init_flax_like(net, torch.Generator().manual_seed(1))
    if cfg.rect_head:
        train.load_params_only(
            os.path.join(convert.WEIGHTS_DIR, "e5b_round5.npz"),
            train.TrainState(net, None, 0))
    net = net.to(dev)
    step = train.make_train_step(cfg, net, specs.build_scorer(cfg),
                                 diffusion.get_coeffs(cfg, device=dev),
                                 train.make_optimizer(cfg, net))
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    batches = batch_iterator(ds, "train", cfg.batch_size, shuffle=False)

    def one():
        step(train.to_device(next(batches), dev), generator=gen)

    return one


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gpallas", default="2")
    ap.add_argument("--train", choices=sorted(TRAIN_PRESETS))
    ap.add_argument("--scenes", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "profile_step.json"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("profile_torch_step.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    step = train_step(args, dev) if args.train else closed_loop_step(args,
                                                                    dev)
    what = (f"{args.train} ({TRAIN_PRESETS[args.train][0]}) train step"
            if args.train
            else f"BENCH_GPALLAS={args.gpallas}")
    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()

    step_ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue            # host-side ops; their kernels are listed
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        rows.append({"name": e.key, "calls": e.count,
                     "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    launches = sum(r["calls"] for r in rows)
    out = {"device": torch.cuda.get_device_name(0), "what": what,
           "repo": os.path.abspath(args.repo),
           "device_launches_per_step": launches / args.steps,
           "steps": args.steps, "untraced_step_ms": step_ms,
           "traced_window_ms": window_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / window_ms, "kernels": rows}
    fams = {}
    for r in rows:
        fam = family(r["name"])
        fams[fam] = fams.get(fam, 0.0) + r["device_ms"] / args.steps
    out["family_ms_per_step"] = fams
    if args.train:
        clear = [r for r in rows if "min_clearance" in r["name"]]
        out["clearance_ms_per_step"] = {
            r["name"]: r["device_ms"] / args.steps for r in clear}
        out["other_device_ms_per_step"] = (
            busy_ms - sum(r["device_ms"] for r in clear)) / args.steps
    else:
        out.update(scenes=args.scenes, gpallas=args.gpallas)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"{what} ({out['repo']}): untraced step ms: "
          f"{[round(s, 3) for s in step_ms]}")
    print(f"traced window {window_ms:.3f} ms for {args.steps} steps, device "
          f"busy {busy_ms:.3f} ms ({busy_ms / window_ms:.3f} of the window), "
          f"{launches / args.steps:.0f} device launches per step")
    if args.train:
        print("device ms per step: clearance kernels "
              + ", ".join(f"{v:.4f}" for v in
                          out["clearance_ms_per_step"].values())
              + f"; everything else {out['other_device_ms_per_step']:.3f}")
    for r in rows[:15]:
        print(f"  {r['device_ms']:10.3f} ms  {r['calls']:6d}  "
              f"{r['name'][:90]}")


if __name__ == "__main__":
    main()
