"""Profile closed-loop replanning steps of the torch port on one GPU.

Runs the heavy ``bench.py`` contract (e7_round5 weights, synthetic scenes
from seed 0) with the guidance route that ``--gpallas`` picks, as
``BENCH_GPALLAS`` does (2: the fused guidance kernel, the default; 3: the
fold2 configuration; 4: the superstep kernel; 1 / 1f: the frozen-payload
kernel; 2f: the folded fused kernel; 0: the XLA guidance loop), for
``--warmup`` untimed steps, then ``--steps`` steps untraced and as many
again under ``torch.profiler``, and writes to ``--out``: the untraced step
times, the traced window's device busy time by kernel name, and the device
busy share of the window (sum of kernel times over the window's wall time;
one stream, so kernels do not overlap).

    python scripts/profile_torch_step.py [--gpallas 0|1|1f|2f|2|3|4]
        [--scenes 16] [--steps 3] [--out build/profile_step.json]
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from pstl_tpu_torch.config import GPALLAS  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gpallas", choices=GPALLAS, default="2")
    ap.add_argument("--scenes", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "profile_step.json"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pstl_tpu_torch import diffusion, sim
    from pstl_tpu_torch.config import bench_config
    from pstl_tpu_torch.data import synthetic
    from pstl_tpu_torch.models import convert
    from pstl_tpu_torch.models.net import Net

    if not torch.cuda.is_available():
        sys.exit("profile_torch_step.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = bench_config("heavy", gpallas=args.gpallas)
    data = synthetic.generate_dataset(0, args.scenes, cfg, scene_len=38)
    scenes = sim.scenes_from_dataset(data, device=dev)
    net = Net(cfg)
    convert.load_weights(net, "e7_round5")
    init_carry, step = sim.make_closed_loop_step(
        scenes, cfg, net.to(dev).eval(), diffusion.get_coeffs(cfg, dev))
    c = init_carry(0)
    for _ in range(args.warmup):
        c = step(c)
    torch.cuda.synchronize()

    step_ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        c = step(c)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            c = step(c)
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
    out = {"device": torch.cuda.get_device_name(0), "scenes": args.scenes,
           "gpallas": args.gpallas,
           "device_launches_per_step": launches / args.steps,
           "steps": args.steps, "untraced_step_ms": step_ms,
           "traced_window_ms": window_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / window_ms, "kernels": rows}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"BENCH_GPALLAS={args.gpallas}: untraced step ms: "
          f"{[round(s, 3) for s in step_ms]}")
    print(f"traced window {window_ms:.3f} ms for {args.steps} steps, device "
          f"busy {busy_ms:.3f} ms ({busy_ms / window_ms:.3f} of the window), "
          f"{launches / args.steps:.0f} device launches per step")
    for r in rows[:15]:
        print(f"  {r['device_ms']:10.3f} ms  {r['calls']:6d}  "
              f"{r['name'][:90]}")


if __name__ == "__main__":
    main()
