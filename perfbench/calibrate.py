"""Readings that the limits of a cell's check are set from: the check's
numbers for the program on several seeds, for the control (the reference
computed in float8 e4m3 where the configuration states bfloat16, put in
the program's place) and for planted faults, each run for just the steps
its check compares.  The benchmark's own runs do not run this.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3
        [--as program|control|unchanged|altered|wrong_choice|one_scene]

Prints one JSON line a seed: the cell, the seed, what ran and the check's
numbers.  Needs a CUDA device (``--device cpu`` for a rehearsal at the
cell's sizes, which is slow).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402
from perfbench.drivers import program, reference  # noqa: E402

FP8 = "float8_e4m3"


def control():
    """The reference in the program's place, its matmuls in float8 e4m3."""
    R = reference()
    base = R.Config
    return SimpleNamespace(**dict(vars(R), name="control",
                                  Config=lambda **kw: base(
                                      **dict(kw, compute_dtype=FP8))))


@contextlib.contextmanager
def fault(kind: str):
    """The program with a fault planted underneath the timed path:
    ``unchanged``, a step that returns its carry unchanged; ``altered``, the closed loop's chosen first control altered where the
    planner produces it; ``wrong_choice``, the closed loop's planner
    executing the lane-keep row three seeds after the one it chose;
    ``one_scene``, the closed loop's last scene planned on the first
    scene's lanes (a fault confined to one scene: a wrong slot)."""
    import torch
    from pstl_tpu_torch import sim
    saved = []

    def patch(mod, name, new):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, new)

    if kind == "unchanged":
        real_make = sim.make_closed_loop_step

        def make_step(*a, **kw):
            init, step = real_make(*a, **kw)

            def frozen(c, noise=None):
                _, info = step(c, noise)
                return c, info
            return init, frozen
        patch(sim, "make_closed_loop_step", make_step)
    elif kind == "altered":
        real_plan = sim.make_planner

        def make_planner(*a, **kw):
            plan = real_plan(*a, **kw)

            def altered(obs, **kw2):
                u0, info = plan(obs, **kw2)
                return u0 + torch.tensor([0.05, 0.5], device=u0.device), info
            return altered
        patch(sim, "make_planner", make_planner)
    elif kind == "wrong_choice":
        real_plan = sim.make_planner

        def make_planner(*a, **kw):
            plan = real_plan(*a, **kw)

            def wrong(obs, **kw2):
                _, info = plan(obs, **kw2)
                bs = info["plan_traj"].shape[0]
                tr = info["trajs"].reshape(bs, -1, *info["trajs"].shape[1:])
                ch = (tr - info["plan_traj"][:, None]).abs().amax(
                    dim=(2, 3)).argmin(1)
                ch = (ch + 9) % tr.shape[1]
                rows = torch.arange(bs, device=ch.device)
                u = info["controls"].reshape(bs, tr.shape[1], -1, 2)
                info = dict(info, plan_traj=tr[rows, ch])
                return u[rows, ch, 0], info
            return wrong
        patch(sim, "make_planner", make_planner)
    elif kind == "one_scene":
        real_scenes = sim.scenes_from_dataset

        def scenes(data, device=None):
            sc = real_scenes(data, device=device)
            wrong = {}
            for key in ("center_dense", "lane_valids", "lanes_t",
                        "lane_valids_t"):
                v = getattr(sc, key)
                if v is not None:
                    v = v.clone()
                    v[-1] = v[0]
                    wrong[key] = v
            return sc._replace(**wrong)
        patch(sim, "scenes_from_dataset", scenes)
    elif kind != "program":
        raise ValueError(f"unknown fault {kind!r}")
    try:
        yield
    finally:
        for mod, name, old in reversed(saved):
            setattr(mod, name, old)


def readings(name: str, seed: int, what: str = "program", device=None,
             overrides=None, root: str = harness.ROOT) -> dict:
    """The check's numbers of one seed: set-up, the steps the check
    compares, release, check."""
    import torch
    cell = harness.load_cell(name, root)
    if overrides:
        for key, val in overrides.items():
            cell.traffic[key] = dict(cell.traffic.get(key, {}), **val)
    dev = torch.device(device or "cuda:0")
    impl = control() if what == "control" else program()
    with fault(what if what not in ("control",) else "program"):
        drv = harness.load_driver(cell).Driver(
            cell, harness.config_fields(cell), dev, int(seed), impl=impl)
        drv.setup()
        need = int(cell.traffic["check"]["steps"])
        drv._run(lambda n, el: n >= need)
        drv.release()
        checks = drv.check()
    return {"workload": name, "seed": int(seed), "as": what,
            "correct": all(c["ok"] for c in checks),
            "checks": {c["name"]: c["value"] for c in checks}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--as", dest="what", default="program",
                    choices=("program", "control", "unchanged",
                             "altered", "wrong_choice", "one_scene"))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    for s in args.seeds:
        print(json.dumps(readings(args.workload, s, args.what, args.device)),
              flush=True)


if __name__ == "__main__":
    main()
