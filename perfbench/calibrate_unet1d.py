"""Readings that the limits of ``ctg-unet1d-cl16``'s check are set from:
``calibrate.py``'s program and control (the plain U-Net and the frozen
reference in the program's place, float8 e4m3 operands), and a fault
planted in the program's U-Net, each run for just the steps the check
compares.  The benchmark's own runs do not run this.

    python3 perfbench/calibrate_unet1d.py --workload ctg-unet1d-cl16
        --seeds 1 2 3 [--as program|control|drop_skip]

``drop_skip``: the deepest skip connection dropped (the up path's first
residual block reads zeros in its place: the skip half of its first
convolution's and its residual convolution's input channels zeroed after
the draw).  Prints one JSON line a seed, as ``calibrate.py`` does, with
``rows_off_at``: the share of the compared rows whose score is more than
each of :data:`TOLS` off the reference's, which a ``score_tol`` would
give.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import calibrate  # noqa: E402

KINDS = ("program", "control", "drop_skip")
#: score tolerances ``rows_off_at`` reads at
TOLS = (0.01, 0.03, 0.1, 0.3, 1.0)


@contextlib.contextmanager
def fault(kind: str):
    """The program with ``kind`` planted (``program``: none)."""
    import torch
    from pstl_tpu_torch.models import net as program_net
    if kind == "program":
        yield
        return
    if kind != "drop_skip":
        raise ValueError(f"unknown fault {kind!r}")
    real = program_net.init_seeded

    def init_seeded(net, generator):
        real(net, generator)
        res = net.eps_net.up_modules[0][0]
        with torch.no_grad():
            for conv in (res.blocks[0].block[0], res.residual_conv):
                conv.weight[:, conv.weight.shape[1] // 2:] = 0.0
    program_net.init_seeded = init_seeded
    try:
        yield
    finally:
        program_net.init_seeded = real


def readings(name: str, seed: int, what: str = "program", device=None,
             overrides=None) -> dict:
    """``calibrate.readings`` with ``what`` planted, and ``rows_off_at``
    from the reference's scores of the steps the check replans."""
    import torch
    from perfbench import harness
    from perfbench.reference.port import sim as rsim
    cell = harness.load_cell(name)
    for key, val in (overrides or {}).items():
        cell.traffic[key] = dict(cell.traffic.get(key, {}), **val)
    dev = torch.device(device or "cuda:0")
    impl = calibrate.control() if what == "control" else None
    with fault("program" if what == "control" else what):
        drv = harness.load_driver(cell).Driver(
            cell, harness.config_fields(cell), dev, int(seed), impl=impl)
        drv.setup()
        drv._run(lambda n, el: n >= int(cell.traffic["check"]["steps"]))
        drv.release()
        ref_scores = []
        real = rsim.make_closed_loop_step

        def make_step(*a, **kw):
            init, step = real(*a, **kw)

            def kept(c, noise=None):
                new, info = step(c, noise)
                ref_scores.append(info["scores"])
                return new, info
            return init, kept
        rsim.make_closed_loop_step = make_step
        try:
            checks = drv.check()
        finally:
            rsim.make_closed_loop_step = real
    return {"workload": name, "seed": int(seed), "as": what,
            "correct": all(c["ok"] for c in checks),
            "checks": {c["name"]: c["value"] for c in checks},
            "rows_off_at": rows_off_at(drv, ref_scores)}


def rows_off_at(drv, ref_scores) -> dict:
    """The share of the active rows of the checked steps whose score lies
    more than each of :data:`TOLS` from the reference's (``ref_scores``:
    the reference's, in the order the check replans its picks)."""
    gaps, acts = [], []
    for i, s_r in zip(drv.picks(), ref_scores):
        r = drv.records[i]
        gaps.append((r.scores - s_r).abs().reshape(drv.bs, -1))
        acts.append(~r.carry[2])
    n = sum(int(a.sum()) * g.shape[1] for g, a in zip(gaps, acts))
    return {str(t): sum(int(((g > t) & a[:, None]).sum())
                        for g, a in zip(gaps, acts)) / max(n, 1)
            for t in TOLS}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--as", dest="what", default="program", choices=KINDS)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    for s in args.seeds:
        print(json.dumps(readings(args.workload, s, args.what, args.device)),
              flush=True)


if __name__ == "__main__":
    main()
