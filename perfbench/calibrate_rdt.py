"""Readings that the limits of ``ctg-rdt1b-cl1``'s check are set from:
``calibrate.py``'s program and control (the plain RDT and the frozen
reference in the program's place, float8 e4m3 operands), and faults
planted in the program's RDT, each run for just the steps the check
compares.  The benchmark's own runs do not run this.

    python3 perfbench/calibrate_rdt.py --workload ctg-rdt1b-cl1
        --seeds 1 2 3 [--as program|control|no_qk_norm|swap_streams]
        [--paired 51]

``no_qk_norm``: QK-norm left out (q and k reach the softmax as their
linear layers give them); ``swap_streams``: the two condition streams
swapped (the image stream on even blocks, the language stream on odd).
Prints one JSON line a seed, as ``calibrate_unet1d.py`` does (its
``readings``, with these faults), ``rows_off_at`` included, at
:data:`TOLS`.  ``--paired SECONDS`` reads instead the program, the control
and both faults at the check points of a full run of that window
(:func:`paired`).
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

from perfbench import calibrate_unet1d  # noqa: E402

KINDS = ("program", "control", "no_qk_norm", "swap_streams")
#: score tolerances ``rows_off_at`` reads at: the scores of a 1.2 B-parameter
#: eps network's plans part wider than the U-Net's
TOLS = (0.1, 0.3, 1.0, 3.0, 10.0, 30.0)


@contextlib.contextmanager
def fault(kind: str):
    """The program with ``kind`` planted (``program``: none)."""
    from pstl_tpu_torch.models import rdt
    if kind == "program":
        yield
        return
    if kind == "no_qk_norm":
        name, new = "head_norm", lambda x, m, w: x
    elif kind == "swap_streams":
        name, new = "STREAMS", tuple(reversed(rdt.STREAMS))
    else:
        raise ValueError(f"unknown fault {kind!r}")
    real = getattr(rdt, name)
    setattr(rdt, name, new)
    try:
        yield
    finally:
        setattr(rdt, name, real)


def readings(name: str, seed: int, what: str = "program", device=None,
             overrides=None) -> dict:
    """``calibrate_unet1d.readings`` with this file's faults and
    :data:`TOLS`."""
    real = calibrate_unet1d.fault, calibrate_unet1d.TOLS
    calibrate_unet1d.fault, calibrate_unet1d.TOLS = fault, TOLS
    try:
        return calibrate_unet1d.readings(name, seed, what, device, overrides)
    finally:
        calibrate_unet1d.fault, calibrate_unet1d.TOLS = real


def _rows_off_at(drv, ref_scores) -> dict:
    """``calibrate_unet1d.rows_off_at`` at :data:`TOLS`."""
    real = calibrate_unet1d.TOLS
    calibrate_unet1d.TOLS = TOLS
    try:
        return calibrate_unet1d.rows_off_at(drv, ref_scores)
    finally:
        calibrate_unet1d.TOLS = real


def paired(name: str, seed: int, seconds: float, device=None,
           overrides=None, kinds=KINDS[1:]) -> dict:
    """The check's readings at the check points of a full run, for the
    program and for each of ``kinds`` (the control and the faults) beside
    it: the program runs the window for ``seconds``, as the benchmark's run
    does, so the check compares the steps a run of ``seed`` compares.
    Each kind replans those steps from the program's own carry with the
    same draws (the control: the frozen reference planner in float8 e4m3;
    a fault: the program's step with it planted) and its scores meet the
    reference's as the program's do; its eps function of the probed step
    is read on the program's tapped states, against the same float32 eps
    function, so that every kind's ``eps_rms_err`` is taken on the very
    states the program's is (``eps_rel_err``, that difference over eps's
    norm, beside it: it does not decide).  One JSON-able dict: the program's checks and
    ``rows_off_at``, and per kind its checks and whether it passes."""
    import torch
    from perfbench import calibrate, harness
    from perfbench.drivers import closed_loop
    from perfbench.drivers import closed_loop_rdt as with_rdt
    from perfbench.drivers import closed_loop_unet1d as taps
    from perfbench.reference import rdt as ref_rdt
    from perfbench.reference.port import sim as rsim
    cell = harness.load_cell(name)
    for key, val in (overrides or {}).items():
        cell.traffic[key] = dict(cell.traffic.get(key, {}), **val)
    dev = torch.device(device or "cuda:0")
    chk = cell.traffic["check"]
    drv = harness.load_driver(cell).Driver(
        cell, harness.config_fields(cell), dev, int(seed))
    drv.setup()
    drv._run(lambda n, el: el >= seconds)
    picks = drv.picks()
    got = {}

    def replans(P, steps, kind, key=None):
        """``P``'s replans of the picks (scores) and its eps function of
        the first, made by ``P.sim.models.make_cm_eps_fn``."""
        models = P.sim.models
        real, fns, scores = models.make_cm_eps_fn, [], []

        def spy(*a, **kw):
            fns.append(real(*a, **kw))
            return fns[-1] if key is None else taps.tapped(fns[-1], (), {},
                                                           key)
        models.make_cm_eps_fn = spy
        try:
            with fault(kind if P.name == "program" else "program"):
                for i in picks:
                    r = drv.records[i]
                    c = P.sim.Carry(*r.carry[:-1],
                                    generator=torch.Generator(device=dev))
                    scores.append(steps(r.scene_set)(c, drv._noise(r.k))[1]
                                  ["scores"])
        finally:
            models.make_cm_eps_fn = real
        got[kind] = (scores, fns[0] if fns else None)

    for kind in kinds:
        if kind != "control":
            # a key of its own: the fault's chain is captured with it
            replans(drv.impl, lambda s: drv.sets[s][1], kind,
                    taps._TapKey())
    if "control" in kinds:
        C = with_rdt.with_rdt(calibrate.control(), drv.spec,
                              drv.weights_seed)
        ccfg = C.Config(**drv.fields)
        cnet = C.Net(ccfg)
        C.convert.load_weights(cnet, drv.weights)
        cnet = cnet.to(dev).eval()
        coeffs = C.diffusion.get_coeffs(ccfg, dev)
        csteps = {}

        def cstep(s):
            if s not in csteps:
                scenes = C.sim.scenes_from_dataset(drv.data[s], device=dev)
                csteps[s] = C.sim.make_closed_loop_step(
                    scenes, ccfg, cnet, coeffs, with_info=True)[1]
            return csteps[s]
        replans(C, cstep, "control")
        del cnet, csteps
    drv.release()
    ref_scores, ref_fns = [], []
    real_step, real_make = rsim.make_closed_loop_step, ref_rdt.make_cm_eps_fn

    def make_step(*a, **kw):
        init, step = real_step(*a, **kw)

        def kept(c, noise=None):
            new, info = step(c, noise)
            ref_scores.append(info["scores"])
            return new, info
        return init, kept

    def make_eps(*a, **kw):
        ref_fns.append(real_make(*a, **kw))
        return ref_fns[-1]
    rsim.make_closed_loop_step, ref_rdt.make_cm_eps_fn = make_step, make_eps
    try:
        checks = drv.check()
    finally:
        rsim.make_closed_loop_step, ref_rdt.make_cm_eps_fn = real_step, \
            real_make
    out = {"workload": name, "seed": int(seed), "seconds": seconds,
           "steps": len(drv.records), "picks": picks,
           "program": {"correct": all(c["ok"] for c in checks),
                       "checks": {c["name"]: c["value"] for c in checks},
                       "rows_off_at": _rows_off_at(drv, ref_scores)}}
    lim = chk["limits"]
    p = drv.probe
    if p is not None and p["same"] and ref_fns:
        with torch.no_grad():
            out["program"]["eps_rel_err"] = max(
                float((e.float() - e_ref).norm() / e_ref.norm())
                for e, e_ref in ((e, ref_fns[0](x.float(), t))
                                 for t, (x, e) in p["taps"].items()))
    for kind, (scores, fn) in got.items():
        off = n_rows = 0
        gap = 0.0
        for i, s_k, s_r in zip(picks, scores, ref_scores):
            act = ~drv.records[i].carry[2]
            g = (s_k - s_r).abs().reshape(drv.bs, -1)
            off += int(((g > chk["score_tol"]) & act[:, None]).sum())
            n_rows += int(act.sum()) * g.shape[1]
            gap = max(gap, float(g[act].median(1).values.max()))
        eps = rel = float("inf")
        if p is not None and fn is not None and ref_fns:
            eps = rel = 0.0
            with torch.no_grad(), fault("program" if kind == "control"
                                        else kind):
                for t, (x, _) in p["taps"].items():
                    e_ref = ref_fns[0](x.float(), t)
                    e = fn(x, t)
                    eps = max(eps, with_rdt.eps_rms(e, e_ref))
                    rel = max(rel, float((e.float() - e_ref).norm()
                                         / e_ref.norm()))
        vals = {"rows_off_share": off / max(n_rows, 1),
                "scene_median_gap": gap, "eps_rms_err": eps}
        out[kind] = {"correct": all(v <= lim[k] for k, v in vals.items()),
                     "checks": vals, "eps_rel_err": rel}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--as", dest="what", default="program", choices=KINDS)
    ap.add_argument("--paired", type=float, default=None, metavar="SECONDS",
                    help="run the program's window for SECONDS and read "
                    "the control and the faults at its check points")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    for s in args.seeds:
        got = (paired(args.workload, s, args.paired, args.device)
               if args.paired is not None
               else readings(args.workload, s, args.what, args.device))
        print(json.dumps(got), flush=True)


if __name__ == "__main__":
    main()
