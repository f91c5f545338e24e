"""The program's spans in a traced window: every device operation, idle
interval and host sync put down to the layer of the program whose host
code issued it or was running.

The port opens named ``record_function`` spans at its layer boundaries
while a profiler runs (``pstl_tpu_torch/utils/trace.py``).  In the chrome
trace they are ``user_annotation`` events on the host thread's clock, the
clock the device events are aligned to.  :func:`attribute` then puts

- each device operation (kernel, copy, set) down to the innermost span
  open at the host call that launched it (the ``cuda_runtime`` or
  ``cuda_driver`` event of the same ``args.correlation``);
- each idle interval of the window (no device operation running) down to
  the innermost span of the window's thread over each part of it, the
  interval cut at span boundaries, so that the parts add up exactly;
- each synchronizing runtime call made inside a ``sim.step`` span (the
  driver's own end-of-step sync lies outside it) down to its innermost
  span.

:func:`layer_metrics` folds the spans into the layers of ``LAYER_OF``,
this file's own table (it does not import the program's: a program change
cannot move a metric without an edit here).  The sums close: the layers'
operations plus those outside every span are every device operation of
the trace, and the layers' idle time plus the idle time outside every
span is the window's.

    python3 perfbench/spans.py --workload <cell> --seed <n>

runs a cell's set-up, its untraced steps and its traced window as
``run.py --trace 1`` does, and prints one JSON line: the per-layer
figures, ``launches_per_step.plan`` and ``device_idle_share.plan`` read
from the same trace, and the two sums.  It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import shutil
import sys
import tempfile
from types import SimpleNamespace
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402
from perfbench.metrics import _common  # noqa: E402

#: span -> layer, by innermost span
LAYER_OF = {
    "sim.step": "prep", "sim.observe": "prep", "sim.plan": "prep",
    "plan.prep": "prep",
    "plan.sample": "sample",
    "plan.guidance": "guidance",
    "plan.score": "score",
    "plan.select": "select",
    "sim.env": "env",
}
LAYERS = ("prep", "sample", "guidance", "score", "select", "env")
STEP_SPAN = "sim.step"
#: host calls that launch device work, and carry its correlation id
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: calls that wait for the device (a ``cudaMemcpy`` / ``cuMemcpy`` that is
#: not ``...Async`` blocks too)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize")


def is_sync(name: str) -> bool:
    if name in SYNC_CALLS:
        return True
    return name.startswith(("cudaMemcpy", "cuMemcpy")) \
        and "Async" not in name


def _thread(e) -> tuple:
    return (e.get("pid"), e.get("tid"))


class _Pieces:
    """A thread's timeline cut at its spans' boundaries, each piece named
    by its innermost span (None between top-level spans)."""

    def __init__(self, spans):
        pts = sorted({p for a, b, _ in spans for p in (a, b)})
        spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts, self.ends, self.names = [], [], []
        open_, i = [], 0
        for t0, t1 in zip(pts, pts[1:]):
            while i < len(spans) and spans[i][0] <= t0:
                open_.append(spans[i])
                i += 1
            open_ = [s for s in open_ if s[1] > t0]
            # the innermost: the latest start, then the shortest
            inner = max(open_, key=lambda s: (s[0], -s[1]), default=None)
            self.starts.append(t0)
            self.ends.append(t1)
            self.names.append(inner[2] if inner else None)

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0 or t >= self.ends[i]:
            return None
        return self.names[i]

    def over(self, a: float, b: float) -> Dict[Optional[str], float]:
        """The parts of [a, b) under each innermost span (None: outside
        every span); they add up to b - a."""
        out: Dict[Optional[str], float] = {}
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        covered = 0.0
        while i < len(self.starts) and self.starts[i] < b:
            lo, hi = max(a, self.starts[i]), min(b, self.ends[i])
            if hi > lo:
                out[self.names[i]] = out.get(self.names[i], 0.0) + hi - lo
                covered += hi - lo
            i += 1
        if b - a - covered > 0:
            out[None] = out.get(None, 0.0) + (b - a - covered)
        return out


def attribute(trace: dict) -> SimpleNamespace:
    """Device operations, idle time (us) and host syncs of the trace, by
    innermost program span (None: outside every span).  ``unmatched``:
    device operations whose correlation matched no launch call (counted
    outside every span too); ``n_spans``: the program's span events."""
    events = trace.get("traceEvents", [])
    mark = next(e for e in events if e.get("name") == harness.WINDOW_MARK
                and e.get("ph") == "X"
                and e.get("cat") != "gpu_user_annotation")
    w0 = float(mark["ts"])
    w1 = w0 + float(mark["dur"])
    by_thread: Dict[tuple, list] = {}
    n_spans = 0
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X" \
                and e.get("name") != harness.WINDOW_MARK:
            a = float(e["ts"])
            by_thread.setdefault(_thread(e), []).append(
                (a, a + float(e.get("dur", 0.0)), e["name"]))
            n_spans += 1
    pieces = {k: _Pieces(v) for k, v in by_thread.items()}
    main = pieces.get(_thread(mark), _Pieces([]))
    steps = {k: _Pieces([s for s in v if s[2] == STEP_SPAN])
             for k, v in by_thread.items()}

    launch: Dict[int, tuple] = {}
    syncs: Dict[Optional[str], int] = {}
    for e in events:
        if e.get("cat") not in LAUNCH_CATS or e.get("ph") != "X":
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            launch[corr] = (_thread(e), float(e["ts"]))
        if is_sync(e["name"]):
            th, t = _thread(e), float(e["ts"])
            if th in steps and steps[th].at(t) is not None:
                name = pieces[th].at(t)
                syncs[name] = syncs.get(name, 0) + 1

    ops: Dict[Optional[str], int] = {}
    unmatched = 0
    dev = []
    for e in events:
        if e.get("cat") not in harness.DEVICE_CATS or e.get("ph") != "X":
            continue
        ts = float(e["ts"])
        dev.append((ts, ts + float(e.get("dur", 0.0))))
        hit = launch.get((e.get("args") or {}).get("correlation"))
        if hit is None:
            unmatched += 1
            name = None
        else:
            name = pieces.get(hit[0], main).at(hit[1])
        ops[name] = ops.get(name, 0) + 1

    idle: Dict[Optional[str], float] = {}
    edge = w0
    for a, b in harness.merge(dev) + [[w1, w1]]:
        if a > edge:
            for name, us in main.over(edge, min(a, w1)).items():
                idle[name] = idle.get(name, 0.0) + us
        edge = max(edge, b)
    return SimpleNamespace(ops=ops, idle_us=idle, syncs=syncs,
                           unmatched=unmatched, n_ops=len(dev),
                           n_spans=n_spans, window_us=w1 - w0)


def layer_metrics(att: SimpleNamespace, steps: int) -> Dict[str, float]:
    """The per-layer figures: ``launches_per_step.<layer>``,
    ``device_idle_share.<layer>`` (% of the traced window) and
    ``host_syncs_per_step.plan``; empty when the trace holds no device
    operation (the CPU) or no span of the program (a program without
    them)."""
    if not att.n_ops or not steps or not any(n in LAYER_OF
                                             for n in att.ops):
        return {}
    out = {}
    for layer in LAYERS:
        names = [n for n, lay in LAYER_OF.items() if lay == layer]
        out[f"launches_per_step.{layer}"] = \
            sum(att.ops.get(n, 0) for n in names) / steps
        out[f"device_idle_share.{layer}"] = \
            100.0 * sum(att.idle_us.get(n, 0.0) for n in names) \
            / att.window_us
    out["host_syncs_per_step.plan"] = sum(att.syncs.values()) / steps
    return out


def outside(att: SimpleNamespace, steps: int) -> Dict[str, float]:
    """What no layer of ``LAYER_OF`` holds: operations a step, idle share
    (%), and operations whose correlation matched no launch a step."""
    mine = set(LAYER_OF)
    return {
        "launches_per_step": sum(v for k, v in att.ops.items()
                                 if k not in mine) / max(steps, 1),
        "device_idle_share": 100.0 * sum(
            v for k, v in att.idle_us.items() if k not in mine)
        / att.window_us,
        "unmatched_per_step": att.unmatched / max(steps, 1)}


# ---------------------------------------------------------------------------
# a cell's traced window
# ---------------------------------------------------------------------------

def _traced_events(run_steps):
    """``harness.traced``'s window, with the chrome trace kept: (steps,
    trace dict, trace bytes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(harness.WINDOW_MARK):
            steps = run_steps()
    d = tempfile.mkdtemp(prefix="perfbench-spans-")
    try:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        trace = harness.load_json(path)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return steps, trace, size


def run(name: str, seed: int, device=None,
        overrides: Optional[dict] = None) -> dict:
    """One cell's set-up, untraced steps and traced window; the figures of
    its trace.  ``device`` None means the first CUDA device and fails
    without one; the tests pass "cpu" and ``overrides`` as
    ``harness.run_cell`` takes them."""
    import torch

    cell = harness.load_cell(name)
    if device is None:
        if not torch.cuda.is_available():
            raise harness.NoDevice("no CUDA device: the spans are read on "
                                   "the card")
        device = "cuda:0"
    dev = torch.device(device)
    for key, val in (overrides or {}).items():
        cell.traffic[key] = dict(cell.traffic.get(key, {}), **val)
    driver = harness.load_driver(cell).Driver(
        cell, harness.config_fields(cell), dev, int(seed))
    driver.setup()
    step_s = driver.timed_steps()
    steps, trace, size = _traced_events(driver.trace_steps)
    red = harness.reduce_trace(trace)
    att = attribute(trace)
    ctx = SimpleNamespace(kernels=red.kernels, busy_s=red.busy_s,
                          window_s=red.window_s, steps=steps)
    plan = {"launches_per_step.plan": _common.launches_per_step(ctx),
            "device_idle_share.plan": _common.idle_share(ctx)}
    layers = layer_metrics(att, steps)
    out_ = outside(att, steps)
    sums = {}
    if layers:
        sums = {
            "launches": sum(layers[f"launches_per_step.{x}"]
                            for x in LAYERS) + out_["launches_per_step"],
            "idle": sum(layers[f"device_idle_share.{x}"] for x in LAYERS)
            + out_["device_idle_share"]}
    by_span = {"launches_per_step": {str(k): v / steps
                                     for k, v in att.ops.items()},
               "idle_s": {str(k): v * 1e-6 for k, v in att.idle_us.items()},
               "syncs_per_step": {str(k): v / steps
                                  for k, v in att.syncs.items()}}
    print(f"spans: outside every span {out_['launches_per_step']:.3f} "
          f"operations a step, {out_['device_idle_share']:.4f} % idle; "
          f"{att.unmatched} operations matched no launch; {att.n_spans} "
          f"spans", file=sys.stderr)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {"cell": name, "seed": int(seed), "device": kind,
            "steps": steps, "spans": att.n_spans, "untraced_step_s": step_s,
            "traced_step_s": red.window_s / steps, "trace_bytes": size,
            "metrics": dict(layers, **{k: v for k, v in plan.items()
                                       if v is not None}),
            "outside": out_, "sums": sums, "by_span": by_span}


def main(argv: Optional[List[str]] = None, device=None,
         overrides: Optional[dict] = None) -> int:
    ap = argparse.ArgumentParser(description="A cell's traced window by "
                                             "the program's layers.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    try:
        out = run(args.workload, args.seed, device=device,
                  overrides=overrides)
    except harness.NoDevice as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return harness.EXIT_NO_DEVICE
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    from perfbench import run as _run  # noqa: F401  (run.py's environment)
    import torch
    torch.set_num_threads(1)
    sys.exit(main(sys.argv[1:]))
