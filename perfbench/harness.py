"""The benchmark's core: the cell's files, the device, the window, the trace
and the result line.

A cell names a configuration (``configs/<config>.json``), a traffic file
(``workloads/<cell>.json``) and a driver (``drivers/<driver>.py``); the
metrics a run reports are the entries of ``BENCHMARK.json`` that list the
cell, or list none.  A per-layer metric is read by ``metrics/<name>.py``'s
``read(ctx)``, which returns a number, or None when the trace holds
nothing for it (the metric is then left out of the line).
"""

from __future__ import annotations

import argparse
import bisect
import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "pstl_tpu")
#: exit codes: no card (or too few), a forbidden module, an unknown cell
EXIT_NO_DEVICE, EXIT_FORBIDDEN, EXIT_SPEC = 3, 4, 5
TOP = 10


class SpecError(Exception):
    """A cell, configuration or metric that the benchmark's files do not
    describe."""


class NoDevice(Exception):
    """The run found fewer CUDA devices than its cell asks for."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> SimpleNamespace:
    """The cell ``name`` of ``BENCHMARK.json``: its entry, its traffic file,
    its configuration's entry and file, and the metrics it reports."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SpecError(f"no cell {name!r} in BENCHMARK.json")
    conf = next((c for c in bench["configs"]
                 if c["name"] == entry["config"]), None)
    if conf is None:
        raise SpecError(f"cell {name!r} names no configuration of "
                        f"BENCHMARK.json: {entry['config']!r}")
    traffic = load_json(os.path.join(root, "perfbench", "workloads",
                                     f"{name}.json"))
    if traffic.get("config") != entry["config"]:
        raise SpecError(f"workloads/{name}.json names configuration "
                        f"{traffic.get('config')!r}, BENCHMARK.json "
                        f"{entry['config']!r}")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return SimpleNamespace(
        name=name, entry=entry, traffic=traffic, conf_entry=conf,
        config=load_json(os.path.join(root, conf["file"])),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)],
        chips=int(entry["chips"]))


def config_fields(cell: SimpleNamespace) -> dict:
    """Every ``Config`` field of the cell: the configuration's fields with
    the traffic file's ``set`` over them (JSON lists as tuples)."""
    fields = dict(cell.config["fields"])
    fields.update(cell.traffic.get("set", {}))
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in fields.items()}


def load_driver(cell: SimpleNamespace):
    return importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}")


def load_reader(name: str, root: str = ROOT):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(root, "perfbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_MARK = "perfbench.window"


def merge(intervals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce_trace(trace: dict) -> SimpleNamespace:
    """Device operations, busy time and idle gaps of the traced window (the
    ``WINDOW_MARK`` annotation), in seconds.  Each idle gap is named by the
    innermost host operation running at its middle ("python" where none
    runs)."""
    events = trace.get("traceEvents", [])
    marks = [e for e in events if e.get("name") == WINDOW_MARK
             and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"]
    if not marks:
        raise RuntimeError("the trace holds no window annotation")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
           for e in events if e.get("cat") in DEVICE_CATS
           and e.get("ph") == "X"]
    busy = merge((ts, ts + d) for _, ts, d in dev)
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    for name, _, d in dev:
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted((float(e["ts"]), float(e.get("dur", 0.0)), e["name"])
                 for e in events if e.get("cat") == "cpu_op"
                 and e.get("ph") == "X")
    starts = [o[0] for o in ops]
    gaps = []
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps.append((edge, min(a, w1)))
        edge = max(edge, b)
    gap_by: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for j in range(i - 1, max(i - 256, -1), -1):
            ts, d, name = ops[j]
            if ts + d >= mid and (best is None or d < best[0]):
                best = (d, name)
        label = best[1] if best else "python"
        gap_by[label] = gap_by.get(label, 0.0) + (b - a)
    return SimpleNamespace(
        kernels=dev, busy_s=busy_us * 1e-6, window_s=(w1 - w0) * 1e-6,
        device_ops=sorted(([k, v * 1e-6] for k, v in by_name.items()),
                          key=lambda r: -r[1])[:TOP],
        idle_gaps=sorted(([k, v * 1e-6] for k, v in gap_by.items()),
                         key=lambda r: -r[1])[:TOP])


def traced(run_steps) -> SimpleNamespace:
    """Run ``run_steps()`` (which returns the number of steps) under
    ``torch.profiler`` and reduce its chrome trace, written to a directory
    under ``TMPDIR`` and removed after; also returns the trace's size."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_MARK):
            steps = run_steps()
    d = tempfile.mkdtemp(prefix="perfbench-trace-")
    try:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        out = reduce_trace(load_json(path))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out.steps = steps
    out.trace_bytes = size
    return out


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

def device_info(dev, count: int) -> dict:
    import torch
    if dev.type == "cuda":
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": count, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device=None, t_start: Optional[float] = None,
             overrides: Optional[dict] = None, root: str = ROOT,
             impl=None) -> dict:
    """One run of cell ``name``: set-up, the window (or with ``trace`` a
    short traced window), the comparison with the reference; returns the
    result line's object.  ``device`` None means the first CUDA device and
    fails without one; the tests pass "cpu" and ``overrides`` (sizes of a
    tiny run: ``set`` for Config fields, ``traffic`` and ``check``), and
    ``impl`` to put another implementation in the program's place."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, root)
    if device is None:
        if not torch.cuda.is_available():
            raise NoDevice("no CUDA device: the benchmark measures the card")
        if torch.cuda.device_count() < cell.chips:
            raise NoDevice(f"cell {name} needs {cell.chips} CUDA devices, "
                           f"{torch.cuda.device_count()} found")
        device = "cuda:0"
    dev = torch.device(device)
    if overrides:
        for key in ("set", "traffic", "check"):
            if key in overrides:
                merged = dict(cell.traffic.get(key, {}))
                merged.update(overrides[key])
                cell.traffic[key] = merged
    driver = load_driver(cell).Driver(cell, config_fields(cell), dev,
                                      int(seed), impl=impl)
    driver.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    out = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if trace:
        step_s = driver.timed_steps()
        tr = traced(driver.trace_steps)
        ctx = SimpleNamespace(
            kernels=tr.kernels, busy_s=tr.busy_s, window_s=tr.window_s,
            steps=tr.steps, step_s=step_s, fields=driver.fields,
            shapes=driver.shapes())
        for m in cell.per_layer:
            val = load_reader(m["name"], root)(ctx)
            if val is not None:
                out["metrics"][m["name"]] = {"value": float(val),
                                             "unit": m["unit"]}
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        out["breakdown"] = {"device_ops": tr.device_ops,
                            "idle_gaps": tr.idle_gaps}
        print(f"trace: untraced step {step_s:.6f} s, traced step "
              f"{tr.window_s / tr.steps:.6f} s; {tr.steps} steps, "
              f"window {tr.window_s:.6f} s, busy "
              f"{tr.busy_s:.6f} s, {len(tr.kernels)} device operations, "
              f"chrome trace {tr.trace_bytes} bytes", file=sys.stderr)
    else:
        # a collection of the records the window keeps would stall a step
        gc.collect()
        gc.disable()
        try:
            e2e = driver.window(seconds)
        finally:
            gc.enable()
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise SpecError(f"driver {cell.traffic['driver']} does not "
                                f"measure {m['name']}")
            out["metrics"][m["name"]] = {"value": float(e2e[m["name"]]),
                                         "unit": m["unit"]}
        extra = {}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["device"] = dict(device_info(dev, cell.chips), **extra)
    out["attempted"] = driver.attempted
    driver.release()
    t_check = time.perf_counter()
    checks = driver.check()
    print(f"reference check: {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    out["failed"] = driver.failed
    out["correct"] = bool(checks) and all(c["ok"] for c in checks)
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out


def main(argv=None, t_start: Optional[float] = None, device=None,
         overrides: Optional[dict] = None) -> int:
    """The command line.  ``device`` and ``overrides`` are for the tests: a
    measured run passes neither, and without a card exits with
    ``EXIT_NO_DEVICE``."""
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), device=device, t_start=t_start,
                       overrides=overrides)
    except NoDevice as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return EXIT_NO_DEVICE
    except (SpecError, FileNotFoundError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return EXIT_SPEC
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return EXIT_FORBIDDEN
    sys.stdout.flush()
    print(f"correct: {out['correct']}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    sys.stdout.flush()
    return 0
