"""``spans.py``: the attribution of a chrome trace's device operations,
idle time and host syncs to the program's spans, on a hand-built trace;
its table against the program's spans; a CPU run of a cell."""

import contextlib
import io
import json

import pytest

from perfbench import harness, spans
from perfbench.metrics import _common
from perfbench.tests.sizes import tiny
from pstl_tpu_torch.utils import trace as program_trace


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"name": name, "ph": "X", "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def hand_trace():
    """One step in a 100 us window: nested spans, launches on the runtime
    and the driver API, a device operation with no launch, two syncs in
    the step and one after it."""
    ev = [_x(harness.WINDOW_MARK, "user_annotation", 0.0, 100.0),
          _x("sim.step", "user_annotation", 5.0, 85.0),
          _x("sim.step", "gpu_user_annotation", 8.0, 80.0, tid=7),
          _x("sim.observe", "user_annotation", 6.0, 4.0),
          _x("sim.plan", "user_annotation", 11.0, 59.0),
          _x("plan.prep", "user_annotation", 12.0, 8.0),
          _x("plan.sample", "user_annotation", 21.0, 29.0),
          _x("plan.guidance", "user_annotation", 30.0, 10.0),
          _x("plan.select", "user_annotation", 51.0, 18.0),
          _x("plan.score", "user_annotation", 55.0, 5.0),
          _x("sim.env", "user_annotation", 71.0, 14.0),
          # launches and what they launched
          _x("cudaLaunchKernel", "cuda_runtime", 7.0, 0.5, corr=1),
          _x("k_observe", "kernel", 8.0, 4.0, tid=7, corr=1),
          _x("cuLaunchKernelEx", "cuda_driver", 25.0, 0.5, corr=2),
          _x("k_eps", "kernel", 26.0, 2.0, tid=7, corr=2),
          _x("cudaLaunchKernel", "cuda_runtime", 32.0, 0.5, corr=3),
          _x("k_guidance", "kernel", 33.0, 12.0, tid=7, corr=3),
          _x("cudaMemcpyAsync", "cuda_runtime", 56.0, 0.5, corr=4),
          _x("Memcpy DtoH", "gpu_memcpy", 57.0, 1.0, tid=7, corr=4),
          _x("cudaStreamSynchronize", "cuda_runtime", 58.0, 1.0, corr=10),
          _x("cudaLaunchKernel", "cuda_runtime", 80.0, 0.5, corr=5),
          _x("k_env", "kernel", 81.0, 2.0, tid=7, corr=5),
          _x("cudaMemcpy", "cuda_runtime", 82.0, 3.0, corr=8),
          _x("Memcpy HtoD", "gpu_memcpy", 84.0, 0.5, tid=7, corr=8),
          _x("cudaDeviceSynchronize", "cuda_runtime", 92.0, 1.0, corr=11),
          _x("cudaLaunchKernel", "cuda_runtime", 94.0, 0.5, corr=6),
          _x("k_driver", "kernel", 95.0, 1.0, tid=7, corr=6),
          _x("k_orphan", "kernel", 97.0, 1.0, tid=7, corr=99),
          _x("aten::add", "cpu_op", 31.0, 5.0)]
    return {"traceEvents": ev}


def test_attribution_by_span():
    att = spans.attribute(hand_trace())
    assert att.ops == {"sim.observe": 1, "plan.sample": 1,
                       "plan.guidance": 1, "plan.score": 1, "sim.env": 2,
                       None: 2}
    assert att.unmatched == 1 and att.n_ops == 8
    # gaps 0-8, 12-26, 28-33, 45-57, 58-81, 83-84, 84.5-95, 96-97, 98-100
    # cut at the span boundaries
    want = {None: 13.0, "sim.step": 7.0, "sim.observe": 2.0,
            "plan.prep": 8.0, "sim.plan": 3.0, "plan.sample": 12.0,
            "plan.guidance": 3.0, "plan.select": 13.0, "plan.score": 4.0,
            "sim.env": 11.5}
    assert att.idle_us == {k: pytest.approx(v) for k, v in want.items()}
    # the step's stream sync and blocking copy; not the one after the step
    assert att.syncs == {"plan.score": 1, "sim.env": 1}


def test_layers_and_the_two_sums():
    tr = hand_trace()
    att = spans.attribute(tr)
    got = spans.layer_metrics(att, 1)
    want = {"prep": (1, 20.0), "sample": (1, 12.0), "guidance": (1, 3.0),
            "score": (1, 4.0), "select": (0, 13.0), "env": (2, 11.5)}
    for layer, (ops, idle) in want.items():
        assert got[f"launches_per_step.{layer}"] == ops
        assert got[f"device_idle_share.{layer}"] == pytest.approx(idle)
    assert got["host_syncs_per_step.plan"] == 2
    out = spans.outside(att, 1)
    assert out == {"launches_per_step": 2, "unmatched_per_step": 1,
                   "device_idle_share": pytest.approx(13.0)}
    red = harness.reduce_trace(tr)
    ctx = type("Ctx", (), dict(kernels=red.kernels, busy_s=red.busy_s,
                               window_s=red.window_s, steps=1))
    assert sum(got[f"launches_per_step.{x}"] for x in spans.LAYERS) \
        + out["launches_per_step"] == _common.launches_per_step(ctx) == 8
    assert sum(got[f"device_idle_share.{x}"] for x in spans.LAYERS) \
        + out["device_idle_share"] == pytest.approx(_common.idle_share(ctx))


def test_nothing_without_spans_or_device_operations():
    """A program without spans (every operation outside them) and a trace
    without device operations (the CPU) read nothing."""
    tr = hand_trace()
    bare = {"traceEvents": [e for e in tr["traceEvents"]
                            if e["cat"] != "user_annotation"
                            or e["name"] == harness.WINDOW_MARK]}
    att = spans.attribute(bare)
    assert att.ops == {None: 8} and att.syncs == {}
    assert spans.layer_metrics(att, 1) == {}
    cpu = {"traceEvents": [e for e in tr["traceEvents"]
                           if e["cat"] not in harness.DEVICE_CATS]}
    assert spans.layer_metrics(spans.attribute(cpu), 1) == {}


def test_the_table_names_the_programs_spans():
    assert set(spans.LAYER_OF) == set(program_trace.SPANS)
    assert set(spans.LAYER_OF.values()) == set(spans.LAYERS)


@pytest.mark.parametrize("cell", ["e7-heavy-cl16", "ctg-cl128"])
def test_a_cpu_run(cell):
    """The CLI at a tiny size on the CPU: the spans are there, and with no
    device operation no figure is read."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = spans.main(["--workload", cell, "--seed", str(2 ** 31 + 9)],
                        device="cpu", overrides=tiny(cell))
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["metrics"] == {}
    # every traced step opens all nine spans, some more than once
    assert line["spans"] >= 9 * line["steps"] > 0
