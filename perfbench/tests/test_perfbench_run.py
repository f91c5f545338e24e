"""``run.py`` end to end at a tiny size on the CPU, through the tests' entry
(``harness.main(device="cpu")``); a measured run that finds no card, and
a checkout that holds nothing but the benchmark, fail."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench.tests.sizes import ROOT, tiny
from perfbench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_line(cell, trace, root=ROOT, seed=2 ** 31 + 5):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.main(["--workload", cell, "--seed", str(seed),
                           "--seconds", "1", "--trace", str(trace)],
                          device="cpu", overrides=tiny(cell, root))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell,trace", [("e7-heavy-cl16", 0),
                                        ("e7-heavy-cl16", 1),
                                        ("ctg-cl128", 0)])
def test_result_line(cell, trace):
    line = run_line(cell, trace)
    assert set(KEYS) <= set(line) and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    spec = harness.load_cell(cell)
    want = spec.per_layer if trace else spec.end_to_end
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in want}
        for m in want:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
            assert line["metrics"][m["name"]]["value"] > 0
    else:
        # no device operation on the CPU: the readers find nothing
        assert line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["platform"] == "cpu"
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


def test_no_card_fails(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "e7-heavy-cl16", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc == harness.EXIT_NO_DEVICE
    assert capsys.readouterr().out == ""


def test_lone_benchmark_fails(tmp_path):
    """A directory with only BENCHMARK.json and perfbench/: no program."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "e7-heavy-cl16", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_jax_loaded():
    """Harness, drivers, metrics and reference import no jax or JAX
    package (top-level names compared whole); the reference alone loads
    nothing of the port."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import perfbench.reference.port.sim\n"
        "import perfbench.drivers as d; d.reference()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('pstl_tpu_torch', 'pstl_tpu', 'jax', 'jaxlib', 'flax')]\n"
        "assert not bad, bad\n"
        "from perfbench import harness, calibrate, roofline, traffic\n"
        "from perfbench.drivers import closed_loop\n"
        "d.program()\n"
        "import glob, os\n"
        "for f in glob.glob(os.path.join(%r, 'perfbench/metrics/*.py')):\n"
        "    n = os.path.basename(f)[:-3]\n"
        "    if not n.startswith('_'): harness.load_reader(n)\n"
        "bad = harness.forbidden_modules()\n"
        "assert not bad, bad\n"
        "assert 'pstl_tpu_torch' in sys.modules\n") % (ROOT, ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr


def test_a_new_cell_is_new_files(tmp_path):
    """A throwaway cell, traffic mix and per-layer metric in a copy: new
    files under perfbench/ and new entries in BENCHMARK.json, nothing
    edited."""
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    w = dict(json.load(open(os.path.join(
        ROOT, "perfbench", "workloads", "e7-heavy-cl16.json"))),
        name="e7-tiny-cl2", why="a throwaway cell")
    w["traffic"] = dict(w["traffic"], scenes=2)
    (tmp_path / "perfbench" / "workloads" / "e7-tiny-cl2.json").write_text(
        json.dumps(w))
    (tmp_path / "perfbench" / "metrics" / "traced_steps.py").write_text(
        "def read(ctx):\n    return ctx.steps\n")
    b["workloads"].append({"name": "e7-tiny-cl2", "config": "e7_ours",
                           "traffic": "e7-tiny-cl2", "chips": 1,
                           "why": "a throwaway cell"})
    for m in b["end_to_end"]:
        if m["name"] in ("agent_steps_per_s", "step_ms_p95"):
            m["workloads"].append("e7-tiny-cl2")
    b["per_layer"].append({"name": "traced_steps", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "episode loop and planner dispatch",
                           "moves": "agent_steps_per_s",
                           "workloads": ["e7-tiny-cl2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    over = dict(tiny("e7-heavy-cl16"))
    line = harness.run_cell("e7-tiny-cl2", 3, 1.0, False, device="cpu",
                            overrides=over, root=str(tmp_path))
    assert line["correct"] and set(line["metrics"]) == {
        "agent_steps_per_s", "step_ms_p95", "setup_s"}
    line = harness.run_cell("e7-tiny-cl2", 3, 1.0, True, device="cpu",
                            overrides=over, root=str(tmp_path))
    assert line["metrics"]["traced_steps"]["value"] == 2
