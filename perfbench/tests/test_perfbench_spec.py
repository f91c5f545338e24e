"""``BENCHMARK.json`` and the files it names: they parse, keep to the
contract's keys, names and units, and every cell finds its files."""

import json
import os
import re

import pytest

from perfbench.tests.sizes import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(b["command"]) <= 32 and all(line_ok(w) for w in b["command"])
    for w in b["command"][1:]:
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w.startswith(p + "/") for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_configs():
    b = bench()
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in b["workloads"]}
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"])
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        # every Config field, written out
        from perfbench.reference.port.config import Config
        assert set(conf["fields"]) == set(Config.__dataclass_fields__)
        assert conf["weights"]["plan"]


def test_workloads():
    b = bench()
    ws = b["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line_ok(w["why"])
        path = os.path.join(ROOT, "perfbench", "workloads",
                            f"{w['traffic']}.json")
        with open(path) as f:
            t = json.load(f)
        assert t["config"] == w["config"] and t["why"] == w["why"]
        assert os.path.exists(os.path.join(ROOT, "perfbench", "drivers",
                                           f"{t['driver']}.py"))
        assert t["check"]["limits"]


def test_metrics():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert e2e["setup_s"]["bound"] <= 0.25
    names = list(e2e) + [m["name"] for m in b["per_layer"]]
    assert len(set(names)) == len(names)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and line_ok(m["layer"])
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells)
        assert os.path.exists(os.path.join(ROOT, "perfbench", "metrics",
                                           f"{m['name']}.py"))
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in cells
    for cell in cells:
        mine = [m for m in b["end_to_end"] + b["per_layer"]
                if cell in m.get("workloads", cells)]
        assert any(m["name"] == "setup_s" for m in mine)
        assert any(m["name"] != "setup_s" for m in mine
                   if m in b["end_to_end"])
        assert any(m in b["per_layer"] for m in mine)


@pytest.mark.parametrize("path", ["perfbench"])
def test_file_names(path):
    for dirpath, _, files in os.walk(os.path.join(ROOT, path)):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert PATH.match(rel), rel
