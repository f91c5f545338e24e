"""``scripts/e2e_pipeline_torch.py`` end to end on the CPU at a tiny width
(``E2E_DEVICE=cpu``, six scenes, one epoch, two trajopt iterations,
``E2E_METHODS=e5,e7``): its ``results.json`` holds the rows that
``scripts/e2e_pipeline.py`` writes for those methods, each with the JAX
script's keys, and finite values."""

import ast
import importlib.util
import json
import math
import os

from pstl_tpu_torch import eval_openloop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script_rows():
    """The JAX script's (eval rows, sim rows) as {row: method} and its
    closed-loop row keys, read from its source."""
    tree = ast.parse(open(os.path.join(REPO, "scripts",
                                       "e2e_pipeline.py")).read())
    rows, sim_keys = {}, None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ("EVAL_CFGS", "SIM_CFGS")):
            rows[node.targets[0].id] = {
                k.value: v.elts[0].value
                for k, v in zip(node.value.keys, node.value.values)}
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "compliance"
                for k in node.keys):
            sim_keys = {k.value for k in node.keys}
    return rows["EVAL_CFGS"], rows["SIM_CFGS"], sim_keys


def test_e2e_pipeline_tiny_on_cpu(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "e2e_pipeline_torch", os.path.join(REPO, "scripts",
                                           "e2e_pipeline_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "e2e"
    monkeypatch.setattr(mod, "OUT", str(out))
    monkeypatch.setattr(mod, "BASE", dict(
        n_randoms=2, n_neighbors=2, batch_size=2, hiddens=(32, 32),
        rect_hiddens=(32, 32), diffusion_steps=4, n_shards=2,
        compute_dtype="float32"))
    for k, v in (("SAMPLING_SIZE", 2), ("EVAL_TRIALS", 0), ("N_TEST", 2),
                 ("SIM_STEPS", 2)):
        monkeypatch.setattr(mod, k, v)
    for k, v in (("E2E_DEVICE", "cpu"), ("E2E_SCENES", "6"),
                 ("E2E_T_SAMPLES", "1"), ("E2E_EPOCHS_E5", "1"),
                 ("E2E_EPOCHS_E7", "1"), ("E2E_TJ_ITERS", "2"),
                 ("E2E_METHODS", "e5,e7")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("E2E_STAGES", raising=False)
    mod.main()
    res = json.loads((out / "results.json").read_text())
    eval_rows, sim_rows, sim_keys = jax_script_rows()
    methods = ("e5", "e7")
    want = ({"trajopt_sat"}
            | {f"openloop_{r}" for r, m in eval_rows.items() if m in methods}
            | {f"closedloop_{r}" for r, m in sim_rows.items()
               if m in methods})
    assert set(res) == want
    eval_keys = {f"{r}_{m}" for r in ("tj", "nn")
                 for m in eval_openloop.RUN_METRICS} | {"time"}
    for k, v in res.items():
        if k.startswith("openloop_"):
            assert set(v) == eval_keys, k
        elif k.startswith("closedloop_"):
            assert set(v) == sim_keys, k
        vals = v.values() if isinstance(v, dict) else [v]
        assert all(math.isfinite(x) for x in vals), k
    for m in ("models_e5", "models_e7", "models"):
        assert (out / m / "LAST").exists()
    assert (out / "cache_aug.npz").exists()
    assert sorted(os.listdir(out / "viz_ours")) == [
        f"paper_scene{i:02d}.png" for i in range(2)]
