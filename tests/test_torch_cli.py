"""The port's command line (``pstl_tpu_torch.cli``) against
``pstl_tpu.cli``: the same preset listing, configs field for field from the
same ``--set`` values, a bit-identical ``data`` store, ``check``'s
calibration to 1e-5, and the same arguments handed to each command's
callee (``trajopt.augment_dataset``, ``train.train``,
``eval_openloop.run``, ``sim.run_closed_loop_host``, monkeypatched in both
packages); then real runs of every command on the CPU at a tiny width,
what the port refuses by name, and chip_smoke.py's phases 33 and 36
rehearsed on the CPU."""

import argparse
import json
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

from pstl_tpu import cli as jcli
from pstl_tpu import eval_openloop as jeval, sim as jsim, specs as jspecs
from pstl_tpu import train as jtrain, trajopt as jtrajopt
from pstl_tpu_torch import cli as tcli
from pstl_tpu_torch import eval_openloop as teval, sim as tsim
from pstl_tpu_torch import specs as tspecs, train as ttrain
from pstl_tpu_torch import trajopt as ttrajopt
from pstl_tpu_torch.config import bench_config
from pstl_tpu_torch.models import convert
from pstl_tpu_torch.models.net import Net

import torch_parity  # noqa: F401  (torch thread count)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["n_randoms=2", "n_neighbors=2"]
#: a tiny diffusion planner for the closed-loop and eval runs
TINY = SMALL + ["diffusion=true", "diffusion_steps=4",
                "compute_dtype=float32", "batch_size=2", "n_shards=2"]


def printed_json(out):
    return json.loads(out[out.index("{"):])


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A fresh working directory; stdout restored after the test (the
    ``train`` command tees it into its experiment directory)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    return tmp_path


@pytest.fixture
def cache(workdir):
    """A three-scene store with scene tensors, written by the port."""
    path = str(workdir / "scenes.npz")
    tcli.main(["data", "--out", path, "--scenes", "3", "--scene-len", "10",
               "--set", *SMALL])
    return path


# ---------------------------------------------------------------------------
# configs, presets, data, check
# ---------------------------------------------------------------------------

def test_presets_prints_jax_lines(capsys):
    jcli.main(["presets"])
    want = capsys.readouterr().out
    tcli.main(["presets"])
    assert capsys.readouterr().out == want
    assert want.count("\n") == 12


@pytest.mark.parametrize("preset,sets,exp", [
    (None, ["n_randoms=2", "flex=true", "guidance=false"], None),
    (None, ["lr=3e-4", "hiddens=64,64", "mesh_shape=-1"], None),
    (None, ["net_pretrained_path=none", "sampler=ddim", "ddim_steps=null"],
     "x"),
    ("e7_ours", ["multi_cands=3", "guidance=true", "guidance_lr=0.04"],
     None),
    ("ours_guidance", [], "og_run"),
    ("e2_vae_mono", ["use_pallas_clearance=true", "no_viz=true"], None),
], ids=["bool_int", "float_tuple", "none_string", "preset_overrides",
        "preset_exp_name", "mono_preset"])
def test_build_config_matches_jax(preset, sets, exp):
    args = argparse.Namespace(preset=preset, set=sets, exp_name=exp)
    want = jcli.build_config(args).to_dict()
    got = tcli.build_config(args).to_dict()
    assert got == want
    for kv in sets:
        k, v = kv.split("=", 1)
        assert got[k] == jcli._parse_value(None, v)


def test_build_config_unknown_key_exits_as_jax():
    args = argparse.Namespace(preset=None, set=["no_such_field=1"],
                              exp_name=None)
    with pytest.raises(SystemExit) as want:
        jcli.build_config(args)
    with pytest.raises(SystemExit) as got:
        tcli.build_config(args)
    assert str(got.value) == str(want.value) == \
        "unknown config field: no_such_field"


def test_cli_heavy_sets_are_bench_heavy():
    """chip_smoke.py's phase 33 gives bench.py's heavy contract to ``cli
    sim`` as ``--set`` pairs: with no preset, equal field for field."""
    from chip_smoke import CLI_HEAVY
    args = argparse.Namespace(preset=None, set=list(CLI_HEAVY),
                              exp_name=None)
    got = tcli.build_config(args).with_(test=True, epochs=1).to_dict()
    assert got == bench_config("heavy").to_dict()


@pytest.mark.parametrize("extra", [[], ["--t-samples", "2", "--t-stride",
                                        "3"]], ids=["one_t", "two_t"])
def test_data_store_equals_jax(tmp_path, extra):
    argv = ["--scenes", "4", "--scene-len", "12", *extra, "--set", *SMALL]
    jcli.main(["data", "--out", str(tmp_path / "j.npz"), *argv])
    tcli.main(["data", "--out", str(tmp_path / "t.npz"), *argv])
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype and np.array_equal(j[k], t[k]), k
    for suffix in (".split.txt",):
        a, b = tmp_path / f"j.npz{suffix}", tmp_path / f"t.npz{suffix}"
        assert a.exists() == b.exists()
        if a.exists():
            assert a.read_text() == b.read_text()


def test_check_matches_jax(cache, capsys, monkeypatch):
    """``check``'s calibrated stlp and ACC, batch by batch, to 1e-5 (the
    JAX command run op by op so that its values can be read)."""
    seen = {"jax": [], "port": []}

    def recorder(mod, where):
        cal, comp = mod.calibrate_stlp, mod.compute_scores

        def calibrate(*a, **kw):
            out = cal(*a, **kw)
            seen[where].append(["stlp", np.asarray(out)])
            return out

        def compute(*a, **kw):
            out = comp(*a, **kw)
            seen[where][-1] += ["acc", float(out[2])]
            return out

        monkeypatch.setattr(mod, "calibrate_stlp", calibrate)
        monkeypatch.setattr(mod, "compute_scores", compute)

    recorder(jspecs, "jax")
    recorder(tspecs, "port")
    argv = ["check", "--cache", cache, "--set", *SMALL, "batch_size=1"]
    with jax.disable_jit():
        jcli.main(argv)
    want = capsys.readouterr().out
    tcli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert len(seen["port"]) == len(seen["jax"]) == 2
    for (_, sj, _, aj), (_, st, _, at) in zip(seen["jax"], seen["port"]):
        np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1e-5)
        assert abs(at - aj) <= 1e-5
    assert got.splitlines()[-1] == want.splitlines()[-1]


# ---------------------------------------------------------------------------
# the wiring: what each command hands its callee
# ---------------------------------------------------------------------------

def spy(monkeypatch, mod, name, result=None):
    """Replace ``mod.name`` by a recorder returning ``result``."""
    calls = []

    def fake(*a, **kw):
        calls.append((a, kw))
        return result

    monkeypatch.setattr(mod, name, fake)
    return calls


def same_dataset(j, t):
    assert len(j) == len(t)
    assert sorted(j.data) == sorted(t.data)
    assert sorted(j.scene_data) == sorted(t.scene_data)
    for s in ("train", "val"):
        np.testing.assert_array_equal(j.splits[s], t.splits[s])


def test_trajopt_wiring(cache, monkeypatch):
    jc = spy(monkeypatch, jtrajopt, "augment_dataset")
    tc = spy(monkeypatch, ttrajopt, "augment_dataset")
    argv = ["trajopt", "--cache", cache, "--out", "aug.npz", "--iters", "7",
            "--set", *SMALL]
    jcli.main(argv)
    tcli.main(argv + ["--device", "cpu"])
    (ja, jk), (ta, tk) = jc[0], tc[0]
    assert ta[1].to_dict() == ja[1].to_dict()
    same_dataset(ja[0], ta[0])
    assert tk.pop("device") == torch.device("cpu")
    # trajopt_only finalizes batch_size to 1024: one batch of the 3 scenes
    assert tk == jk == {"batch_size": 3, "iters": 7, "epochs": 1}


@pytest.mark.parametrize("argv", [
    ["--preset", "e5_ddpm", "--epochs", "3", "--ckpt", "w.npz"],
    ["--preset", "e2_vae_mono", "-e", "mono", "--set",
     "use_pallas_clearance=true", "no_viz=true"],
    ["--set", "diffusion=true", "n_randoms=2", "n_neighbors=2"],
], ids=["preset_ckpt", "mono_exp", "no_preset"])
def test_train_wiring(cache, monkeypatch, argv):
    jc = spy(monkeypatch, jtrain, "train")
    tc = spy(monkeypatch, ttrain, "train")
    argv = ["train", "--cache", cache] + argv
    if "--set" not in argv:
        argv += ["--set", *SMALL]
    jcli.main(argv)
    tcli.main(argv + ["--device", "cpu"])
    (ja, jk), (ta, tk) = jc[0], tc[0]
    assert ta[0].to_dict() == ja[0].to_dict()
    same_dataset(ja[1], ta[1])
    assert jk.pop("mesh") is None
    assert tk.pop("mesh") is None
    assert tk.pop("device") == torch.device("cpu")
    assert tk == jk
    if ja[0].exp_name:
        assert os.path.exists(os.path.join("exps", ja[0].exp_name,
                                           "torch_models"))


def test_eval_wiring(cache, monkeypatch, capsys):
    jc = spy(monkeypatch, jeval, "run", {"nn_acc": 0.25})
    tc = spy(monkeypatch, teval, "run", {"nn_acc": 0.25})
    argv = ["eval", "--preset", "ours_guidance", "--cache", cache,
            "--trials", "2", "--set", *SMALL, "n_shards=2", "hiddens=32,32",
            "rect_hiddens=32,32"]
    jcli.main(argv)
    want = capsys.readouterr().out
    tcli.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == want
    (ja, jk), (ta, tk) = jc[0], tc[0]
    assert ta[0].to_dict() == ja[0].to_dict()
    same_dataset(ja[1], ta[1])
    assert isinstance(ta[2], Net)
    assert tk == {"n_trials": 2, "device": torch.device("cpu")}
    assert jk["n_trials"] == 2


def _episodes(path):
    path.write_text("# scene ti rationale\n0 0\n2 9  # late start\n1\n")
    return str(path)


@pytest.mark.parametrize("case", ["synthetic", "no_pre_check",
                                  "test_scenes", "cache_episodes",
                                  "cache_test_aggressive", "render"])
def test_sim_wiring(workdir, cache, monkeypatch, capsys, case):
    """What ``sim`` hands ``run_closed_loop_host``: the config, every
    scene tensor, the steps, the record / render flags, the start frames
    and the stlp override; the mirrors of ``tests/test_cli.py``'s
    ``test_cli_sim_consumes_cache_with_episode_list`` and
    ``test_cli_sim_cache_test_aggressive`` among them."""
    res = {"collide": np.zeros(3), "agent_steps": 6.0}
    jc = spy(monkeypatch, jsim, "run_closed_loop_host", res)
    tc = spy(monkeypatch, tsim, "run_closed_loop_host", res)
    eps = ["--cache", cache, "--episodes", _episodes(workdir / "eps.txt")]
    argv, sets = {
        "synthetic": (["--scenes", "3", "--scene-len", "8"], []),
        "no_pre_check": (["--scenes", "3", "--scene-len", "8",
                          "--no-pre-check", "--record"], []),
        "test_scenes": (["--preset", "ours_guidance_sim", "--scene-len",
                         "8"], []),
        "cache_episodes": (eps, []),
        "cache_test_aggressive": (eps, ["test_aggressive=true"]),
        "render": (["--scenes", "2", "--scene-len", "8", "--render", "-e",
                    "rendered"], [])}[case]
    argv = ["sim", "--steps", "5", *argv, "--set", *TINY, *sets]
    jcli.main(argv)
    want = capsys.readouterr().out
    tcli.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == want
    (ja, jk), (ta, tk) = jc[0], tc[0]
    assert ta[0] == 0 and ta[2].to_dict() == ja[2].to_dict()
    for f in jsim.SceneTensors._fields:
        j, t = getattr(ja[1], f), getattr(ta[1], f)
        assert (j is None) == (t is None), f
        if j is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for k in ("max_steps", "record", "render_dir"):
        assert tk[k] == jk[k], k
    for k in ("t0", "stlp_override"):
        assert (tk[k] is None) == (jk[k] is None), k
        if jk[k] is not None:
            np.testing.assert_array_equal(tk[k], jk[k])
    n = len(ta[1].ego_full)
    if case == "cache_episodes":
        assert n == 3 and list(tk["t0"]) == [0, 6, 0]
    if case == "cache_test_aggressive":
        assert n == 3 and list(tk["t0"]) == [0, 0, 0]
        np.testing.assert_array_equal(tk["stlp_override"],
                                      tsim.TEST_AGGRESSIVE_STLPS)
    if case == "test_scenes":
        assert n == 25
    if case == "render":
        assert tk["record"] and tk["render_dir"] == "exps/rendered/viz"


# ---------------------------------------------------------------------------
# real runs on the CPU, and what is refused
# ---------------------------------------------------------------------------

def test_commands_run_on_the_cpu(workdir, cache, capsys):
    """Every command end to end at a tiny width with ``--device cpu``:
    finite output, the JSON keys of the JAX command line's."""
    dev = ["--device", "cpu"]
    tcli.main(["check", "--cache", cache, "--set", *SMALL, "batch_size=2",
               *dev])
    assert capsys.readouterr().out.splitlines()[-1].startswith("ACC:")
    tcli.main(["trajopt", "--cache", cache, "--out", "aug.npz", "--iters",
               "2", "--set", *SMALL, "batch_size=3", *dev])
    with np.load("aug.npz") as f:
        assert "params" in f.files and "tj_scores_prior" in f.files
    tcli.main(["train", "--preset", "e5_ddpm", "--cache", "aug.npz",
               "--epochs", "1", "--set", *SMALL, "hiddens=32,32",
               "diffusion_steps=4", "batch_size=1", "no_viz=true", *dev])
    assert os.path.exists("exps/e5_ddpm/torch_models/LAST")
    capsys.readouterr()
    tcli.main(["eval", "--cache", "aug.npz", "--trials", "0",
               "--ckpt", "exps/e5_ddpm/torch_models", "--set", *TINY,
               "sampling_size=2", "hiddens=32,32", *dev])
    ev = printed_json(capsys.readouterr().out)
    assert set(ev) == {f"{r}_{m}" for r in ("tj", "nn")
                       for m in teval.RUN_METRICS} | {"time"}
    tcli.main(["sim", "--scenes", "2", "--scene-len", "8", "--steps", "2",
               "--record", "--set", *TINY, *dev])
    res = printed_json(capsys.readouterr().out)
    assert set(res) == {"collide", "out_of_lane", "traj_len", "progress",
                        "stl_acc", "agent_steps", "repairs", "area"}
    for d in (ev, res):
        assert all(math.isfinite(v) for v in d.values())


def test_sim_short_cache_late_episodes_as_jax(workdir, cache, capsys):
    """The time-index trap: a ``--scene-len 10`` cache, episodes that start
    late (t0 9, clamped to 6) and more steps than the scenes hold.  JAX
    clamps its time windows (``dynamic_slice_in_dim``), torch.gather would
    raise; the store's tracks run nt + 2 frames past the scene length and
    the done rule stops an episode at length - 2, so neither package reads
    past a track: both run to the end, with the same keys and every episode
    within its frames."""
    argv = ["sim", "--cache", cache, "--episodes",
            _episodes(workdir / "eps.txt"), "--steps", "12",
            "--set", *TINY]
    with np.load(cache) as f:
        L_full, length = f["scene_ego_full"].shape[1], f["scene_len"]
    t0 = np.minimum([0, 9, 0], np.maximum(length[[0, 2, 1]] - 4, 0))
    assert (t0 + 1 + 20 <= L_full).all()
    jcli.main(argv)
    want = printed_json(capsys.readouterr().out)
    tcli.main(argv + ["--device", "cpu"])
    got = printed_json(capsys.readouterr().out)
    assert set(got) == set(want)
    bound = float(np.sum(length[[0, 2, 1]] - 2 - t0))
    for r in (got, want):
        assert 3 <= r["agent_steps"] <= bound
        assert all(math.isfinite(v) for v in r.values())


def test_ckpt_npz_loads_the_committed_weights():
    """``--ckpt x.npz`` loads the tensors ``convert.load_weights`` does."""
    cfg = bench_config("heavy")
    net = tcli._net(cfg, torch.device("cpu"), os.path.join(
        REPO, "pstl_tpu_torch", "weights", "e7_round5.npz"))
    ref = Net(cfg)
    convert.load_weights(ref, "e7_round5")
    got, want = net.state_dict(), ref.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_orbax_ckpt_raises_by_name(workdir, cache):
    with pytest.raises(ValueError, match="export_torch_weights"):
        tcli.main(["eval", "--cache", cache, "--ckpt",
                   os.path.join(REPO, "checkpoints", "e7_round5"), "--set",
                   *TINY, "--device", "cpu"])


def test_unported_commands_raise_by_name(workdir, cache, monkeypatch):
    """The two commands that raised until the extraction and ``parallel``
    were ported: without the devkit, ``data --real`` (and
    ``synthetic=false``) raises naming it, as the JAX command line does;
    ``train --mesh`` reaches ``train.train`` with a world-1 mesh."""
    with pytest.raises(RuntimeError, match="nuscenes-devkit"):
        tcli.main(["data", "--out", "x.npz", "--real"])
    with pytest.raises(RuntimeError, match="nuscenes-devkit"):
        tcli.main(["data", "--out", "x.npz", "--set", "synthetic=false"])
    tc = spy(monkeypatch, ttrain, "train")
    try:
        tcli.main(["train", "--cache", cache, "--mesh", "--set", *SMALL,
                   "--device", "cpu"])
    finally:
        torch.distributed.destroy_process_group()
    mesh = tc[0][1]["mesh"]
    assert mesh.mesh_dim_names == ("data",) and mesh.size(0) == 1


def test_commands_default_to_the_card(cache, monkeypatch):
    """Without ``--device`` a command runs on the card, and raises where
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["check", "--cache", cache],
                 ["sim", "--scenes", "1", "--set", *TINY]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)


def _rehearsal(tmp_path, monkeypatch):
    """chip_smoke.py on the CPU at a small size: the launch counts it
    expects read from the plain versions' calls (a wrapper runs its plain
    version for CPU tensors; the fused plain version calls the frozen one,
    which is not counted here), the device syncs and the device-only
    timers stubbed, its log collected.  Returns (chip_smoke, log lines)."""
    import chip_smoke as cs
    from pstl_tpu_torch import device as devmod
    from pstl_tpu_torch.ops import clearance_kernel as ck
    from pstl_tpu_torch.ops import guidance_kernel as gk

    calls = {}
    for mod, name, key in ((gk, "guidance_fused_plain", "guidance_fused"),
                           (ck, "min_clearance_fwd_plain",
                            "min_clearance_fwd"),
                           (ck, "min_clearance_bwd_plain",
                            "min_clearance_bwd")):
        def counted(*a, _real=getattr(mod, name), _key=key, **kw):
            calls[_key] = calls.get(_key, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    keys = ("guidance_fused", "guidance_frozen", "superstep",
            "superstep_guided", "min_clearance_fwd", "min_clearance_bwd")
    monkeypatch.setattr(cs, "reset_counts", calls.clear)
    monkeypatch.setattr(cs, "read_counts",
                        lambda: {k: calls.get(k, 0) for k in keys})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    for name, stub in (("profile_calls", lambda fn, n: (fn(), 0, 0.0, 1.0,
                                                        {})[1:]),
                       ("kernel_ms", lambda fn: (fn(), {"ms": 0.0,
                                                        "graph_ms": 0.0})[1]),
                       ("time_cuda", lambda fn, n=20, warm=3: (fn(), 0.0)[1])):
        monkeypatch.setattr(cs, name, stub)
    real = devmod.resolve_device
    monkeypatch.setattr(devmod, "resolve_device",
                        lambda device=None: real(device or "cpu"))
    for k, v in (("CLI_SCENES", 24), ("CLI_SIM_SCENES", 2),
                 ("CLI_SIM_STEPS", 2), ("CLI_TJ_ITERS", 2),
                 ("CLI_WORK", str(tmp_path / "cli_phase"))):
        monkeypatch.setattr(cs, k, v)
    lines = []
    monkeypatch.setattr(cs, "log", lines.append)
    return cs, lines


def test_chip_phase_rehearsed_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 33 at a small size on the CPU."""
    cs, lines = _rehearsal(tmp_path, monkeypatch)
    cs.cli_phase(torch.device("cpu"), "cpu", width=(
        "n_randoms=4", "batch_size=8", "sampling_size=4"))
    sim_line = [ln for ln in lines if "kernel 1 launched" in ln][0]
    assert "= 99 guided denoise steps x 2 steps of 2 scenes" in sim_line


def test_chip_phase_36_rehearsed_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 36 at a small size on the CPU, on phase 33's
    store: the tree against the bank and trajopt with each (a small
    e1_trajopt batch), the gt_nei=False step card-vs-CPU path and ``cli
    train`` with the clearance calls it must make, and the grad_rollout
    step and ``cli train``."""
    from pstl_tpu_torch.data.dataset import SceneDataset

    cs, lines = _rehearsal(tmp_path, monkeypatch)
    width = ("n_randoms=4", "batch_size=8")
    cs.cli_phase(torch.device("cpu"), "cpu", width=width + (
        "sampling_size=4",))
    real_e1 = cs.e1_config
    monkeypatch.setattr(cs, "e1_config", lambda **kw: real_e1(
        batch_size=8, n_randoms=4, **kw))
    for k, v in (("TREE_ITERS", 2), ("CV_EPOCHS", 2), ("GR_EPOCHS", 2),
                 ("DENSE_REF_SCENES", 2)):
        monkeypatch.setattr(cs, k, v)
    store = SceneDataset.from_synthetic(cs.e1_config(), n_scenes=8)
    store.ensure_random_params(0)
    cpu = torch.device("cpu")
    cs.tree_phase(cpu, store, "cpu")
    cv = cs.cv_phase(cpu, "cpu", width=width)
    cs.grad_rollout_phase(cpu, "cpu", width=width + ("diffusion_steps=6",))
    # 16 train and 8 val scenes of 24: two train batches and a val batch
    # an epoch, 2 epochs
    assert cv["fwd"][0] == 6 and cv["bwd"][0] == 4
    assert cv["fwd"][1] == 0.0 and cv["bwd"][1] == 0.0
    assert any("trajopt with the tree" in ln for ln in lines)
    assert any("cli train (grad_rollout): 4 steps" in ln for ln in lines)
