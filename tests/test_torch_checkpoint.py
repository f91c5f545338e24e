"""Checkpoints and the warm start of the port's training: save -> load ->
resume equals the uninterrupted run bit for bit on the CPU (parameters,
Adam moments, step count; e5 with every parameter in the optimizer, e7 with
the RefineNet head only); ``load_params_only`` from a port checkpoint and
from a flat ``.npz``, keeping a head the source lacks; the committed
``e5b_round5.npz`` against the orbax checkpoint; ``train.train`` on
``e7_ours`` warm-started from it, writing under
``exps/<exp_name>/torch_models``; the meters and the experiment directory
against ``pstl_tpu.utils``."""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from pstl_tpu.utils import meters as jmeters
from pstl_tpu_torch import diffusion, specs, train
from pstl_tpu_torch.config import PRESETS
from pstl_tpu_torch.data.dataset import SceneDataset, batch_iterator
from pstl_tpu_torch.models import convert
from pstl_tpu_torch.models.net import Net, init_flax_like
from pstl_tpu_torch.utils import exp as texp, meters as tmeters

from chip_smoke import dense_draws
import torch_parity  # noqa: F401  (torch thread count)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E5B = os.path.join(convert.WEIGHTS_DIR, "e5b_round5.npz")
# hiddens stay at the presets' (256, 256), the width of the e5b base
SMALL = dict(exp_name=None, rect_hiddens=(32, 32), n_randoms=4, n_shards=2,
             diffusion_steps=8, batch_size=2, n_neighbors=3, print_freq=1)


def fresh(cfg, seed):
    net = Net(cfg)
    init_flax_like(net, torch.Generator().manual_seed(seed))
    return train.TrainState(net, train.make_optimizer(cfg, net), 0)


def step_fn(cfg, state):
    return train.make_train_step(cfg, state.net, specs.build_scorer(cfg),
                                 diffusion.get_coeffs(cfg), state.opt)


def assert_same_state(a, b):
    for (k, x), y in zip(a.net.state_dict().items(),
                         b.net.state_dict().values()):
        assert torch.equal(x, y), k
    pa = a.opt.param_groups[0]["params"]
    pb = b.opt.param_groups[0]["params"]
    assert len(pa) == len(pb)
    for x, y in zip(pa, pb):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a.opt.state[x][key], b.opt.state[y][key]), key


@pytest.mark.parametrize("preset", ["e5_ddpm", "e7_ours"])
def test_save_load_resume_is_bit_identical(preset, tmp_path):
    cfg = PRESETS[preset].with_(**SMALL, hiddens=(32, 32))
    ds = SceneDataset.from_synthetic(cfg, n_scenes=12)
    ds.ensure_random_params(cfg.seed)
    batches = [train.to_device(b, "cpu") for b in batch_iterator(
        ds, "train", cfg.batch_size, shuffle=False)][:3]
    draws = [dense_draws(cfg, cfg.batch_size, 20 + i) for i in range(3)]
    a = fresh(cfg, 0)
    step = step_fn(cfg, a)
    for b, d in zip(batches, draws):
        step(b, draws=d)
    a = a._replace(step=3)
    b_state = fresh(cfg, 0)
    step = step_fn(cfg, b_state)
    for b, d in zip(batches[:2], draws[:2]):
        step(b, draws=d)
    path = train.save_checkpoint(str(tmp_path / "ck"), b_state._replace(
        step=2), 1)
    assert os.path.basename(path) == "step_00000001.pt"
    with open(tmp_path / "ck" / "LAST") as f:
        assert f.read() == path
    c = train.load_checkpoint(str(tmp_path / "ck"), fresh(cfg, 7))
    assert c.step == 2
    assert_same_state(b_state, c)
    step_fn(cfg, c)(batches[2], draws=draws[2])
    assert_same_state(a, c)
    # the LAST pointer still resolves once the directory has moved
    os.rename(tmp_path / "ck", tmp_path / "moved")
    assert train.load_checkpoint(str(tmp_path / "moved"),
                                 fresh(cfg, 8)).step == 2


def test_load_params_only(tmp_path):
    """From the e5b npz into an e7 net: the base's four modules are the
    file's, the RefineNet head keeps its init; from a port checkpoint:
    everything it holds; a module short of a tensor is refused."""
    cfg = PRESETS["e7_ours"].with_(**SMALL)
    st = fresh(cfg, 0)
    head = {k: v.clone() for k, v in st.net.state_dict().items()
            if k.split(".")[0] in train.RECT_MODULES}
    train.load_params_only(E5B, st)
    src = convert.load_npz(E5B)
    assert {k.split(".")[0] for k in src} == {
        "ego_encoder", "neighbor_encoder", "lane_encoder", "policy_net"}
    for k, v in st.net.state_dict().items():
        assert torch.equal(v, head[k] if k in head else src[k]), k
    train.save_checkpoint(str(tmp_path), st, 0)
    other = train.load_params_only(str(tmp_path), fresh(cfg, 1))
    assert_same = [torch.equal(x, y) for x, y in zip(
        st.net.state_dict().values(), other.net.state_dict().values())]
    assert all(assert_same)
    torch.save({"params": {"rect_net.layers.0.weight": torch.zeros(1)}},
               tmp_path / "bad.pt")
    with pytest.raises(KeyError, match="rect_net"):
        train.load_params_only(str(tmp_path / "bad.pt"), fresh(cfg, 2))


def test_committed_e5b_weights_equal_checkpoint():
    """pstl_tpu_torch/weights/e5b_round5.npz is bit for bit the orbax
    checkpoint's own params (no RefineNet head), and loads into the e5
    net of the preset strictly."""
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights",
        os.path.join(REPO, "scripts", "export_torch_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    flat = mod.flat_params(jax.tree_util.tree_map(np.asarray, mod.restore_own(
        os.path.join(REPO, "checkpoints", "e5b_round5"))))
    with np.load(E5B) as f:
        assert sorted(f.files) == sorted(flat)
        for k in f.files:
            assert f[k].dtype == np.float32
            np.testing.assert_array_equal(f[k], flat[k], err_msg=k)
    convert.load_weights(Net(PRESETS["e5_ddpm"]), "e5b_round5")


def test_train_e7_warm_start_writes_a_checkpoint(tmp_path, monkeypatch):
    """``train.train`` on e7_ours warm-started from the e5b base, end to
    end: checkpoints at epoch 0 (save_freq) and at the last, that
    ``load_checkpoint`` resumes; only the RefineNet head moved."""
    monkeypatch.chdir(tmp_path)
    cfg = PRESETS["e7_ours"].with_(**dict(SMALL, exp_name="e7_tiny"),
                                   no_viz=True, net_pretrained_path=E5B)
    ds = SceneDataset.from_synthetic(cfg, n_scenes=10)
    seen = []
    state = train.train(cfg, ds, epochs=2, device="cpu", log=lambda s: None,
                        epoch_cb=lambda epi, st: seen.append((epi, st.step)))
    n_train = ds.split_len("train") // cfg.batch_size
    assert seen == [(0, n_train), (1, 2 * n_train)]
    root = os.path.join("exps", "e7_tiny")
    models = os.path.join(root, texp.MODELS_DIR)
    assert sorted(os.listdir(models)) == ["LAST", "step_00000000.pt",
                                          "step_00000001.pt"]
    assert os.path.exists(os.path.join(root, "config.json"))
    resumed = train.load_checkpoint(models, fresh(cfg, 3))
    assert resumed.step == state.step == 2 * n_train
    assert_same_state(state, resumed)
    src = convert.load_npz(E5B)
    for k, v in state.net.state_dict().items():
        if k in src:
            assert torch.equal(v.cpu(), src[k]), k


def test_experiment_directory_refusals(tmp_path, monkeypatch):
    """An orbax experiment directory of the JAX package is refused by name
    as pretrained weights; an experiment of the port with its viz on
    writes its checkpoint and its epoch figures."""
    monkeypatch.chdir(tmp_path)
    cfg = PRESETS["e7_ours"].with_(**dict(SMALL, exp_name="x"), num_viz=2)
    ds = SceneDataset.from_synthetic(cfg, n_scenes=6)
    with pytest.raises(ValueError, match="export_torch_weights"):
        train.train(cfg.with_(net_pretrained_path=os.path.join(
            REPO, "checkpoints", "e7_round5")), ds, device="cpu")
    train.train(cfg, ds, epochs=1, device="cpu", log=lambda s: None)
    assert sorted(os.listdir(os.path.join("exps", "x", "viz"))) == [
        "epoch0000_scene00.png", "epoch0000_scene01.png"]
    assert os.path.exists(os.path.join("exps", "x", texp.MODELS_DIR,
                                       "LAST"))


def test_meters_match_jax():
    a, b = tmeters.MeterDict(), jmeters.MeterDict()
    for k, v, n in (("loss", 1.5, 1), ("acc", 0.25, 3), ("loss", 0.5, 2)):
        a.update(k, v, n)
        b.update(k, v, n)
    assert a.summary() == b.summary() and a("loss") == b("loss")
    assert "acc" in a and a["acc"] == b["acc"]
    ea, eb = tmeters.EtaEstimator(5, 10, 3, 2), jmeters.EtaEstimator(5, 10,
                                                                     3, 2)
    for e in (ea, eb):
        e.update("train", 4.0, 10)
        e.update("val", 1.5, 3)
        e.update("viz", 2.0)
        e.epoch_done()
    assert ea.eta_seconds() == eb.eta_seconds() and ea.eta_str() == \
        eb.eta_str()
    t = tmeters.Timer()
    t.add("data")
    t.add("step")
    assert t.report().startswith("data->step:")


def test_setup_exp_dir(tmp_path, capsys):
    cfg = PRESETS["e7_ours"].with_(exp_name="d")
    full = texp.setup_exp_dir(cfg, root=str(tmp_path), tee=False)
    assert sorted(os.listdir(full)) == ["cmd.txt", "config.json", "src",
                                        texp.MODELS_DIR, "viz"]
    assert os.path.exists(os.path.join(full, "src", "pstl_tpu_torch",
                                       "train.py"))
    log = tmp_path / "log.txt"
    tee = texp.TeeLogger(str(log))
    tee.write("line\n")
    tee.flush()
    assert log.read_text() == "line\n" and "line" in capsys.readouterr().out
