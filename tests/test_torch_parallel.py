"""The port's parallel layer (``pstl_tpu_torch.parallel``) on the CPU: every
test of ``tests/test_parallel.py`` that the mesh basics and the training
need, and the data-parallel train step against the one-process step and
the JAX step.

Two ranks of a gloo group run in processes of ``tests/torch_parallel_case.py``
(one run for the file); the one-process port and the JAX package run here.

Tolerances.  A sharded step computes what the unsharded step computes,
but its sums run over each rank's rows and then over the ranks, so they
round differently: metrics are held to rtol 1e-5 and the averaged
gradients to rtol 1e-4 with a floor of 1e-6 of each tensor's largest entry
(``torch_mono_case.check_close``, the dense tests' fp32 bounds), and the
parameters after the step to ``check_params``' bounds against the JAX
step (within 2*lr everywhere, 0.01*lr where the gradient stood above
1e-6 of its tensor's largest entry).  Every rank holds the same
parameters after the step, to the bit.  The world-1 mesh makes no
collective, so ``cli train --mesh`` there equals ``cli train`` to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pstl_tpu import diffusion as jdiff, specs as jspecs, train as jtrain
from pstl_tpu_torch import cli, diffusion as tdiff, parallel
from pstl_tpu_torch import specs as tspecs, train as ttrain
from pstl_tpu_torch.config import Config as TConfig, mono_config
from pstl_tpu_torch.models.net import Net as TNet

import torch_dense_case as tdc
import torch_mono_case as tmc
from torch_parallel_case import run_ranks

WORLD = 2
#: the train step's scenes (divisible by WORLD)
BS = 4


def _jax_step(cfg, jnet, params, batch, key, opts=None):
    """One JAX train step from fresh Adam state: (metrics, params)."""
    jopt = jtrain.make_optimizer(cfg, params)
    st = jtrain.TrainState(params, jopt.init(params),
                           jnp.zeros((), jnp.int32))
    step = jtrain.make_train_step(cfg, jnet, jspecs.build_scorer(cfg),
                                  jdiff.get_coeffs(cfg), jopt)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if opts:
        st2, rd = tdc.jit_fast(step, st, jb, key)
    else:
        st2, rd = step(st, jb, key)
    return {k: float(v) for k, v in rd.items()}, st2.params


def _one_process(tcfg, state, batch, draws):
    """The port's one-process step: (metrics, gradients)."""
    net = TNet(tcfg)
    net.load_state_dict(state)
    step = ttrain.make_train_step(tcfg, net, tspecs.build_scorer(tcfg),
                                  tdiff.get_coeffs(tcfg),
                                  ttrain.make_optimizer(tcfg, net))
    rd = step(ttrain.to_device(batch, "cpu"), draws=draws)
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in net.named_parameters()}
    return {k: float(v) for k, v in rd.items()}, grads


def e7_case():
    """e7_ours (torch_dense_case's scenes and weights) at BS scenes, fp32,
    the JAX step's draws."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tdc.SMALL, "batch_size", BS)
        tdc.small_sampler_noise(mp)
        cfg, batches, jnet, jparams = tdc.setup("e7_ours",
                                                compute_dtype="float32")
        key = jax.random.PRNGKey(11)
        jrd, jp = _jax_step(cfg, jnet, jparams, batches[0], key,
                            tdc.JAX_OPTS)
    return (cfg, batches[0], tdc.jax_draws(cfg, key, BS),
            tdc.torch_net(cfg, jparams).state_dict(), jrd, jp)


def e2_case():
    """e2_vae_mono with stl_weight 1 (the clearance VJP carries a nonzero
    cotangent; its plain versions here), torch_mono_case's size."""
    cfg, batches, jnet, jstate = tmc.setup("e2_vae_mono",
                                           compute_dtype="float32",
                                           stl_weight=1.0)
    key = jax.random.PRNGKey(11)
    jrd, jp = _jax_step(cfg, jnet, jstate.params, batches[0], key)
    net = TNet(TConfig(**cfg.to_dict()))
    from pstl_tpu_torch.models import convert
    net.load_state_dict(convert.from_flax(jax.device_get(jstate.params)))
    return (cfg, batches[0], tmc.jax_draws(cfg, key, cfg.batch_size),
            net.state_dict(), jrd, jp)


#: a small mono train loop: 12 scenes, batches of 4 (two train batches)
LOOP_CFG = mono_config("e2_vae_mono", hiddens=(32, 32), vae_dim=8,
                       n_randoms=4, batch_size=4, n_neighbors=3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on two ranks (one run), with the references."""
    steps = {"e7": e7_case(), "e2": e2_case()}
    cases = [("basics", {})]
    for cfg, batch, draws, state, _, _ in steps.values():
        cases.append(("train_step", dict(
            cfg=TConfig(**cfg.to_dict()).to_dict(), state=state,
            batch=batch, draws=draws)))
    cases.append(("train_loop", dict(cfg=LOOP_CFG.to_dict(), scenes=12,
                                     epochs=1)))
    outs, wall = run_ranks(cases, tmp_path_factory.mktemp("ranks"), WORLD)
    print(f"two gloo ranks: {wall:.1f} s")
    return steps, outs


@pytest.fixture(autouse=True, scope="module")
def no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# test_parallel.py's cases
# ---------------------------------------------------------------------------

def test_init_multihost_noop_without_env(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    was = dist.is_initialized()
    assert parallel.init_multihost(device="cpu") == 0
    assert dist.is_initialized() == was


def test_local_rows_single_process():
    assert parallel.local_rows(64) == slice(0, 64)


def test_make_mesh_infers_size(runs):
    mesh = parallel.make_mesh((-1,), ("data",), device_type="cpu")
    assert mesh.size(0) == 1
    assert [o[0]["size"] for o in runs[1]] == [WORLD, WORLD]
    with pytest.raises(ValueError, match="does not cover"):
        parallel.make_mesh((3,), ("data",), device_type="cpu")


def test_shard_batch_splits_leading_axis(runs):
    """(16, 4) splits into 8 rows a rank in rank order; (3,) (indivisible)
    is kept whole on both; in one process nothing is split."""
    full = np.arange(64, dtype=np.float32).reshape(16, 4)
    for r, o in enumerate(runs[1]):
        np.testing.assert_array_equal(o[0]["a"], full[8 * r:8 * r + 8])
        np.testing.assert_array_equal(o[0]["b"], np.ones(3, np.float32))
    mesh = parallel.make_mesh(device_type="cpu")
    one = parallel.shard_batch({"a": full, "n": None}, mesh)
    np.testing.assert_array_equal(one["a"], full)
    assert one["n"] is None


def test_replicated_params_math(runs):
    """mean(x @ w) over the sharded rows with w replicated: 8.0."""
    for o in runs[1]:
        assert o[0]["replicated_mean"] == 8.0


def test_global_batch_from_local(runs):
    """One process: the rows as tensors.  Two: each rank's local_rows(16)
    are its equal shard, and unequal shards raise by name."""
    mesh = parallel.make_mesh(device_type="cpu")
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    out = parallel.global_batch_from_local({"x": x}, mesh)
    np.testing.assert_array_equal(out["x"].numpy(), x)
    for r, o in enumerate(runs[1]):
        assert o[0]["rows"] == (8 * r, 8 * r + 8)
        assert "unequal shards" in o[0]["unequal"]


def test_two_process_global_batch(runs):
    """The global mean of arange(64).reshape(16, 4) from two ranks' halves
    reads 31.5 on both."""
    assert [o[0]["global_mean"] for o in runs[1]] == [31.5, 31.5]


def test_sharded_draw_and_count(runs):
    """Inside a data sharding a rank's draw is its rows of the whole draw,
    and the mean of per-rank means is the whole batch's."""
    whole = torch.randn((8, 5), generator=torch.Generator().manual_seed(3))
    for r, o in enumerate(runs[1]):
        assert torch.equal(o[0]["draw"], whole[4 * r:4 * r + 4])
        assert o[0]["mask_mean"] == 6.5


# ---------------------------------------------------------------------------
# the data-parallel train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset,i", [("e7", 1), ("e2", 2)])
def test_two_process_full_train_step(runs, preset, i):
    """One train step on two ranks (each half the batch, the gradients
    averaged) against the port's one-process step and the JAX step on the
    same weights, batch and draws; both ranks end with the same
    parameters."""
    steps, outs = runs
    cfg, batch, draws, state, jrd, jparams = steps[preset]
    tcfg = TConfig(**cfg.to_dict())
    rd1, g1 = _one_process(tcfg, state, batch, draws)
    r0, r1 = outs[0][i], outs[1][i]
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
    assert r0["metrics"] == r1["metrics"]
    assert sorted(r0["metrics"]) == sorted(rd1) == sorted(jrd)
    for k in rd1:
        tmc.check_close(r0["metrics"][k], rd1[k], False, f"one-process {k}")
        tmc.check_close(r0["metrics"][k], jrd[k], False, f"jax {k}")
    for k, g in g1.items():
        tmc.check_close(r0["grads"][k], g, False, f"grad {k}", rtol=1e-4)
    floor = {k: g.abs() > 1e-6 * g.abs().max() for k, g in g1.items()}
    net = TNet(tcfg)
    net.load_state_dict(r0["state"])
    tmc.check_params(net, jparams, floor, cfg.lr, 1, False,
                     f"{preset} params after the sharded step")


def test_train_loop_under_mesh(runs):
    """``train.train(mesh=...)`` on two ranks against the one-process loop:
    the first train batch's metrics to rtol 1e-5; every later batch starts
    from parameters that may differ by up to 2*lr a step (Adam on
    gradients at rounding noise), so its metrics are held to the dense
    tests' second-step rtol 1e-3 / atol 1e-6, and the parameters after the
    epoch to 2*lr a train step."""
    hist = []
    ds = ttrain.SceneDataset.from_synthetic(LOOP_CFG, n_scenes=12)
    state = ttrain.train(LOOP_CFG, ds, epochs=1, device="cpu", history=hist,
                         log=lambda *_: None)
    got = runs[1][0][3]
    assert [(e, m) for e, m, _ in got["history"]] == \
        [(e, m) for e, m, _ in hist]
    for i, ((_, _, a), (_, _, b)) in enumerate(zip(got["history"], hist)):
        assert sorted(a) == sorted(b)
        for k in b:
            if i == 0:
                tmc.check_close(a[k], b[k], False, k)
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-3, atol=1e-6,
                                           err_msg=f"batch {i} {k}")
    n_train = sum(m == "train" for _, m, _ in hist)
    for k, v in state.net.state_dict().items():
        d = float((got["state"][k] - v).abs().max())
        assert d <= 2 * LOOP_CFG.lr * n_train, (k, d)


def test_cli_train_mesh_world1_equals_train(tmp_path, monkeypatch):
    """``cli train --mesh`` in one process (a world-1 mesh) runs the same
    epoch as ``cli train``, metric for metric and parameter for parameter,
    to the bit."""
    monkeypatch.chdir(tmp_path)
    real = ttrain.train
    runs = []

    def recorded(*a, **kw):
        hist = []
        state = real(*a, history=hist, **kw)
        runs.append((kw.get("mesh"), hist, state.net.state_dict()))
        return state

    monkeypatch.setattr(ttrain, "train", recorded)
    argv = ["train", "--preset", "e2_vae_mono", "--epochs", "1", "--device",
            "cpu", "--set", "hiddens=32,32", "vae_dim=8", "n_randoms=4",
            "batch_size=4", "n_neighbors=3", "use_pallas_clearance=true",
            "exp_name=none"]
    cli.main(argv)
    cli.main(argv + ["--mesh"])
    (m0, h0, s0), (m1, h1, s1) = runs
    assert m0 is None and m1.size(0) == 1
    assert len(h0) > 0 and h1 == h0
    for k in s0:
        assert torch.equal(s1[k], s0[k]), k
