"""RDT-1B's diffusion transformer as the eps network of the port's planner
(``models/rdt.py``, ``Net(cfg, eps_net=RdtSpec(...))``) against the plain
reference of the benchmark (``perfbench/reference/rdt.py``), on seeded
weights that each side draws by its own code.

The CPU runs the tiny widths :data:`TINY` (D 64, 4 heads of 16, 4 blocks,
so that both condition streams recur); the published widths are built on
the meta device only, for the parameter count.

Tolerances, with their reasons:

- float32 against float32: 1e-5 of the output's norm.  The two compute
  RMSNorm, GELU, SiLU and the softmax by different formulas (a few ulps
  each; the program's attention is SDPA, the reference's an explicit
  softmax) and sum in other orders, through ~40 layers: about 1e-6 is
  what that leaves (4e-7 measured).
- the stated precision (bfloat16 operands, float32 accumulation) against
  the float32 reference: 3e-2 of the norm.  bfloat16 rounds to 8 bits (a
  relative 2e-3 to 4e-3 an operand) at every linear layer and attention
  product (0.6 % measured here); the control, float8 e4m3 operands, is
  held to lie beyond it (12 % measured here).
- gradients in float32: 1e-4 of each gradient's norm (a backward sums
  products of the forward's rounding once more).  What only a language
  block's cross-attention query and key norm read (``norm2``, ``q``, the
  QK-norm weights) gets none (a softmax over one key is 1): the
  reference's is exactly 0, the program's (through SDPA's backward)
  within 1e-6 of it, rounding.
- the candidate-minor layout against the row-major forward: 1e-5 of the
  norm in float32 (the layout folds a scene's rows into one query axis and
  builds the image stream once a scene, so attention and the adaptors sum
  over other batch shapes), and the captured chain against the eager one:
  to the bit.

Tests marked ``cuda`` repeat the comparisons at the published widths on
the card, with the real CUDA graph.  This file imports no jax.
"""

import dataclasses
import json
import os

import pytest
import torch

from perfbench.reference import rdt as ref
from perfbench.reference.port.config import Config as RConfig
from perfbench.reference.port.models import net as rnet
from perfbench.tests.sizes import TINY as TINY_RUN
from pstl_tpu_torch import diffusion, sim
from pstl_tpu_torch.config import Config
from pstl_tpu_torch.data import synthetic
from pstl_tpu_torch.models import net as N
from pstl_tpu_torch.models import rdt
from test_torch_chain_graph import _assert_equal_runs, _record_chain, \
    _standin, _steps
from test_torch_unet1d import _holding_standin

import torch_parity  # noqa: F401  (torch thread count)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"hidden_size": 64, "num_heads": 4, "depth": 4}
F32_TOL, BF16_TOL = 1e-5, 3e-2


def _conf():
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "ctg_rdt1b.json")) as f:
        return json.load(f)


def _fields(**kw):
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in _conf()["fields"].items()}
    fields.update(kw)
    return fields


def _spec(**kw):
    eps = _conf()["eps_net"]
    keys = [f.name for f in dataclasses.fields(rdt.RdtSpec)]
    return rdt.RdtSpec(**dict({k: eps[k] for k in keys}, **kw))


def _pair(widths=TINY, seed=5, **kw):
    """The program's net and the reference's frozen net with its RDT, both
    drawn from ``seed``: (cfg, net, reference net)."""
    fields = _fields(**kw)
    cfg = Config(**fields)
    spec = _spec(**widths)
    net = N.Net(cfg, eps_net=spec)
    N.init_seeded(net, torch.Generator().manual_seed(seed))
    r = ref.attach(rnet.Net(RConfig(**fields)), dataclasses.asdict(spec),
                   seed)
    return cfg, net, r


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


def _rows(n, bs, nt, seed=0, dev="cpu"):
    """Row-major inputs of ``n`` rows over ``bs`` scenes: the scenes'
    batch (ego and stlp rows), a feature (tiled a scene), highlevel,
    noise (n, nt, 2) and timesteps (n,)."""
    g = torch.Generator().manual_seed(seed)
    batch = {"ego_traj": torch.randn(bs, 5, 7, generator=g),
             "stlp_dense": torch.randn(n, 1, 6, generator=g)}
    feature = torch.randn(bs, 224, generator=g).repeat_interleave(n // bs, 0)
    hl = torch.randn(n, 1, generator=g)
    x = torch.randn(n, nt, 2, generator=g)
    t = torch.randint(1, 100, (n,), generator=g).float()
    move = lambda v: v.to(dev)
    return ({k: move(v) for k, v in batch.items()}, move(feature), move(hl),
            move(x), move(t))


def _ref_eps(r, batch, feature, hl, x, t, dt=torch.float32, dev="cpu"):
    """The reference on the same rows: every row its own condition."""
    n = x.shape[0]
    ego = ref.ego_inputs(batch).repeat_interleave(
        n // batch["ego_traj"].shape[0], 0)
    return ref.forward(r.rdt.on(dev), r.rdt.spec, x, t, ego,
                       torch.cat([hl, batch["stlp_dense"][:, 0]], -1),
                       feature.reshape(n, 7, 32), dt)


def _net_eps(net, batch, feature, hl, x, t):
    n = x.shape[0]
    return net(batch, {"timestep": t[:, None], "highlevel": hl,
                       "noise": x.reshape(n, -1)}, prev_feature=feature)


# --------------------------------------------------------------------------
# the network
# --------------------------------------------------------------------------

def test_seeded_weights_equal_the_references():
    """Every parameter by its published name, equal to the bit; the
    encoders too."""
    _, net, r = _pair()
    sd = net.eps_net.state_dict()
    assert set(sd) == set(r.rdt.params)
    for k, v in sd.items():
        assert torch.equal(v, r.rdt.params[k]), k
    for enc in ref.ref_unet.ENCODERS:
        for a, b in zip(getattr(net, enc).parameters(),
                        getattr(r, enc).parameters()):
            assert torch.equal(a, b), enc
    for name in ("model.blocks.3.attn.q_norm.weight",
                 "model.blocks.0.cross_attn.kv.bias",
                 "model.final_layer.ffn_final.fc2.weight",
                 "model.t_embedder.mlp.2.weight", "state_adaptor.4.weight",
                 "lang_adaptor.2.weight", "img_adaptor.0.weight"):
        assert name in sd
    # the departure: a drawn final layer
    assert sd["model.final_layer.ffn_final.fc2.weight"].abs().sum() > 0


def test_published_widths_on_the_meta_device():
    """At the published widths (built on the meta device, never run here):
    the configuration's parameter count, each of 28 blocks 41.97 M."""
    with torch.device("meta"):
        net = N.Net(Config(**_fields()), eps_net=_spec())
    head = net.eps_net
    assert sum(p.numel() for p in head.parameters()) \
        == _conf()["eps_net"]["parameters"] == 1_206_264_834
    assert sum(p.numel() for p in head.model.blocks[0].parameters()) \
        == 41_969_920
    assert len(head.model.blocks) == 28
    assert head.model.x_pos_embed.shape == (1, 23, 2048)


def test_meta_build_then_draw_equals_a_plain_build():
    """The benchmark builds the net on the meta device and draws it once:
    the same parameters as a CPU build drawn from the same seed."""
    cfg = Config(**_fields())
    with torch.device("meta"):
        a = N.Net(cfg, eps_net=_spec(**TINY))
    a.to_empty(device="cpu")
    N.init_seeded(a, torch.Generator().manual_seed(9))
    b = N.Net(cfg, eps_net=_spec(**TINY))
    N.init_seeded(b, torch.Generator().manual_seed(9))
    for (k, v), (_, w) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(v, w), k


@pytest.mark.parametrize("nt", [20, 8])
def test_forward_matches_reference(nt):
    _, net, r = _pair(nt=nt, compute_dtype="float32")
    _, netb, _ = _pair(nt=nt)
    batch, feature, hl, x, t = _rows(12, 2, nt)
    with torch.no_grad():
        want = _ref_eps(r, batch, feature, hl, x, t)
        f32 = _net_eps(net, batch, feature, hl, x, t)
        bf16 = _net_eps(netb, batch, feature, hl, x, t)
        fp8 = _ref_eps(r, batch, feature, hl, x, t, rnet.FP8)
    assert f32.shape == (12, nt, 2)
    assert _rel(f32, want) < F32_TOL
    assert _rel(bf16, want) < BF16_TOL
    # the tolerance is tight enough to fail the next precision down
    assert _rel(fp8, want) > BF16_TOL


def test_gradients_through_net_forward_match_reference():
    """The training path: ``Net.forward``'s diffusion head (row-major, the
    multi-candidate rows) in float32, its gradients to every RDT parameter
    and to the scene feature against autograd through the reference."""
    cfg, net, r = _pair(compute_dtype="float32")
    batch, feature, hl, x, t = _rows(12, 2, cfg.nt, seed=1)
    feature.requires_grad_(True)
    w_out = torch.randn(12, cfg.nt, 2,
                        generator=torch.Generator().manual_seed(2))
    eps = _net_eps(net, batch, feature, hl, x, t)
    (eps * w_out).sum().backward()
    r.rdt.params = {k: v.clone().requires_grad_(True)
                    for k, v in r.rdt.params.items()}
    f2 = feature.detach().clone().requires_grad_(True)
    e_ref = _ref_eps(r, batch, f2, hl, x, t)
    (e_ref * w_out).sum().backward()
    assert _rel(eps, e_ref) < F32_TOL
    assert _rel(feature.grad, f2.grad) < 1e-4
    for k, p in net.eps_net.named_parameters():
        g_ref = r.rdt.params[k].grad
        if not g_ref.any():
            # what only a language block's query and key norm read: a
            # softmax over its one key is 1
            assert int(k.split(".")[2]) % 2 == 0 and any(
                f".{m}." in k for m in ("norm2", "cross_attn.q",
                                        "cross_attn.q_norm",
                                        "cross_attn.k_norm")), k
            assert float(p.grad.abs().max()) < 1e-6, k
        else:
            assert _rel(p.grad, g_ref) < 1e-4, k


def _cm_case(cfg, bs, dev="cpu", seed=3):
    M, nt = cfg.n_randoms, cfg.nt
    n = bs * 3 * M
    batch, feature, hl, _, _ = _rows(n, bs, nt, seed=seed, dev=dev)
    x_cm = torch.randn(bs, nt, 2, 3 * M,
                       generator=torch.Generator().manual_seed(seed + 1))
    return batch, feature, hl, x_cm.to(dev)


def _cm_against_rows(net, cfg, batch, feature, hl, x_cm, t=37):
    """``make_cm_eps_fn``'s eps and the row-major forward's on the same
    candidates, in the candidate-minor layout."""
    bs, nt, _, R = x_cm.shape
    M, n = R // 3, bs * R
    # candidate r = j*M + m of scene b is row b*3M + m*3 + j
    x_rows = x_cm.reshape(bs, nt, 2, 3, M).permute(0, 4, 3, 1, 2).reshape(
        n, nt, 2)
    with torch.no_grad():
        eps_cm = N.make_cm_eps_fn(net, batch, hl, feature, cfg)
        got = eps_cm(x_cm, t)
        rows = _net_eps(net, batch, feature, hl, x_rows,
                        torch.full((n,), float(t), device=x_cm.device))
    want = rows.reshape(bs, M, 3, nt, 2).permute(0, 3, 4, 2, 1).reshape(
        bs, nt, 2, 3 * M)
    return eps_cm, got, want


def test_cm_layout_equals_rowmajor_forward():
    cfg, net, _ = _pair(n_randoms=4, compute_dtype="float32")
    batch, feature, hl, x_cm = _cm_case(cfg, 2)
    before = rdt.cond_builds
    eps_cm, got, want = _cm_against_rows(net, cfg, batch, feature, hl, x_cm)
    assert got.shape == want.shape and got.is_contiguous()
    assert _rel(got, want) < F32_TOL
    # built once a plan: the state and frequency tokens a scene, the
    # language K / V a row, the image K / V a scene, the mask
    assert rdt.cond_builds == before + 2
    n, H, hd = 24, 4, 16
    shapes = {k: tuple(v.shape) for k, v in eps_cm.inputs.items()}
    assert shapes == {"fixed": (2, 2, 64), "mask": (128,),
                      "lang_kv": (2, 2, n, H, 1, hd),
                      "img_kv": (2, 2, 2, H, 7, hd)}


def test_rdt_routes_raise():
    cfg = Config(**_fields())
    spec = _spec(**TINY)
    with pytest.raises(NotImplementedError, match="superstep"):
        N.Net(cfg.with_(guidance_pallas_superstep=True), eps_net=spec)
    with pytest.raises(NotImplementedError, match="use_init_hint"):
        N.Net(cfg.with_(use_init_hint=True), eps_net=spec)
    with pytest.raises(ValueError, match="adaptor inputs"):
        N.Net(cfg, eps_net=_spec(**TINY, img_in=64))
    with pytest.raises(ValueError, match="num_heads"):
        N.Net(cfg, eps_net=_spec(**dict(TINY, num_heads=5)))
    net = N.Net(cfg, eps_net=spec)
    n = 3 * cfg.n_randoms
    with pytest.raises(NotImplementedError, match="superstep"):
        N.make_cm_eps_fn(net, {"stlp_dense": torch.zeros(n, 1, 6)},
                         torch.zeros(n, 1), torch.zeros(n, 224),
                         cfg.with_(guidance_pallas_superstep=True))


def test_eps_weights_kept_while_the_parameters_stay():
    """The RDT's weight pieces (``N.eps_weights``; the chain's graph is
    keyed on them) come from the versioned cache: a repeat call gives the
    same object, an in-place write of a parameter a new one."""
    cfg = Config(**_fields())
    net = N.Net(cfg, eps_net=_spec(**TINY))
    with torch.no_grad():
        w = N.eps_weights(net, cfg)
        assert N.eps_weights(net, cfg) is w
        assert w.dt == torch.bfloat16
        next(net.eps_net.parameters()).add_(1.0)
        assert N.eps_weights(net, cfg) is not w


# --------------------------------------------------------------------------
# the closed loop and the chain's graph
# --------------------------------------------------------------------------

def _case(dev, bs, widths, seed=0, **kw):
    """A closed-loop step of ``ctg_rdt1b`` (fields ``kw`` set) with an RDT
    of ``widths`` on ``bs`` synthetic scenes: (cfg, init, step,
    noise(k))."""
    cfg = Config(**_fields(**kw))
    data = synthetic.generate_dataset(seed, bs, cfg, scene_len=14)
    scenes = sim.scenes_from_dataset(data, device=dev)
    net = N.Net(cfg, eps_net=_spec(**widths))
    N.init_seeded(net, torch.Generator().manual_seed(7))
    net = net.to(dev).eval()
    coeffs = diffusion.get_coeffs(cfg, dev)
    init, step = sim.make_closed_loop_step(scenes, cfg, net, coeffs,
                                           with_info=True)
    shape = ((diffusion.n_draws(cfg),)
             + tuple(diffusion.draw_layout(cfg, bs, 3 * cfg.n_randoms)))

    def noise(k):
        g = torch.Generator(device=dev).manual_seed(100 + k)
        return torch.randn(shape, generator=g, device=dev)
    return cfg, init, step, noise


def _graph_then_eager(monkeypatch, dev, bs, widths, **kw):
    """Three closed-loop steps with the chain's graph, then the same three
    eagerly: both runs, their chains, and the RDT's passes, rows and
    condition builds each counted."""
    chains = _record_chain(monkeypatch)
    cfg, init, step, noise = _case(dev, bs, widths, **kw)

    def counts():
        return rdt.calls, rdt.rows, rdt.cond_builds
    c0 = counts()
    graph = _steps(init, step, noise)
    counted = [tuple(b - a for a, b in zip(c0, counts()))]
    with_graph = list(chains)
    chains.clear()
    monkeypatch.setattr(diffusion, "_CAPTURE", {})
    c0 = counts()
    eager = _steps(init, step, noise)
    counted.append(tuple(b - a for a, b in zip(c0, counts())))
    return cfg, (graph, with_graph), (eager, list(chains)), counted


def test_standin_graph_equals_eager(monkeypatch):
    monkeypatch.setitem(diffusion._CAPTURE, "cpu", _standin)
    monkeypatch.setattr(diffusion, "chain_graph_captures", 0)
    monkeypatch.setattr(diffusion, "chain_graph_replays", 0)
    cfg, (graph, gch), (eager, ech), counted = _graph_then_eager(
        monkeypatch, "cpu", 2, TINY, **TINY_RUN["closed_loop"]["set"])
    assert (diffusion.chain_graph_captures,
            diffusion.chain_graph_replays) == (1, 2)
    calls = 3 * (cfg.diffusion_steps - 1)
    # the stand-in counts the passes of its re-runs; one build a plan
    assert counted[1] == (calls, calls * 2 * 3 * cfg.n_randoms, 3)
    assert counted[0][2] == 3
    assert not torch.equal(eager[1][1]["controls"], eager[2][1]["controls"])
    _assert_equal_runs(graph, eager, gch, ech)


def test_capture_holds_the_counters_the_eps_function_names(monkeypatch):
    """The chain's graph holds the RDT's passes and rows because its eps
    function names them (``counters``): a replay adds what the capture
    held; the condition build runs outside the graph, once a plan."""
    assert not hasattr(diffusion, "rdt")
    monkeypatch.setitem(diffusion._CAPTURE, "cpu", _holding_standin)
    cfg, (graph, gch), (eager, ech), counted = _graph_then_eager(
        monkeypatch, "cpu", 2, TINY, **TINY_RUN["closed_loop"]["set"])
    calls = 3 * (cfg.diffusion_steps - 1)
    assert counted == [(calls, calls * 2 * 3 * cfg.n_randoms, 3)] * 2
    _assert_equal_runs(graph, eager, gch, ech)


# --------------------------------------------------------------------------
# the card: published widths, the real graph
# --------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the published widths and the "
                    "CUDA graph run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_full_width_forward_on_the_card(dev):
    """The cell's 192 rows (one scene): the stated precision within its
    tolerance of the float32 reference, the control beyond it; the
    candidate-minor layout within it of the row-major forward."""
    cfg, net, r = _pair({})
    net = net.to(dev)
    batch, feature, hl, x, t = _rows(192, 1, cfg.nt, dev=dev)
    with torch.no_grad():
        want = _ref_eps(r, batch, feature, hl, x, t, dev=dev)
        got = _net_eps(net, batch, feature, hl, x, t)
        fp8 = _ref_eps(r, batch, feature, hl, x, t, rnet.FP8, dev=dev)
    print("bf16", _rel(got, want), "fp8", _rel(fp8, want))
    assert _rel(got, want) < BF16_TOL < _rel(fp8, want)
    _, got_cm, want_cm = _cm_against_rows(net, cfg, *_cm_case(cfg, 1, dev))
    print("cm against rows", _rel(got_cm, want_cm))
    assert _rel(got_cm, want_cm) < BF16_TOL


@pytest.mark.cuda
def test_graph_equals_eager_on_the_card(dev, monkeypatch):
    cfg, (graph, gch), (eager, ech), counted = _graph_then_eager(
        monkeypatch, dev, 1, {})
    torch.cuda.synchronize(dev)
    # the first plan's eager run before the capture, then one replay a
    # plan: as many passes as the eager loop's; one condition build a plan
    calls = 3 * (cfg.diffusion_steps - 1)
    assert counted == [(calls, calls * 3 * cfg.n_randoms, 3)] * 2
    assert not torch.equal(eager[1][1]["controls"], eager[2][1]["controls"])
    _assert_equal_runs(graph, eager, gch, ech)
