"""ConditionalUnet1D as the eps network of the port's planner
(``models/unet1d.py``, ``Net(cfg, eps_net=spec)``) against the plain
reference of the benchmark (``perfbench/reference/unet1d.py``), on seeded
weights that each side draws by its own code.

Tolerances, with their reasons:

- float32 against float32: 1e-5 of the output's norm.  The two compute
  Mish, GroupNorm and the step embedding by different formulas (a few
  ulps each) and sum convolutions in other orders, through about 40
  layers: about 1e-6 is what that leaves (7e-7 measured).
- the stated precision (bfloat16 operands, float32 accumulation) against
  the float32 reference: 3e-2 of the norm.  bfloat16 rounds to 8 bits (a
  relative 2e-3 to 4e-3 an operand) at every one of the ~45 convolution
  and linear layers (0.6-1.3 % measured); the control, float8 e4m3
  operands, is held to lie beyond it.
- the candidate-minor layout against the row-major forward, and the
  captured chain against the eager one: to the bit where the same
  kernels see the same rows (the chain), else within bfloat16's rounding
  of one operand (the step encoder runs on one row in the chain and on
  every row in the forward, so its matmul may sum in another order).

- the activation pass between two convolutions (``ops/unet1d_norm``):
  its plain version against PyTorch's composition (``F.group_norm``,
  ``F.mish``, then the FiLM or the residual sum) in float32: 1e-5 of
  each output's largest element (the two take the group statistics and
  Mish by other formulas and orders; a few ulps).  The kernel against the
  plain version on the card (bfloat16 in and out): all but a 1 % share
  of the elements equal to the bit, and every element within one
  bfloat16 step (2^-7 of its size, plus 1e-5): the two sum the groups in
  other orders and the card contracts to FMAs, so the float32 values
  before the last rounding differ by a few ulps, which flips that
  rounding where it falls near a boundary.  The float32 residual stream
  and the float32 route: 1e-5 of each element's size, plus 1e-5.

Tests marked ``cuda`` repeat the comparisons at the published widths on
the card, with the real CUDA graph.  This file imports no jax.
"""

import dataclasses
import json
import os

import pytest
import torch
import torch.nn.functional as F

from perfbench.reference import unet1d as ref
from perfbench.reference.port.config import Config as RConfig
from perfbench.reference.port.models import net as rnet
from perfbench.tests.sizes import TINY
from pstl_tpu_torch import diffusion, sim
from pstl_tpu_torch.config import Config
from pstl_tpu_torch.data import synthetic
from pstl_tpu_torch.models import net as N
from pstl_tpu_torch.models import unet1d
from pstl_tpu_torch.ops import unet1d_norm
from test_torch_chain_graph import _assert_equal_runs, _record_chain, \
    _standin, _steps

import torch_parity  # noqa: F401  (torch thread count)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_DIMS = (16, 32, 64)
FULL_DIMS = (256, 512, 1024)
F32_TOL, BF16_TOL = 1e-5, 3e-2


def _conf():
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "ctg_unet1d.json")) as f:
        return json.load(f)


def _fields(**kw):
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in _conf()["fields"].items()}
    fields.update(kw)
    return fields


def _spec(dims):
    eps = _conf()["eps_net"]
    return unet1d.UnetSpec(**{k: eps[k] for k in (
        "kernel_size", "n_groups", "step_embed_dim", "cond_predict_scale")},
        down_dims=dims)


def _pair(dims, seed=5, **kw):
    """The program's net and the reference's frozen net with its U-Net,
    both drawn from ``seed``: (cfg, net, reference net)."""
    fields = _fields(**kw)
    cfg = Config(**fields)
    spec = _spec(dims)
    net = N.Net(cfg, eps_net=spec)
    N.init_seeded(net, torch.Generator().manual_seed(seed))
    r = ref.attach(rnet.Net(RConfig(**fields)), dataclasses.asdict(spec),
                   seed)
    return cfg, net, r


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


def _inputs(n, nt, seed=0, dev="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, 2, nt, generator=g)
    t = torch.randint(1, 100, (n,), generator=g).float()
    c = torch.randn(n, 231, generator=g)
    return x.to(dev), t.to(dev), c.to(dev)


# --------------------------------------------------------------------------
# the network
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [TINY_DIMS, FULL_DIMS],
                         ids=["tiny", "full"])
def test_seeded_weights_equal_the_references(dims):
    _, net, r = _pair(dims)
    sd = net.eps_net.state_dict()
    assert set(sd) == set(r.unet.params)
    for k, v in sd.items():
        assert torch.equal(v, r.unet.params[k]), k
    for enc in ref.ENCODERS:
        for a, b in zip(getattr(net, enc).parameters(),
                        getattr(r, enc).parameters()):
            assert torch.equal(a, b), enc
    if dims == FULL_DIMS:
        assert sum(p.numel() for p in net.eps_net.parameters()) \
            == _conf()["eps_net"]["parameters"]


@pytest.mark.parametrize("dims,nt", [(TINY_DIMS, 20), (TINY_DIMS, 8),
                                     (FULL_DIMS, 20), (FULL_DIMS, 8)],
                         ids=["tiny-nt20", "tiny-nt8", "full-nt20",
                              "full-nt8"])
def test_forward_matches_reference(dims, nt):
    _, net, r = _pair(dims)
    spec = r.unet.spec
    x, t, c = _inputs(8, nt)
    with torch.no_grad():
        want = ref.forward(r.unet.params, spec, x, t, c)
        f32 = unet1d.forward(net.eps_net, unet1d.unet_weights(
            net.eps_net, torch.float32), x, t, c)
        bf16 = unet1d.forward(net.eps_net, unet1d.unet_weights(
            net.eps_net, torch.bfloat16), x, t, c)
        fp8 = ref.forward(r.unet.params, spec, x, t, c, rnet.FP8)
    assert f32.shape == (8, 2, nt)
    assert _rel(f32, want) < F32_TOL
    assert _rel(bf16, want) < BF16_TOL
    # the tolerance is tight enough to fail the next precision down
    assert _rel(fp8, want) > BF16_TOL


def test_gradients_through_net_forward_match_reference():
    """The training path: ``Net.forward``'s diffusion head (row-major, the
    multi-candidate rows) in float32, its gradients to every U-Net
    parameter and to the scene feature against autograd through the
    reference."""
    cfg, net, r = _pair(TINY_DIMS, compute_dtype="float32")
    n, nt = 12, cfg.nt
    x, t, _ = _inputs(n, nt, seed=1)
    g = torch.Generator().manual_seed(2)
    feature = torch.randn(n, 224, generator=g, requires_grad=True)
    hl = torch.randn(n, 1, generator=g)
    stlp = torch.randn(n, 1, 6, generator=g)
    w_out = torch.randn(n, nt, 2, generator=g)
    ext = {"timestep": t[:, None], "highlevel": hl,
           "noise": x.transpose(1, 2).reshape(n, nt * 2)}
    eps = net({"stlp_dense": stlp}, ext, prev_feature=feature)
    (eps * w_out).sum().backward()
    params = {k: v.clone().requires_grad_(True)
              for k, v in r.unet.params.items()}
    f2 = feature.detach().clone().requires_grad_(True)
    e_ref = ref.forward(params, r.unet.spec, x, t,
                        ref.condition(f2, hl, stlp[:, 0]))
    (e_ref.transpose(1, 2) * w_out).sum().backward()
    assert _rel(eps, e_ref.transpose(1, 2)) < F32_TOL
    assert _rel(feature.grad, f2.grad) < F32_TOL
    for k, p in net.eps_net.named_parameters():
        assert _rel(p.grad, params[k].grad) < 1e-4, k


def test_cm_layout_equals_rowmajor_forward():
    cfg, net, _ = _pair(TINY_DIMS, n_randoms=4)
    bs, M, nt = 2, cfg.n_randoms, cfg.nt
    n = bs * M * 3
    g = torch.Generator().manual_seed(3)
    feature = torch.randn(n, 224, generator=g)
    hl = torch.randn(n, 1, generator=g)
    stlp = torch.randn(n, 1, 6, generator=g)
    x_cm = torch.randn(bs, nt, 2, 3 * M, generator=g)
    # candidate r = j*M + m of scene b is row b*3M + m*3 + j
    x_rows = x_cm.reshape(bs, nt, 2, 3, M).permute(0, 4, 3, 1, 2).reshape(
        n, nt * 2)
    with torch.no_grad():
        eps_cm = N.make_cm_eps_fn(net, {"stlp_dense": stlp}, hl, feature,
                                  cfg)
        got = eps_cm(x_cm, 37)
        rows = net({"stlp_dense": stlp},
                   {"timestep": torch.full((n, 1), 37.0), "highlevel": hl,
                    "noise": x_rows}, prev_feature=feature)
    want = rows.reshape(bs, M, 3, nt, 2).permute(0, 3, 4, 2, 1).reshape(
        bs, nt, 2, 3 * M)
    assert got.shape == want.shape and got.is_contiguous()
    assert _rel(got, want) < 4e-3
    assert eps_cm.inputs["g"].shape == (n, 231)


def test_unet_routes_raise():
    cfg = Config(**_fields())
    spec = _spec(TINY_DIMS)
    with pytest.raises(NotImplementedError, match="superstep"):
        N.Net(cfg.with_(guidance_pallas_superstep=True), eps_net=spec)
    with pytest.raises(NotImplementedError, match="use_init_hint"):
        N.Net(cfg.with_(use_init_hint=True), eps_net=spec)
    with pytest.raises(ValueError, match="divisible by 4"):
        N.Net(cfg.with_(nt=10), eps_net=spec)
    net = N.Net(cfg, eps_net=spec)
    n = 3 * cfg.n_randoms
    with pytest.raises(NotImplementedError, match="superstep"):
        N.make_cm_eps_fn(net, {"stlp_dense": torch.zeros(n, 1, 6)},
                         torch.zeros(n, 1), torch.zeros(n, 224),
                         cfg.with_(guidance_pallas_superstep=True))


@pytest.mark.parametrize("head", ["mlp", "unet"])
def test_eps_weights_kept_while_the_parameters_stay(head):
    """Both eps heads' weight pieces (``N.eps_weights``; the chain's graph
    is keyed on them) come from one versioned cache: a repeat call gives
    the same object, an in-place write of a parameter a new one, and a
    call while autograd records a fresh one each time."""
    cfg = Config(**_fields())
    net = N.Net(cfg, eps_net=_spec(TINY_DIMS) if head == "unet" else None)
    param = next((net.eps_net if head == "unet"
                  else net.policy_net).parameters())
    with torch.no_grad():
        w = N.eps_weights(net, cfg)
        assert N.eps_weights(net, cfg) is w
        param.add_(1.0)
        w2 = N.eps_weights(net, cfg)
        assert w2 is not w and N.eps_weights(net, cfg) is w2
    a, b = N.eps_weights(net, cfg), N.eps_weights(net, cfg)
    assert a is not b and w2 not in (a, b)


# --------------------------------------------------------------------------
# the activation pass between two convolutions
# --------------------------------------------------------------------------

#: (channels, positions) of every Conv1dBlock's output at the published
#: widths and the planner's horizon: down levels 1-3 (and the mid blocks),
#: up levels 1-2
SHAPES = [(256, 20), (512, 10), (1024, 5), (512, 5), (256, 10)]
VARIANTS = ["film", "identity", "conv_residual"]
GROUPS, GN_EPS = 8, 1e-5


def _epilogue_case(C, L, variant, n, dt, seed=0, dev="cpu"):
    """Operands of one pass: the convolution's output y (n, L, C) in
    ``dt`` and the ``norm_mish`` keywords of ``variant``."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale + shift).to(dtype)
    y = rnd(n, L, C, scale=2.0, shift=0.3, dtype=dt)
    kw = dict(bias=rnd(C, scale=0.2, dtype=dt),
              gamma=rnd(C, scale=0.2, shift=1.0),
              beta=rnd(C, scale=0.2), groups=GROUPS, eps=GN_EPS)
    if variant == "film":
        kw["film"] = rnd(n, 2 * C, scale=0.5, dtype=dt)
    elif variant == "identity":
        kw.update(res=rnd(n, L, C), stream32=True)
    else:
        kw.update(res=rnd(n, L, C, dtype=dt), res_bias=rnd(C, scale=0.2,
                                                           dtype=dt))
    move = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in kw.items()}
    return y.to(dev), move


def _composition(y, bias, gamma, beta, groups, eps, film=None, res=None,
                 res_bias=None, stream32=False):
    """The pass as PyTorch's ops compose it on (n, C, L): the bias add,
    ``F.group_norm``, ``F.mish``, then the FiLM or the residual sum."""
    x = (y.float() + bias.float()).transpose(1, 2)
    h = F.mish(F.group_norm(x, groups, gamma, beta, eps)).transpose(1, 2)
    C = y.shape[-1]
    if film is not None:
        f = film.float()[:, None, :]
        return f[..., :C] * h + f[..., C:]
    if res_bias is not None:
        return h + (res.float() + res_bias.float())
    return h + res


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("C,L", SHAPES, ids=[f"C{c}_L{l}" for c, l in SHAPES])
def test_norm_mish_plain_equals_composition(C, L, variant):
    y, kw = _epilogue_case(C, L, variant, 6, torch.float32)
    out, out32 = unet1d_norm.norm_mish_plain(y, **kw)
    want = _composition(y, **kw)
    assert out.dtype == torch.float32 and out.shape == (6, L, C)
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())
    if variant == "identity":
        assert torch.equal(out32, out)
    else:
        assert out32 is None
    # a CPU tensor never reaches the kernel
    before = unet1d_norm.launches
    got, _ = unet1d_norm.norm_mish(y, **kw)
    assert torch.equal(got, out) and unet1d_norm.launches == before


def test_mish_equals_torch_mish():
    """The pass's Mish, u n / (n + 2) with n = e^u (e^u + 2), against
    ``F.mish`` over float32's range: within 4 ulps of the larger of the
    value and 1e-30 (the two underflow alike below u = -100)."""
    u = torch.cat([torch.linspace(-120.0, 120.0, 200001),
                   torch.tensor([-20.0, 0.0, 19.999, 20.0, 20.001, 44.5,
                                 89.0, 1e30, -1e30])])
    got, want = unet1d_norm.mish(u), F.mish(u)
    ulp = 2.0 ** -23 * torch.maximum(want.abs(), torch.tensor(1e-30))
    assert float(((got - want).abs() / ulp).max()) <= 4.0
    assert torch.isfinite(got).all()


def test_norm_mish_geometry_and_refusals():
    """The kernel's block at every published shape (VC vectors a position
    times P positions a pass, about UN_THREADS threads), and the operands
    it refuses before any launch."""
    for C, L in SHAPES:
        assert unet1d_norm.threads(L, C, torch.bfloat16) == 128
    assert unet1d_norm.threads(20, 256, torch.float32) == 128
    assert unet1d_norm.threads(2, 1024, torch.float32) == 256
    with pytest.raises(ValueError, match="shared"):
        unet1d_norm.threads(64, 1024, torch.bfloat16)
    y, kw = _epilogue_case(16, 20, "film", 2, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        unet1d_norm._launch(y, **{**kw, "film_scale": True,
                                  "res": None, "res_bias": None,
                                  "stream32": False})


def test_plain_epilogue_carries_gradients():
    """Under autograd the pass is the plain version, which autograd
    differentiates: its gradients equal those of PyTorch's composition."""
    y, kw = _epilogue_case(256, 10, "film", 3, torch.float32, seed=4)
    leaves = [y] + [kw[k] for k in ("bias", "gamma", "beta", "film")]
    for t in leaves:
        t.requires_grad_(True)
    w = torch.randn(3, 10, 256, generator=torch.Generator().manual_seed(5))
    got = torch.autograd.grad(
        (unet1d_norm.norm_mish(y, **kw)[0] * w).sum(), leaves)
    want = torch.autograd.grad((_composition(y, **kw) * w).sum(), leaves)
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-5


# --------------------------------------------------------------------------
# the closed loop and the chain's graph
# --------------------------------------------------------------------------

def _case(dev, bs, dims, seed=0, **kw):
    """A closed-loop step of ``ctg_unet1d`` (fields ``kw`` set) with a
    U-Net of ``dims`` on ``bs`` synthetic scenes: (cfg, init, step,
    noise(k))."""
    cfg = Config(**_fields(**kw))
    data = synthetic.generate_dataset(seed, bs, cfg, scene_len=14)
    scenes = sim.scenes_from_dataset(data, device=dev)
    net = N.Net(cfg, eps_net=_spec(dims))
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


def _graph_then_eager(monkeypatch, dev, bs, dims, **kw):
    """Three closed-loop steps with the chain's graph, then the same three
    eagerly: both runs, their chains, and the U-Net passes, rows and
    epilogue kernel launches each counted."""
    chains = _record_chain(monkeypatch)
    cfg, init, step, noise = _case(dev, bs, dims, **kw)

    def counts():
        return unet1d.calls, unet1d.rows, unet1d_norm.launches
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
        monkeypatch, "cpu", 2, TINY_DIMS, **TINY["closed_loop"]["set"])
    assert (diffusion.chain_graph_captures,
            diffusion.chain_graph_replays) == (1, 2)
    calls = 3 * (cfg.diffusion_steps - 1)
    assert counted == [(calls, calls * 2 * 3 * cfg.n_randoms, 0)] * 2
    assert not torch.equal(eager[1][1]["controls"], eager[2][1]["controls"])
    _assert_equal_runs(graph, eager, gch, ech)


def _holding_standin(body, dev):
    """A capture that, as a CUDA graph's does, counts nothing while it
    records: the counters ``body`` names are set back after the recorded
    run and after each replay, and returned as what a replay holds."""
    def counted():
        return [getattr(m, k) for m, k in body.counters]

    def set_back(values):
        for (m, k), v in zip(body.counters, values):
            setattr(m, k, v)

    first = body()
    before = counted()
    out = tuple(t.clone() for t in body())
    held = tuple(a - b for a, b in zip(counted(), before))
    set_back(before)

    def replay():
        saved = counted()
        for o, n in zip(out, body()):
            o.copy_(n)
        set_back(saved)
    return first, out, replay, held


def test_capture_holds_the_counters_the_eps_function_names(monkeypatch):
    """The chain's graph holds the U-Net's counters because its eps
    function names them (``counters``), not because the sampler knows the
    U-Net: a replay adds what the capture held."""
    assert not hasattr(diffusion, "unet1d")
    monkeypatch.setitem(diffusion._CAPTURE, "cpu", _holding_standin)
    cfg, (graph, gch), (eager, ech), counted = _graph_then_eager(
        monkeypatch, "cpu", 2, TINY_DIMS, **TINY["closed_loop"]["set"])
    calls = 3 * (cfg.diffusion_steps - 1)
    assert counted == [(calls, calls * 2 * 3 * cfg.n_randoms, 0)] * 2
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
    """The cell's 3,072 rows: the stated precision within its tolerance of
    the float32 reference, the control beyond it."""
    _, net, r = _pair(FULL_DIMS)
    net = net.to(dev)
    x, t, c = _inputs(3072, 20, dev=dev)
    p = r.unet.on(dev)
    with torch.no_grad():
        want = ref.forward(p, r.unet.spec, x, t, c)
        got = unet1d.forward(net.eps_net, unet1d.unet_weights(
            net.eps_net, torch.bfloat16), x, t, c)
        fp8 = ref.forward(p, r.unet.spec, x, t, c, rnet.FP8)
    print("bf16", _rel(got, want), "fp8", _rel(fp8, want))
    assert _rel(got, want) < BF16_TOL < _rel(fp8, want)


@pytest.mark.cuda
def test_graph_equals_eager_on_the_card(dev, monkeypatch):
    cfg, (graph, gch), (eager, ech), counted = _graph_then_eager(
        monkeypatch, dev, 2, FULL_DIMS)
    torch.cuda.synchronize(dev)
    # the first plan's eager run before the capture, then one replay a
    # plan: as many passes as the eager loop's, and 25 epilogue launches
    # a pass (12 residual blocks x 2 Conv1dBlocks, and the final block)
    calls = 3 * (cfg.diffusion_steps - 1)
    assert counted == [(calls, calls * 2 * 3 * cfg.n_randoms,
                        25 * calls)] * 2
    assert not torch.equal(eager[1][1]["controls"], eager[2][1]["controls"])
    _assert_equal_runs(graph, eager, gch, ech)


def _assert_kernel_matches_plain(y, kw):
    before = unet1d_norm.launches
    got, got32 = unet1d_norm.norm_mish(y, **kw)
    assert unet1d_norm.launches == before + 1
    want, want32 = unet1d_norm.norm_mish_plain(y, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if got.dtype == torch.bfloat16:
        assert float((err > 2.0 ** -7 * w.abs() + 1e-5).float().mean()) == 0
        assert float((g != w).float().mean()) <= 1e-2
    else:
        assert float((err > 1e-5 * w.abs() + 1e-5).float().mean()) == 0
    assert (got32 is None) == (want32 is None)
    if want32 is not None:
        assert float(((got32 - want32).abs()
                      > 1e-5 * want32.abs() + 1e-5).float().mean()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("C,L", SHAPES, ids=[f"C{c}_L{l}" for c, l in SHAPES])
def test_norm_mish_kernel_matches_plain_on_the_card(dev, C, L, variant):
    """The cell's 3,072 rows a pass, in bfloat16."""
    y, kw = _epilogue_case(C, L, variant, 3072, torch.bfloat16, dev=dev)
    _assert_kernel_matches_plain(y, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_norm_mish_kernel_final_block_and_fp32(dev, dt):
    """The final block (no FiLM, no residual), and the float32 route, on
    every variant."""
    y, kw = _epilogue_case(256, 20, "film", 3072, dt, dev=dev)
    kw.pop("film")
    _assert_kernel_matches_plain(y, kw)
    if dt == torch.float32:
        for variant in VARIANTS:
            _assert_kernel_matches_plain(*_epilogue_case(
                256, 20, variant, 3072, dt, seed=1, dev=dev))


@pytest.mark.cuda
def test_full_width_forward_has_no_layout_transposes(dev):
    """A pass at the cell's 3,072 rows runs its convolutions channels-last
    (no cuDNN NCHW <-> NHWC transpose) and its normalization in the
    epilogue kernel (no PyTorch GroupNorm statistics), 25 launches."""
    _, net, _ = _pair(FULL_DIMS)
    net = net.to(dev)
    x, t, c = _inputs(3072, 20, dev=dev)
    w = unet1d.unet_weights(net.eps_net, torch.bfloat16)
    with torch.no_grad():
        unet1d.forward(net.eps_net, w, x, t, c)
        torch.cuda.synchronize()
        before = unet1d_norm.launches
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            unet1d.forward(net.eps_net, w, x, t, c)
            torch.cuda.synchronize()
    assert unet1d_norm.launches == before + 25
    names = [e.key for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA")]
    print(len(names), "device kernels:", names)
    assert any("norm_mish_kernel" in k for k in names)
    for bad in ("nchwToNhwc", "nhwcToNchw", "RowwiseMoments"):
        assert not [k for k in names if bad in k], bad
