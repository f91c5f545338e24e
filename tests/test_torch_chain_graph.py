"""The candidate-minor DDPM chain replayed as one captured graph
(``diffusion._chain_graph``) against the eager loop it captures.

CPU tests reach the plumbing without a card: the eligibility rule, what
the fused loss gives the graph against the host-freeze rule, and a
stand-in capture (registered for the CPU in ``diffusion._CAPTURE``) that
re-runs the recorded body on the graph's static buffers at every replay.
Through it, successive closed-loop steps with new observations and draws
must equal the eager loop to the bit, which holds only if the body reads
nothing but the buffers each plan copies in (a read of any other tensor of
the fused loss meets a meta tensor and raises).  The tiny size of
``perfbench/tests/sizes.TINY``, the benchmark's two configurations and two
other guidance routes.

Tests marked ``cuda`` run the same at the benchmark configurations' full
widths on the card (2 scenes each), with the real CUDA graph; they skip
where ``torch.cuda.is_available()`` is false.  This file imports no jax:

    python -m pytest --noconftest -q tests/test_torch_chain_graph.py
"""

import json
import os

import pytest
import torch

from perfbench.tests.sizes import TINY
from pstl_tpu_torch import diffusion, sim
from pstl_tpu_torch.config import Config
from pstl_tpu_torch.data import synthetic
from pstl_tpu_torch.models import convert
from pstl_tpu_torch.models.net import Net
from pstl_tpu_torch.ops import guidance_kernel
from pstl_tpu_torch.ops.guidance_loss import CandMinorGuidanceLoss
from pstl_tpu_torch.parallel import mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the routes held: the benchmark's configurations, and e7 on the frozen
#: kernel's route and with selections carried across steps (both freeze
#: through ``freeze_cm`` on the chain's side)
ROUTES = {"e7_ours": ("e7_ours", {}), "e5b_ctg": ("e5b_ctg", {}),
          "e7_frozen": ("e7_ours", {"guidance_pallas_fuse_freeze": False}),
          "e7_sel2": ("e7_ours", {"guidance_sel_every": 2})}


def _fields(name, **kw):
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as f:
        conf = json.load(f)
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in conf["fields"].items()}
    fields.update(kw)
    return fields, conf["weights"]["plan"]


def _case(name, dev, bs, seed=0, **kw):
    """A closed-loop step of configuration ``name`` (fields ``kw`` set) on
    ``bs`` synthetic scenes: (cfg, init, step, noise(k))."""
    fields, weights = _fields(name, **kw)
    cfg = Config(**fields)
    data = synthetic.generate_dataset(seed, bs, cfg, scene_len=14)
    scenes = sim.scenes_from_dataset(data, device=dev)
    net = Net(cfg)
    convert.load_weights(net, weights)
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


def _record_chain(monkeypatch):
    """Keep a copy of every (controls, all_steps) ``reverse_sample``
    returns."""
    seen = []
    inner = diffusion.reverse_sample

    def spy(*a, **k):
        out = inner(*a, **k)
        seen.append(tuple(t.clone() for t in out))
        return out
    monkeypatch.setattr(diffusion, "reverse_sample", spy)
    return seen


def _steps(init, step, noise, n=3):
    """``n`` closed-loop steps from a fresh carry: each step's (carry,
    info)."""
    out, carry = [], init(0)
    for k in range(n):
        carry, info = step(carry, noise(k))
        out.append((carry, info))
    return out


def _assert_equal_runs(a, b, chains_a, chains_b, atol=0.0):
    """Two runs of ``_steps`` (and their recorded chains) equal: to the
    bit, or within ``atol`` for the floats (the chosen rows exactly)."""
    def same(x, y, what):
        if atol == 0.0 or not x.is_floating_point():
            assert torch.equal(x, y), what
        else:
            assert torch.allclose(x, y, rtol=0.0, atol=atol), what
    assert len(chains_a) == len(chains_b) == len(a)
    for k, ((ca, ia), (cb, ib)) in enumerate(zip(a, b)):
        for i, (x, y) in enumerate(zip(chains_a[k], chains_b[k])):
            same(x, y, f"step {k}: chain output {i}")
        for key in ("controls", "scores", "plan_traj"):
            same(ia[key], ib[key], f"step {k}: {key}")
        for i, (x, y) in enumerate(zip(ca, cb)):
            if torch.is_tensor(x):
                same(x, y, f"step {k}: carry {i}")


# --------------------------------------------------------------------------
# the CPU: the rule and a stand-in capture
# --------------------------------------------------------------------------

def _standin(body, dev):
    """A capture that records ``body`` and re-runs it at every replay,
    writing into the recorded run's outputs as a graph replay does."""
    first = body()
    out = tuple(t.clone() for t in first)

    def replay():
        for o, n in zip(out, body()):
            o.copy_(n)
    return first, out, replay, (0, 0)


@pytest.fixture
def standin(monkeypatch):
    monkeypatch.setitem(diffusion._CAPTURE, "cpu", _standin)
    monkeypatch.setattr(diffusion, "chain_graph_captures", 0)
    monkeypatch.setattr(diffusion, "chain_graph_replays", 0)


def test_eligibility_keeps_the_eager_loop(monkeypatch):
    fields, _ = _fields("e7_ours")
    cfg = Config(**fields)

    class Eps:
        def on_base(self, b):
            return self
    noise = torch.zeros(2)
    with torch.no_grad():
        # the CPU: nothing captures there
        assert not diffusion.graph_eligible(Eps(), cfg, noise)
        monkeypatch.setitem(diffusion._CAPTURE, "cpu", _standin)
        assert diffusion.graph_eligible(Eps(), cfg, noise)
        # the XLA guidance loop
        assert not diffusion.graph_eligible(
            Eps(), cfg.with_(guidance_pallas=False), noise)
        # draws from a generator
        assert not diffusion.graph_eligible(Eps(), cfg, None)
        # an eps function that cannot be rebased on static buffers
        assert not diffusion.graph_eligible(lambda x, t: x, cfg, noise)
        # a sharding: a candidate share, and the planner's context
        ax = mesh.Axis(None, 0, 2)
        with mesh.candidate_share(ax, 2):
            assert not diffusion.graph_eligible(Eps(), cfg, noise)
        mesh._CAND_MESH[0] = ax
        try:
            assert not diffusion.graph_eligible(Eps(), cfg, noise)
        finally:
            mesh._CAND_MESH[0] = None
    # autograd recording
    assert not diffusion.graph_eligible(Eps(), cfg, noise)


@pytest.mark.parametrize("route", list(ROUTES))
def test_standin_graph_equals_eager(route, standin, monkeypatch):
    name, kw = ROUTES[route]
    kw = {**TINY["closed_loop"]["set"], **kw}
    chains = _record_chain(monkeypatch)
    cfg, init, step, noise = _case(name, "cpu", 2, **kw)
    # the first plan captures (and returns the eager run made before the
    # capture), the next two replay
    graph = _steps(init, step, noise)
    assert (diffusion.chain_graph_captures,
            diffusion.chain_graph_replays) == (1, 2)
    with_graph = list(chains)
    chains.clear()
    monkeypatch.delitem(diffusion._CAPTURE, "cpu")
    eager = _steps(init, step, noise)
    assert (diffusion.chain_graph_captures,
            diffusion.chain_graph_replays) == (1, 2)
    # the draws and observations of the steps differ, so a graph that read
    # an earlier plan's tensors would miss the later ones
    assert not torch.equal(eager[1][1]["controls"], eager[2][1]["controls"])
    _assert_equal_runs(graph, eager, with_graph, chains)


#: the routes on which the host freezes (``guidance_loss.host_freeze``)
HOST_FROZEN = ("e7_frozen", "e7_sel2")


@pytest.mark.parametrize("route", list(ROUTES))
def test_loss_inputs_follow_the_host_freeze(route, monkeypatch):
    """The fused loss's ``inputs`` hold the tensors ``freeze_cm`` reads
    exactly when an eager chain calls it, and ``on_base`` of given inputs
    is a copy whose kernel operands and freeze reads are those tensors
    and whose other tensors are meta tensors."""
    name, kw = ROUTES[route]
    losses, freezes = [], []
    inner = diffusion.reverse_sample

    def spy(cm_fn, guide, *a, **k):
        losses.append(diffusion._as_ctx(guide).fused_loss)
        return inner(cm_fn, guide, *a, **k)
    monkeypatch.setattr(diffusion, "reverse_sample", spy)
    real = CandMinorGuidanceLoss.freeze_cm
    monkeypatch.setattr(CandMinorGuidanceLoss, "freeze_cm",
                        lambda self, m: freezes.append(1) or real(self, m))
    cfg, init, step, noise = _case(name, "cpu", 2,
                                   **{**TINY["closed_loop"]["set"], **kw})
    step(init(0), noise(0))
    loss, = losses
    reads = set(loss.FREEZE_READS)
    assert bool(freezes) == (route in HOST_FROZEN)
    assert set(loss.inputs) & reads == (reads if freezes else set())
    given = {k: v.clone() for k, v in loss.inputs.items()}
    rebound = loss.on_base(given)
    ops = guidance_kernel.kernel_operands(rebound, cfg)
    for f in guidance_kernel.Operands._fields:
        assert getattr(ops, f) is given["op." + f], f
    for k in set(given) & reads:
        assert getattr(rebound, k) is given[k], k
    assert rebound.valid_r.is_meta and rebound.lanes.is_meta
    assert not loss.valid_r.is_meta
    assert guidance_kernel.kernel_operands(loss, cfg).lanes \
        is not given["op.lanes"]


def test_standin_second_shape_captures_second_graph(standin):
    kw = TINY["closed_loop"]["set"]
    # the third is the first's shape on another net, whose weights a graph
    # of the first does not read
    for bs, captures in ((2, 1), (1, 2), (2, 3)):
        _, init, step, noise = _case("e5b_ctg", "cpu", bs, **kw)
        step(init(0), noise(0))
        assert diffusion.chain_graph_captures == captures
    assert diffusion.chain_graph_replays == 0


def test_generator_draws_stay_eager(standin):
    _, init, step, _ = _case("e5b_ctg", "cpu", 2,
                             **TINY["closed_loop"]["set"])
    step(init(0))
    assert (diffusion.chain_graph_captures,
            diffusion.chain_graph_replays) == (0, 0)


# --------------------------------------------------------------------------
# the card: the real graph at full width
# --------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chain is captured as a CUDA "
                    "graph only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["e7_ours", "e5b_ctg"])
def test_graph_equals_eager_on_the_card(name, dev, monkeypatch):
    chains = _record_chain(monkeypatch)
    cfg, init, step, noise = _case(name, dev, 2)
    captures = diffusion.chain_graph_captures
    replays = diffusion.chain_graph_replays
    launches = guidance_kernel.launches
    guided = int(diffusion._trigger_schedule(cfg).sum())
    graph = _steps(init, step, noise)
    torch.cuda.synchronize(dev)
    assert diffusion.chain_graph_captures == captures + 1
    assert diffusion.chain_graph_replays == replays + 2
    # the first plan's eager run before the capture, then one replay a plan
    assert guidance_kernel.launches == launches + 3 * guided
    with_graph = list(chains)
    chains.clear()
    monkeypatch.setattr(diffusion, "_CAPTURE", {})
    eager = _steps(init, step, noise)
    assert guidance_kernel.launches == launches + 6 * guided
    assert diffusion.chain_graph_replays == replays + 2
    assert not torch.equal(eager[1][1]["controls"], eager[2][1]["controls"])
    _assert_equal_runs(graph, eager, with_graph, chains)


@pytest.mark.cuda
def test_second_shape_captures_second_graph_on_the_card(dev):
    captures = diffusion.chain_graph_captures
    replays = diffusion.chain_graph_replays
    launches = guidance_kernel.launches
    for bs, n in ((2, 1), (1, 2)):
        cfg, init, step, noise = _case("e5b_ctg", dev, bs)
        for k in range(2):
            step(init(0), noise(k))
        assert diffusion.chain_graph_captures == captures + n
    guided = int(diffusion._trigger_schedule(cfg).sum())
    assert diffusion.chain_graph_replays == replays + 2
    assert guidance_kernel.launches == launches + 4 * guided
