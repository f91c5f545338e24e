"""The plan step's selection tail (``sim._select``: the multi-cands scoring,
the RefineNet and its rolls, the final score, the forward shield and the
lane-keep argmax) replayed as one captured graph (``sim._select_graph``)
against the eager block.

CPU tests: the eligibility rule, the scorer's graph protocol
(``TiledScorer.inputs`` / ``on_base``), the factored-out tail against the
block as ``sim.make_planner`` ran it inline before, and the stand-in
capture of ``test_torch_chain_graph`` (registered for the CPU in
``diffusion._CAPTURE``; it re-runs the recorded body on the graph's static
buffers at every replay).  Through it, closed-loop steps with new
observations must equal the eager steps to the bit, which holds only if
the tail reads nothing of a plan but the buffers each plan copies in.  The
tiny size of ``perfbench/tests/sizes.TINY``.

Tests marked ``cuda`` run the real CUDA graph at the benchmark
configurations' full widths on the card (16 scenes: 3,072 rows); they skip
where ``torch.cuda.is_available()`` is false.  This file imports no jax:

    python -m pytest --noconftest -q tests/test_torch_select_graph.py
"""

import pytest
import torch

from perfbench.tests.sizes import TINY
from pstl_tpu_torch import diffusion, refine, sim, specs
from pstl_tpu_torch.config import PRESETS, Config
from pstl_tpu_torch.data import synthetic
from pstl_tpu_torch.models.net import Net, init_flax_like
from pstl_tpu_torch.ops import dynamics as dyn
from pstl_tpu_torch.parallel import mesh

from test_torch_chain_graph import _case, _fields, _standin, _steps

#: the tails held: the benchmark's two configurations (multi-cands,
#: RefineNet and rolls; no RefineNet), the RefineNet on the sampler's last
#: decoding alone, and the VAE planner (a prior latent decoded, no sampler)
ROUTES = {"e7_ours": ("e7_ours", {}), "e5b_ctg": ("e5b_ctg", {}),
          "e7_one_cand": ("e7_ours", {"multi_cands": None}),
          "e3_vae": ("e3_vae", {})}
#: the test-time refinements, which keep the eager block (a host sync)
REFINED = {"e7_refine": ("e7_ours", {"refinement": True}),
           "e7_raw_lite": ("e7_ours", {"raw_refinement": True,
                                       "lite_refine": True})}
INFO = ("controls", "trajs", "scores", "plan_traj", "stl_acc")


def _route(route, dev, bs):
    """(cfg, init, step, noise(k)) of a closed-loop step of ``route`` on
    ``bs`` scenes at the tiny size."""
    name, kw = {**ROUTES, **REFINED}[route]
    if name != "e3_vae":
        return _case(name, dev, bs, **{**TINY["closed_loop"]["set"], **kw})
    cfg = PRESETS["e3_vae"].with_(
        exp_name=None, n_randoms=4, hiddens=(32, 32), vae_dim=8,
        compute_dtype="float32", **kw)
    data = synthetic.generate_dataset(0, bs, cfg, scene_len=14)
    scenes = sim.scenes_from_dataset(data, device=dev)
    net = Net(cfg)
    init_flax_like(net, torch.Generator().manual_seed(0))
    net = net.to(dev).eval()
    init, step = sim.make_closed_loop_step(
        scenes, cfg, net, diffusion.get_coeffs(cfg, dev), with_info=True)

    def noise(k):
        g = torch.Generator(device=dev).manual_seed(100 + k)
        return torch.randn((bs * 3 * cfg.n_randoms, cfg.vae_dim),
                           generator=g, device=dev)
    return cfg, init, step, noise


def _counts():
    """(tail captures, tail replays, chain captures, chain replays)."""
    return (sim.select_graph_captures, sim.select_graph_replays,
            diffusion.chain_graph_captures, diffusion.chain_graph_replays)


def _added(before, *delta):
    return tuple(b + d for b, d in zip(before, delta))


def _assert_same(a, b):
    """Two runs of ``_steps``: every step's info and carry equal to the
    bit."""
    assert len(a) == len(b)
    for k, ((ca, ia), (cb, ib)) in enumerate(zip(a, b)):
        for key in INFO:
            assert torch.equal(ia[key], ib[key]), f"step {k}: {key}"
        for i, (x, y) in enumerate(zip(ca, cb)):
            if torch.is_tensor(x):
                assert torch.equal(x, y), f"step {k}: carry {i}"


def _generator(k):
    """No pinned draws: the plan draws from the carry's generator, and the
    chain stays eager (``diffusion.graph_eligible``)."""
    return None


# --------------------------------------------------------------------------
# the CPU: the rule, the scorer's protocol, the factored-out block
# --------------------------------------------------------------------------

@pytest.fixture
def standin(monkeypatch):
    monkeypatch.setitem(diffusion._CAPTURE, "cpu", _standin)
    for k in ("chain_graph_captures", "chain_graph_replays"):
        monkeypatch.setattr(diffusion, k, 0)
    for k in ("select_graph_captures", "select_graph_replays"):
        monkeypatch.setattr(sim, k, 0)


def test_eligibility_keeps_the_eager_block(monkeypatch):
    fields, _ = _fields("e7_ours")
    cfg = Config(**fields)
    cpu = torch.device("cpu")

    class Scorer:
        def on_base(self, d):
            return self
    with torch.no_grad():
        # the CPU: nothing captures there
        assert not sim.select_graph_eligible(Scorer(), cfg, cpu)
        monkeypatch.setitem(diffusion._CAPTURE, "cpu", _standin)
        assert sim.select_graph_eligible(Scorer(), cfg, cpu)
        # a scorer that cannot be rebased on static buffers (the
        # formulas' closure under tiled_scorer=False)
        assert not sim.select_graph_eligible(lambda ego: ego, cfg, cpu)
        # the host-synced branches
        for k in ("refinement", "raw_refinement"):
            assert not sim.select_graph_eligible(
                Scorer(), cfg.with_(**{k: True}), cpu)
        # a sharding: a candidate share, and the planner's context
        ax = mesh.Axis(None, 0, 2)
        with mesh.candidate_share(ax, 2):
            assert not sim.select_graph_eligible(Scorer(), cfg, cpu)
        mesh._CAND_MESH[0] = ax
        try:
            assert not sim.select_graph_eligible(Scorer(), cfg, cpu)
        finally:
            mesh._CAND_MESH[0] = None
    # autograd recording
    assert not sim.select_graph_eligible(Scorer(), cfg, cpu)


def test_run_graph_buffers_keep_the_layout(monkeypatch):
    """``diffusion.run_graph``'s static buffers take each fresh tensor's
    strides (a broadcast stays one, a gapped view keeps its gaps), so the
    body runs on what an eager call gets; a replay reads the new values,
    and another layout is another graph."""
    monkeypatch.setitem(diffusion._CAPTURE, "cpu", _standin)
    cpu = torch.device("cpu")
    grid = torch.arange(24.0).reshape(4, 6)

    def fresh(x):
        return {"row": x.expand(4, 6), "gapped": (grid + x[0])[:, ::2]}

    def eager(d):
        return (d["row"] * 2 + d["gapped"].sum(), d["gapped"].t())

    made = []

    def make_body(static):
        made.append(static)

        def body():
            return eager(static)
        body.counters = ()
        return body
    graphs = {}
    x = torch.arange(6.0)
    out, captured = diffusion.run_graph(graphs, "k", fresh(x), make_body, cpu)
    assert captured and len(made) == 1
    assert made[0]["row"].stride() == (0, 1)
    assert made[0]["gapped"].stride() == (6, 2)
    out, captured = diffusion.run_graph(graphs, "k", fresh(x + 1), make_body,
                                        cpu)
    assert not captured and len(made) == 1
    for a, b in zip(out, eager(fresh(x + 1))):
        assert torch.equal(a, b)
    d = {k: v.contiguous() for k, v in fresh(x).items()}
    _, captured = diffusion.run_graph(graphs, "k", d, make_body, cpu)
    assert captured and len(graphs) == 2


def _recorded(monkeypatch, route):
    """One eager closed-loop step of ``route`` on 2 scenes: (cfg, the
    arguments and outputs of its ``sim._select`` call, the sampler's
    (controls, all_steps) or None, the step's info)."""
    seen = {"cands": None}
    inner_select, inner_cands = sim._select, sim._candidates

    def select(*a, **k):
        out = inner_select(*a, **k)
        seen["select"] = (a, k, out)
        return out

    def cands(*a, **k):
        seen["cands"] = inner_cands(*a, **k)
        return seen["cands"]
    monkeypatch.setattr(sim, "_select", select)
    monkeypatch.setattr(sim, "_candidates", cands)
    cfg, init, step, noise = _route(route, "cpu", 2)
    _, info = step(init(0), noise(0))
    return cfg, seen["select"], seen["cands"], info


@pytest.mark.parametrize("norm_stl", [False, True])
def test_scorer_on_base_scores_equal(norm_stl, monkeypatch):
    """A ``TiledScorer`` rebuilt by ``on_base`` from copies of its
    ``inputs`` reads those copies and scores equal to the bit with the
    original."""
    monkeypatch.setitem(ROUTES, "norm", ("e7_ours", {"norm_stl": norm_stl}))
    cfg, ((_, _, states_flat, *_, scorer, _), _, _), _, _ = _recorded(
        monkeypatch, "norm")
    assert isinstance(scorer, specs.TiledScorer)
    names = {"discs.nx", "discs.ny", "discs.r", "discs.valid", "lanes",
             "stlp"} | ({"vf", "df", "sf"} if norm_stl else set())
    assert set(scorer.inputs) == names
    given = {k: v.clone() for k, v in scorer.inputs.items()}
    rebound = scorer.on_base(given)
    assert all(v is given[k] for k, v in rebound.inputs.items())
    assert all(v is not given[k] for k, v in scorer.inputs.items())
    g = torch.Generator().manual_seed(3)
    u = 0.3 * torch.randn((states_flat.shape[0], cfg.nt, 2), generator=g)
    ego = dyn.rollout(states_flat, u, cfg.dt)[:, :-1]
    for hard in (False, True):
        assert torch.equal(rebound(ego, hard=hard), scorer(ego, hard=hard))


def _inline_block(net, nn_controls, all_steps, states_flat, score_rows,
                  feature, highlevel, stlp_rows, valid, cfg):
    """The selection block as ``sim.make_planner``'s plan ran it inline,
    before it became ``sim._select``."""
    M = cfg.n_randoms
    bs = states_flat.shape[0] // (M * 3)

    def score_controls(u):
        trajs = dyn.rollout(states_flat, u, cfg.dt)
        s = score_rows(trajs[:, :-1])
        return s, trajs

    if cfg.rect_head and not cfg.not_use_rect:
        if cfg.multi_cands is not None:
            nn_controls, prev_scores = diffusion.select_multi_cands(
                all_steps, cfg.multi_cands, states_flat, score_rows, cfg)
        else:
            prev_scores, _ = score_controls(nn_controls)
        controls = net.rect(feature, highlevel, stlp_rows, nn_controls,
                            prev_scores)
        for _ in range(cfg.n_rolls or 0):
            s_re, _ = score_controls(controls)
            controls = net.rect(feature, highlevel, stlp_rows, controls,
                                s_re)
        if cfg.refinement or cfg.raw_refinement:
            if not cfg.lite_refine or float(mesh.shard_max(
                    torch.amax(score_controls(controls)[0]
                               .reshape(bs, M, 3)[:, :, 0]))) <= 0:
                if cfg.refinement:
                    controls = refine.convex_refinement(
                        controls, all_steps, states_flat, score_rows, valid,
                        cfg, K=6)
                else:
                    controls = refine.raw_refinement(
                        controls, states_flat, score_rows, valid, cfg)
    else:
        controls = nn_controls

    scores, trajs = score_controls(controls)
    scores3 = scores.reshape(bs, M, 3)
    if cfg.forward_shield:
        min_v = torch.amin(trajs[..., 3], dim=-1).reshape(bs, M, 3)
        scores3 = scores3 - torch.clamp(-min_v, min=0.0) * 1e3
    keep = torch.arange(3, device=scores.device)[None, None, :] == 0
    keep_scores = torch.where(keep, scores3,
                              torch.full_like(scores3, -10000.0))
    best = torch.argmax(keep_scores.reshape(bs, M * 3), dim=-1)
    u_all = controls.reshape(bs, M * 3, cfg.nt, 2)
    tr_all = trajs.reshape(bs, M * 3, cfg.nt + 1, 4)
    u_best = sim._rows(u_all, best)
    tr_best = sim._rows(tr_all, best)
    stl_acc = torch.mean((keep_scores[:, :, 0] > 0).float(), dim=-1)
    return u_best[:, 0, :], controls, trajs, scores, tr_best, stl_acc


@pytest.mark.parametrize("route", list(ROUTES) + list(REFINED))
def test_select_equals_the_inline_block(route, monkeypatch):
    cfg, (args, kw, out), sampled, info = _recorded(monkeypatch, route)
    net, cands, states_flat, feature, highlevel, stlp_rows, scorer, _ = args
    assert (kw["repair"] is not None) == (route in REFINED)
    if sampled is None:                   # the VAE: its decoding alone
        nn_controls, all_steps = cands, cands[None]
    else:
        nn_controls, all_steps = sampled
    with torch.no_grad():
        old = _inline_block(net, nn_controls, all_steps, states_flat, scorer,
                            feature, highlevel, stlp_rows,
                            info["valids_dense"].reshape(-1), cfg)
    for i, (x, y) in enumerate(zip(out, old)):
        assert torch.equal(x, y), f"output {i}"


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("pinned", [False, True])
def test_standin_tail_equals_eager(route, pinned, standin, monkeypatch):
    """The first plan captures the tail (and returns the eager run made
    before the capture), the next two replay it, whether the chain is a
    graph too (pinned draws) or eager (the carry's generator)."""
    cfg, init, step, noise = _route(route, "cpu", 2)
    draws = noise if pinned else _generator
    chain = 1 if pinned and cfg.diffusion else 0
    graph = _steps(init, step, draws)
    assert _counts() == (1, 2, chain, 2 * chain)
    monkeypatch.delitem(diffusion._CAPTURE, "cpu")
    eager = _steps(init, step, draws)
    assert _counts() == (1, 2, chain, 2 * chain)
    # the observations and draws of the steps differ, so a graph that read
    # an earlier plan's tensors would miss the later ones
    assert not torch.equal(eager[1][1]["controls"], eager[2][1]["controls"])
    _assert_same(graph, eager)


@pytest.mark.parametrize("route", list(REFINED))
def test_standin_refinement_stays_eager(route, standin):
    _, init, step, noise = _route(route, "cpu", 2)
    _steps(init, step, noise, n=2)
    assert _counts()[:2] == (0, 0)


# --------------------------------------------------------------------------
# the card: the real graph at full width
# --------------------------------------------------------------------------

#: the benchmark's cl16 scenes: 3,072 rows at 64 seeds x 3 maneuvers
CARD_SCENES = 16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tail is captured as a CUDA "
                    "graph only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["e7_ours", "e5b_ctg"])
def test_tail_graph_equals_eager_on_the_card(name, dev, monkeypatch):
    """The chain eager (generator draws), the tail captured in the first
    plan and replayed, one replay a later plan, on new observations."""
    cfg, init, step, _ = _case(name, dev, CARD_SCENES)
    assert 3 * cfg.n_randoms * CARD_SCENES == 3072
    before = _counts()
    graph = _steps(init, step, _generator)
    torch.cuda.synchronize(dev)
    assert _counts() == _added(before, 1, 2, 0, 0)
    monkeypatch.setattr(diffusion, "_CAPTURE", {})
    eager = _steps(init, step, _generator)
    assert _counts() == _added(before, 1, 2, 0, 0)
    assert not torch.equal(eager[1][1]["controls"], eager[2][1]["controls"])
    _assert_same(graph, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["e7_ours", "e5b_ctg"])
def test_plan_with_both_graphs_equals_eager_on_the_card(name, dev,
                                                        monkeypatch):
    _, init, step, noise = _case(name, dev, CARD_SCENES)
    before = _counts()
    graph = _steps(init, step, noise)
    torch.cuda.synchronize(dev)
    assert _counts() == _added(before, 1, 2, 1, 2)
    monkeypatch.setattr(diffusion, "_CAPTURE", {})
    eager = _steps(init, step, noise)
    assert _counts() == _added(before, 1, 2, 1, 2)
    assert not torch.equal(eager[1][1]["controls"], eager[2][1]["controls"])
    _assert_same(graph, eager)
