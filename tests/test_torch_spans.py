"""The closed-loop step's spans (``pstl_tpu_torch.utils.trace``): under
``torch.profiler`` one tiny step of each benchmark configuration
(``perfbench/configs``, at the sizes of ``perfbench/tests/sizes.TINY``)
records the span tree the benchmark's readers attribute by; with no
profiler no span is made; the step's outputs do not depend on which."""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.tests.sizes import TINY
from pstl_tpu_torch import diffusion, sim
from pstl_tpu_torch.config import Config
from pstl_tpu_torch.data import synthetic
from pstl_tpu_torch.models import convert
from pstl_tpu_torch.models.net import Net
from pstl_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 2


def _step_case(name):
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as f:
        conf = json.load(f)
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in conf["fields"].items()}
    fields.update(TINY["closed_loop"]["set"])
    cfg = Config(**fields)
    data = synthetic.generate_dataset(0, BS, cfg, scene_len=14)
    scenes = sim.scenes_from_dataset(data, device="cpu")
    net = Net(cfg)
    convert.load_weights(net, conf["weights"]["plan"])
    net.eval()
    coeffs = diffusion.get_coeffs(cfg, "cpu")
    init, step = sim.make_closed_loop_step(scenes, cfg, net, coeffs,
                                           with_info=True)
    shape = ((diffusion.n_draws(cfg),)
             + tuple(diffusion.draw_layout(cfg, BS, 3 * cfg.n_randoms)))
    noise = torch.randn(shape, generator=torch.Generator().manual_seed(7))
    return cfg, init, step, noise


@pytest.fixture(scope="module", params=["e7_ours", "e5b_ctg"])
def case(request):
    return request.param, _step_case(request.param)


def _traced_spans(step, carry, noise, path):
    """The step's outputs and its spans from the chrome trace, as the
    benchmark reads them: (name, start us, end us)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step(carry, noise)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("ph") == "X" and e["name"] in trace.SPANS)
    return out, spans


def _parents(spans):
    """Each span's innermost enclosing span (None at the top)."""
    out = []
    for i, (name, a, b) in enumerate(spans):
        up = [s for j, s in enumerate(spans) if j != i
              and s[1] <= a and b <= s[2] and (s[2] - s[1]) >= (b - a)]
        best = min(up, key=lambda s: s[2] - s[1]) if up else None
        out.append((name, best[0] if best else None))
    return out


def test_span_tree(case, tmp_path):
    name, (cfg, init, step, noise) = case
    _, spans = _traced_spans(step, init(0), noise, tmp_path / "t.json")
    tree = _parents(spans)
    count = lambda n: sum(s == n for s, _ in tree)
    under = lambda n: {p for s, p in tree if s == n}
    assert count("sim.step") == 1 and under("sim.step") == {None}
    for child in ("sim.observe", "sim.plan", "sim.env"):
        assert count(child) == 1 and under(child) == {"sim.step"}, tree
    assert under("plan.prep") == {"sim.plan"} and count("plan.prep") == 2
    assert count("plan.sample") == 1 and under("plan.sample") == {"sim.plan"}
    assert count("plan.select") == 1 and under("plan.select") == {"sim.plan"}
    assert under("plan.guidance") == {"plan.sample"}
    assert under("plan.score") == {"plan.select"}
    assert {s for s, _ in tree} == set(trace.SPANS)


def test_a_guidance_span_per_guided_step(case, tmp_path):
    name, (cfg, init, step, noise) = case
    _, spans = _traced_spans(step, init(0), noise, tmp_path / "t.json")
    guided = int(diffusion._trigger_schedule(cfg).sum())
    assert guided == cfg.diffusion_steps - 1
    assert sum(s[0] == "plan.guidance" for s in spans) == guided


def test_a_score_span_per_scorer_call(case, tmp_path):
    name, (cfg, init, step, noise) = case
    _, spans = _traced_spans(step, init(0), noise, tmp_path / "t.json")
    if name == "e7_ours":
        # multi-cands scores the last multi_cands decodings (10 of the
        # cell's 100; all 6 here), then each roll and the final choice
        assert cfg.multi_cands + cfg.n_rolls + 1 == 14
        want = min(cfg.multi_cands, cfg.diffusion_steps) + cfg.n_rolls + 1
    else:
        want = 1
    assert sum(s[0] == "plan.score" for s in spans) == want


def test_no_span_without_a_profiler(case, monkeypatch):
    name, (cfg, init, step, noise) = case

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("sim.step") is trace.span("plan.score")
    carry, info = step(init(0), noise)
    assert torch.isfinite(info["scores"]).all()


def test_outputs_equal_with_and_without_spans(case, tmp_path):
    name, (cfg, init, step, noise) = case
    off = step(init(0), noise)
    on, spans = _traced_spans(step, init(0), noise, tmp_path / "t.json")
    assert spans
    (c_off, i_off), (c_on, i_on) = off, on
    for a, b in zip(c_off[:-1], c_on[:-1]):
        assert torch.equal(a, b)
    assert i_off.keys() == i_on.keys()
    for k in i_off:
        assert torch.equal(i_off[k], i_on[k]), k
