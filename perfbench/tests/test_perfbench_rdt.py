"""``ctg-rdt1b-cl1``'s pieces on the CPU: the RDT's FLOP count
(``roofline/rdt.py``) against ``torch.utils.flop_counter`` on the plain
reference, and the cell's driver end to end at a tiny size, ``correct``
for the program and not for the control or the planted faults.

The tiny size is this file's own: ``sizes.TINY``'s closed-loop cut (2
scenes, 4 seeds, 6 diffusion steps), an RDT of width 64 with 4 heads and
4 blocks (both streams recur) and float32 compute.  In float32 the
program and the reference agree to rounding, so a wrong layout, weight,
stream or norm fails here; the cell's limits are set from readings at its
own size on the card (``calibrate_rdt.py``)."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import calibrate, calibrate_rdt, harness
from perfbench.reference import rdt as ref
from perfbench.roofline import rdt as roof
from perfbench.tests.sizes import TINY

CELL = "ctg-rdt1b-cl1"
TINY_RDT = {"hidden_size": 64, "num_heads": 4, "depth": 4}


def small_cell(monkeypatch):
    """The cell with its RDT at :data:`TINY_RDT`; the tiny overrides."""
    real = harness.load_cell

    def load(name, root=harness.ROOT):
        c = real(name, root)
        c.config = dict(c.config, eps_net=dict(c.config["eps_net"],
                                               **TINY_RDT))
        return c
    monkeypatch.setattr(harness, "load_cell", load)
    over = json.loads(json.dumps(TINY["closed_loop"]))
    over["set"]["compute_dtype"] = "float32"
    return over


def _spec(**kw):
    from perfbench.drivers.closed_loop_rdt import WIDTHS
    eps = harness.load_cell(CELL).config["eps_net"]
    return dict({k: eps[k] for k in WIDTHS}, **kw)


@pytest.mark.parametrize("widths,rows,nt", [
    (dict(TINY_RDT, state_token_dim=16), 5, 8),
    (dict(hidden_size=96, num_heads=3, depth=3), 70, 20)])
def test_flops_equal_the_flop_counter(widths, rows, nt):
    """Two sizes, the second over two of the reference's row blocks and
    with an odd depth (the language stream one block more)."""
    spec = _spec(**widths)
    p = ref.draw(spec, nt, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    args = (torch.randn(rows, nt, 2, generator=g), torch.full((rows,), 7.0),
            torch.randn(rows, 6, generator=g),
            torch.randn(rows, roof.LANG_IN, generator=g),
            torch.randn(rows, roof.IMG_TOKENS, roof.IMG_IN, generator=g))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.forward(p, spec, *args)
    # the reference builds every row's condition and embedders each pass
    assert (roof.flops(spec, rows, nt, step_rows=rows)
            + roof.cond_flops(spec, rows, rows, freq_rows=rows)
            == fc.get_total_flops())


def test_published_widths_count():
    spec = _spec()
    # 21.96 G multiply-adds a row a pass, the timestep embedder's 4.72 M
    # once; 835 TFLOP a plan at 192 rows and 99 passes
    assert roof.flops(spec, 1, 20, step_rows=0) == 2 * 21_955_096_576
    assert roof.flops(spec, 0, 20) == 2 * 4_718_592
    assert round(99 * roof.flops(spec, 192, 20) / 1e12, 1) == 834.6


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_is_correct(trace, monkeypatch):
    over = small_cell(monkeypatch)
    line = harness.run_cell(CELL, 2 ** 31 + 11, 0.5, bool(trace),
                            device="cpu", overrides=over)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["eps_rms_err"]["value"] < 1e-5
    if trace:
        # no device operation on the CPU: the readers find nothing
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == {"agent_steps_per_s", "step_ms_p95",
                                        "setup_s"}


def test_shapes_count_the_rdt(monkeypatch):
    over = small_cell(monkeypatch)
    cell = harness.load_cell(CELL)
    for key in ("set", "traffic", "check"):
        cell.traffic[key] = dict(cell.traffic[key], **over[key])
    drv = harness.load_driver(cell).Driver(
        cell, harness.config_fields(cell), torch.device("cpu"), 5)
    drv.setup()
    drv.timed_steps()
    s = drv.shapes()
    assert s["eps_calls"] == drv.cfg.diffusion_steps - 1
    assert s["eps_rows"] == s["rows"] == 2 * 3 * drv.cfg.n_randoms
    assert s["eps_net"]["hidden_size"] == TINY_RDT["hidden_size"]
    reader = harness.load_reader("rdt_mfu.plan")
    ctx = type("Ctx", (), dict(kernels=[("k", 0.0, 1.0)], step_s=2.0,
                               fields={"compute_dtype": "bfloat16"},
                               shapes=s))
    want = (s["eps_calls"] * roof.flops(s["eps_net"], s["eps_rows"], s["nt"])
            / (2.0 * 989e12) * 100)
    assert reader(ctx) == pytest.approx(want)


@pytest.mark.parametrize("what", ["control", "no_qk_norm", "swap_streams"])
def test_control_and_faults_fail(what, monkeypatch):
    over = small_cell(monkeypatch)
    got = calibrate_rdt.readings(CELL, 7, what, device="cpu",
                                 overrides=over)
    assert got["correct"] is False, got
    assert got["checks"]["eps_rms_err"] > 0.03


def test_control_is_the_reference_in_float8():
    assert calibrate.control().Config(**harness.config_fields(
        harness.load_cell(CELL))).compute_dtype == calibrate.FP8


def test_paired_reads_control_and_faults_at_the_programs_check_points(
        monkeypatch):
    over = small_cell(monkeypatch)
    got = calibrate_rdt.paired(CELL, 2 ** 31 + 11, 0.5, device="cpu",
                               overrides=over)
    assert got["program"]["correct"] is True, got["program"]
    assert got["picks"] and got["steps"] >= len(got["picks"])
    for kind in ("control", "no_qk_norm", "swap_streams"):
        assert got[kind]["correct"] is False, got[kind]
        assert got[kind]["checks"]["eps_rms_err"] > 0.03
