"""``ctg-unet1d-cl16``'s pieces on the CPU: the U-Net's FLOP count
(``roofline/unet1d.py``) against ``torch.utils.flop_counter`` on the plain
reference, and the cell's driver end to end at a tiny size, ``correct``
for the program and not for the control or the planted fault.

The tiny size is this file's own: ``sizes.TINY``'s closed-loop cut (2
scenes, 4 seeds, 6 diffusion steps), U-Net widths 16, 32, 64 and float32
compute.  At 5 denoise steps of the tiny schedule's large betas, bfloat16
rounding moves most rows' scores by more than the check's ``score_tol``;
the cell's limits are set from readings at its own size on the card
(``calibrate_unet1d.py``).  In float32 the program and the reference
agree to rounding, so a wrong layout, weight or condition fails here."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import calibrate, calibrate_unet1d, harness
from perfbench.reference import unet1d as ref
from perfbench.roofline import unet1d as roof
from perfbench.tests.sizes import TINY

CELL = "ctg-unet1d-cl16"
TINY_DIMS = [16, 32, 64]


def small_cell(monkeypatch):
    """The cell with its U-Net at :data:`TINY_DIMS`; the tiny overrides."""
    real = harness.load_cell

    def load(name, root=harness.ROOT):
        c = real(name, root)
        c.config = dict(c.config, eps_net=dict(c.config["eps_net"],
                                               down_dims=TINY_DIMS))
        return c
    monkeypatch.setattr(harness, "load_cell", load)
    over = json.loads(json.dumps(TINY["closed_loop"]))
    over["set"]["compute_dtype"] = "float32"
    return over


@pytest.mark.parametrize("dims,rows,nt", [([16, 32, 64], 5, 8),
                                          ([256, 512, 1024], 3, 20)])
def test_flops_equal_the_flop_counter(dims, rows, nt):
    spec = dict(harness.load_cell(CELL).config["eps_net"], down_dims=dims)
    p = ref.draw(spec, roof.IN_DIM, roof.GLOBAL_DIM,
                 torch.Generator().manual_seed(0))
    x = torch.randn(rows, roof.IN_DIM, nt)
    t = torch.full((rows,), 7.0)
    g = torch.randn(rows, roof.GLOBAL_DIM)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.forward(p, spec, x, t, g)
    # the reference runs its step encoder on every row
    assert roof.flops(spec, rows, nt, step_rows=rows) == fc.get_total_flops()


def test_published_widths_count():
    spec = harness.load_cell(CELL).config["eps_net"]
    # 370.1 M multiply-adds a row, and the step encoder's 0.52 M once
    assert roof.flops(spec, 1, 20, step_rows=0) == 2 * 370_122_752
    assert roof.flops(spec, 0, 20) == 2 * 524_288


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_is_correct(trace, monkeypatch):
    over = small_cell(monkeypatch)
    line = harness.run_cell(CELL, 2 ** 31 + 9, 0.5, bool(trace),
                            device="cpu", overrides=over)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["eps_rel_err"]["value"] < 1e-5
    if trace:
        # no device operation on the CPU: the readers find nothing
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == {"agent_steps_per_s", "step_ms_p95",
                                        "setup_s"}


def tiny_driver(monkeypatch, seed=5, **traffic):
    """The cell's driver at the tiny size, set up; ``traffic`` overrides."""
    over = small_cell(monkeypatch)
    over["traffic"].update(traffic)
    cell = harness.load_cell(CELL)
    for key in ("set", "traffic", "check"):
        cell.traffic[key] = dict(cell.traffic[key], **over[key])
    drv = harness.load_driver(cell).Driver(
        cell, harness.config_fields(cell), torch.device("cpu"), seed)
    drv.setup()
    return drv


def test_shapes_count_the_unet(monkeypatch):
    drv = tiny_driver(monkeypatch)
    drv.timed_steps()
    s = drv.shapes()
    assert s["eps_calls"] == drv.cfg.diffusion_steps - 1
    assert s["eps_rows"] == s["rows"] == 2 * 3 * drv.cfg.n_randoms
    assert s["eps_net"]["down_dims"] == TINY_DIMS


@pytest.mark.parametrize("what", ["control", "drop_skip"])
def test_control_and_fault_fail(what, monkeypatch):
    over = small_cell(monkeypatch)
    got = calibrate_unet1d.readings(CELL, 7, what, device="cpu",
                                    overrides=over)
    assert got["correct"] is False, got
    assert got["checks"]["eps_rel_err"] > 0.05


def test_control_is_the_reference_in_float8():
    assert calibrate.control().Config(**harness.config_fields(
        harness.load_cell(CELL))).compute_dtype == calibrate.FP8


def test_finished_scenes_restart_from_their_first_frame(monkeypatch):
    """A scene that finishes plans again from its first frame on the next
    step, so every step's scenes are live; a restart to another state is
    a start mismatch."""
    drv = tiny_driver(monkeypatch, episode_steps=4)
    init, step = drv.sets[0]
    first = torch.tensor([True, False])

    def finishing(c, noise=None):
        # scene 0 finishes on every step
        new, info = step(c, noise)
        return new._replace(done=new.done | first), info
    drv.sets[0] = (init, finishing)
    drv._run(lambda n, el: n >= 3)
    ego0 = torch.as_tensor(drv.data[0]["scene_ego_full"][:, 0, :4])
    assert sorted(drv.restarted) == [1, 2]
    for r in drv.records[1:]:
        assert not r.carry[2].any()
        assert torch.equal(r.carry[0][0], ego0[0]) and int(r.carry[1][0]) == 0
    assert drv._restart_mismatches() == 0
    r = drv.records[1]
    drv.records[1] = r._replace(carry=(r.carry[0] + 1.0,) + r.carry[1:])
    assert drv._restart_mismatches() >= 1


@pytest.mark.parametrize("tamper", [False, True])
def test_eps_rel_err_reads_the_chains_states(tamper, monkeypatch):
    """``eps_rel_err`` compares the eps network's input and output as the
    program's plan of the checked step made them: the chain's states (the
    first draw at t = T - 1, then what the chain made of it), in a plan
    whose scores are the timed step's; a plan that is not reads as
    infinite."""
    drv = tiny_driver(monkeypatch)
    drv._run(lambda n, el: n >= 2)
    i = drv.picks()[0]
    if tamper:
        r = drv.records[i]
        drv.records[i] = r._replace(scores=r.scores + 1e-3)
    drv.release()
    p = drv.probe
    assert p["same"] is (not tamper)
    T = drv.cfg.diffusion_steps
    noise = drv._noise(drv.records[i].k)
    x_first, x_last = p["taps"][T - 1][0], p["taps"][1][0]
    assert torch.equal(x_first, noise[0].reshape(x_first.shape))
    assert not torch.equal(x_last, noise[T - 2].reshape(x_last.shape))
    got = {c["name"]: c["value"] for c in drv.check()}["eps_rel_err"]
    assert (got == float("inf")) if tamper else got < 1e-5
