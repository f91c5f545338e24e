"""``correct`` comes out false for the control (the reference computed in
float8 e4m3 where the configuration states bfloat16, in the program's
place) and for each fault a cell can have, planted underneath the timed
path: on the CPU at a tiny size, and (marked ``cuda``) the control at
each cell's own size on three seeds."""

import pytest
import torch

from perfbench import calibrate, harness
from perfbench.tests.sizes import tiny

PLAN = ["e7-heavy-cl16", "ctg-cl128"]
CASES = [(c, w) for c in PLAN for w in ("program", "control", "unchanged",
                                        "altered", "wrong_choice",
                                        "one_scene")]


@pytest.mark.parametrize("cell,what", CASES)
def test_correct_only_for_the_program(cell, what):
    """A whole run (set-up, window, check) past the look for a card."""
    impl = calibrate.control() if what == "control" else None
    with calibrate.fault("program" if what == "control" else what):
        line = harness.run_cell(cell, 11, 0.5, False, device="cpu",
                                overrides=tiny(cell), impl=impl)
    assert line["correct"] is (what == "program"), line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", PLAN)
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control at a cell's own size runs on the card")
    for seed in (21, 22, 23):
        got = calibrate.readings(cell, seed, "control")
        print(got)
        assert got["correct"] is False, got
