"""The operation and byte counts of ``roofline/``: against hand counts at a
tiny shape, against the operands of a real launch of kernel 1's wrapper,
and against the matmul FLOPs that ``torch.utils.flop_counter`` counts
while the program runs a plan step on the CPU."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import harness, roofline
from perfbench.tests.sizes import tiny

# a tiny shape: nt 2, 2 neighbors, 3 segments, 2 discs, 2 seeds, 1 iteration
SMALL = dict(nt=2, n_neighbors=2, n_segs=3, refined_nL=2, n_randoms=2,
             guidance_niters=1, clearance_coarse_pair=False)


def test_guidance_ops_hand_count():
    # per column: fwd = T(12+30+20) + K*T*15 = 124 + 60 = 184; one
    # iteration 3*184 + 2*T*12 = 600; freeze T*3*S*10 + K*T*(2*2)*6 = 180
    # + 96; 2 scenes x 6 columns
    assert roofline.guidance_ops(SMALL, 2) == 2 * 6 * (600 + 180 + 96)
    coarse = dict(SMALL, clearance_coarse_pair=True)
    assert roofline.guidance_ops(coarse, 2) == 2 * 6 * (600 + 180 + 96)
    assert roofline.guidance_ops(dict(coarse, refined_nL=4), 1) \
        == 6 * (3 * (2 * 62 + 2 * 2 * 15) + 48 + 180 + 2 * 2 * 8 * 6)


def test_guidance_bytes_hand_count():
    # muw, mua in and out 4*2*2*6; lanes 2*27; ndx, ndy 2*2*2*2*2;
    # crad, cvalid 2*2*2*2; stlp 2*6*6; nf 2*3*6; valid 2*6; scal 4; gvec 3
    floats = 96 + 54 + 32 + 16 + 72 + 36 + 12 + 4 + 3
    assert roofline.guidance_bytes(SMALL, 2) == 4 * floats


def test_mlp_flops_hand_count():
    # 3 rows, 4 -> 5 -> 2: 2*3*(20 + 10)
    assert roofline.mlp_flops(3, 4, (5, 2)) == 180


def test_guidance_bytes_of_a_launch(monkeypatch):
    """The bytes of every operand of kernel 1's first launch in a tiny plan
    step, read once, and of its two outputs."""
    from pstl_tpu_torch.ops import guidance_kernel as gk
    calls = []
    real = gk.guidance_fused

    def rec(*a):
        out = real(*a)
        calls.append((a, out))
        return out
    monkeypatch.setattr(gk, "guidance_fused", rec)
    fields, drv = _driver("e7-heavy-cl16")
    drv.setup()
    args, out = calls[0]
    got = sum(x.numel() * x.element_size() for x in list(args[:-1]) + list(out))
    assert got == roofline.guidance_bytes(fields, drv.bs)


def _driver(cell):
    spec = harness.load_cell(cell)
    for key, val in tiny(cell).items():
        spec.traffic[key] = dict(spec.traffic.get(key, {}), **val)
    fields = harness.config_fields(spec)
    drv = harness.load_driver(spec).Driver(spec, fields,
                                           torch.device("cpu"), 4)
    return fields, drv


@pytest.mark.parametrize("cell", ["e7-heavy-cl16", "ctg-cl128"])
def test_plan_flops_counted(cell):
    fields, drv = _driver(cell)
    drv.setup()
    carry, step = drv._start(0)
    noise = drv._noise(0)
    with FlopCounterMode(display=False) as fc:
        step(carry, noise)
    assert fc.get_total_flops() == roofline.plan_flops(fields, drv.bs)

