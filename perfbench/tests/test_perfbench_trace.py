"""The trace's reduction and the traffic's rasters."""

import numpy as np
import pytest

from perfbench import harness, traffic
from perfbench.reference.port import sim
from perfbench.reference.port.config import Config
from perfbench.reference.port.data import synthetic


def test_reduce_trace():
    ev = [{"name": harness.WINDOW_MARK, "ph": "X", "cat": "user_annotation",
           "ts": 0.0, "dur": 100.0},
          {"name": "k1", "ph": "X", "cat": "kernel", "ts": 10.0, "dur": 20.0},
          {"name": "k2", "ph": "X", "cat": "kernel", "ts": 25.0, "dur": 10.0},
          {"name": "k1", "ph": "X", "cat": "kernel", "ts": 60.0, "dur": 5.0},
          {"name": "aten::mm", "ph": "X", "cat": "cpu_op", "ts": 30.0,
           "dur": 40.0},
          {"name": "aten::add", "ph": "X", "cat": "cpu_op", "ts": 40.0,
           "dur": 10.0}]
    r = harness.reduce_trace({"traceEvents": ev})
    assert r.busy_s == pytest.approx(30e-6)
    assert r.window_s == pytest.approx(100e-6)
    assert r.device_ops == [["k1", pytest.approx(25e-6)],
                            ["k2", pytest.approx(10e-6)]]
    # gaps: 0-10 (python), 35-60 (aten::add at 47.5), 65-100 (python)
    assert dict(r.idle_gaps) == {"python": pytest.approx(45e-6),
                                 "aten::add": pytest.approx(25e-6)}


def test_rasters_equal_the_planners():
    cfg = Config(diffusion=True, flex=True).finalize()
    data = synthetic.generate_dataset(9, 6, cfg, scene_len=38)
    for c, v in zip(data["scene_center_dense"], data["scene_lane_valids"]):
        m, o, r = sim.rasterize_corridor(c, v)
        m2, o2, r2 = traffic.corridor(c, v)
        assert np.array_equal(m, m2) and np.array_equal(o, o2) and r == r2
