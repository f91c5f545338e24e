"""A fake ``nuscenes`` devkit at the exact API surface the extraction
calls, without jax: the tables of ``NuScenes`` (records chained by
``token`` / ``next``, LIDAR_TOP ego poses with (w, x, y, z) quaternions,
vehicle and pedestrian annotations) and ``NuScenesMap``
(``get_records_in_radius`` over two layers, ``discretize_lanes``,
``get_outgoing_lane_ids``, ``arcline_path_3``,
``explorer.layers_on_point``, ``get_map_mask``), injected into
``sys.modules`` by :func:`fake_devkit_ctx`.  A copy of the stand-ins in
``tests/test_devkit_shim.py`` that imports neither jax nor ``pstl_tpu``,
so that ``tests/test_torch_extract.py`` and ``chip_smoke.py`` (on the
card's host) run the port's ``extract_dataset`` through the same devkit
code path; ``GOLDEN`` / ``GOLDEN_CFG`` / ``GOLDEN_STRIDE`` name the
committed capsule ``tests/golden/make_extract_golden.py`` writes and the
arguments it was written with.
"""

import contextlib
import importlib
import math
import os
import sys
import types

import numpy as np

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "extract_golden_v1.0-mini.npz")
#: ``make_extract_golden.CFG_KW`` and ``SAMPLE_STRIDE``
GOLDEN_CFG = dict(n_neighbors=2, n_randoms=2)
GOLDEN_STRIDE = 6

LANE_OFF = 3.5
DT = 0.5
L_FRAMES = 40
V_EGO = 5.0


def quat_for_heading(th):
    """Inverse of extract.heading_from_quaternion's pi-roll convention."""
    r = math.pi - th
    return [math.cos(r / 2.0), math.sin(r / 2.0), 0.0, 0.0]


def _lane(y, x0, x1, step=0.5):
    xs = np.arange(x0, x1 + 1e-6, step)
    return [(float(x), float(y), 0.0) for x in xs]


class FakeNuScenesMap:
    """Devkit NuScenesMap stand-in: 3 parallel lanes along +x (current /
    left / right), each split into two graph-connected arcline records;
    drivable band |y| <= 5.5; no intersections."""

    def __init__(self, dataroot=None, map_name=None):
        self.map_name = map_name
        self._lanes = {}
        for name, y in (("c", 0.0), ("l", LANE_OFF), ("r", -LANE_OFF)):
            self._lanes[f"{name}0"] = _lane(y, -10.0, 60.0)
            self._lanes[f"{name}1"] = _lane(y, 60.5, 220.0)
        # one lane lives in the lane_connector layer to exercise the
        # two-layer radius query
        self._connector_ids = {"c1", "l1", "r1"}
        self.arcline_path_3 = dict(self._lanes)
        self.explorer = self._Explorer()

    class _Explorer:
        @staticmethod
        def layers_on_point(x, y):
            drivable = "drv_token" if (-20.0 <= x <= 240.0
                                       and abs(y) <= 5.5) else ""
            seg = "seg_token" if drivable else ""
            return {"drivable_area": drivable, "road_segment": seg}

    def get(self, table, token):
        assert table == "road_segment" and token == "seg_token"
        return {"is_intersection": False, "token": token}

    def get_records_in_radius(self, x, y, radius, layers):
        out = {layer: [] for layer in layers}
        for lid, pts in self._lanes.items():
            arr = np.asarray(pts)
            if np.min(np.hypot(arr[:, 0] - x, arr[:, 1] - y)) <= radius:
                layer = ("lane_connector" if lid in self._connector_ids
                         else "lane")
                if layer in out:
                    out[layer].append(lid)
        return out

    def discretize_lanes(self, ids, resolution):
        return {lid: list(self._lanes[lid]) for lid in ids
                if lid in self._lanes}

    def get_outgoing_lane_ids(self, lane_id):
        return [lane_id[:-1] + "1"] if lane_id.endswith("0") else []

    def get_map_mask(self, patch, angle, layers, canvas):
        cx, cy, h, w = patch
        n_row, n_col = canvas
        ys = cy - h / 2 + (np.arange(n_row) + 0.5) * h / n_row
        xs = cx - w / 2 + (np.arange(n_col) + 0.5) * w / n_col
        mask = ((np.abs(ys)[:, None] <= 5.5)
                & (xs[None, :] >= -20.0) & (xs[None, :] <= 240.0))
        return [mask.astype(np.uint8)]


def _discretize_lane(record, resolution_meters):
    return list(record)


class FakeNuScenes:
    """Devkit NuScenes stand-in: 2 scenes on the same map, each a straight
    drive along y=0 with one left-lane vehicle neighbor."""

    constructed = 0

    def __init__(self, version=None, dataroot=None, verbose=False):
        FakeNuScenes.constructed += 1
        self.version = version
        self.scene, self.log = [], []
        self.sample, self.sample_data = [], []
        self.ego_pose, self.sample_annotation = [], []
        self.log.append({"token": "log0", "location": "fake-town"})
        for si in range(2):
            first = self._build_scene(si)
            self.scene.append({
                "token": f"scene{si}", "log_token": "log0",
                "name": f"scene-{si:04d}", "nbr_samples": L_FRAMES,
                "first_sample_token": first,
            })

    def _build_scene(self, si):
        x_off = 5.0 * si
        for ti in range(L_FRAMES):
            tok = f"s{si}_{ti}"
            nxt = f"s{si}_{ti + 1}" if ti + 1 < L_FRAMES else ""
            sd_tok, ep_tok = f"sd_{tok}", f"ep_{tok}"
            ann_tok = f"ann_{tok}"
            self.sample.append({
                "token": tok, "next": nxt,
                "data": {"LIDAR_TOP": sd_tok, "CAM_FRONT": "unused"},
                "anns": [ann_tok, f"ped_{tok}"],
            })
            self.sample_data.append(
                {"token": sd_tok, "ego_pose_token": ep_tok})
            self.ego_pose.append({
                "token": ep_tok,
                "translation": [x_off + ti * V_EGO * DT, 0.0, 0.0],
                "rotation": quat_for_heading(0.0),
            })
            # a car one lane to the left, slightly ahead, same speed
            self.sample_annotation.append({
                "token": ann_tok, "instance_token": f"car{si}",
                "category_name": "vehicle.car",
                "translation": [x_off + 8.0 + ti * V_EGO * DT,
                                LANE_OFF, 0.0],
                "rotation": quat_for_heading(0.0),
                "size": [2.0, 4.5, 1.7],       # devkit order: w, l, h
            })
            # non-vehicle annotation must be filtered out
            self.sample_annotation.append({
                "token": f"ped_{tok}", "instance_token": f"ped{si}",
                "category_name": "human.pedestrian.adult",
                "translation": [0.0, 20.0, 0.0],
                "rotation": quat_for_heading(0.0),
                "size": [0.5, 0.5, 1.8],
            })
        return f"s{si}_0"


@contextlib.contextmanager
def fake_devkit_ctx(extract=None):
    """Inject the fake devkit into sys.modules and reload ``extract`` (the
    port's ``pstl_tpu_torch.data.extract`` by default) so its devkit code
    path runs; both are restored on exit."""
    if extract is None:
        from pstl_tpu_torch.data import extract
    had = extract.HAVE_NUSCENES
    root = types.ModuleType("nuscenes")
    nn = types.ModuleType("nuscenes.nuscenes")
    nn.NuScenes = FakeNuScenes
    me = types.ModuleType("nuscenes.map_expansion")
    ma = types.ModuleType("nuscenes.map_expansion.map_api")
    ma.NuScenesMap = FakeNuScenesMap
    apu = types.ModuleType("nuscenes.map_expansion.arcline_path_utils")
    apu.discretize_lane = _discretize_lane
    root.nuscenes, root.map_expansion = nn, me
    me.map_api, me.arcline_path_utils = ma, apu
    mods = {"nuscenes": root, "nuscenes.nuscenes": nn,
            "nuscenes.map_expansion": me,
            "nuscenes.map_expansion.map_api": ma,
            "nuscenes.map_expansion.arcline_path_utils": apu}
    saved = {k: sys.modules.get(k) for k in mods}
    sys.modules.update(mods)
    try:
        importlib.reload(extract)
        assert extract.HAVE_NUSCENES
        FakeNuScenes.constructed = 0
        yield
    finally:
        for k, old in saved.items():
            if old is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = old
        importlib.reload(extract)
        assert extract.HAVE_NUSCENES == had
