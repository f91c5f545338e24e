"""Offline NuScenes -> tensor-cache extraction: the port's own copy of
``pstl_tpu/data/extract.py`` (the card's host cannot import ``pstl_tpu``,
whose ``__init__`` imports jax).  Pure numpy; it needs neither torch nor a
card, and the devkit only for the real-data entry point.  Its arrays equal
the JAX package's bit for bit (``tests/test_torch_extract.py``: every mock
case through both, and the committed golden capsule).

Parity target: the reference's live NuScenes access layer (``nusc_api.py``)
and ``--collect_data`` mode (``nusc_train.py:190-208``), restructured as a
one-time offline tool: the nuscenes-devkit runs only here; training and the
closed-loop simulator consume the resulting fixed-shape array store (the
same per-sample schema ``data/synthetic.py`` emits, expanded to multiple
(scene, t) samples per scene like the reference's split files), so no
devkit code runs at run time.

Architecture: a small :class:`MapAdapter` protocol isolates every map query
the extraction needs (lanes near a point, outgoing lane graph, drivable /
intersection point tests, drivable-area rasterization).  All the behavior
-- lane selection scoring, graph expansion, left/right lateral search,
same-lane dedup, intersection suppression, u-turn feasibility and gating,
high-level labeling, neighbor track assembly -- is numpy on top of the
adapter, tested against a mock map without the devkit, and the
devkit-backed :class:`NuScenesMapAdapter` is a thin shim.

Reference behavior map:
- current-lane selection score = min point dist + mean traj dist + heading
  penalty ``(1-cos)/2``, heading gate 0.8       (nusc_api.py:191-220)
- outgoing-lane expansion by (endpoint dist + heading) best-first until the
  lane covers the trajectory length (+10 m)     (nusc_api.py:222-256)
- index-even waypoint resampling                (nusc_api.py:258-267)
- left/right: +-LANE_WIDTH lateral probe, nearest lane != current, expand,
  intersection suppression unless the labeled maneuver points there
                                                (nusc_api.py:383-468)
- same-lane dedup: mean min point distance < 0.5 m -> invalid
                                                (nusc_api.py:481-514)
- u-turn feasibility: opposite heading cos < -0.9, speed <= 3, lane gap
  <= 8 m, drivable probes 4/6/8 m ahead of the midpoint
                                                (nusc_api.py:274-304)
- u-turn gating of side lanes, status codes -1..5
                                                (nusc_dataset.py:158-188)
- high-level labels from annotation keyframes with the switch-time window
  rule (nusc_api.py:529-560); lateral-displacement heuristic fallback when
  no annotations exist
- per-scene drivable-area raster for the closed-loop out-of-lane check
  (the reference queries ``layers_on_point`` live, nusc_sim.py:190-211)
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:  # devkit only needed for the real-data entry point
    from nuscenes.nuscenes import NuScenes  # type: ignore
    from nuscenes.map_expansion.map_api import NuScenesMap  # type: ignore
    HAVE_NUSCENES = True
except Exception:  # pragma: no cover - devkit not installed in CI
    HAVE_NUSCENES = False

LANE_WIDTH = 4.0        # lateral probe distance (nusc_api.py:495)
DIST_THRES = 7.0        # side-lane acceptance distance (nusc_api.py:324)
MIN_CONSIDER_LEN = 20.0  # minimum lane length (nusc_api.py:325)
DEDUP_THRES = 0.5       # same-lane mean distance (nusc_api.py:509-514)
HEAD_GATE = 0.8         # current-lane heading gate (nusc_api.py:219-221)


# ---------------------------------------------------------------------------
# map adapter
# ---------------------------------------------------------------------------

class MapAdapter:
    """Minimal map surface the extractor needs.  Implementations: the
    devkit-backed :class:`NuScenesMapAdapter` and test mocks."""

    def lanes_near(self, x: float, y: float,
                   radius: float) -> Dict[str, np.ndarray]:
        """lane_id -> discretized poses (m, 3) within ``radius`` of (x, y)."""
        raise NotImplementedError

    def outgoing(self, lane_id: str) -> List[str]:
        raise NotImplementedError

    def lane_pts(self, lane_id: str) -> Optional[np.ndarray]:
        """Discretized poses (m, 3) for a lane id, or None."""
        raise NotImplementedError

    def drivable_at(self, x: float, y: float) -> bool:
        raise NotImplementedError

    def is_intersection_at(self, x: float, y: float) -> bool:
        raise NotImplementedError

    def drivable_mask(self, center_xy: Sequence[float], half_size: float,
                      resolution: float) -> np.ndarray:
        """(H, W) bool raster of the drivable area on a square patch.
        Row i, col j covers world point ``center + ((j+.5)*res - half,
        (i+.5)*res - half)``.  Default: pointwise ``drivable_at`` queries
        (mocks); real adapters use the devkit's mask API."""
        n = int(round(2 * half_size / resolution))
        mask = np.zeros((n, n), bool)
        for i in range(n):
            wy = center_xy[1] - half_size + (i + 0.5) * resolution
            for j in range(n):
                wx = center_xy[0] - half_size + (j + 0.5) * resolution
                mask[i, j] = self.drivable_at(wx, wy)
        return mask


class NuScenesMapAdapter(MapAdapter):  # pragma: no cover - needs devkit
    """Thin devkit shim (nusc_api.py query patterns)."""

    def __init__(self, nusc_map):
        self.m = nusc_map
        self._cache: Dict[str, np.ndarray] = {}

    def lanes_near(self, x, y, radius):
        recs = self.m.get_records_in_radius(x, y, radius,
                                            ["lane", "lane_connector"])
        ids = recs["lane"] + recs["lane_connector"]
        pts = self.m.discretize_lanes(ids, 0.5)
        return {k: np.asarray(v) for k, v in pts.items() if len(v) >= 2}

    def outgoing(self, lane_id):
        return self.m.get_outgoing_lane_ids(lane_id)

    def lane_pts(self, lane_id):
        if lane_id in self._cache:
            return self._cache[lane_id]
        from nuscenes.map_expansion import arcline_path_utils as apu
        rec = self.m.arcline_path_3.get(lane_id)
        if not rec:
            return None
        pts = np.asarray(apu.discretize_lane(rec, resolution_meters=0.5))
        self._cache[lane_id] = pts
        return pts

    def drivable_at(self, x, y):
        return self.m.explorer.layers_on_point(x, y)["drivable_area"] != ""

    def is_intersection_at(self, x, y):
        layers = self.m.explorer.layers_on_point(x, y)
        tok = layers.get("road_segment", "")
        if tok == "":
            return False
        return bool(self.m.get("road_segment", tok)["is_intersection"])

    def drivable_mask(self, center_xy, half_size, resolution):
        n = int(round(2 * half_size / resolution))
        patch = (center_xy[0], center_xy[1], 2 * half_size, 2 * half_size)
        mask = self.m.get_map_mask(patch, 0.0, ["drivable_area"], (n, n))[0]
        return mask.astype(bool)


# ---------------------------------------------------------------------------
# pure-numpy helpers (unit-tested)
# ---------------------------------------------------------------------------

def angle_penalty(a: float, b: float) -> float:
    """Heading distance ``(1 - cos(a-b))/2`` (nusc_api.py:175-176)."""
    return 0.5 * (1.0 - math.cos(a - b))


def traj_len(traj: np.ndarray) -> float:
    return float(np.sum(np.linalg.norm(np.diff(traj[:, :2], axis=0),
                                       axis=-1)))


def heading_from_quaternion(q: Sequence[float]) -> float:
    """Reference heading convention: ``pi - roll`` of the (w, x, y, z)
    LIDAR ego-pose quaternion (nusc_api.py:167-168 quirk, reproduced)."""
    w, x, y, z = q
    roll = math.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    return math.pi - roll


def resample_wpts(poses: np.ndarray, n_segs: int) -> np.ndarray:
    """Index-even waypoint subsampling (nusc_api.py:258-267 — the reference
    picks round(linspace) INDICES, not arc-length positions)."""
    idx = np.round(np.linspace(0, poses.shape[0] - 1, n_segs)).astype(int)
    return poses[idx].astype(np.float32)


def resample_polyline(pts: np.ndarray, n_out: int) -> np.ndarray:
    """Arc-length uniform resampling of an (m, 2) polyline to (n_out, 3)
    waypoints (x, y, heading) — used for the dense sim centerline."""
    pts = np.asarray(pts, np.float64)
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=-1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = max(s[-1], 1e-6)
    si = np.linspace(0.0, total, n_out)
    x = np.interp(si, s, pts[:, 0])
    y = np.interp(si, s, pts[:, 1])
    dx = np.gradient(x)
    dy = np.gradient(y)
    th = np.arctan2(dy, dx)
    return np.stack([x, y, th], axis=-1).astype(np.float32)


def knn_pad_neighbors(ego_xy: np.ndarray, rows: List[np.ndarray],
                      k: int) -> np.ndarray:
    """Keep the k nearest (valid, x, y, th, v, L, W) rows, zero-pad the rest
    (nusc_api.py:149-162)."""
    out = np.zeros((k, 7), np.float32)
    if rows:
        arr = np.stack(rows)
        d = np.linalg.norm(arr[:, 1:3] - ego_xy[None, :2], axis=-1)
        order = np.argsort(d)[:k]
        out[:len(order)] = arr[order]
    return out


def interp_track(times: np.ndarray, states: np.ndarray,
                 query_times: np.ndarray) -> np.ndarray:
    """Linear interpolation of (x, y, th, v) samples with constant-velocity
    extrapolation beyond the last observation (nusc_api.py:634-683)."""
    out = np.zeros((len(query_times), 4), np.float32)
    for d in range(4):
        out[:, d] = np.interp(query_times, times, states[:, d])
    beyond = query_times > times[-1]
    if beyond.any():
        x0, y0, th0, v0 = states[-1]
        dt = query_times[beyond] - times[-1]
        out[beyond, 0] = x0 + v0 * np.cos(th0) * dt
        out[beyond, 1] = y0 + v0 * np.sin(th0) * dt
        out[beyond, 2] = th0
        out[beyond, 3] = v0
    return out


def select_current_lane(cands: Dict[str, np.ndarray],
                        ego_trajs: np.ndarray):
    """Current-lane selection (nusc_api.py:191-221): score = min point dist
    + mean-of-min traj dist (first 5 states) + heading penalty; reject when
    the heading penalty alone exceeds 0.8.  Returns (lane_id, poses,
    nearest_idx) or ("", None, 0)."""
    x, y = ego_trajs[0, 0], ego_trajs[0, 1]
    best, best_id, best_poses, best_i, best_head = np.inf, "", None, 0, 0.0
    for lane_id, poses in cands.items():
        pts = poses[:, :2]
        d = np.linalg.norm(pts - [x, y], axis=1)
        i = int(np.argmin(d))
        traj_dist = float(np.linalg.norm(
            pts[None, :] - ego_trajs[:5, None, :2], axis=2).min(1).mean())
        head = angle_penalty(ego_trajs[0, 2], poses[i, 2])
        score = float(d[i]) + traj_dist + head
        if score < best:
            best, best_id, best_poses, best_i, best_head = (
                score, lane_id, poses, i, head)
    if best_id and best_head > HEAD_GATE:
        return "", None, 0
    return best_id, best_poses, best_i


def expand_lane(adapter: MapAdapter, lane_id: str, poses: np.ndarray,
                n_expands: int, target_len: float) -> np.ndarray:
    """Best-first outgoing-lane expansion (nusc_api.py:222-256): append the
    outgoing lane minimizing endpoint distance + heading penalty until the
    concatenated length exceeds ``target_len``."""
    chain = [poses]
    cur = lane_id
    total = traj_len(poses)
    for _ in range(n_expands):
        if total > target_len:
            break
        nxt = []
        for out_id in adapter.outgoing(cur):
            out_pts = adapter.lane_pts(out_id)
            if out_pts is None or len(out_pts) < 2:
                continue
            derr = float(np.linalg.norm(out_pts[0, :2] - chain[-1][-1, :2]))
            herr = angle_penalty(out_pts[0, 2], chain[-1][-1, 2])
            nxt.append((derr + herr, out_id, out_pts))
        if not nxt:
            break
        nxt.sort(key=lambda t: t[0])
        _, cur, best_pts = nxt[0]
        chain.append(best_pts)
        total += traj_len(best_pts)
    return np.concatenate(chain, axis=0)


def same_lane_dedup(curr_full: np.ndarray, side_full: np.ndarray) -> bool:
    """True when the side lane is really the current lane: symmetric mean
    min point distance < 0.5 m (compute_traj_diff, nusc_api.py:481-514).

    Computed via the squared-distance GEMM expansion |a|^2+|b|^2-2ab
    instead of a broadcast pairwise-norm tensor — exact same decision
    (sqrt commutes with the row-min), ~10x faster, and this call dominates
    extraction throughput (scripts/extract_bench.py)."""
    a = np.ascontiguousarray(curr_full[:, :2], np.float64)
    b = np.ascontiguousarray(side_full[:, :2], np.float64)
    a2 = np.einsum("id,id->i", a, a)
    b2 = np.einsum("id,id->i", b, b)
    d2 = np.maximum(a2[None, :] + b2[:, None] - 2.0 * (b @ a.T), 0.0)
    m_a = np.sqrt(d2.min(axis=0)).mean()      # per curr point -> nearest side
    m_b = np.sqrt(d2.min(axis=1)).mean()      # per side point -> nearest curr
    return float(min(m_a, m_b)) < DEDUP_THRES


def side_lane_search(adapter: MapAdapter, ego_trajs: np.ndarray, side: str,
                     curr_id: str, curr_full: Optional[np.ndarray],
                     n_expands: int, n_segs: int, highlevel: int = 0,
                     radius: float = 2.0):
    """Left/right centerline via a +-LANE_WIDTH lateral probe
    (nusc_api.py:383-468): nearest lane to the probe that isn't the current
    lane; expanded along the graph; suppressed at intersections unless the
    GT maneuver points to this side; deduped against the current lane.

    Returns (valid, wpts (n_segs, 3), full)."""
    x, y, th = ego_trajs[0, 0], ego_trajs[0, 1], ego_trajs[0, 2]
    want = (side == "left" and highlevel == 1) or \
        (side == "right" and highlevel == 2)
    if not want and adapter.is_intersection_at(x, y):
        return False, np.zeros((n_segs, 3), np.float32), None
    sgn = 1.0 if side == "left" else -1.0
    px = x + LANE_WIDTH * math.cos(th + sgn * math.pi / 2)
    py = y + LANE_WIDTH * math.sin(th + sgn * math.pi / 2)
    cands = adapter.lanes_near(px, py, radius)
    best, best_id, best_poses, best_i = DIST_THRES, "", None, 0
    for lane_id, poses in cands.items():
        if lane_id == curr_id:
            continue
        d = np.linalg.norm(poses[:, :2] - [px, py], axis=1)
        i = int(np.argmin(d))
        if float(d[i]) < best:
            best, best_id, best_poses, best_i = float(d[i]), lane_id, poses, i
    if not best_id:
        return False, np.zeros((n_segs, 3), np.float32), None
    tail = best_poses[best_i:]
    target = max(MIN_CONSIDER_LEN, traj_len(ego_trajs))
    full = expand_lane(adapter, best_id, tail, n_expands, target)
    if curr_full is not None and same_lane_dedup(curr_full, full):
        return False, np.zeros((n_segs, 3), np.float32), None
    return True, resample_wpts(full, n_segs), full


def current_lane_search(adapter: MapAdapter, ego_trajs: np.ndarray,
                        n_expands: int, n_segs: int, radius: float = 4.0):
    """Current centerline: selection + expansion (+10 m margin like
    nusc_api.py:253-255).  Returns (valid, lane_id, wpts, full)."""
    cands = adapter.lanes_near(ego_trajs[0, 0], ego_trajs[0, 1], radius)
    lane_id, poses, i = select_current_lane(cands, ego_trajs)
    if not lane_id:
        return False, "", np.zeros((n_segs, 3), np.float32), None
    tail = poses[max(0, i - 5):]
    target = max(MIN_CONSIDER_LEN, traj_len(ego_trajs)) + 10.0
    full = expand_lane(adapter, lane_id, tail, n_expands, target)
    return True, lane_id, resample_wpts(full, n_segs), full


def uturn_feasible(adapter: MapAdapter, ego_state: np.ndarray,
                   curr_wpts: np.ndarray, test_wpts: np.ndarray) -> bool:
    """is_able_uturn (nusc_api.py:274-304): near-opposite heading, slow ego,
    close lanes, drivable gap probes at 4/6/8 m ahead of the midpoint."""
    if math.cos(test_wpts[0, 2] - curr_wpts[0, 2]) >= -0.9:
        return False
    if ego_state[3] > 3.0:
        return False
    if np.linalg.norm(test_wpts[0, :2] - curr_wpts[0, :2]) > 8.0:
        return False
    mid = (test_wpts[0, :2] + curr_wpts[0, :2]) / 2
    th = curr_wpts[0, 2]
    for d in (4.0, 6.0, 8.0):
        p = (mid[0] + d * math.cos(th), mid[1] + d * math.sin(th))
        if not adapter.drivable_at(p[0], p[1]):
            return False
    return True


def uturn_gate(adapter: MapAdapter, ego_state: np.ndarray,
               curr_wpts: np.ndarray, side_wpts: np.ndarray,
               side_valid: bool, side: str,
               status: int) -> Tuple[bool, np.ndarray, int]:
    """Side-lane u-turn gating (nusc_dataset.py:158-188).  Status codes:
    -1 none; 0/1 normal left/right; 2/3 infeasible l/r u-turn (side lane
    invalidated); 4/5 feasible l/r u-turn (side lane kept)."""
    if not side_valid:
        return side_valid, side_wpts, status
    base = 0 if side == "left" else 1
    if math.cos(side_wpts[0, 2] - curr_wpts[0, 2]) < 0:
        if uturn_feasible(adapter, ego_state, curr_wpts, side_wpts):
            return True, side_wpts, base + 4
        return False, side_wpts * 0, base + 2
    return True, side_wpts, base


def high_level_from_keyframes(keyframes: Dict[int, float], ti: int,
                              nt: int) -> float:
    """Annotation-keyframe labeling with the switch-window rule
    (nusc_api.py:529-560): before a switch time, the segment is labeled by
    the PRE-switch keyframe only if the switch falls inside [ti, ti+nt);
    after, by the latest switch keyframe at or before ti."""
    keys = sorted(keyframes)
    if len(keys) == 1:
        return float(keyframes[keys[0]])
    for k_i in range(1, len(keys)):
        if ti < keys[k_i]:
            # region [keys[k_i-1], keys[k_i]): lane-keep unless the next
            # switch falls inside the horizon, then the REGION's keyframe
            # label (reproduced exactly, incl. the 3-keyframe middle-region
            # behavior at nusc_api.py:545-555)
            if ti + nt < keys[k_i]:
                return 0.0
            return float(keyframes[keys[k_i - 1]])
    return float(keyframes[keys[-1]])


def label_high_level(ego_traj: np.ndarray, lane_wpts: np.ndarray,
                     change_thresh: float = 1.75) -> int:
    """Heuristic fallback label from the lateral-offset trend relative to
    the starting lane: 0 keep, 1 left, 2 right, 3 outlier."""
    def lateral(p):
        d2 = np.sum((lane_wpts[:, :2] - p[:2]) ** 2, axis=-1)
        i = int(np.argmin(d2))
        nx, ny = -np.sin(lane_wpts[i, 2]), np.cos(lane_wpts[i, 2])
        return (p[0] - lane_wpts[i, 0]) * nx + (p[1] - lane_wpts[i, 1]) * ny

    delta = lateral(ego_traj[-1]) - lateral(ego_traj[0])
    if np.std(ego_traj[:, 3]) > 4.0:       # erratic
        return 3
    if delta > change_thresh:
        return 1
    if delta < -change_thresh:
        return 2
    return 0


# ---------------------------------------------------------------------------
# scene walk (adapter-backed; devkit only inside NuScenesSceneSource)
# ---------------------------------------------------------------------------

def extract_sample(adapter: MapAdapter, ego_full: np.ndarray,
                   nei_full: np.ndarray, ti: int, cfg,
                   keyframes: Optional[Dict[int, float]] = None
                   ) -> Optional[Dict[str, np.ndarray]]:
    """One (scene, t) training sample from scene-level tensors + the map.

    ego_full: (L, 4) GT states; nei_full: (K, L, 7) neighbor tracks.
    Returns the full per-sample schema (data/synthetic.py keys) or None
    when no current lane is found.
    """
    nt, k = cfg.nt, cfg.n_neighbors
    ego_seg = ego_full[ti:ti + nt]                          # (nt, 4)
    if ego_seg.shape[0] < nt:
        return None
    ok, curr_id, curr_wpts, curr_full = current_lane_search(
        adapter, ego_seg, cfg.n_expands, cfg.n_segs)
    if not ok:
        return None

    if keyframes:
        hl = high_level_from_keyframes(keyframes, ti, nt)
    else:
        hl = float(label_high_level(ego_seg, curr_wpts))

    lv, left_wpts, _ = side_lane_search(
        adapter, ego_seg, "left", curr_id, curr_full, cfg.n_expands,
        cfg.n_segs, highlevel=int(hl))
    rv, right_wpts, _ = side_lane_search(
        adapter, ego_seg, "right", curr_id, curr_full, cfg.n_expands,
        cfg.n_segs, highlevel=int(hl))

    status = -1
    lv, left_wpts, status = uturn_gate(adapter, ego_seg[0], curr_wpts,
                                       left_wpts, lv, "left", status)
    rv, right_wpts, status = uturn_gate(adapter, ego_seg[0], curr_wpts,
                                        right_wpts, rv, "right", status)

    ego_traj = np.concatenate(
        [ego_seg, np.full((nt, 1), cfg.ego_L), np.full((nt, 1), cfg.ego_W)],
        axis=-1).astype(np.float32)
    nei_seg = nei_full[:, ti:ti + nt].astype(np.float32)    # (K, nt, 7)
    return {
        "ego_traj": ego_traj,
        "neighbors": nei_seg[:, 0],
        "neighbors_traj": nei_seg,
        "currlane_wpts": curr_wpts.astype(np.float32),
        "leftlane_wpts": (left_wpts * float(lv)).astype(np.float32),
        "rightlane_wpts": (right_wpts * float(rv)).astype(np.float32),
        "curr_id": np.array([1.0], np.float32),
        "left_id": np.array([float(lv)], np.float32),
        "right_id": np.array([float(rv)], np.float32),
        "gt_high_level": np.array([hl], np.float32),
        "uturn_status": np.array([float(status)], np.float32),
    }


def extract_scene(adapter: MapAdapter, ego_full: np.ndarray,
                  nei_full: np.ndarray, cfg, sample_stride: int = 1,
                  keyframes: Optional[Dict[int, float]] = None,
                  raster_half: float = 60.0, raster_res: float = 0.5
                  ) -> Tuple[List[Dict], Optional[Dict]]:
    """All (scene, t) samples + scene-level closed-loop tensors.

    Returns (samples, scene_rec).  samples[i]["ti"] records the source
    frame; scene_rec carries the sim tensors incl. the rasterized
    drivable-area mask (out-of-lane parity with nusc_sim.py:190-211).
    """
    L = ego_full.shape[0]
    nt = cfg.nt
    samples = []
    for ti in range(0, max(L - nt, 1), sample_stride):
        s = extract_sample(adapter, ego_full, nei_full, ti, cfg,
                           keyframes=keyframes)
        if s is None:
            continue
        s["ti"] = np.array(ti, np.int64)
        samples.append(s)
    if not samples:
        return [], None

    # scene tensors: dense centerline along the full GT corridor
    ok, _, _, full0 = current_lane_search(adapter, ego_full[:max(L - nt, 2)],
                                          cfg.n_expands, cfg.n_segs)
    if not ok:
        return samples, None
    center_dense = resample_polyline(full0[:, :2], 200)

    # per-t lane tensors for the closed-loop sim: TRUE left/right windows,
    # validity and maneuver label at every extracted t (the reference
    # re-queries these around the simulated pose each sim step,
    # nusc_sim.py:145-156; the sim selects the entry nearest the simulated
    # pose).  Frames between strided samples inherit the nearest earlier
    # sample's entry.
    Lt = max(L - nt, 1)
    lanes_t = np.zeros((Lt, 3, cfg.n_segs, 3), np.float32)
    lane_valids_t = np.zeros((Lt, 3), np.float32)
    hl_t = np.zeros((Lt,), np.float32)
    sample_tis = [int(s["ti"]) for s in samples]
    si = 0
    for t in range(Lt):
        while si + 1 < len(samples) and sample_tis[si + 1] <= t:
            si += 1
        s = samples[si]
        lanes_t[t, 0] = s["currlane_wpts"]
        lanes_t[t, 1] = s["leftlane_wpts"]
        lanes_t[t, 2] = s["rightlane_wpts"]
        lane_valids_t[t] = [float(s["curr_id"][0]), float(s["left_id"][0]),
                            float(s["right_id"][0])]
        hl_t[t] = float(s["gt_high_level"][0])

    mid = ego_full[:, :2].mean(axis=0)
    # the patch must cover wherever the sim ego can plausibly drive: the GT
    # corridor extent plus margin (outside the patch counts as off-road)
    extent = float(np.abs(np.concatenate(
        [ego_full[:, :2] - mid, center_dense[:, :2] - mid])).max())
    half = max(raster_half, extent + 25.0)
    mask = adapter.drivable_mask(mid, half, raster_res)
    first = samples[0]
    scene_rec = {
        "scene_ego_full": ego_full.astype(np.float32),
        "scene_nei_full": nei_full.astype(np.float32),
        "scene_center_dense": center_dense,
        "scene_lane_valids": np.array(
            [1.0, float(first["left_id"][0]), float(first["right_id"][0])],
            np.float32),
        "scene_len": np.array(max(L - nt - 2, 1), np.int32),
        "scene_lanes_t": lanes_t,
        "scene_lane_valids_t": lane_valids_t,
        "scene_hl_t": hl_t,
        "scene_drivable": mask.astype(np.bool_),
        "scene_drivable_origin": np.array(
            [mid[0] - half, mid[1] - half], np.float32),
        "scene_drivable_res": np.array(raster_res, np.float32),
    }
    return samples, scene_rec


# ---------------------------------------------------------------------------
# devkit-backed scene source
# ---------------------------------------------------------------------------

class TableCache:
    """Pickled one-pass snapshot of the NuScenes DB tables the extraction
    walks — the analogue of the reference's ``NuscenesPkl`` pickle cache
    (nusc_api.py:15-90, self-benchmarked at :938-966).

    The devkit's ``nusc.get`` is a dict lookup behind several layers of
    indirection, and constructing ``NuScenes`` re-parses hundreds of MB of
    JSON; this cache walks the tables ONCE, keeps plain token->record
    dicts for exactly the tables extraction touches, and pickles them so a
    re-run (or a second extraction pass) skips the devkit entirely.
    Exposes the ``.get(table, token)`` / ``.scene`` surface
    ``ego_track_from_scene`` / ``neighbor_tracks_from_scene`` consume, so
    it is a drop-in ``nusc`` replacement for them.
    """

    TABLES = ("sample", "sample_data", "ego_pose", "sample_annotation",
              "log")

    def __init__(self, tables: Dict[str, Dict[str, dict]],
                 scene: List[dict]):
        self._tables = tables
        self.scene = scene

    @classmethod
    def from_nusc(cls, nusc) -> "TableCache":
        tables: Dict[str, Dict[str, dict]] = {}
        for name in cls.TABLES:
            tables[name] = {r["token"]: r for r in getattr(nusc, name)}
        return cls(tables, list(nusc.scene))

    def get(self, table: str, token: str) -> dict:
        return self._tables[table][token]

    def save(self, path: str) -> None:
        import pickle
        with open(path, "wb") as f:
            pickle.dump({"tables": self._tables, "scene": self.scene}, f,
                        protocol=4)

    @classmethod
    def load(cls, path: str) -> "TableCache":
        import pickle
        with open(path, "rb") as f:
            d = pickle.load(f)
        return cls(d["tables"], d["scene"])


def ego_track_from_scene(nusc, scene, dt: float) -> np.ndarray:
    """(L, 4) GT ego states from the LIDAR ego poses (nusc_api.py:126-144):
    heading via the pi-roll quirk, speed by pose finite differences."""
    tokens = []
    tok = scene["first_sample_token"]
    while tok:
        tokens.append(tok)
        tok = nusc.get("sample", tok)["next"]
    poses = []
    for t in tokens:
        sd = nusc.get("sample_data",
                      nusc.get("sample", t)["data"]["LIDAR_TOP"])
        ep = nusc.get("ego_pose", sd["ego_pose_token"])
        th = heading_from_quaternion(ep["rotation"])
        poses.append([ep["translation"][0], ep["translation"][1], th])
    poses = np.asarray(poses)
    v = np.zeros(len(poses))
    if len(poses) > 1:
        d = np.linalg.norm(np.diff(poses[:, :2], axis=0), axis=-1) / dt
        v[:-1] = d
        v[-1] = d[-1]
    return np.concatenate([poses[:, :2], poses[:, 2:3], v[:, None]],
                          axis=-1).astype(np.float32)


def neighbor_tracks_from_scene(nusc, scene, ego_full: np.ndarray, cfg
                               ) -> np.ndarray:
    """(K, L, 7) neighbor tracks: per-instance vehicle annotations ranked by
    start distance, linear interp at missing keyframes, const-vel
    extrapolation (nusc_api.py:613-683)."""
    tokens = []
    tok = scene["first_sample_token"]
    while tok:
        tokens.append(tok)
        tok = nusc.get("sample", tok)["next"]
    L = len(tokens)
    nei_full = np.zeros((cfg.n_neighbors, L, 7), np.float32)
    inst_tracks: Dict[str, List] = {}
    for ti, t in enumerate(tokens):
        samp = nusc.get("sample", t)
        for ann_tok in samp["anns"]:
            ann = nusc.get("sample_annotation", ann_tok)
            if "vehicle" not in ann["category_name"]:
                continue
            yaw = heading_from_quaternion(ann["rotation"])
            inst_tracks.setdefault(ann["instance_token"], []).append(
                (ti, ann["translation"][0], ann["translation"][1], yaw,
                 ann["size"][1], ann["size"][0]))
    scored = []
    for inst, obs in inst_tracks.items():
        obs = sorted(obs)
        d0 = np.linalg.norm(np.asarray(obs[0][1:3])
                            - ego_full[obs[0][0], :2])
        scored.append((d0, inst, obs))
    scored.sort(key=lambda x: x[0])
    for slot, (_, inst, obs) in enumerate(scored[:cfg.n_neighbors]):
        times = np.asarray([o[0] for o in obs], float) * cfg.dt
        xy = np.asarray([[o[1], o[2]] for o in obs])
        th = np.asarray([o[3] for o in obs])
        if len(obs) > 1:
            vv = np.concatenate([
                np.linalg.norm(np.diff(xy, axis=0), axis=-1)
                / np.maximum(np.diff(times), 1e-3), [0.0]])
        else:
            vv = np.zeros(1)
        states = np.stack([xy[:, 0], xy[:, 1], th, vv], -1)
        track = interp_track(times, states, np.arange(L) * cfg.dt)
        nei_full[slot, :, 0] = 1.0
        nei_full[slot, :, 1:5] = track
        nei_full[slot, :, 5] = obs[0][4]
        nei_full[slot, :, 6] = obs[0][5]
        nei_full[slot, :obs[0][0], 0] = 0.0     # not yet observed
    return nei_full


def extract_dataset(cfg, version: str = "v1.0-trainval",
                    dataroot: Optional[str] = None,
                    out_path: str = "cache_nuscenes.npz",
                    sample_stride: int = 1,
                    max_scenes: Optional[int] = None,
                    anno_dir: Optional[str] = None,
                    table_cache_path: Optional[str] = None) -> str:
    """Full real-data extraction (requires devkit + NuScenes data): every
    scene -> multiple (scene, t) samples + per-scene sim tensors, saved as
    one array store consumable by SceneDataset / the closed-loop sim.

    ``anno_dir``: optional directory of per-scene high-level keyframe
    pickles ({t: label}) from the reference's annotation tool.
    ``table_cache_path``: pickled :class:`TableCache`; when it exists the
    DB tables load from it (skipping the devkit JSON parse entirely, like
    the reference's ``NuscenesPkl`` — nusc_api.py:15-90), else it is
    written after the first parse."""
    import os
    import pickle
    if cfg.mini:
        version = "v1.0-mini"
    if table_cache_path is None and dataroot:
        table_cache_path = os.path.join(dataroot,
                                        f"pstl_tables_{version}.pkl")
    if table_cache_path and os.path.exists(table_cache_path):
        nusc = TableCache.load(table_cache_path)
    else:
        if not HAVE_NUSCENES:
            raise RuntimeError(
                "nuscenes-devkit is not installed; use the synthetic scene "
                "source (pstl_tpu_torch.cli data) or install the devkit + "
                "dataset to extract real scenes.")
        nusc_live = NuScenes(version=version, dataroot=dataroot,
                             verbose=False)
        nusc = TableCache.from_nusc(nusc_live)
        if table_cache_path:
            nusc.save(table_cache_path)
    if not HAVE_NUSCENES:
        raise RuntimeError(
            "nuscenes-devkit is not installed (needed for the map API); "
            "use the synthetic scene source (pstl_tpu_torch.cli data) or "
            "install the devkit + dataset to extract real scenes.")
    adapters: Dict[str, NuScenesMapAdapter] = {}
    all_samples: List[Dict] = []
    scene_recs: List[Dict] = []
    for si, scene in enumerate(nusc.scene):
        if max_scenes is not None and si >= max_scenes:
            break
        loc = nusc.get("log", scene["log_token"])["location"]
        if loc not in adapters:
            adapters[loc] = NuScenesMapAdapter(
                NuScenesMap(dataroot=dataroot, map_name=loc))
        ego_full = ego_track_from_scene(nusc, scene, cfg.dt)
        if ego_full.shape[0] < cfg.nt + 2:
            continue
        nei_full = neighbor_tracks_from_scene(nusc, scene, ego_full, cfg)
        keyframes = None
        if anno_dir:
            p = os.path.join(anno_dir,
                             scene["first_sample_token"] + ".pkl")
            if os.path.exists(p):
                with open(p, "rb") as f:
                    keyframes = pickle.load(f)
        samples, scene_rec = extract_scene(
            adapters[loc], ego_full, nei_full, cfg,
            sample_stride=sample_stride, keyframes=keyframes)
        for s in samples:
            s["traj_i"] = np.array(si, np.int64)
        all_samples += samples
        if scene_rec is not None:
            scene_recs.append(scene_rec)
    data = pack_samples(all_samples, scene_recs)
    np.savez_compressed(out_path, **data)
    return out_path


def _pad_stack(arrs: List[np.ndarray], time_axis: int) -> np.ndarray:
    """Stack variable-length scene tensors, padding the time axis by
    repeating the final frame (episodes are capped by scene_len, so padded
    frames are never consumed)."""
    L = max(a.shape[time_axis] for a in arrs)
    out = []
    for a in arrs:
        pad = L - a.shape[time_axis]
        if pad:
            last = np.take(a, [-1], axis=time_axis)
            a = np.concatenate([a] + [last] * pad, axis=time_axis)
        out.append(a)
    return np.stack(out)


def pack_samples(samples: List[Dict], scene_recs: List[Dict]
                 ) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts; scene-level tensors are stacked separately
    under their scene_* keys (sample count != scene count is fine — the sim
    consumes only scene_* keys, training only per-sample keys).  Scenes of
    different length / raster size are padded to the batch maximum."""
    assert samples, "extraction produced no samples"
    data = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    scene_recs = [r for r in scene_recs if r is not None]
    if scene_recs:
        data["scene_ego_full"] = _pad_stack(
            [r["scene_ego_full"] for r in scene_recs], 0)
        data["scene_nei_full"] = _pad_stack(
            [r["scene_nei_full"] for r in scene_recs], 1)
        masks = [r["scene_drivable"] for r in scene_recs]
        H = max(m.shape[0] for m in masks)
        W = max(m.shape[1] for m in masks)
        dm = np.zeros((len(masks), H, W), np.bool_)
        for i, m in enumerate(masks):
            dm[i, :m.shape[0], :m.shape[1]] = m
        data["scene_drivable"] = dm
        for k in ("scene_lanes_t", "scene_lane_valids_t", "scene_hl_t"):
            if k in scene_recs[0]:
                data[k] = _pad_stack([r[k] for r in scene_recs], 0)
        for k in ("scene_center_dense", "scene_lane_valids", "scene_len",
                  "scene_drivable_origin", "scene_drivable_res"):
            data[k] = np.stack([r[k] for r in scene_recs])
    return data
