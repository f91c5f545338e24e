"""A frozen copy of ``pstl_tpu_torch/data/synthetic.py`` of the PyTorch port, kept as the benchmark's plain
reference: every kernel dispatch runs the plain version.  Do not edit to
follow the program."""


from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from perfbench.reference.port.config import Config

LANE_OFFSET = 3.5


def _arc_centerline(start_xy, start_th, curvature, length, n_pts):
    """Waypoints (n_pts, 3) of a constant-curvature arc."""
    s = np.linspace(0.0, length, n_pts)
    if abs(curvature) < 1e-6:
        th = np.full(n_pts, start_th)
        xs = start_xy[0] + s * np.cos(start_th)
        ys = start_xy[1] + s * np.sin(start_th)
    else:
        th = start_th + curvature * s
        xs = start_xy[0] + (np.sin(th) - np.sin(start_th)) / curvature
        ys = start_xy[1] - (np.cos(th) - np.cos(start_th)) / curvature
    return np.stack([xs, ys, th], axis=-1)


def _offset_lane(lane, offset):
    """Parallel lane at signed lateral offset (left positive)."""
    nx = -np.sin(lane[:, 2])
    ny = np.cos(lane[:, 2])
    out = lane.copy()
    out[:, 0] += nx * offset
    out[:, 1] += ny * offset
    return out


def _track_lane_controls(s0, lane_full, target_offset_fn, v_target, nt, dt,
                         w_max, a_max):
    """Feedback controller: steer toward a lateral offset from
    ``lane_full`` while regulating speed.  Returns (nt, 2)."""
    s = s0.copy()
    us = np.zeros((nt, 2))
    for t in range(nt):
        d2 = np.sum((lane_full[:, :2] - s[:2]) ** 2, axis=-1)
        i = int(np.argmin(d2))
        th_lane = lane_full[i, 2]
        nx, ny = -np.sin(th_lane), np.cos(th_lane)
        lat = (s[0] - lane_full[i, 0]) * nx + (s[1] - lane_full[i, 1]) * ny
        err = target_offset_fn(t) - lat
        th_des = th_lane + np.arctan2(0.45 * err, max(s[3], 1.0))
        dth = (th_des - s[2] + np.pi) % (2 * np.pi) - np.pi
        w = np.clip(2.0 * dth, -w_max, w_max)
        a = np.clip(1.0 * (v_target - s[3]), -a_max, a_max)
        us[t] = (w, a)
        s = s + np.array([s[3] * np.cos(s[2]), s[3] * np.sin(s[2]), w, a]) * dt
    return us


def _rollout_np(s0, us, dt):
    nt = us.shape[0]
    traj = np.zeros((nt + 1, 4))
    traj[0] = s0
    for t in range(nt):
        x, y, th, v = traj[t]
        traj[t + 1] = (x + v * np.cos(th) * dt, y + v * np.sin(th) * dt,
                       th + us[t, 0] * dt, v + us[t, 1] * dt)
    return traj


def label_high_level(ego_traj: np.ndarray, lane_wpts: np.ndarray,
                     change_thresh: float = 1.75) -> int:
    """Maneuver label from the lateral-offset trend relative to the starting
    lane (mirror of ``pstl_tpu.data.extract.label_high_level``)."""
    def lateral(p):
        d2 = np.sum((lane_wpts[:, :2] - p[:2]) ** 2, axis=-1)
        i = int(np.argmin(d2))
        nx, ny = -np.sin(lane_wpts[i, 2]), np.cos(lane_wpts[i, 2])
        return (p[0] - lane_wpts[i, 0]) * nx + (p[1] - lane_wpts[i, 1]) * ny

    delta = lateral(ego_traj[-1]) - lateral(ego_traj[0])
    if np.std(ego_traj[:, 3]) > 4.0:
        return 3
    if delta > change_thresh:
        return 1
    if delta < -change_thresh:
        return 2
    return 0


def generate_scene(rng: np.random.RandomState, cfg: Config,
                   scene_len: Optional[int] = None,
                   t_samples: int = 1,
                   t_stride: int = 4):
    """One scene (a dict), or a list of (scene, t0) samples when
    ``t_samples`` > 1.  See ``pstl_tpu.data.synthetic.generate_scene``."""
    nt, dt, k = cfg.nt, cfg.dt, cfg.n_neighbors
    L = scene_len or nt
    full_len = L + nt + 1

    # --- road ---------------------------------------------------------
    start_th = rng.uniform(-np.pi, np.pi)
    curvature = rng.uniform(-0.015, 0.015) * (rng.rand() < 0.7)
    start_xy = rng.uniform(-50, 50, 2)
    road_len = 40.0 + 12.0 * full_len * dt
    n_dense = 200
    center = _arc_centerline(start_xy, start_th, curvature,
                             road_len, n_dense)
    left_valid = rng.rand() < 0.6
    right_valid = rng.rand() < 0.6
    lanes_full = {
        "curr": center,
        "left": _offset_lane(center, LANE_OFFSET),
        "right": _offset_lane(center, -LANE_OFFSET),
    }

    # --- maneuver -----------------------------------------------------
    r = rng.rand()
    if r < 0.60:
        hl = 0
    elif r < 0.72 and left_valid:
        hl = 1
    elif r < 0.84 and right_valid:
        hl = 2
    elif r < 0.92:
        hl = 0
    else:
        hl = 3

    if rng.rand() < cfg.synth_low_speed_frac:
        v0 = rng.uniform(0.3, 3.0)
        v_target = np.clip(v0 + rng.uniform(-2.5, 1.5), 0.0, 4.0)
    else:
        v0 = rng.uniform(2.0, 9.0)
        v_target = np.clip(v0 + rng.uniform(-1.5, 1.5), 1.0, 10.0)
    s0 = np.array([center[2, 0], center[2, 1], center[2, 2]
                   + rng.uniform(-0.05, 0.05), v0])

    if hl == 0:
        offset_fn = lambda t: 0.0
    elif hl == 1:
        offset_fn = lambda t: LANE_OFFSET * min(1.0, max(0.0, (t - 2) / 8.0))
    elif hl == 2:
        offset_fn = lambda t: -LANE_OFFSET * min(1.0, max(0.0, (t - 2) / 8.0))
    else:
        amp = rng.uniform(1.5, 3.0)
        offset_fn = lambda t: amp * np.sin(t / 3.0)

    us = _track_lane_controls(s0, center, offset_fn, v_target, full_len, dt,
                              cfg.mul_w_max, cfg.mul_a_max)
    if hl == 3:
        us[:, 1] += rng.randn(full_len) * 1.5
        us[:, 1] = np.clip(us[:, 1], -cfg.mul_a_max, cfg.mul_a_max)
    ego_full = _rollout_np(s0, us, dt)

    # --- neighbors ------------------------------------------------------
    nei_full = np.zeros((k, full_len + 1, 7))
    for j in range(k):
        if rng.rand() < 0.75:
            lane_key = ["curr", "left", "right"][rng.randint(3)]
            lane = lanes_full[lane_key]
            i0 = rng.randint(0, n_dense // 2)
            nv = rng.uniform(0.0, 8.0)
            nth = lane[i0, 2]
            npos = lane[i0, :2] + rng.randn(2) * 0.3
            if np.linalg.norm(npos - s0[:2]) < 8.0:
                continue
            nL = rng.uniform(3.8, 5.2)
            nW = rng.uniform(1.6, 2.1)
            t_axis = np.arange(full_len + 1) * dt
            nei_full[j, :, 0] = 1.0
            nei_full[j, :, 1] = npos[0] + nv * np.cos(nth) * t_axis
            nei_full[j, :, 2] = npos[1] + nv * np.sin(nth) * t_axis
            nei_full[j, :, 3] = nth
            nei_full[j, :, 4] = nv
            nei_full[j, :, 5] = nL
            nei_full[j, :, 6] = nW

    def lane_window(lane_full_pts, pose, n_segs):
        d2 = np.sum((lane_full_pts[:, :2] - pose[:2]) ** 2, axis=-1)
        i0 = max(int(np.argmin(d2)) - 2, 0)
        step = max((n_dense - i0 - 1) // (n_segs * 2), 1)
        idx = np.clip(i0 + np.arange(n_segs) * step, 0, n_dense - 1)
        return lane_full_pts[idx]

    def build_sample(t0):
        s = make_observation(cfg, ego_full, nei_full, lanes_full,
                             left_valid, right_valid, hl, t0=t0,
                             lane_window_fn=lane_window)
        if t0 > 0:
            hl_t = label_high_level(ego_full[t0:t0 + nt],
                                    s["currlane_wpts"])
            if hl == 3:
                hl_t = 3 if hl_t == 3 or t0 < nt else hl_t
            s["gt_high_level"] = np.array([float(hl_t)], np.float32)
        s["uturn_status"] = np.array([-1.0], np.float32)
        return s

    sample = build_sample(0)
    if scene_len is not None:
        sample["scene_ego_full"] = ego_full.astype(np.float32)
        sample["scene_nei_full"] = nei_full.astype(np.float32)
        lanes_t = np.zeros((L, 3, cfg.n_segs, 3), np.float32)
        for t in range(L):
            for li, key in enumerate(("curr", "left", "right")):
                lanes_t[t, li] = lane_window(lanes_full[key], ego_full[t],
                                             cfg.n_segs)
        sample["scene_lanes_t"] = lanes_t
        sample["scene_len"] = np.array(L, np.int32)
        sample["scene_center_dense"] = center.astype(np.float32)
        sample["scene_lane_valids"] = np.array(
            [1.0, float(left_valid), float(right_valid)], np.float32)
    if t_samples <= 1:
        return sample
    samples = [sample]
    for si in range(1, t_samples):
        t0 = si * t_stride
        if t0 + nt > full_len:
            break
        samples.append(build_sample(t0))
    return samples


def make_observation(cfg: Config, ego_full, nei_full, lanes_full,
                     left_valid, right_valid, hl, t0, lane_window_fn):
    """Fixed-shape observation tensors at scene time t0."""
    nt = cfg.nt
    ego_seg = ego_full[t0:t0 + nt]
    ego_traj = np.concatenate(
        [ego_seg, np.full((nt, 1), cfg.ego_L), np.full((nt, 1), cfg.ego_W)],
        axis=-1)
    nei_seg = nei_full[:, t0:t0 + nt]
    pose = ego_full[t0]
    return {
        "ego_traj": ego_traj.astype(np.float32),
        "neighbors": nei_full[:, t0].astype(np.float32),
        "neighbors_traj": nei_seg.astype(np.float32),
        "currlane_wpts": lane_window_fn(lanes_full["curr"], pose,
                                        cfg.n_segs).astype(np.float32),
        "leftlane_wpts": (lane_window_fn(lanes_full["left"], pose, cfg.n_segs)
                          * float(left_valid)).astype(np.float32),
        "rightlane_wpts": (lane_window_fn(lanes_full["right"], pose,
                                          cfg.n_segs)
                           * float(right_valid)).astype(np.float32),
        "curr_id": np.array([1.0], np.float32),
        "left_id": np.array([float(left_valid)], np.float32),
        "right_id": np.array([float(right_valid)], np.float32),
        "gt_high_level": np.array([float(hl)], np.float32),
    }


def generate_dataset(seed: int, n_scenes: int, cfg: Config,
                     scene_len: Optional[int] = None,
                     t_samples: int = 1,
                     t_stride: int = 4) -> Dict[str, np.ndarray]:
    """Stacked dataset dict (leading axis = sample index)."""
    rng = np.random.RandomState(seed)
    samples = []
    for i in range(n_scenes):
        out = generate_scene(rng, cfg, scene_len=scene_len,
                             t_samples=t_samples, t_stride=t_stride)
        scene_samples = out if isinstance(out, list) else [out]
        for ti_idx, s in enumerate(scene_samples):
            s["traj_i"] = np.array(i, np.int64)
            s["ti"] = np.array(ti_idx * t_stride, np.int64)
            for k in scene_samples[0]:
                if k.startswith("scene_") and k not in s:
                    s[k] = scene_samples[0][k]
            samples.append(s)
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
