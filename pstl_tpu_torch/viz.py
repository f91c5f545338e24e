"""Matplotlib scene rendering, a copy of ``pstl_tpu/viz.py`` for the port.

Parity target: ``nusc_viz.py`` (agent boxes :13-21, control histograms /
trajectory fans :44-96, debug scene plots :391-478) and the closed-loop frame
renderer (``nusc_sim.py:229-354``).  The NuScenes map-patch backdrop is
replaced by the scene's lane polylines (synthetic scenes carry no raster
map); GIF assembly uses PIL instead of imageio.

All functions take plain numpy arrays (callers move tensors with
``.detach().cpu().numpy()``), so rendering never blocks the device.
matplotlib (on its ``Agg`` backend) and PIL are imported by the functions
that draw, not with the module: the package imports on a host without them,
and a call there raises an ``ImportError`` that names the missing package.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np


def _pyplot():
    """``matplotlib.pyplot`` on the ``Agg`` backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("pstl_tpu_torch.viz draws with matplotlib, which "
                          "is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


COLOR_AGENT = "#004E9E"
COLOR_NEI = "#C04F15"
COLOR_MODES = ["blue", "green", "red"]


def plot_agent(ax, xy, th, L, W, color=COLOR_AGENT, alpha=1.0,
               edgecolor="black"):
    """Oriented box (nusc_viz.py:13-21)."""
    plt = _pyplot()
    c, s = np.cos(th), np.sin(th)
    corners = np.array([[L / 2, W / 2], [L / 2, -W / 2],
                        [-L / 2, -W / 2], [-L / 2, W / 2]])
    rot = corners @ np.array([[c, s], [-s, c]])
    poly = plt.Polygon(rot + xy, closed=True, facecolor=color, alpha=alpha,
                       edgecolor=edgecolor)
    ax.add_patch(poly)


def plot_scene(batch: Dict[str, np.ndarray], i: int,
               cand_trajs: Optional[np.ndarray] = None,
               cand_scores: Optional[np.ndarray] = None,
               gt: bool = True, ax=None, title: str = ""):
    """Debug scene plot (``plot_debug_scene``, nusc_viz.py:391-478):
    lanes, neighbors, GT trajectory, and candidate trajectory fans colored
    by maneuver with STL-violating candidates dashed.

    cand_trajs: (M, 3, T, >=2); cand_scores: (M, 3).
    """
    plt = _pyplot()
    own_fig = ax is None
    if own_fig:
        _, ax = plt.subplots(figsize=(8, 8))
    for key, color in (("currlane_wpts", "gray"), ("leftlane_wpts", "green"),
                       ("rightlane_wpts", "red")):
        idk = {"currlane_wpts": "curr_id", "leftlane_wpts": "left_id",
               "rightlane_wpts": "right_id"}[key]
        if batch[idk][i, 0] > 0.5:
            lane = batch[key][i]
            ax.plot(lane[:, 0], lane[:, 1], color=color, lw=5, alpha=0.3)
    neis = batch["neighbors"][i] if "neighbors" in batch \
        else batch["neighbors_traj"][i][:, 0]
    for nei in neis:
        if nei[0] > 0.5:
            plot_agent(ax, nei[1:3], nei[3], nei[5], nei[6],
                       color=COLOR_NEI, alpha=0.4)
    ego = batch["ego_traj"][i]
    plot_agent(ax, ego[0, :2], ego[0, 2], ego[0, 4], ego[0, 5])
    if gt:
        ax.plot(ego[:, 0], ego[:, 1], "c-", lw=2, zorder=900, label="GT")
    if cand_trajs is not None:
        for m in range(cand_trajs.shape[0]):
            for k in range(3):
                ls = "-" if (cand_scores is None
                             or cand_scores[m, k] > 0) else ":"
                ax.plot(cand_trajs[m, k, :, 0], cand_trajs[m, k, :, 1],
                        ls, color=COLOR_MODES[k], lw=0.8, alpha=0.7)
    ax.set_aspect("equal")
    ax.set_title(title)
    return ax


def save_scene(path: str, *args, **kw):
    plt = _pyplot()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plot_scene(*args, **kw)
    plt.savefig(path, bbox_inches="tight", pad_inches=0.1)
    plt.close()


ACTION_LABEL = {0: "keep", 1: "left-lane-change", 2: "right-lane-change",
                3: "outlier"}


def _drivable_backdrop(ax, batch, i):
    """Render the scene's rasterized drivable area as the map backdrop
    (stand-in for the reference's nusc_map.render_map_patch)."""
    if "scene_drivable" not in batch:
        return False
    mask = np.asarray(batch["scene_drivable"][i])
    ox, oy = np.asarray(batch["scene_drivable_origin"][i])
    res = float(batch["scene_drivable_res"][i])
    H, W = mask.shape
    ax.imshow(mask, origin="lower", cmap="Greys", alpha=0.15,
              extent=(ox, ox + W * res, oy, oy + H * res), zorder=0)
    return True


def plot_paper_scene(path: str, batch: Dict[str, np.ndarray], i: int,
                     nn_trajs: Optional[np.ndarray] = None,
                     nn_scores: Optional[np.ndarray] = None,
                     ego_only: bool = False, r: float = 50.0,
                     delta_r: float = 15.0):
    """Paper figure (``plot_paper_scene``, nusc_viz.py:111-202): clean
    ego-centered patch shifted ``delta_r`` ahead of the ego heading, the
    drivable backdrop, bold neighbor/ego boxes, candidate trajectories with
    satisfying candidates solid and violating ones faint, no axes.

    nn_trajs: (M, 3, T, >=2); nn_scores: (M, 3).
    """
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 8))
    _drivable_backdrop(ax, batch, i)
    for key, color in (("currlane_wpts", "#9ecae1"),
                       ("leftlane_wpts", "#a1d99b"),
                       ("rightlane_wpts", "#fcae91")):
        idk = {"currlane_wpts": "curr_id", "leftlane_wpts": "left_id",
               "rightlane_wpts": "right_id"}[key]
        if batch[idk][i, 0] > 0.5:
            lane = batch[key][i]
            ax.plot(lane[:, 0], lane[:, 1], color=color, lw=7, alpha=0.5,
                    zorder=1, solid_capstyle="round")
    neis = batch["neighbors"][i] if "neighbors" in batch \
        else batch["neighbors_traj"][i][:, 0]
    if not ego_only:
        for nei in neis:
            if nei[0] > 0.5:
                plot_agent(ax, nei[1:3], nei[3], nei[5], nei[6],
                           color=COLOR_NEI, alpha=0.9)
    ego = batch["ego_traj"][i]
    if nn_trajs is not None:
        for m in range(nn_trajs.shape[0]):
            for k in range(3):
                sat = nn_scores is None or nn_scores[m, k] > 0
                ax.plot(nn_trajs[m, k, :, 0], nn_trajs[m, k, :, 1], "-",
                        color=COLOR_MODES[k], lw=2.2 if sat else 0.8,
                        alpha=0.85 if sat else 0.2, zorder=800,
                        solid_capstyle="round")
    plot_agent(ax, ego[0, :2], ego[0, 2], ego[0, 4], ego[0, 5],
               color=COLOR_AGENT)
    cx = ego[0, 0] + delta_r * np.cos(ego[0, 2])
    cy = ego[0, 1] + delta_r * np.sin(ego[0, 2])
    ax.set_xlim(cx - r, cx + r)
    ax.set_ylim(cy - r, cy + r)
    ax.set_aspect("equal")
    ax.set_xticks([])
    ax.set_yticks([])
    for sp in ax.spines.values():
        sp.set_visible(False)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path, bbox_inches="tight", pad_inches=0.05, dpi=150)
    plt.close(fig)


def plot_training_viz(path: str, batch: Dict[str, np.ndarray], i: int,
                      tj_trajs: Optional[np.ndarray] = None,
                      tj_scores: Optional[np.ndarray] = None,
                      nn_trajs: Optional[np.ndarray] = None,
                      nn_scores: Optional[np.ndarray] = None,
                      epoch: int = 0, split: str = "train",
                      r: float = 50.0):
    """Per-epoch training scene viz (``plot_nuscene_viz``,
    nusc_viz.py:204-339): lanes in blue/green/red, neighbors, GT, the
    trajopt candidate fan and (when given) the model candidate fan colored
    by maneuver with dashed violating candidates; title carries the action
    label + per-set satisfaction.

    tj/nn_trajs: (M, 3, T, >=2); tj/nn_scores: (M, 3).
    """
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 8))
    _drivable_backdrop(ax, batch, i)
    for key, color in (("currlane_wpts", "blue"), ("leftlane_wpts", "green"),
                       ("rightlane_wpts", "red")):
        idk = {"currlane_wpts": "curr_id", "leftlane_wpts": "left_id",
               "rightlane_wpts": "right_id"}[key]
        if batch[idk][i, 0] > 0.5:
            lane = batch[key][i]
            ax.plot(lane[:, 0], lane[:, 1], color=color, lw=6, alpha=0.4,
                    label=key.replace("_wpts", ""))
    neis = batch["neighbors"][i] if "neighbors" in batch \
        else batch["neighbors_traj"][i][:, 0]
    for nei in neis:
        if nei[0] > 0.5:
            plot_agent(ax, nei[1:3], nei[3], nei[5] * 1.2, nei[6] * 1.2,
                       color="brown", alpha=0.3)
    ego = batch["ego_traj"][i]
    plot_agent(ax, ego[0, :2], ego[0, 2], ego[0, 4], ego[0, 5])
    ax.plot(ego[:, 0], ego[:, 1], "c-", lw=2.5, zorder=900, label="GT")

    def fan(trajs, scores, lw, alpha):
        accs = []
        for k in range(3):
            sat = (scores[:, k] > 0) if scores is not None \
                else np.ones(trajs.shape[0], bool)
            accs.append(float(np.mean(sat)))
            for m in range(trajs.shape[0]):
                ax.plot(trajs[m, k, :, 0], trajs[m, k, :, 1],
                        "-" if sat[m] else ":", color=COLOR_MODES[k],
                        lw=lw, alpha=alpha)
        return accs

    title = f"{split} ep{epoch}"
    if "gt_high_level" in batch:
        hl = int(batch["gt_high_level"][i, 0])
        title += f" [{ACTION_LABEL.get(hl, hl)}]"
    if tj_trajs is not None:
        accs = fan(tj_trajs, tj_scores, 0.7, 0.45)
        title += " tj:" + "/".join(f"{a:.2f}" for a in accs)
    if nn_trajs is not None:
        accs = fan(nn_trajs, nn_scores, 1.4, 0.8)
        title += " nn:" + "/".join(f"{a:.2f}" for a in accs)
    ax.set_xlim(ego[0, 0] - r, ego[0, 0] + r)
    ax.set_ylim(ego[0, 1] - r, ego[0, 1] + r)
    ax.set_aspect("equal")
    ax.set_title(title)
    ax.legend(loc="upper right", fontsize=8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path, bbox_inches="tight", pad_inches=0.1)
    plt.close(fig)


def plot_control_histograms(controls: np.ndarray, path: str):
    """Steer/accel histograms (nusc_viz.py:44-96)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hist(controls[..., 0].ravel(), bins=50, color=COLOR_AGENT)
    axes[0].set_title("steer rate")
    axes[1].hist(controls[..., 1].ravel(), bins=50, color=COLOR_NEI)
    axes[1].set_title("acceleration")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path, bbox_inches="tight")
    plt.close()


def render_closed_loop_frame(path: str, scene_center: np.ndarray,
                             lane_valids: np.ndarray, ego_hist: np.ndarray,
                             neighbors: np.ndarray, plan_traj: np.ndarray,
                             ego_LW=(4.084, 1.73), r: float = 40.0,
                             drivable=None, drivable_origin=None,
                             drivable_res: float = 0.5):
    """One closed-loop frame (NuScenesSim.render, nusc_sim.py:229-347).

    ``drivable``/``drivable_origin``/``drivable_res``: the scene's
    rasterized drivable-area mask drawn as the map backdrop — the stand-in
    for the reference's NuScenes map-patch rendering (nusc_viz.py:204-339).
    """
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 8))
    if drivable is not None:
        mask = np.asarray(drivable)
        ox, oy = np.asarray(drivable_origin)
        H, W = mask.shape
        ax.imshow(mask, origin="lower", cmap="Greys", alpha=0.15,
                  extent=(ox, ox + W * drivable_res,
                          oy, oy + H * drivable_res), zorder=0)
    offs = [0.0, 3.5, -3.5]
    for li in range(3):
        if lane_valids[li] > 0.5:
            nx = -np.sin(scene_center[:, 2]) * offs[li]
            ny = np.cos(scene_center[:, 2]) * offs[li]
            ax.plot(scene_center[:, 0] + nx, scene_center[:, 1] + ny,
                    color="gray", lw=4, alpha=0.25)
    for nei in neighbors:
        if nei[0] > 0.5:
            plot_agent(ax, nei[1:3], nei[3], nei[5], nei[6],
                       color=COLOR_NEI, alpha=0.35)
    pos = ego_hist[-1]
    plot_agent(ax, pos[:2], pos[2], ego_LW[0], ego_LW[1])
    ax.plot(ego_hist[:, 0], ego_hist[:, 1], color="#fb9a99", lw=3,
            zorder=1000, label="sim")
    if plan_traj is not None:
        ax.plot(plan_traj[:, 0], plan_traj[:, 1], color="purple", lw=3.5,
                zorder=1500, label="plan")
    ax.set_xlim(pos[0] - r, pos[0] + r)
    ax.set_ylim(pos[1] - r, pos[1] + r)
    ax.set_aspect("equal")
    ax.legend(loc="upper right")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path, bbox_inches="tight", pad_inches=0.1)
    plt.close()


def generate_gif(gif_path: str, frame_paths: Sequence[str],
                 duration_ms: int = 100):
    """Assemble frames into a GIF (utils.py:106-110, via PIL)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("pstl_tpu_torch.viz assembles GIFs with PIL "
                          "(pillow), which is not installed") from e
    frames = [Image.open(p) for p in frame_paths]
    if not frames:
        return
    frames[0].save(gif_path, save_all=True, append_images=frames[1:],
                   duration=duration_ms, loop=0)
