"""Traffic generation that the drivers share: the synthetic scenes'
drivable rasters.

``sim.scenes_from_dataset`` rasterizes each scene's lane corridor on the
host (``sim.rasterize_corridor``, about a third of a second a scene) unless
the data carries the raster; ``drivable`` computes the same raster, cell
for cell, by stamping a disc around each point of each valid lane's
centerline, so that a cell of 128 scenes does not spend its set-up there.
"""

from __future__ import annotations

import numpy as np

#: ``sim``'s lane geometry: lane offset, corridor half-width (m)
LANE_OFFSET, CORRIDOR_HALF = 3.5, 3.25
RESOLUTION, MARGIN = 0.5, 12.0


def corridor(center_dense: np.ndarray, lane_valids: np.ndarray):
    """``sim.rasterize_corridor``'s (mask (H, W) bool, origin (2,),
    resolution): a cell is drivable when its centre lies within
    CORRIDOR_HALF of a point of a valid lane's centerline."""
    pts = center_dense[:, :2]
    lo = pts.min(axis=0) - (LANE_OFFSET + MARGIN)
    hi = pts.max(axis=0) + (LANE_OFFSET + MARGIN)
    H = int(np.ceil((hi[1] - lo[1]) / RESOLUTION))
    W = int(np.ceil((hi[0] - lo[0]) / RESOLUTION))
    offsets = [0.0] + [LANE_OFFSET * s for s, v in
                       ((+1.0, lane_valids[1]), (-1.0, lane_valids[2]))
                       if v > 0.5]
    nx = -np.sin(center_dense[:, 2])
    ny = np.cos(center_dense[:, 2])
    ox = np.concatenate([pts[:, 0] + nx * off for off in offsets])
    oy = np.concatenate([pts[:, 1] + ny * off for off in offsets])
    reach = int(np.ceil(CORRIDOR_HALF / RESOLUTION)) + 1
    d = np.arange(-reach, reach + 1)
    j = np.floor((ox - lo[0]) / RESOLUTION).astype(np.int64)[:, None, None] \
        + d[None, None, :]
    i = np.floor((oy - lo[1]) / RESOLUTION).astype(np.int64)[:, None, None] \
        + d[None, :, None]
    j, i = np.broadcast_arrays(j, i)
    gx = lo[0] + (j + 0.5) * RESOLUTION
    gy = lo[1] + (i + 0.5) * RESOLUTION
    ok = ((gx - ox[:, None, None]) ** 2 + (gy - oy[:, None, None]) ** 2
          <= CORRIDOR_HALF ** 2) & (i >= 0) & (i < H) & (j >= 0) & (j < W)
    mask = np.zeros((H, W), bool)
    mask[i[ok], j[ok]] = True
    return mask, lo.astype(np.float32), np.float32(RESOLUTION)


def drivable(data: dict) -> dict:
    """``data`` with every scene's raster, zero-padded to the largest, as
    ``scene_drivable`` (bs, H, W), ``scene_drivable_origin`` (bs, 2) and
    ``scene_drivable_res`` (bs,)."""
    out = [corridor(np.asarray(c), np.asarray(v)) for c, v in
           zip(data["scene_center_dense"], data["scene_lane_valids"])]
    Hm = max(m.shape[0] for m, _, _ in out)
    Wm = max(m.shape[1] for m, _, _ in out)
    mask = np.zeros((len(out), Hm, Wm), bool)
    for k, (m, _, _) in enumerate(out):
        mask[k, :m.shape[0], :m.shape[1]] = m
    return dict(data, scene_drivable=mask,
                scene_drivable_origin=np.stack([o for _, o, _ in out]),
                scene_drivable_res=np.stack([r for _, _, r in out]))
