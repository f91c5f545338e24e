"""Evaluation metrics (port of ``pstl_tpu/metrics.py``): masked candidate
std and per-timestep convex-hull area (``measure_diversity``), histogram
entropies and the occupancy area (``measure_extra_diversity``), in-label /
out-label satisfaction (``label_score_breakdown``) and min-ADE / min-FDE
(``ade_fde``).

The hull area is the JAX package's exact all-pairs edge test: a directed
edge (i, j) lies on the ccw hull iff every other valid point is (weakly)
left of it, and the area is the sum of cross(p_i, p_j) / 2 over those
edges.  XLA fuses the (..., m, m, m) test; eager PyTorch materializes it,
so :func:`hull_area` runs it over chunks of the leading cells
(``HULL_CHUNK_ELEMS`` elements of the test a chunk), which changes no
result.  Above ``HULL_EXACT_MAX_M`` candidates it uses the host monotone
chain, a numpy copy of the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

#: more candidates than this: the host monotone chain, as in the JAX package
HULL_EXACT_MAX_M = 128
#: elements of the (cells, m, m, m) edge test a chunk: at m = 64, 128 cells
#: and a few hundred MB of float32 intermediates
HULL_CHUNK_ELEMS = 1 << 25


def masked_std(x: Tensor, mask: Tensor, dim: int) -> Tensor:
    """Population std over ``dim`` counting only mask==1 entries; 0 where
    none is valid (np.ma.std().filled(0))."""
    mask = mask.to(x.dtype)
    cnt = torch.sum(mask, dim=dim, keepdim=True)
    safe = torch.clamp(cnt, min=1.0)
    mean = torch.sum(x * mask, dim=dim, keepdim=True) / safe
    var = torch.sum(mask * (x - mean) ** 2, dim=dim, keepdim=True) / safe
    std = torch.sqrt(torch.clamp(var, min=0.0))
    return torch.where(cnt > 0, std, torch.zeros_like(std)).squeeze(dim)


# ---------------------------------------------------------------------------
# exact 2-D convex hull area (masked, batched)
# ---------------------------------------------------------------------------

def _monotone_chain_area(p: np.ndarray) -> float:
    """Convex hull area of (k, 2) points via Andrew's monotone chain."""
    p = np.unique(p[np.lexsort((p[:, 1], p[:, 0]))], axis=0)
    if len(p) < 3:
        return 0.0

    def half(pts):
        h = []
        for q in pts:
            while len(h) >= 2 and np.cross(h[-1] - h[-2], q - h[-2]) <= 0:
                h.pop()
            h.append(q)
        return h

    hull = np.array(half(p)[:-1] + half(p[::-1])[:-1])
    if len(hull) < 3:
        return 0.0
    x, y = hull[:, 0], hull[:, 1]
    return float(0.5 * abs(np.dot(x, np.roll(y, -1))
                           - np.dot(y, np.roll(x, -1))))


def _hull_area_host(points: np.ndarray, mask: np.ndarray) -> np.ndarray:
    pts = np.asarray(points)
    mk = np.asarray(mask) > 0.5
    out = np.zeros(pts.shape[:-2], np.float32)
    for idx in np.ndindex(*out.shape):
        p = pts[idx][mk[idx]].astype(np.float64)
        if len(p) >= 3:
            out[idx] = _monotone_chain_area(p)
    return out


def _hull_area_exact(points: Tensor, mask: Tensor, eps: float) -> Tensor:
    """The all-pairs edge test on (c, m, 2) points, (c, m) mask -> (c,)."""
    m = points.shape[-2]
    p_i = points[:, :, None, :]                  # (c, m, 1, 2)
    p_j = points[:, None, :, :]                  # (c, 1, m, 2)
    e = p_j - p_i                                # (c, m, m, 2)
    d = points[:, None, None, :, :] - p_i[:, :, :, None, :]  # (c, m, 1, m, 2)
    cross = e[..., None, 0] * d[..., 1] - e[..., None, 1] * d[..., 0]
    valid = mask.to(torch.bool)
    ok = (~valid[:, None, None, :]) | (cross >= -eps)
    all_left = torch.all(ok, dim=-1)             # (c, m, m)
    ij_valid = valid[:, :, None] & valid[:, None, :]
    not_diag = ~torch.eye(m, dtype=torch.bool, device=points.device)
    nonzero = torch.sum(e * e, dim=-1) > eps * eps
    is_edge = all_left & ij_valid & not_diag & nonzero
    cr = p_i[..., 0] * p_j[..., 1] - p_i[..., 1] * p_j[..., 0]
    area = torch.sum(torch.where(is_edge, cr, torch.zeros_like(cr)),
                     dim=(-2, -1)) / 2.0
    return torch.clamp(area, min=0.0)


def hull_area(points: Tensor, mask: Tensor, eps: float = 1e-7) -> Tensor:
    """Area of the convex hull of masked 2-D points.

    points: (..., m, 2); mask: (..., m) with 1 = valid.  Invalid points
    neither bound nor constrain the hull; fewer than 3 non-collinear valid
    points give 0.  m > HULL_EXACT_MAX_M runs the host monotone chain.
    """
    lead, m = points.shape[:-2], points.shape[-2]
    if m > HULL_EXACT_MAX_M:
        out = _hull_area_host(points.detach().cpu().numpy(),
                              mask.detach().cpu().numpy())
        return torch.as_tensor(out, device=points.device)
    pts = points.reshape(-1, m, 2)
    msk = mask.reshape(-1, m)
    c = max(HULL_CHUNK_ELEMS // (m * m * m), 1)
    parts = [_hull_area_exact(pts[i:i + c], msk[i:i + c], eps)
             for i in range(0, pts.shape[0], c)]
    out = torch.cat(parts) if parts else pts.new_zeros((0,))
    return out.reshape(lead)


def measure_diversity(trajs: Tensor, scores: Tensor, valids: Tensor,
                      nt: int) -> Dict[str, Tensor]:
    """Masked std + summed per-timestep hull area.

    trajs: (bs, m, 3, nt*2) xy trajectories; scores/valids: (bs, m, 3).
    Returns scalars ma_std, ma_vol and per-maneuver breakdowns.
    """
    bs, m = trajs.shape[0], trajs.shape[1]
    acc = (scores > 0).to(trajs.dtype)                      # (bs, m, 3)
    std = masked_std(trajs, acc[..., None], dim=1)          # (bs, 3, nt*2)
    std = torch.mean(std, dim=-1)                           # (bs, 3)
    lane_valid = valids[:, 0, :]                            # (bs, 3)
    ma_std = (torch.sum(std * lane_valid)
              / torch.clamp(torch.sum(lane_valid), min=1.0))

    pts = trajs.reshape(bs, m, 3, nt, 2).permute(0, 2, 3, 1, 4)
    msk = acc.permute(0, 2, 1)[:, :, None, :].expand(bs, 3, nt, m)
    vols = hull_area(pts, msk)                              # (bs, 3, nt)
    vol = torch.sum(vols, dim=-1) * lane_valid              # (bs, 3)
    ma_vol = torch.sum(vol) / torch.clamp(torch.sum(lane_valid), min=1.0)
    return {"ma_std": ma_std, "ma_vol": ma_vol,
            "std_per_mode": std, "vol_per_mode": vol}


# ---------------------------------------------------------------------------
# histogram entropy & occupancy area
# ---------------------------------------------------------------------------

def entropy(x: Tensor, mask: Tensor, n_bins: int = 10,
            x_min: Optional[float] = None,
            x_max: Optional[float] = None) -> Tensor:
    """Shannon entropy (bits) of masked per-row histograms.  x, mask:
    (N, m) -> (N,).  Masked entries are +-inf, as in the JAX package (a row
    with none valid gets NaN bin edges, empty counts and entropy 0).  The
    bin fractions are ``arange(n_bins + 1) * (1 / n_bins)`` in float32,
    which equals ``jnp.linspace(0, 1, n_bins + 1)`` (``torch.linspace``
    differs from it by an ulp at 0.9, which moves a bin edge)."""
    CLIP = 1e-5
    inf = torch.full_like(x, float("inf"))
    x_lo = torch.where(mask == 0, -inf, x)
    x_hi = torch.where(mask == 0, inf, x)
    if x_min is None:
        xmin = torch.amin(x_hi, dim=1) - CLIP
        xmax = torch.amax(x_lo, dim=1) + CLIP
    else:
        xmin = torch.full(x.shape[:1], x_min, dtype=x.dtype, device=x.device)
        xmax = torch.full(x.shape[:1], x_max, dtype=x.dtype, device=x.device)
    alphas = (torch.arange(n_bins + 1, device=x.device, dtype=x.dtype)
              * (1.0 / n_bins))
    bins = xmin[:, None] * (1 - alphas) + xmax[:, None] * alphas
    spotted = ((x_hi[:, :, None] >= bins[:, None, :-1])
               & (x_hi[:, :, None] < bins[:, None, 1:]))
    counts = torch.sum(spotted.to(x.dtype), dim=1)                 # (N, nb)
    probs = counts / torch.clamp(torch.sum(counts, -1, keepdim=True),
                                 min=CLIP)
    return torch.sum(-probs * torch.log2(torch.clamp(probs, min=CLIP)),
                     dim=-1)


def occupancy_area(x: Tensor, y: Tensor, th: Tensor, val: Tensor,
                   n_bins: int = 100) -> Tensor:
    """Mean occupied-cell area of heading-aligned displacement histograms.

    x, y, th: (R, m, nt) displacement + heading; val: (R, m, nt).  Masked
    points are zeroed into the histogram at the origin, as the reference
    does.  Each row's (n_bins x n_bins) occupancy is one ``bincount`` over
    row-offset cells.  Returns a scalar.
    """
    R = x.shape[0]
    x_rel = x * torch.cos(th) + y * torch.sin(th)
    y_rel = -x * torch.sin(th) + y * torch.cos(th)
    xr = (x_rel * val).reshape(R, -1)
    yr = (y_rel * val).reshape(R, -1)
    xmin, xmax = torch.amin(xr, dim=1), torch.amax(xr, dim=1)
    ymin, ymax = torch.amin(yr, dim=1), torch.amax(yr, dim=1)
    xl, yl = xmax - xmin, ymax - ymin

    def cell(v, vmin, vl):
        scale = torch.clamp(vl, min=1e-9)[:, None]
        i = torch.floor((v - vmin[:, None]) / scale * n_bins).to(torch.int32)
        return torch.clamp(i, 0, n_bins - 1).long()

    nb2 = n_bins * n_bins
    rows = torch.arange(R, device=x.device)[:, None] * nb2
    idx = rows + cell(xr, xmin, xl) * n_bins + cell(yr, ymin, yl)
    occ = torch.bincount(idx.reshape(-1), minlength=R * nb2).reshape(R, nb2)
    area = torch.mean((occ > 0).to(torch.float32), dim=1) * xl * yl
    return torch.mean(area)


def measure_extra_diversity(trajs: Tensor, scores: Tensor, valids: Tensor,
                            nt: int, controls: Tensor, wmin: float,
                            wmax: float, amin: float,
                            amax: float) -> Dict[str, Tensor]:
    """Entropy / area bundle.  trajs: (bs, m, 3, nt*4); scores / valids:
    (bs, m, 3); controls: (bs, m, 3, nt*2)."""
    bs, m, _ = scores.shape
    trajs = trajs.reshape(bs, m, 3, nt, 4).permute(0, 2, 1, 3, 4).reshape(
        bs * 3, m, nt, 4)
    scores = scores.permute(0, 2, 1).reshape(bs * 3, m)
    valids = valids.permute(0, 2, 1).reshape(bs * 3, m)
    controls = controls.reshape(bs, m, 3, nt, 2).permute(
        0, 2, 1, 3, 4).reshape(bs * 3, m, nt, 2)
    valids = valids * (scores > 0).to(valids.dtype)

    ent_s = entropy(scores, valids)
    valids_rev = valids[:, None, :].expand(bs * 3, nt, m).reshape(
        bs * 3 * nt, m)

    def rev(v):
        return v.permute(0, 2, 1).reshape(bs * 3 * nt, m)

    x_ = trajs[..., 0] - trajs[..., 0:1, 0]
    y_ = trajs[..., 1] - trajs[..., 0:1, 1]
    ent_w = entropy(rev(controls[..., 0]), valids_rev, x_min=wmin, x_max=wmax)
    ent_a = entropy(rev(controls[..., 1]), valids_rev, x_min=amin, x_max=amax)
    area = occupancy_area(x_, y_, trajs[..., 2],
                          valids[:, :, None].expand(bs * 3, m, nt))
    return {"ent_s": torch.mean(ent_s), "ent_w": torch.mean(ent_w),
            "ent_a": torch.mean(ent_a),
            "ent_wa": torch.mean(ent_w) + torch.mean(ent_a), "area": area}


def label_score_breakdown(scores: Tensor, gt_labels: Tensor,
                          valids: Tensor) -> Dict[str, Tensor]:
    """In-label / out-label satisfaction rates, overall and per maneuver.
    scores / valids: (bs, M, 3); gt_labels: (bs,).  Outliers (label 3) are
    left out entirely."""
    bs = scores.shape[0]
    lab = gt_labels.reshape(bs, 1, 1)
    not_outlier = (gt_labels < 3).reshape(bs, 1, 1).to(scores.dtype)
    mode = torch.arange(3, device=scores.device).reshape(1, 1, 3).to(
        lab.dtype)
    in_mask = (mode == lab).to(scores.dtype) * valids * not_outlier
    out_mask = (mode != lab).to(scores.dtype) * valids * not_outlier
    sat = (scores > 0).to(scores.dtype)

    def mm(m, dim=None):
        if dim is None:
            return torch.sum(sat * m) / torch.clamp(torch.sum(m), min=1.0)
        return (torch.sum(sat * m, dim=dim)
                / torch.clamp(torch.sum(m, dim=dim), min=1.0))

    out = {"in_label_acc": mm(in_mask), "out_label_acc": mm(out_mask)}
    per_in = mm(in_mask, dim=(0, 1))
    per_out = mm(out_mask, dim=(0, 1))
    for i, name in enumerate(("curr", "left", "right")):
        out[f"in_label_{name}_acc"] = per_in[i]
        out[f"out_label_{name}_acc"] = per_out[i]
    return out


def ade_fde(gt_trajs: Tensor, est_trajs: Tensor,
            mask: Tensor) -> Tuple[Tensor, Tensor]:
    """min-ADE / min-FDE over candidates.  gt_trajs: (bs, nt, k); est_trajs:
    (bs, M, 3, nt, k) (or any (bs, -1, nt, k) layout); mask: (bs, M*3)."""
    bs, nt, k = gt_trajs.shape
    mask = mask.reshape(bs, -1)
    est = est_trajs.reshape(bs, -1, nt, k)
    mm = mask[:, :, None, None]
    err_t = torch.sum(torch.square((gt_trajs[:, None] - est) * mm
                                   + (1 - mm) * 10000.0), dim=-1)
    err = torch.mean(err_t, dim=-1)
    ade = torch.mean(torch.amin(err, dim=-1))
    fde = torch.mean(torch.amin(err_t[:, :, -1], dim=-1))
    return ade, fde
