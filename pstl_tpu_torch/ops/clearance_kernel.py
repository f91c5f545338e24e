"""Masked minimum anchor-disc clearance of ego rollouts against K neighbor
tracks, with a hand-written VJP.

This is the port of ``pstl_tpu/ops/pallas_kernels.py``: the Pallas kernels
``_min_clearance_fwd`` and ``_min_clearance_bwd`` behind the ``min_clearance``
custom VJP.  On CUDA tensors :func:`min_clearance_fwd` and
:func:`min_clearance_bwd` launch the hand-written kernels of
``csrc/min_clearance.cu``; on CPU tensors they run the plain versions
(:func:`min_clearance_fwd_plain`, :func:`min_clearance_bwd_plain`), the same
computation in PyTorch ops.  There is no fallback from one to the other.
``fwd_launches`` and ``bwd_launches`` count kernel launches.

:class:`MinClearance` is the autograd function: its forward is the forward
kernel, its backward the backward kernel, which recomputes the forward from
the inputs (no residual is saved) and gives no gradient to the neighbors.
:func:`min_neighbor_distance_fused` is the drop-in for
``geometry.min_neighbor_distance`` (``num_W == 1``) that ``specs.prep_signals``
takes under ``cfg.use_pallas_clearance``.

Semantics (the TPU kernels', ``_disc_geometry`` / ``_fwd_block`` /
``_bwd_block``): ego and neighbor boxes are covered by nL discs of radius
W/2 along the heading, at offsets blended as ``iota/(nL-1)`` (not a
linspace); per neighbor the clearance is the minimum disc-pair distance
(the square root after the min over squared distances, +1e-12 inside)
minus both radii, clipped to [-5, 20], 100 for an invalid neighbor; the
result is the minimum over K.  The VJP splits exact ties over K and over
the nL*nL disc pairs, and passes gradient only strictly inside the clip
range and for valid neighbors.
"""

from __future__ import annotations

import ctypes

import torch

Tensor = torch.Tensor

#: kernel launches since the last reset (the plain versions do not count)
fwd_launches = 0
bwd_launches = 0

_MAXK, _MAXNL = 64, 8


def _consts(ego_L: float, ego_W: float):
    """(c0, c1, re): the ego disc offsets' end points and its disc radius,
    as the TPU kernel computes them from Python floats."""
    re = ego_W / 2.0
    return -ego_L / 2 + re, ego_L / 2 - re, re


def _alpha(nL: int, device) -> Tensor:
    return torch.arange(nL, dtype=torch.float32, device=device) \
        / max(nL - 1, 1)


def _disc_geometry(ego: Tensor, nei: Tensor, ego_L: float, ego_W: float,
                   nL: int):
    """``_disc_geometry`` on (n, T, 3) ego states and (n, K, T, 7) neighbor
    rows: the masked clearances (n, T, K) and the terms the VJP needs."""
    c0, c1, re = _consts(ego_L, ego_W)
    x, y, th = ego[..., 0], ego[..., 1], ego[..., 2]
    alpha = _alpha(nL, ego.device)
    ax = c0 * (1 - alpha) + c1 * alpha                     # (nL,)
    cth, sth = torch.cos(th), torch.sin(th)
    ex = x[..., None] + ax * cth[..., None]                # (n, T, nL)
    ey = y[..., None] + ax * sth[..., None]
    neiT = torch.swapaxes(nei, 1, 2)                       # (n, T, K, 7)
    valid = neiT[..., 0]
    nx0, ny0, nth = neiT[..., 1], neiT[..., 2], neiT[..., 3]
    Ln, Wn = neiT[..., 5], neiT[..., 6]
    rn = Wn / 2.0
    half0 = -Ln / 2 + rn
    half1 = Ln / 2 - rn
    axn = half0[..., None] * (1 - alpha) + half1[..., None] * alpha
    nx = nx0[..., None] + axn * torch.cos(nth)[..., None]  # (n, T, K, nL)
    ny = ny0[..., None] + axn * torch.sin(nth)[..., None]
    d2 = []
    for i in range(nL):
        dx = ex[:, :, None, i:i + 1] - nx                  # (n, T, K, nL)
        dy = ey[:, :, None, i:i + 1] - ny
        d2.append(dx * dx + dy * dy)
    d2min = torch.amin(torch.stack(d2, -1), dim=(-2, -1))  # (n, T, K)
    dist = torch.sqrt(d2min + 1e-12)
    per = dist - re - rn
    masked = torch.clamp(per, -5.0, 20.0) * valid + (1 - valid) * 100.0
    return masked, (ex, ey, nx, ny, d2, d2min, dist, per, valid, ax, cth,
                    sth)


def min_clearance_fwd_plain(ego: Tensor, nei: Tensor, ego_L: float,
                            ego_W: float, num_L: int = 4) -> Tensor:
    """``_fwd_block``: (n, T, 3), (n, K, T, 7) -> (n, T)."""
    masked, _ = _disc_geometry(ego, nei, ego_L, ego_W, num_L)
    return torch.amin(masked, dim=-1)


def min_clearance_bwd_plain(ego: Tensor, nei: Tensor, g: Tensor,
                            ego_L: float, ego_W: float,
                            num_L: int = 4) -> Tensor:
    """``_bwd_block``: the cotangent g (n, T) -> d ego (n, T, 3)."""
    masked, (ex, ey, nx, ny, d2, d2min, dist, per, valid, ax, cth,
             sth) = _disc_geometry(ego, nei, ego_L, ego_W, num_L)
    out = torch.amin(masked, dim=-1, keepdim=True)
    eqK = (masked == out).to(g.dtype)
    wK = eqK / torch.clamp(eqK.sum(-1, keepdim=True), min=1.0)
    gate = ((per > -5.0) & (per < 20.0)).to(g.dtype) * valid
    gK = g[..., None] * wK * gate                          # (n, T, K)
    eq = [(d2i == d2min[..., None]).to(g.dtype) for d2i in d2]
    cnt = sum(e.sum(-1) for e in eq)
    gKn = gK / torch.clamp(cnt, min=1.0) / dist
    g_ex = torch.stack([((e * (ex[:, :, None, i:i + 1] - nx)).sum(-1) * gKn)
                        .sum(-1) for i, e in enumerate(eq)], -1)
    g_ey = torch.stack([((e * (ey[:, :, None, i:i + 1] - ny)).sum(-1) * gKn)
                        .sum(-1) for i, e in enumerate(eq)], -1)
    gth = (g_ex * (-ax * sth[..., None]) + g_ey * (ax * cth[..., None]))
    return torch.stack([g_ex.sum(-1), g_ey.sum(-1), gth.sum(-1)], dim=-1)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    from pstl_tpu_torch.ops import _build
    lib = _build.load("min_clearance")
    for fn, nptr in ((lib.pstl_min_clearance_fwd, 3),
                     (lib.pstl_min_clearance_bwd, 4)):
        if fn.argtypes is None:
            fn.argtypes = [_P] * nptr + [_I] * 4 + [_F] * 3 + [_P]
            fn.restype = _I
    return lib


def _check(name: str, x: Tensor, shape, dev) -> None:
    if x.device != dev:
        raise ValueError(f"min_clearance: {name} is on {x.device}, expected "
                         f"{dev}")
    if x.dtype != torch.float32:
        raise TypeError(f"min_clearance: {name} must be float32, got "
                        f"{x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"min_clearance: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"min_clearance: {name} must be contiguous")


def _sizes(ego: Tensor, nei: Tensor, num_L: int):
    if ego.ndim != 3 or nei.ndim != 4:
        raise ValueError(f"min_clearance: ego must be (n, T, 3) and nei "
                         f"(n, K, T, 7), got {tuple(ego.shape)} and "
                         f"{tuple(nei.shape)}")
    n, T = ego.shape[:2]
    K = nei.shape[1]
    if not (1 <= K <= _MAXK and 1 <= num_L <= _MAXNL):
        raise ValueError(f"min_clearance: K={K}, nL={num_L} beyond the "
                         f"kernel's limits (K<={_MAXK}, nL<={_MAXNL})")
    _check("ego", ego, (n, T, 3), ego.device)
    _check("nei", nei, (n, K, T, 7), ego.device)
    return n, T, K


def _launch_fwd(ego, nei, ego_L, ego_W, num_L) -> Tensor:
    global fwd_launches
    n, T, K = _sizes(ego, nei, num_L)
    out = torch.empty((n, T), dtype=torch.float32, device=ego.device)
    stream = torch.cuda.current_stream(ego.device).cuda_stream
    err = _lib().pstl_min_clearance_fwd(
        ego.data_ptr(), nei.data_ptr(), out.data_ptr(), n, T, K, num_L,
        *_consts(ego_L, ego_W), stream)
    if err != 0:
        raise RuntimeError(f"min_clearance forward kernel launch failed: "
                           f"CUDA error {err}")
    fwd_launches += 1
    return out


def _launch_bwd(ego, nei, g, ego_L, ego_W, num_L) -> Tensor:
    global bwd_launches
    n, T, K = _sizes(ego, nei, num_L)
    _check("g", g, (n, T), ego.device)
    d_ego = torch.empty((n, T, 3), dtype=torch.float32, device=ego.device)
    stream = torch.cuda.current_stream(ego.device).cuda_stream
    err = _lib().pstl_min_clearance_bwd(
        ego.data_ptr(), nei.data_ptr(), g.data_ptr(), d_ego.data_ptr(), n, T,
        K, num_L, *_consts(ego_L, ego_W), stream)
    if err != 0:
        raise RuntimeError(f"min_clearance backward kernel launch failed: "
                           f"CUDA error {err}")
    bwd_launches += 1
    return d_ego


def min_clearance_fwd(ego: Tensor, nei: Tensor, ego_L: float, ego_W: float,
                      num_L: int = 4) -> Tensor:
    """Forward: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if ego.device.type == "cuda":
        return _launch_fwd(ego, nei, ego_L, ego_W, num_L)
    if ego.device.type == "cpu":
        return min_clearance_fwd_plain(ego, nei, ego_L, ego_W, num_L)
    raise ValueError(f"min_clearance: no implementation for device "
                     f"{ego.device}")


def min_clearance_bwd(ego: Tensor, nei: Tensor, g: Tensor, ego_L: float,
                      ego_W: float, num_L: int = 4) -> Tensor:
    """VJP: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if ego.device.type == "cuda":
        return _launch_bwd(ego, nei, g, ego_L, ego_W, num_L)
    if ego.device.type == "cpu":
        return min_clearance_bwd_plain(ego, nei, g, ego_L, ego_W, num_L)
    raise ValueError(f"min_clearance: no implementation for device "
                     f"{ego.device}")


class MinClearance(torch.autograd.Function):
    """Forward kernel, and the backward kernel as its VJP (recomputing from
    the inputs; no gradient to ``nei``)."""

    @staticmethod
    def forward(ctx, ego, nei, ego_L, ego_W, num_L):
        ctx.save_for_backward(ego, nei)
        ctx.consts = (ego_L, ego_W, num_L)
        return min_clearance_fwd(ego, nei, ego_L, ego_W, num_L)

    @staticmethod
    def backward(ctx, g):
        ego, nei = ctx.saved_tensors
        d_ego = min_clearance_bwd(ego, nei, g.float().contiguous(),
                                  *ctx.consts)
        return d_ego, None, None, None, None


def min_clearance(ego_xyth: Tensor, nei: Tensor, ego_L: float, ego_W: float,
                  num_L: int = 4) -> Tensor:
    """Fused masked min neighbor clearance.  ego_xyth: (n, T, 3); nei:
    (n, K, T, 7) rows (valid, x, y, th, -, L, W).  Returns (n, T) float32."""
    return MinClearance.apply(ego_xyth.float().contiguous(),
                              nei.float().contiguous(), ego_L, ego_W, num_L)


def neighbor_rows(nei_traj: Tensor, nei_valid: Tensor) -> Tensor:
    """The kernels' 7-column neighbor rows (valid, x, y, th, 0, L, W) from
    tracks (n, K, T, >=6) rows (x, y, th, ..., L, W) and validity (n, K, T),
    without gradient."""
    return torch.cat([nei_valid[..., None], nei_traj[..., 0:3],
                      torch.zeros_like(nei_traj[..., 0:1]),
                      nei_traj[..., -2:-1], nei_traj[..., -1:]],
                     dim=-1).detach()


def min_neighbor_distance_fused(ego_traj: Tensor, nei_traj: Tensor,
                                nei_valid: Tensor, ego_L: float,
                                ego_W: float, num_L: int = 4) -> Tensor:
    """Drop-in for ``geometry.min_neighbor_distance`` with ``num_W == 1``.
    ego_traj: (n, T, >=3); nei_traj: (n, K, T, >=6) rows (x, y, th, ..., L,
    W); nei_valid: (n, K, T).  Returns (n, T)."""
    return min_clearance(ego_traj[..., :3], neighbor_rows(nei_traj, nei_valid),
                         ego_L, ego_W, num_L)
