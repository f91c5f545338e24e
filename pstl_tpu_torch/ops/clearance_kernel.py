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

Neighbors are given per scene: ``nei`` is (n / m, K, T, 7) for n ego rows,
``m = rows_per_scene``, and row r meets the neighbors of scene ``r // m``
(the order of ``torch.repeat_interleave(x, m, 0)``).  ``m = 1`` is one
neighbor set per row, the TPU kernel's layout.  The kernels build a scene's
neighbor discs once per block in shared memory, where every candidate row of
the block reads them; the plain versions repeat the neighbors themselves and
are then ``_fwd_block`` / ``_bwd_block`` on the expanded rows.

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
import functools

import torch

Tensor = torch.Tensor

#: kernel launches since the last reset (the plain versions do not count)
fwd_launches = 0
bwd_launches = 0


@functools.lru_cache(maxsize=None)
def _limits():
    """(most nL, bytes of shared memory a block can use) as the kernels'
    source defines them; one scene's discs, K*T*(2*nL+2) floats, must fit
    the latter."""
    from pstl_tpu_torch.ops import _build
    macros = _build.source_macros("min_clearance")
    return macros["MC_MAXNL"], macros["MC_SMEM_MAX"]


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


def _check_rows(n: int, scenes: int, m: int) -> None:
    if m < 1 or n % m != 0:
        raise ValueError(f"min_clearance: n={n} ego rows are no multiple of "
                         f"rows_per_scene={m}")
    if scenes * m != n:
        raise ValueError(f"min_clearance: nei holds {scenes} scenes, "
                         f"expected n / rows_per_scene = {n} / {m} = {n // m}")


def _per_row(ego: Tensor, nei: Tensor, m: int) -> Tensor:
    """The neighbors of every ego row: each scene's repeated m times."""
    _check_rows(ego.shape[0], nei.shape[0], m)
    return nei if m == 1 else torch.repeat_interleave(nei, m, 0)


def min_clearance_fwd_plain(ego: Tensor, nei: Tensor, ego_L: float,
                            ego_W: float, num_L: int = 4,
                            rows_per_scene: int = 1) -> Tensor:
    """``_fwd_block``: (n, T, 3), (n / m, K, T, 7) -> (n, T)."""
    masked, _ = _disc_geometry(ego, _per_row(ego, nei, rows_per_scene),
                               ego_L, ego_W, num_L)
    return torch.amin(masked, dim=-1)


def min_clearance_bwd_plain(ego: Tensor, nei: Tensor, g: Tensor,
                            ego_L: float, ego_W: float, num_L: int = 4,
                            rows_per_scene: int = 1) -> Tensor:
    """``_bwd_block``: the cotangent g (n, T) -> d ego (n, T, 3)."""
    masked, (ex, ey, nx, ny, d2, d2min, dist, per, valid, ax, cth,
             sth) = _disc_geometry(ego, _per_row(ego, nei, rows_per_scene),
                                   ego_L, ego_W, num_L)
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
            fn.argtypes = [_P] * nptr + [_I] * 5 + [_F] * 3 + [_P]
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


def _sizes(ego: Tensor, nei: Tensor, num_L: int, rows_per_scene: int = 1):
    """(n, T, K) of operands the kernels take; raises on any other."""
    if ego.ndim != 3 or nei.ndim != 4:
        raise ValueError(f"min_clearance: ego must be (n, T, 3) and nei "
                         f"(n / rows_per_scene, K, T, 7), got "
                         f"{tuple(ego.shape)} and {tuple(nei.shape)}")
    n, T = ego.shape[:2]
    K = nei.shape[1]
    _check_rows(n, nei.shape[0], rows_per_scene)
    max_nL, smem_max = _limits()
    if not (K >= 1 and T >= 1 and 1 <= num_L <= max_nL):
        raise ValueError(f"min_clearance: K={K}, T={T}, nL={num_L} beyond "
                         f"the kernel's limits (K>=1, T>=1, 1<=nL<={max_nL})")
    scene_bytes = 4 * K * T * (2 * num_L + 2)
    if scene_bytes > smem_max:
        raise ValueError(f"min_clearance: one scene's neighbor discs, "
                         f"K*T*(2*nL+2) floats = {scene_bytes} bytes at K={K},"
                         f" T={T}, nL={num_L}, do not fit the {smem_max} "
                         f"bytes of shared memory a block can use")
    _check("ego", ego, (n, T, 3), ego.device)
    _check("nei", nei, (n // rows_per_scene, K, T, 7), ego.device)
    return n, T, K


def _launch_fwd(ego, nei, ego_L, ego_W, num_L, rows_per_scene) -> Tensor:
    global fwd_launches
    n, T, K = _sizes(ego, nei, num_L, rows_per_scene)
    out = torch.empty((n, T), dtype=torch.float32, device=ego.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(ego.device).cuda_stream
    err = _lib().pstl_min_clearance_fwd(
        ego.data_ptr(), nei.data_ptr(), out.data_ptr(), n, T, K, num_L,
        rows_per_scene, *_consts(ego_L, ego_W), stream)
    if err != 0:
        raise RuntimeError(f"min_clearance forward kernel launch failed: "
                           f"CUDA error {err}")
    fwd_launches += 1
    return out


def _launch_bwd(ego, nei, g, ego_L, ego_W, num_L,
                rows_per_scene) -> Tensor:
    global bwd_launches
    n, T, K = _sizes(ego, nei, num_L, rows_per_scene)
    _check("g", g, (n, T), ego.device)
    d_ego = torch.empty((n, T, 3), dtype=torch.float32, device=ego.device)
    if n == 0:
        return d_ego
    stream = torch.cuda.current_stream(ego.device).cuda_stream
    err = _lib().pstl_min_clearance_bwd(
        ego.data_ptr(), nei.data_ptr(), g.data_ptr(), d_ego.data_ptr(), n, T,
        K, num_L, rows_per_scene, *_consts(ego_L, ego_W), stream)
    if err != 0:
        raise RuntimeError(f"min_clearance backward kernel launch failed: "
                           f"CUDA error {err}")
    bwd_launches += 1
    return d_ego


def min_clearance_fwd(ego: Tensor, nei: Tensor, ego_L: float, ego_W: float,
                      num_L: int = 4, rows_per_scene: int = 1) -> Tensor:
    """Forward: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if ego.device.type == "cuda":
        return _launch_fwd(ego, nei, ego_L, ego_W, num_L, rows_per_scene)
    if ego.device.type == "cpu":
        return min_clearance_fwd_plain(ego, nei, ego_L, ego_W, num_L,
                                       rows_per_scene)
    raise ValueError(f"min_clearance: no implementation for device "
                     f"{ego.device}")


def min_clearance_bwd(ego: Tensor, nei: Tensor, g: Tensor, ego_L: float,
                      ego_W: float, num_L: int = 4,
                      rows_per_scene: int = 1) -> Tensor:
    """VJP: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if ego.device.type == "cuda":
        return _launch_bwd(ego, nei, g, ego_L, ego_W, num_L, rows_per_scene)
    if ego.device.type == "cpu":
        return min_clearance_bwd_plain(ego, nei, g, ego_L, ego_W, num_L,
                                       rows_per_scene)
    raise ValueError(f"min_clearance: no implementation for device "
                     f"{ego.device}")


class MinClearance(torch.autograd.Function):
    """Forward kernel, and the backward kernel as its VJP (recomputing from
    the inputs; no gradient to ``nei``)."""

    @staticmethod
    def forward(ctx, ego, nei, ego_L, ego_W, num_L, rows_per_scene):
        ctx.save_for_backward(ego, nei)
        ctx.consts = (ego_L, ego_W, num_L, rows_per_scene)
        return min_clearance_fwd(ego, nei, *ctx.consts)

    @staticmethod
    def backward(ctx, g):
        ego, nei = ctx.saved_tensors
        d_ego = min_clearance_bwd(ego, nei, g.float().contiguous(),
                                  *ctx.consts)
        return d_ego, None, None, None, None, None


def min_clearance(ego_xyth: Tensor, nei: Tensor, ego_L: float, ego_W: float,
                  num_L: int = 4, rows_per_scene: int = 1) -> Tensor:
    """Fused masked min neighbor clearance.  ego_xyth: (n, T, 3); nei:
    (n / rows_per_scene, K, T, 7) rows (valid, x, y, th, -, L, W).  Returns
    (n, T) float32."""
    return MinClearance.apply(ego_xyth.float().contiguous(),
                              nei.float().contiguous(), ego_L, ego_W, num_L,
                              rows_per_scene)


def neighbor_rows(nei_traj: Tensor, nei_valid: Tensor) -> Tensor:
    """The kernels' 7-column neighbor rows (valid, x, y, th, 0, L, W) from
    tracks (..., K, T, >=6) rows (x, y, th, ..., L, W) and validity
    (..., K, T), without gradient."""
    return torch.cat([nei_valid[..., None], nei_traj[..., 0:3],
                      torch.zeros_like(nei_traj[..., 0:1]),
                      nei_traj[..., -2:-1], nei_traj[..., -1:]],
                     dim=-1).detach()


def min_neighbor_distance_fused(ego_traj: Tensor, nei_traj: Tensor,
                                nei_valid: Tensor, ego_L: float,
                                ego_W: float, num_L: int = 4,
                                rows_per_scene: int = 1) -> Tensor:
    """Drop-in for ``geometry.min_neighbor_distance`` with ``num_W == 1``.
    ego_traj: (n, T, >=3); nei_traj: (n / rows_per_scene, K, T, >=6) rows
    (x, y, th, ..., L, W); nei_valid: (n / rows_per_scene, K, T).  Returns
    (n, T)."""
    return min_clearance(ego_traj[..., :3], neighbor_rows(nei_traj, nei_valid),
                         ego_L, ego_W, num_L, rows_per_scene)
