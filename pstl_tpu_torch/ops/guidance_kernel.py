"""The guidance step of a denoise step: ``guidance_niters`` Adam steps on
the STL hinge loss of the candidate columns, each followed by the beta_t
trust-region clip, on selections (lane segment, disc pair) frozen at the
posterior mean — one launch per guided denoise step.  Two kernels:

- ``guidance_fused`` (``csrc/guidance_fused.cu``) freezes the selections
  itself: the port of the Pallas kernel ``_kernel_fused``
  (``pstl_tpu/ops/pallas_guidance.py``,
  ``guidance_adam_cm(fuse_freeze=True)``).
- ``guidance_frozen`` (``csrc/guidance_frozen.cu``) reads them as frozen
  payloads made by ``CandMinorGuidanceLoss.freeze_cm``: the port of
  ``_kernel`` (``guidance_adam_cm(fuse_freeze=False)``).

On a CUDA tensor each wrapper launches its hand-written kernel; on a CPU
tensor it runs its plain version (:func:`guidance_fused_plain`,
:func:`guidance_frozen_plain`), the same computation in PyTorch ops with the
gradient from ``torch.autograd.grad``.  There is no fallback from one to the
other.  ``launches`` and ``frozen_launches`` count kernel launches (not
plain-version calls).

The TPU's other layouts of the same computation are launch configurations
here, not kernels of their own.  ``_kernel_fused_f2``
(``guidance_pallas_fold2``: scenes folded into (T, bs*R) lanes on a
column-chunk grid, the compact scene constants broadcast inside the kernel)
and the scene-folded ``_kernel_fused_f`` / ``_kernel_f``
(``guidance_pallas_fold``: the same folded tiles in one program) compute each
column's loss independently of the others
(tests/test_pallas_guidance.py::test_fold_variants_match), and the launches
already cover every column with one block per (scene, chunk of columns),
one warp per column, and the scene's constants in shared memory.  So
``guidance_adam_cm`` runs fold2 and the fused fold through
``guidance_fused``, and the frozen fold through ``guidance_frozen``,
unchanged.  ``guidance_pallas_cols`` (the TPU chunk width) is accepted and
ignored.

Operand layout (all float32, contiguous), for bs scenes, T steps, R = 3*M
candidate columns r = j*M + m (j = maneuver, whose lane the column reads):

  muw, mua        (bs, T, R)        normalized posterior-mean controls
  lanes           (bs, 3, S, 3)     lanes (x, y, heading), recentred at the ego
  ndx, ndy        (bs, K, nLn, T)   neighbor disc centres, recentred
  crad, cvalid    (bs, K, T)        ego + neighbor disc radius, validity
  stlp            (bs, 6, R)        pSTL parameters per column
  nf              (bs, 3, R)        norm_stl factors (vf, df, sf); ones if off
  valid           (bs, R)           column validity
  scal            (bs, 2)           ego start heading and speed (th0, v0)
  gvec            (3,)              beta_t, thres, gscale (device scalars)

``guidance_frozen`` reads crad, cvalid, stlp, nf, valid, scal, gvec as
above (not the lanes and disc centres) and the frozen payloads, all float32
(``frozen_operands``; first / last are 1.0 or 0.0):

  x2, y2, th2, x3, y3, first, last   (bs, T, R)     the frozen lane segment
  axe, nx, ny                        (bs, K, T, R)  ego-disc offset and
                                                    neighbor-disc centre of
                                                    the frozen pair

Returns the guided (muw, mua), each (bs, T, R).  Semantics follow the
Pallas kernel: argmins take the earliest index (lanes s ascending; exact
pairs e outer, nn inner; coarse pairs the ego disc nearest the neighbor's
disc centroid, then the neighbor disc nearest it); ``bf16_cumsum`` rounds
each rollout summand to bf16 and, as ``jax.grad`` of the Pallas kernel
does, rounds the summed cotangent of each summand to bf16 on the way back.
``guidance_pallas_pack`` is a TPU lane-packing layout; it does not change
the result (tests/test_pallas_guidance.py::test_pack_matches_grid) and is
ignored here.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from pstl_tpu_torch.config import Config

Tensor = torch.Tensor

#: kernel launches since the last reset (the plain versions do not count)
launches = 0            # guidance_fused
frozen_launches = 0     # guidance_frozen

#: the frozen payloads, in the order the frozen kernel takes them
FROZEN_KEYS = ("x2", "y2", "th2", "x3", "y3", "first", "last", "axe", "nx",
               "ny")

_MAXT, _MAXK, _MAXNL, _MAXS = 32, 16, 8, 64
_FLAG_INLINE, _FLAG_CLIP, _FLAG_QUIRK, _FLAG_COARSE, _FLAG_BF16 = (
    1, 2, 4, 8, 16)


class KernelParams(NamedTuple):
    T: int
    S: int
    K: int
    nLe: int
    nLn: int
    M: int
    nt2: int
    niters: int
    tau: float
    dt: float
    mul_w: float
    mul_a: float
    lr: float
    ego_L: float
    re: float
    inline: bool
    clip_dist: bool
    quirk: bool
    coarse: bool
    bf16_cumsum: bool


class Operands(NamedTuple):
    """Denoise-step-invariant kernel operands (built once per plan)."""
    lanes: Tensor
    ndx: Tensor
    ndy: Tensor
    crad: Tensor
    cvalid: Tensor
    stlp: Tensor
    nf: Tensor
    valid: Tensor
    scal: Tensor
    gscale: Tensor


def kernel_params(cfg: Config, fused_loss) -> KernelParams:
    return KernelParams(
        T=cfg.nt, S=fused_loss.lanes.shape[2], K=fused_loss.nx.shape[1],
        nLe=int(cfg.refined_nL), nLn=fused_loss.nx.shape[-1],
        M=fused_loss.M, nt2=cfg.nt // 2, niters=int(cfg.guidance_niters),
        tau=float(cfg.smoothing_factor), dt=float(cfg.dt),
        mul_w=float(cfg.mul_w_max), mul_a=float(cfg.mul_a_max),
        lr=float(cfg.guidance_lr), ego_L=float(cfg.ego_L),
        re=float(cfg.ego_W) / 2.0, inline=bool(cfg.inline),
        clip_dist=bool(cfg.clip_dist),
        quirk=bool(cfg.guidance_positive_offset_quirk),
        coarse=bool(cfg.clearance_coarse_pair),
        bf16_cumsum=bool(cfg.guidance_pallas_bf16_cumsum))


def kernel_operands(fused_loss, cfg: Config) -> Operands:
    """The kernel's invariant operands of a ``CandMinorGuidanceLoss``
    built on ``cfg``, made once a loss (its ``kernel_operands``)."""
    return fused_loss.kernel_operands


def frozen_operands(frozen) -> tuple:
    """``freeze_cm``'s dict -> the ten payloads of :data:`FROZEN_KEYS` as
    contiguous float32 tensors: (bs, T, R) for the lane segment, (bs, K, T,
    R) for the disc pair."""
    flat = {**frozen["lane"], **frozen["clear"]}
    return tuple(flat[k].to(torch.float32).contiguous() for k in FROZEN_KEYS)


def frozen_scene(ops: Operands) -> tuple:
    """The scene operands the frozen kernel reads: :class:`Operands` minus
    the lanes and disc centres (and gscale, which rides in gvec)."""
    return (ops.crad, ops.cvalid, ops.stlp, ops.nf, ops.valid, ops.scal)


def guidance_adam_cm(fused_loss, frozen, mu_cm: Tensor, beta_t: Tensor,
                     thres: float, cfg: Config,
                     fuse_freeze: bool = False) -> Tensor:
    """Guided posterior mean, candidate-minor (bs, T, 2, R) in and out —
    the port of ``pallas_guidance.guidance_adam_cm``.  ``fuse_freeze``
    launches :func:`guidance_fused`, which freezes in-kernel (``frozen`` is
    ignored); otherwise :func:`guidance_frozen` runs on ``frozen``
    (``fused_loss.freeze_cm(mu_cm)``).  ``guidance_pallas_fold`` and
    ``guidance_pallas_fold2`` take the same launches (module docstring)."""
    if not fuse_freeze and frozen is None:
        raise ValueError("guidance_adam_cm(fuse_freeze=False) needs the "
                         "frozen selections (fused_loss.freeze_cm)")
    ops = kernel_operands(fused_loss, cfg)
    p = kernel_params(cfg, fused_loss)
    dev = mu_cm.device
    gvec = torch.stack([torch.as_tensor(beta_t, dtype=torch.float32,
                                        device=dev).reshape(()),
                        torch.full((), float(thres), dtype=torch.float32,
                                   device=dev),
                        ops.gscale.reshape(())])
    muw = mu_cm[:, :, 0, :].float().contiguous()
    mua = mu_cm[:, :, 1, :].float().contiguous()
    if fuse_freeze:
        outw, outa = guidance_fused(muw, mua, *ops[:-1], gvec, p)
    else:
        outw, outa = guidance_frozen(muw, mua, *frozen_operands(frozen),
                                     *frozen_scene(ops), gvec, p)
    return torch.stack([outw, outa], dim=2)


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

def _bf16(x: Tensor) -> Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class _CumsumBF16(torch.autograd.Function):
    """Exclusive cumsum over dim 1 of bf16-rounded summands with fp32 sums;
    the backward rounds the summed cotangent to bf16 like ``jax.grad`` of
    ``pallas_guidance._cumsum_T(bf16=True)`` does."""

    @staticmethod
    def forward(ctx, x):
        return _excl_cumsum(_bf16(x))

    @staticmethod
    def backward(ctx, g):
        return _bf16(_excl_rev_cumsum(g))


def _excl_cumsum(x: Tensor) -> Tensor:
    c = torch.cumsum(x, dim=1)
    return torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], dim=1)


def _excl_rev_cumsum(g: Tensor) -> Tensor:
    c = torch.flip(torch.cumsum(torch.flip(g, (1,)), dim=1), (1,))
    return torch.cat([c[:, 1:], torch.zeros_like(c[:, :1])], dim=1)


def _cumsum(x: Tensor, bf16: bool) -> Tensor:
    return _CumsumBF16.apply(x) if bf16 else _excl_cumsum(x)


def rollout_cm(muw: Tensor, mua: Tensor, scal: Tensor, p: KernelParams):
    """(bs, T, R) controls -> recentred ego states (x, y, th, v, cos, sin)."""
    th0 = scal[:, 0, None, None]
    v0 = scal[:, 1, None, None]
    th = th0 + p.dt * _cumsum(muw * p.mul_w, p.bf16_cumsum)
    v = v0 + p.dt * _cumsum(mua * p.mul_a, p.bf16_cumsum)
    c, s = torch.cos(th), torch.sin(th)
    x = _cumsum(v * c * p.dt, p.bf16_cumsum)
    y = _cumsum(v * s * p.dt, p.bf16_cumsum)
    return x, y, th, v, c, s


def axe_values(p: KernelParams):
    """Ego disc offsets along the body axis, as the Pallas kernel computes
    them (python doubles, one fp32 rounding)."""
    return [(-p.ego_L / 2 + p.re) * (1 - e / max(p.nLe - 1, 1))
            + (p.ego_L / 2 - p.re) * (e / max(p.nLe - 1, 1))
            for e in range(p.nLe)]


def column_lanes(lanes: Tensor, M: int) -> Tensor:
    """(bs, 3, S, 3) -> (bs, S, 3, R): each column's own lane."""
    return torch.movedim(torch.repeat_interleave(lanes, M, dim=1), 1, -1)


def freeze(muw0: Tensor, mua0: Tensor, lanes: Tensor, ndx: Tensor,
           ndy: Tensor, scal: Tensor, p: KernelParams) -> Dict[str, Tensor]:
    """Selection indices at (muw0, mua0): ``seg`` (bs, T, R) nearest lane
    segment; ``ie``/``inn`` (bs, K, T, R) ego / neighbor disc of the frozen
    pair (``pallas_guidance._freeze_k``)."""
    with torch.no_grad():
        x, y, _, _, c, s = rollout_cm(muw0, mua0, scal, p)
        lane_r = column_lanes(lanes, p.M)
        lx, ly = lane_r[:, :, 0], lane_r[:, :, 1]             # (bs, S, R)
        pd = torch.sqrt((x[:, :, None] - lx[:, None]) ** 2
                        + (y[:, :, None] - ly[:, None]) ** 2)
        seg = torch.argmin(pd[:, :, :-1] + pd[:, :, 1:], dim=2)
        axe = axe_values(p)
        nx = ndx[..., None]                                   # (bs,K,nLn,T,1)
        ny = ndy[..., None]
        ex = torch.stack([x + a * c for a in axe], dim=1)     # (bs,nLe,T,R)
        ey = torch.stack([y + a * s for a in axe], dim=1)
        if p.coarse:
            ncx, ncy = nx[:, :, 0], ny[:, :, 0]
            for nn in range(1, p.nLn):
                ncx = ncx + nx[:, :, nn]
                ncy = ncy + ny[:, :, nn]
            ncx, ncy = ncx / p.nLn, ncy / p.nLn               # (bs,K,T,1)
            de = ((ex[:, None] - ncx[:, :, None]) ** 2
                  + (ey[:, None] - ncy[:, :, None]) ** 2)     # (bs,K,nLe,T,R)
            ie = torch.argmin(de, dim=2)                      # (bs,K,T,R)
            axe_t = torch.tensor(axe, dtype=torch.float32, device=x.device)
            a_sel = axe_t[ie]
            exs = x[:, None] + a_sel * c[:, None]
            eys = y[:, None] + a_sel * s[:, None]
            dn = ((exs[:, :, None] - nx) ** 2
                  + (eys[:, :, None] - ny) ** 2)              # (bs,K,nLn,T,R)
            inn = torch.argmin(dn, dim=2)
        else:
            d2 = ((ex[:, None, :, None] - nx[:, :, None]) ** 2
                  + (ey[:, None, :, None] - ny[:, :, None]) ** 2)
            bs, K = d2.shape[:2]
            pi = torch.argmin(d2.reshape(bs, K, p.nLe * p.nLn, p.T, -1),
                              dim=2)
            ie, inn = pi // p.nLn, pi % p.nLn
    return dict(seg=seg, ie=ie, inn=inn)


def payloads(sel: Dict[str, Tensor], lanes: Tensor, ndx: Tensor,
             ndy: Tensor, p: KernelParams) -> Dict[str, Tensor]:
    """Frozen per-(t, column) values the Adam loop reads, under
    :data:`FROZEN_KEYS` (``freeze_cm``'s payloads at these selections)."""
    lane_r = column_lanes(lanes, p.M)                         # (bs,S,3,R)
    T = sel["seg"].shape[1]
    lr_t = lane_r[:, None].expand(-1, T, -1, -1, -1)          # (bs,T,S,3,R)
    idx = sel["seg"][:, :, None, None].expand(-1, -1, 1, 3, -1)
    p2 = torch.gather(lr_t, 2, idx)[:, :, 0]                  # (bs,T,3,R)
    p3 = torch.gather(lr_t, 2, idx + 1)[:, :, 0]
    axe_t = torch.tensor(axe_values(p), dtype=torch.float32,
                         device=lanes.device)
    R = sel["seg"].shape[-1]
    nsel = lambda nd: torch.gather(
        nd[..., None].expand(-1, -1, -1, -1, R), 2,
        sel["inn"][:, :, None]).squeeze(2)                    # (bs,K,T,R)
    return dict(x2=p2[:, :, 0], y2=p2[:, :, 1], th2=p2[:, :, 2],
                x3=p3[:, :, 0], y3=p3[:, :, 1],
                first=(sel["seg"] == 0).float(),
                last=(sel["seg"] == p.S - 2).float(),
                axe=axe_t[sel["ie"]], nx=nsel(ndx), ny=nsel(ndy))


def scores_frozen(muw: Tensor, mua: Tensor, pay: Dict[str, Tensor],
                  crad: Tensor, cvalid: Tensor, stlp: Tensor, nf: Tensor,
                  scal: Tensor, p: KernelParams) -> Tensor:
    """Per-column robustness (bs, R) with frozen selections
    (``pallas_guidance._scene_scores``; keep columns r < M, change columns
    r >= M)."""
    tau, M = p.tau, p.M
    x, y, th, v, c, s = rollout_cm(muw, mua, scal, p)
    x2, y2, x3, y3 = pay["x2"], pay["y2"], pay["x3"], pay["y3"]
    area = x * (y2 - y3) + x2 * (y3 - y) + x3 * (y - y2)
    bottom = torch.sqrt((x2 - x3) ** 2 + (y2 - y3) ** 2)
    l2d = torch.sqrt(torch.clamp((x - x2) ** 2 + (y - y2) ** 2, min=1e-3))
    normal = (bottom != 0).float()
    d = normal * area / torch.clamp(bottom, min=1e-7) + (1 - normal) * l2d
    if p.inline:
        l2d1 = torch.sqrt(torch.clamp((x - x3) ** 2 + (y - y3) ** 2,
                                      min=1e-3))
        behind = ((x - x2) * (x3 - x2) + (y - y2) * (y3 - y2)) <= 0
        ahead = ((x - x3) * (x2 - x3) + (y - y3) * (y2 - y3)) <= 0
        behind_all = (pay["first"] > 0) & behind
        ahead_all = (pay["last"] > 0) & ahead
        norm_c = ~(behind_all | ahead_all)
        sign = torch.sign(d)
        d = norm_c * d + behind_all * l2d * sign + ahead_all * l2d1 * sign
    if p.clip_dist:
        d = torch.clamp(d, -5.0, 5.0)
    th_all = 1.0 - torch.cos(pay["th2"] - th)

    mnd = None
    for k in range(p.K):
        exd = x + pay["axe"][:, k] * c
        eyd = y + pay["axe"][:, k] * s
        d2 = (exd - pay["nx"][:, k]) ** 2 + (eyd - pay["ny"][:, k]) ** 2
        per = torch.sqrt(d2 + 1e-12) - crad[:, k, :, None]
        vk = cvalid[:, k, :, None]
        masked = torch.clamp(per, -5.0, 20.0) * vk + (1.0 - vk) * 100.0
        mnd = masked if mnd is None else torch.minimum(mnd, masked)

    P = lambda i: stlp[:, i:i + 1]                            # (bs, 1, R)
    vf, df, sf = nf[:, 0:1], nf[:, 1:2], nf[:, 2:3]
    alw = lambda g: -torch.logsumexp(-g * tau, dim=1) / tau   # (bs, R)
    smin = lambda rows: -torch.logsumexp(
        torch.stack([-r * tau for r in rows], dim=1), dim=1) / tau

    def ev_alw(g):
        suf = torch.flip(torch.logcumsumexp(torch.flip(-g * tau, (1,)), 1),
                         (1,))
        return torch.logsumexp(-suf[:, :p.nt2], dim=1) / tau

    alw_vmin = alw((v - P(0)) / vf)
    alw_vmax = alw((-v + P(1)) / vf)
    alw_safe = alw((mnd - P(4)) / sf)
    thmax = P(5)
    k_, c_ = slice(0, M), slice(M, None)
    s_keep = smin([alw_vmin[:, k_], alw_vmax[:, k_],
                   alw((d - P(2))[..., k_] / df[..., k_]),
                   alw((-d + P(3))[..., k_] / df[..., k_]),
                   alw(((thmax - th_all) / thmax)[..., k_]),
                   alw_safe[:, k_]])
    a_ = ((d - P(2)) / df)[..., c_]
    b_ = ((-d + P(3)) / df)[..., c_]
    band = -torch.logsumexp(torch.stack([-a_ * tau, -b_ * tau]), dim=0) / tau
    s_change = smin([alw_vmin[:, c_], alw_vmax[:, c_], ev_alw(band),
                     ev_alw(((thmax - th_all) / thmax)[..., c_]),
                     alw_safe[:, c_]])
    return torch.cat([s_keep, s_change], dim=1)


def adam_clip(muw0, mua0, grad_fn, beta, p: KernelParams):
    """``niters`` Adam steps from (muw0, mua0) with ``grad_fn(muw, mua) ->
    (gw, ga)``, each followed by the beta trust-region clip around the
    start (``pallas_guidance._adam_loop``)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    muw, mua = muw0, mua0
    mw, vw = torch.zeros_like(muw0), torch.zeros_like(muw0)
    ma, va = torch.zeros_like(mua0), torch.zeros_like(mua0)
    for it in range(p.niters):
        gw, ga = grad_fn(muw, mua)
        mw = b1 * mw + (1 - b1) * gw
        vw = b2 * vw + (1 - b2) * gw * gw
        ma = b1 * ma + (1 - b1) * ga
        va = b2 * va + (1 - b2) * ga * ga
        c1, c2 = 1 - b1 ** (it + 1), 1 - b2 ** (it + 1)
        muw = muw - p.lr * (mw / c1) / (torch.sqrt(vw / c2) + eps)
        mua = mua - p.lr * (ma / c1) / (torch.sqrt(va / c2) + eps)
        if p.quirk:
            dw = torch.minimum(torch.abs(muw - muw0), beta)
            da = torch.minimum(torch.abs(mua - mua0), beta)
        else:
            dw = torch.maximum(torch.minimum(muw - muw0, beta), -beta)
            da = torch.maximum(torch.minimum(mua - mua0, beta), -beta)
        muw, mua = muw0 + dw, mua0 + da
    return muw, mua


def guidance_fused_plain(muw, mua, lanes, ndx, ndy, crad, cvalid, stlp, nf,
                         valid, scal, gvec, p: KernelParams):
    """The fused guidance step in PyTorch ops: the freeze, then
    :func:`guidance_frozen_plain` on its payloads."""
    pay = payloads(freeze(muw, mua, lanes, ndx, ndy, scal, p), lanes, ndx,
                   ndy, p)
    return guidance_frozen_plain(muw, mua, *(pay[k] for k in FROZEN_KEYS),
                                 crad, cvalid, stlp, nf, valid, scal, gvec, p)


def guidance_frozen_plain(muw, mua, x2, y2, th2, x3, y3, first, last, axe,
                          nx, ny, crad, cvalid, stlp, nf, valid, scal, gvec,
                          p: KernelParams):
    """The Adam loop + clip on frozen payloads in PyTorch ops (autograd
    gradient of :func:`scores_frozen`'s hinge loss)."""
    beta, thres, gscale = gvec[0], gvec[1], gvec[2]
    pay = dict(zip(FROZEN_KEYS, (x2, y2, th2, x3, y3, first, last, axe, nx,
                                 ny)))

    def grad_fn(w, a):
        with torch.enable_grad():
            w = w.detach().requires_grad_(True)
            a = a.detach().requires_grad_(True)
            s = scores_frozen(w, a, pay, crad, cvalid, stlp, nf, scal, p)
            loss = torch.sum(torch.relu(thres - s) * valid * gscale)
            return torch.autograd.grad(loss, (w, a))

    return adam_clip(muw, mua, grad_fn, beta, p)


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double


#: pointer arguments of each C entry (tensors, then outw, outa)
_NPTR = {"guidance_fused": 14, "guidance_frozen": 21}


def _lib(name: str):
    from pstl_tpu_torch.ops import _build
    fn = getattr(_build.load(name), f"pstl_{name}")
    if fn.argtypes is None:
        fn.argtypes = ([_P] * _NPTR[name] + [_I] * 10 + [_F] * 5 + [_D] * 2
                       + [_I, _P])
        fn.restype = _I
    return fn


def _check(name, x, shape, dev, dtype=torch.float32, who="guidance_fused"):
    if x.device != dev:
        raise ValueError(f"{who}: {name} is on {x.device}, expected {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{who}: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def operand_shapes(p: KernelParams, bs: int, T: int, R: int) -> dict:
    """Every operand of the guidance kernels, by name, with its shape."""
    return dict(muw=(bs, T, R), mua=(bs, T, R), lanes=(bs, 3, p.S, 3),
                ndx=(bs, p.K, p.nLn, T), ndy=(bs, p.K, p.nLn, T),
                crad=(bs, p.K, T), cvalid=(bs, p.K, T), stlp=(bs, 6, R),
                nf=(bs, 3, R), valid=(bs, R), scal=(bs, 2), gvec=(3,),
                **{k: (bs, T, R) for k in FROZEN_KEYS[:7]},
                **{k: (bs, p.K, T, R) for k in FROZEN_KEYS[7:]})


def check_operands(ops, p: KernelParams, bs: int, T: int, R: int, dev,
                   who: str, names=Operands._fields) -> None:
    """The checks a launch of the guidance device code needs: sizes within
    the kernels' fixed arrays and each operand's device, dtype, shape and
    contiguity (``ops`` named by ``names``; by default the first nine
    fields of :class:`Operands`)."""
    if R != 3 * p.M or T != p.T:
        raise ValueError(f"{who}: T={T}, R={R} do not match T={p.T}, "
                         f"R=3*M={3 * p.M}")
    if not (T <= _MAXT and p.K <= _MAXK and p.nLe <= _MAXNL
            and p.nLn <= _MAXNL and 2 <= p.S <= _MAXS
            and 1 <= p.nt2 <= T):
        raise ValueError(f"{who}: sizes beyond the kernel's limits "
                         f"(T<={_MAXT}, K<={_MAXK}, nL<={_MAXNL}, "
                         f"2<=S<={_MAXS}): {p}")
    shapes = operand_shapes(p, bs, T, R)
    for name, x in zip(names, ops):
        _check(name, x, shapes[name], dev, who=who)


def flags(p: KernelParams) -> int:
    """The kernels' flag word (``F_*`` in csrc/guidance_device.cuh)."""
    return ((_FLAG_INLINE if p.inline else 0)
            | (_FLAG_CLIP if p.clip_dist else 0)
            | (_FLAG_QUIRK if p.quirk else 0)
            | (_FLAG_COARSE if p.coarse else 0)
            | (_FLAG_BF16 if p.bf16_cumsum else 0))


_FUSED_NAMES = ("muw", "mua") + Operands._fields[:9] + ("gvec",)
_FROZEN_NAMES = (("muw", "mua") + FROZEN_KEYS
                 + ("crad", "cvalid", "stlp", "nf", "valid", "scal", "gvec"))


def _launch(name: str, names, args, p: KernelParams):
    """Check ``args`` (named ``names``) and launch kernel ``name`` on the
    current stream; returns (outw, outa)."""
    muw = args[0]
    bs, T, R = muw.shape
    dev = muw.device
    check_operands(args, p, bs, T, R, dev, name, names)
    outw = torch.empty_like(muw)
    outa = torch.empty_like(muw)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib(name)(*(t.data_ptr() for t in args), outw.data_ptr(),
                     outa.data_ptr(), bs, T, R, p.M, p.S, p.K, p.nLe, p.nLn,
                     p.nt2, p.niters, p.tau, p.dt, p.mul_w, p.mul_a, p.lr,
                     p.ego_L, p.re, flags(p), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return outw, outa


def guidance_fused(muw, mua, lanes, ndx, ndy, crad, cvalid, stlp, nf, valid,
                   scal, gvec, p: KernelParams):
    """The fused guidance step: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    global launches
    args = (muw, mua, lanes, ndx, ndy, crad, cvalid, stlp, nf, valid, scal,
            gvec)
    if muw.device.type == "cuda":
        out = _launch("guidance_fused", _FUSED_NAMES, args, p)
        launches += 1
        return out
    if muw.device.type == "cpu":
        return guidance_fused_plain(*args, p)
    raise ValueError(f"guidance_fused: no implementation for device "
                     f"{muw.device}")


def guidance_frozen(muw, mua, x2, y2, th2, x3, y3, first, last, axe, nx, ny,
                    crad, cvalid, stlp, nf, valid, scal, gvec,
                    p: KernelParams):
    """The guidance step on frozen payloads: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    global frozen_launches
    args = (muw, mua, x2, y2, th2, x3, y3, first, last, axe, nx, ny, crad,
            cvalid, stlp, nf, valid, scal, gvec)
    if muw.device.type == "cuda":
        out = _launch("guidance_frozen", _FROZEN_NAMES, args, p)
        frozen_launches += 1
        return out
    if muw.device.type == "cpu":
        return guidance_frozen_plain(*args, p)
    raise ValueError(f"guidance_frozen: no implementation for device "
                     f"{muw.device}")
