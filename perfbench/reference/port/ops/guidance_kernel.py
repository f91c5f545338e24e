"""A frozen copy of ``pstl_tpu_torch/ops/guidance_kernel.py`` of the PyTorch port, kept as the benchmark's plain
reference: every kernel dispatch runs the plain version.  Do not edit to
follow the program."""


from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from perfbench.reference.port.config import Config
from perfbench.reference.port.parallel import mesh

Tensor = torch.Tensor


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
    """The kernel's invariant operands from a ``CandMinorGuidanceLoss``
    (mirrors ``pallas_guidance.pallas_invariants``), memoized on it."""
    if fused_loss._kernel_operands is not None:
        return fused_loss._kernel_operands
    f32 = torch.float32
    bs, R = fused_loss.bs, fused_loss.R
    ones = torch.ones((bs, R), dtype=f32, device=fused_loss.valid_r.device)
    if cfg.norm_stl:
        nf = torch.stack([(fused_loss.vf[:, 0] * ones),
                          (fused_loss.df[:, 0] * ones),
                          (fused_loss.sf[:, 0] * ones)], dim=1)
    else:
        nf = torch.stack([ones] * 3, dim=1)
    valid = fused_loss.valid_r.to(f32).contiguous()
    ops = Operands(
        lanes=fused_loss.lanes.to(f32).contiguous(),
        ndx=fused_loss.nx.permute(0, 1, 3, 2).to(f32).contiguous(),
        ndy=fused_loss.ny.permute(0, 1, 3, 2).to(f32).contiguous(),
        crad=(fused_loss.re + fused_loss.rn).to(f32).contiguous(),
        cvalid=fused_loss.nvalid.to(f32).contiguous(),
        stlp=fused_loss.stlp_r.to(f32).contiguous(),
        nf=nf.contiguous(), valid=valid,
        scal=torch.stack([fused_loss.th0.reshape(bs),
                          fused_loss.v0.reshape(bs)], dim=1).to(f32)
        .contiguous(),
        # the hinge's mean over every row: under a sharding (parallel.mesh)
        # over the rows of all ranks, so each column's gradient is the
        # whole batch's
        gscale=1.0 / (bs * R * mesh.shard_world() * torch.clamp(
            mesh.shard_mean(torch.mean(valid)), min=1e-2)))
    fused_loss._kernel_operands = ops
    return ops


def guidance_adam_cm(fused_loss, mu_cm: Tensor, beta_t: Tensor,
                     thres: float, cfg: Config) -> Tensor:
    """Guided posterior mean, candidate-minor (bs, T, 2, R) in and out —
    the port of ``pallas_guidance.guidance_adam_cm`` with the selections
    frozen in the kernel: :func:`guidance_fused`."""
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
    outw, outa = guidance_fused(muw, mua, *ops[:-1], gvec, p)
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


#: pointer arguments of each C entry (tensors, then outw, outa)
_NPTR = {"guidance_fused": 14, "guidance_frozen": 21}


def guidance_fused(muw, mua, lanes, ndx, ndy, crad, cvalid, stlp, nf, valid,
                   scal, gvec, p: KernelParams):
    """The fused guidance step: its plain version."""
    args = (muw, mua, lanes, ndx, ndy, crad, cvalid, stlp, nf, valid, scal,
            gvec)
    return guidance_fused_plain(*args, p)


