"""Torch transcription of the guidance kernels' hand-written backward pass
(``score_grad`` in ``pstl_tpu_torch/csrc/guidance_device.cuh``), vectorized
over the candidate columns.  What crosses time steps comes in two forms:
serial loops over t (a plain recurrence, the reference), and, with
``scan=True``, the forms the kernel runs on a warp with lane = time step:
Hillis-Steele prefix and suffix sums, the doubling ``logaddexp`` scan of
Eventually-Always and the affine-map scan of its backward, each on 32 lanes
with identities beyond T (``excl_prefix_scan``, ``excl_suffix_scan``,
``ev_fwd_scan``, ``ev_bwd_scan``), and the kernel's hoisted reciprocals: a
divisor that is the same for a whole column (tau, the norm factors, P5, the
sum of the band's softmin, Adam's bias corrections) is inverted once and
multiplied (``_div``, ``adam_clip_recip``).  It reads the selections as frozen
values (``pay``, keyed by
``guidance_kernel.FROZEN_KEYS``), which covers both of the kernels' ways to
read them: the in-kernel freeze's indices (IdxSel, whose values are
``guidance_kernel.payloads``) and the payloads of ``freeze_cm`` (PaySel).
It exists for the tests: a CUDA kernel cannot run on a CPU, so its VJP
algebra is checked here against ``torch.autograd`` of the plain version
(``tests/test_torch_guidance.py``, ``tests/test_torch_frozen_kernel.py``),
and the kernels are compared with the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import torch

from pstl_tpu_torch.ops import guidance_kernel as gk


def _grad_clip(x, lo, hi):
    """d/dx of jnp.clip(x, lo, hi) (0.5 at a boundary)."""
    f1 = torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0))
    f2 = torch.where(x < hi, 1.0, torch.where(x == hi, 0.5, 0.0))
    return f1 * f2


def _grad_max(x, lo):
    return torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0))


def _div(x, d, recip):
    """x / d, or as the kernel has it for a column-wide divisor: x times
    the reciprocal of d (taken once, by a division)."""
    return x * (1.0 / d) if recip else x / d


def _stats(z, dim=1):
    m = torch.amax(z, dim=dim, keepdim=True)
    return m, torch.sum(torch.exp(z - m), dim=dim, keepdim=True)


def _ev_fwd(z, nt2):
    """Serial suffix logaddexp and its (m2, S2) stats; z (bs, T, R)."""
    T = z.shape[1]
    suf = [None] * T
    suf[T - 1] = z[:, T - 1]
    for t in range(T - 2, -1, -1):
        suf[t] = torch.logaddexp(z[:, t], suf[t + 1])
    suf = torch.stack(suf, dim=1)
    m2, S2 = _stats(-suf[:, :nt2])
    return suf, m2, S2, (m2 + torch.log(S2))[:, 0]


def _ev_bwd(z, suf, nt2, m2, S2, gout):
    """d ev / d g_u = sum_{t <= min(u, nt2-1)} q_t exp(z_u - s_t)."""
    T = z.shape[1]
    B = torch.zeros_like(z[:, 0])
    out = []
    for u in range(T):
        if u > 0:
            B = B * torch.exp(suf[:, u] - suf[:, u - 1])
        if u < nt2:
            B = B + torch.exp(-suf[:, u] - m2[:, 0]) / S2[:, 0]
        out.append(gout * torch.exp(z[:, u] - suf[:, u]) * B)
    return torch.stack(out, dim=1)


# ---- the warp forms: 32 lanes along dim 1, identities beyond T -----------

LANES = 32
STEPS = (1, 2, 4, 8, 16)


def _lanes(x, fill):
    """(bs, T, R) -> (bs, 32, R), lanes t >= T filled."""
    pad = x.new_full((x.shape[0], LANES - x.shape[1], x.shape[2]), fill)
    return torch.cat([x, pad], dim=1)


def _from_below(v, d, fill):
    """Lane t's view of lane t - d (``__shfl_up_sync``); ``fill`` below 0."""
    return torch.cat([v.new_full(v[:, :d].shape, fill), v[:, :-d]], dim=1)


def _from_above(v, d, fill):
    """Lane t's view of lane t + d (``__shfl_down_sync``)."""
    return torch.cat([v[:, d:], v.new_full(v[:, :d].shape, fill)], dim=1)


def _lane_index(v):
    return torch.arange(LANES)[None, :, None].expand_as(v)


def excl_prefix_scan(x):
    """Sum over the lanes below (the kernel's ``excl_prefix``)."""
    v = _lanes(x, 0.0)
    for d in STEPS:
        v = torch.where(_lane_index(v) >= d, v + _from_below(v, d, 0.0), v)
    return _from_below(v, 1, 0.0)[:, :x.shape[1]]


def excl_suffix_scan(x):
    """Sum over the lanes above (the kernel's ``excl_suffix``)."""
    v = _lanes(x, 0.0)
    for d in STEPS:
        v = torch.where(_lane_index(v) + d < LANES,
                        v + _from_above(v, d, 0.0), v)
    return _from_above(v, 1, 0.0)[:, :x.shape[1]]


def ev_fwd_scan(z, nt2):
    """``_ev_fwd`` with the suffix logaddexp as the doubling scan of the
    kernel's ``ev_alw_fwd`` (and of ``pallas_guidance._ev_alw``)."""
    T = z.shape[1]
    s = _lanes(z, -1e30)
    for k in STEPS:
        n = torch.where(_lane_index(s) + k >= T, torch.full_like(s, -1e30),
                        _from_above(s, k, -1e30))
        s = torch.logaddexp(s, n)
    suf = s[:, :T]
    m2, S2 = _stats(-suf[:, :nt2])
    return suf, m2, S2, (m2 + torch.log(S2))[:, 0]


def ev_bwd_scan(z, suf, nt2, m2, S2, gout):
    """``_ev_bwd`` with the recurrence B_u = a_u B_{u-1} + q_u as an
    inclusive scan of the affine maps (a_u, q_u) (``ev_alw_bwd``)."""
    T = z.shape[1]
    sufl = _lanes(suf, -1e30)
    lane = _lane_index(sufl)
    A = torch.where(lane > 0, torch.exp(sufl - _from_below(sufl, 1, 0.0)),
                    torch.zeros_like(sufl))
    B = torch.where(lane < nt2, torch.exp(-sufl - m2) / S2,
                    torch.zeros_like(sufl))
    for k in STEPS:
        Ap, Bp = _from_below(A, k, 0.0), _from_below(B, k, 0.0)
        B = torch.where(lane >= k, A * Bp + B, B)
        A = torch.where(lane >= k, A * Ap, A)
    return gout[:, None] * torch.exp(z - suf) * B[:, :T]


class _ScanCumsumBF16(torch.autograd.Function):
    """``guidance_kernel._CumsumBF16`` with the sums in scan order."""

    @staticmethod
    def forward(ctx, x):
        return excl_prefix_scan(gk._bf16(x))

    @staticmethod
    def backward(ctx, g):
        return gk._bf16(excl_suffix_scan(g))


def rollout_scan(muw, mua, scal, p):
    """``guidance_kernel.rollout_cm`` with the kernel's scan-ordered sums."""
    cs = (_ScanCumsumBF16.apply if p.bf16_cumsum else excl_prefix_scan)
    th = scal[:, 0, None, None] + p.dt * cs(muw * p.mul_w)
    v = scal[:, 1, None, None] + p.dt * cs(mua * p.mul_a)
    c, s = torch.cos(th), torch.sin(th)
    return cs(v * c * p.dt), cs(v * s * p.dt), th, v, c, s


def score_grad(w, a, pay, ops, p, thres, gscale, scan=False):
    """Per-column robustness (bs, R) and the gradient of
    sum relu(thres - score) * valid * gscale w.r.t. (w, a), both (bs, T, R),
    as the kernel computes them; ``scan`` picks the warp forms of what
    crosses time steps and the hoisted reciprocals."""
    tau, M, T = p.tau, p.M, p.T
    R = w.shape[-1]
    ev_fwd, ev_bwd = (ev_fwd_scan, ev_bwd_scan) if scan else (_ev_fwd,
                                                              _ev_bwd)
    rev_cumsum = excl_suffix_scan if scan else gk._excl_rev_cumsum
    dv = lambda u, d: _div(u, d, scan)
    x, y, th, v, c, s = (rollout_scan if scan else gk.rollout_cm)(
        w, a, ops.scal, p)
    x2, y2, th2, x3, y3 = (pay[k] for k in ("x2", "y2", "th2", "x3", "y3"))
    area = x * (y2 - y3) + x2 * (y3 - y) + x3 * (y - y2)
    bottom = torch.sqrt((x2 - x3) ** 2 + (y2 - y3) ** 2)
    bc = torch.clamp(bottom, min=1e-7)
    normal = (bottom != 0).float()
    q = (x - x2) ** 2 + (y - y2) ** 2
    l2d = torch.sqrt(torch.clamp(q, min=1e-3))
    d0 = normal * area / bc + (1 - normal) * l2d
    zero = torch.zeros_like(d0)
    nc, ba, aa, sgn, l2d1, q1 = zero + 1, zero, zero, zero, zero + 1, zero
    dpre = d0
    if p.inline:
        q1 = (x - x3) ** 2 + (y - y3) ** 2
        l2d1 = torch.sqrt(torch.clamp(q1, min=1e-3))
        behind = ((x - x2) * (x3 - x2) + (y - y2) * (y3 - y2)) <= 0
        ahead = ((x - x3) * (x2 - x3) + (y - y3) * (y2 - y3)) <= 0
        ba_b = (pay["first"] > 0) & behind
        aa_b = (pay["last"] > 0) & ahead
        ba, aa = ba_b.float(), aa_b.float()
        nc = (~(ba_b | aa_b)).float()
        sgn = torch.sign(d0)
        dpre = nc * d0 + ba * l2d * sgn + aa * l2d1 * sgn
    d = torch.clamp(dpre, -5.0, 5.0) if p.clip_dist else dpre
    tha = 1.0 - torch.cos(th2 - th)

    # clearance: min over k, whole gradient to the earliest minimal k
    best, kmin = None, None
    pieces = []
    for k in range(p.K):
        ax = pay["axe"][:, k]
        dxk = x + ax * c - pay["nx"][:, k]
        dyk = y + ax * s - pay["ny"][:, k]
        dist = torch.sqrt(dxk ** 2 + dyk ** 2 + 1e-12)
        per = dist - ops.crad[:, k, :, None]
        vk = ops.cvalid[:, k, :, None].expand_as(per)
        masked = torch.clamp(per, -5.0, 20.0) * vk + (1.0 - vk) * 100.0
        pieces.append((ax, dxk, dyk, dist, per, vk))
        if best is None:
            best, kmin = masked, torch.zeros_like(masked, dtype=torch.long)
        else:
            better = masked < best
            best = torch.where(better, masked, best)
            kmin = torch.where(better, k, kmin)
    mnd = best

    P = lambda i: ops.stlp[:, i:i + 1]
    vf, df, sf = ops.nf[:, 0:1], ops.nf[:, 1:2], ops.nf[:, 2:3]
    zv1 = -dv(v - P(0), vf) * tau
    zv2 = -dv(-v + P(1), vf) * tau
    zsf = -dv(mnd - P(4), sf) * tau
    (m_v1, S_v1), (m_v2, S_v2), (m_sf, S_sf) = (_stats(z) for z in
                                                 (zv1, zv2, zsf))
    alw = lambda m, S: dv(-(m + torch.log(S)), tau)[:, 0]
    # keep clauses
    zd1 = -dv(d - P(2), df) * tau
    zd2 = -dv(-d + P(3), df) * tau
    zth = -dv(P(5) - tha, P(5)) * tau
    (m_d1, S_d1), (m_d2, S_d2), (m_th, S_th) = (_stats(z) for z in
                                                 (zd1, zd2, zth))
    # change clauses
    xa, xb = zd1, zd2
    mab = torch.maximum(xa, xb)
    band = dv(-(mab + torch.log(torch.exp(xa - mab) + torch.exp(xb - mab))),
              tau)
    zb = -band * tau
    sufb, mb, Sb, evb = ev_fwd(zb, p.nt2)
    sufh, mh, Sh, evh = ev_fwd(zth, p.nt2)
    rows_keep = torch.stack([alw(m_v1, S_v1), alw(m_v2, S_v2),
                             alw(m_d1, S_d1), alw(m_d2, S_d2),
                             alw(m_th, S_th), alw(m_sf, S_sf)], dim=1)
    big = torch.full_like(evb, -1e30)
    rows_change = torch.stack([alw(m_v1, S_v1), alw(m_v2, S_v2),
                               dv(evb, tau), dv(evh, tau), alw(m_sf, S_sf),
                               big], dim=1)
    keep = (torch.arange(R) < M)[None]
    rows = torch.where(keep[:, None], rows_keep, rows_change)  # (bs, 6, R)
    xr = -rows * tau
    xr = torch.where(keep[:, None] | (torch.arange(6) < 5)[None, :, None],
                     xr, torch.full_like(xr, -torch.inf))
    mr, Sr = _stats(xr)
    score = dv(-(mr + torch.log(Sr)), tau)[:, 0]

    # ---- backward -----------------------------------------------------
    gs = torch.where(thres - score > 0, -ops.valid * gscale, 0.0)
    if scan:
        gr = (gs[:, None] / Sr) * torch.exp(xr - mr)           # (bs, 6, R)
    else:
        gr = gs[:, None] * torch.exp(xr - mr) / Sr
    wgt = lambda z, m, S: torch.exp(z - m) / S
    g_v1 = gr[:, 0:1]
    g_v2 = gr[:, 1:2]
    g_sf = torch.where(keep, gr[:, 5], gr[:, 4])[:, None]
    gv = (dv(g_v1 * wgt(zv1, m_v1, S_v1), vf)
          - dv(g_v2 * wgt(zv2, m_v2, S_v2), vf))
    gmnd = dv(g_sf * wgt(zsf, m_sf, S_sf), sf)
    gd_keep = (dv(gr[:, 2:3] * wgt(zd1, m_d1, S_d1), df)
               - dv(gr[:, 3:4] * wgt(zd2, m_d2, S_d2), df))
    gtha_keep = -dv(gr[:, 4:5] * wgt(zth, m_th, S_th), P(5))
    gband = ev_bwd(zb, sufb, p.nt2, mb, Sb, gr[:, 2])
    gthe = ev_bwd(zth, sufh, p.nt2, mh, Sh, gr[:, 3])
    ea, eb = torch.exp(xa - mab), torch.exp(xb - mab)
    pa, pb = dv(ea, ea + eb), dv(eb, ea + eb)
    gd_change = gband * (dv(pa, df) - dv(pb, df))
    gtha_change = -dv(gthe, P(5))
    gd = torch.where(keep[:, None], gd_keep, gd_change)
    gtha = torch.where(keep[:, None], gtha_keep, gtha_change)

    gth = -gtha * torch.sin(th2 - th)
    g = gd * _grad_clip(dpre, -5.0, 5.0) if p.clip_dist else gd
    gd0 = g * nc
    gl2d = g * ba * sgn + gd0 * (1 - normal)
    gl2d1 = g * aa * sgn
    garea = gd0 * normal / bc
    gx = garea * (y2 - y3)
    gy = garea * (x3 - x2)
    gq = gl2d * 0.5 / l2d * _grad_max(q, 1e-3)
    gx = gx + gq * 2 * (x - x2)
    gy = gy + gq * 2 * (y - y2)
    if p.inline:
        gq1 = gl2d1 * 0.5 / l2d1 * _grad_max(q1, 1e-3)
        gx = gx + gq1 * 2 * (x - x3)
        gy = gy + gq1 * 2 * (y - y3)
    gc = torch.zeros_like(gx)
    gsn = torch.zeros_like(gx)
    for k, (ax, dxk, dyk, dist, per, vk) in enumerate(pieces):
        on = (kmin == k).float()
        gper = gmnd * on * vk * _grad_clip(per, -5.0, 20.0)
        gd2 = gper * 0.5 / dist
        gx = gx + gd2 * 2 * dxk
        gy = gy + gd2 * 2 * dyk
        gc = gc + gd2 * 2 * dxk * ax
        gsn = gsn + gd2 * 2 * dyk * ax

    rnd = gk._bf16 if p.bf16_cumsum else (lambda u: u)
    GX = rnd(rev_cumsum(gx))
    GY = rnd(rev_cumsum(gy))
    gv = gv + GX * p.dt * c + GY * p.dt * s
    gc = gc + GX * p.dt * v
    gsn = gsn + GY * p.dt * v
    gth = gth - s * gc + c * gsn
    gw = rnd(rev_cumsum(p.dt * gth)) * p.mul_w
    ga = rnd(rev_cumsum(p.dt * gv)) * p.mul_a
    return score, gw, ga


def adam_clip_recip(muw0, mua0, grad_fn, beta, p):
    """``guidance_kernel.adam_clip`` as the kernel's ``adam_clip`` has it:
    the bias corrections 1 - b^it are taken in double, rounded to the
    tensors' type, inverted once and multiplied."""
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
        rc1 = 1.0 / muw0.new_tensor(1 - b1 ** (it + 1))
        rc2 = 1.0 / muw0.new_tensor(1 - b2 ** (it + 1))
        muw = muw - p.lr * (mw * rc1) / (torch.sqrt(vw * rc2) + eps)
        mua = mua - p.lr * (ma * rc1) / (torch.sqrt(va * rc2) + eps)
        if p.quirk:
            dw = torch.minimum(torch.abs(muw - muw0), beta)
            da = torch.minimum(torch.abs(mua - mua0), beta)
        else:
            dw = torch.maximum(torch.minimum(muw - muw0, beta), -beta)
            da = torch.maximum(torch.minimum(mua - mua0, beta), -beta)
        muw, mua = muw0 + dw, mua0 + da
    return muw, mua


def guidance_fused_twin(muw, mua, lanes, ndx, ndy, crad, cvalid, stlp, nf,
                        valid, scal, gvec, p, scan=False):
    """The whole fused step (freeze, then the frozen step) with the
    hand-written gradient."""
    pay = gk.payloads(gk.freeze(muw, mua, lanes, ndx, ndy, scal, p), lanes,
                      ndx, ndy, p)
    return guidance_frozen_twin(muw, mua, *(pay[k] for k in gk.FROZEN_KEYS),
                                crad, cvalid, stlp, nf, valid, scal, gvec, p,
                                scan=scan)


def guidance_frozen_twin(muw, mua, x2, y2, th2, x3, y3, first, last, axe, nx,
                         ny, crad, cvalid, stlp, nf, valid, scal, gvec, p,
                         scan=False):
    """The step on frozen payloads (``guidance_frozen``'s arguments) with
    the hand-written gradient."""
    pay = dict(zip(gk.FROZEN_KEYS, (x2, y2, th2, x3, y3, first, last, axe,
                                    nx, ny)))
    ops = gk.Operands(None, None, None, crad, cvalid, stlp, nf, valid, scal,
                      gvec[2])
    grad_fn = lambda w, a: score_grad(w, a, pay, ops, p, gvec[1], gvec[2],
                                      scan=scan)[1:]
    loop = adam_clip_recip if scan else gk.adam_clip
    return loop(muw, mua, grad_fn, gvec[0], p)
