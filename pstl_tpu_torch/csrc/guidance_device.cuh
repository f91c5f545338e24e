// Device code of the STL-guidance step, shared by the kernels that run it:
// csrc/guidance_fused.cu (the guidance step alone, freezing in-kernel, one
// launch per guided denoise step), csrc/guidance_frozen.cu (the same on
// selections frozen outside the kernel) and csrc/superstep.cu (a whole
// denoise step).  One copy of the hand-written forward and backward serves
// all three.
//
// Per candidate column: freeze the discrete selections at the posterior
// mean, then `niters` Adam steps on the hinge loss
// sum_r relu(thres - score_r) * valid_r * gscale, each followed by the
// beta_t trust-region clip (guided_update below; adam_clip is the loop
// alone).  A selection is read through a policy: IdxSel holds the in-kernel
// freeze as small indices into the scene's shared memory, PaySel reads the
// frozen payload values of its column from device memory.  It is the port
// of the Pallas helpers `_freeze_k`, `_adam_loop`, `_scene_scores`,
// `_rollout_k` and `_ev_alw` in pstl_tpu/ops/pallas_guidance.py.  The Pallas
// kernels get the gradient from `jax.grad` traced inside the kernel; here
// the backward pass is written by hand (reverse through the softmins, the
// clearance clip/min chain, the lane distance and the prefix-sum rollout).
// Its torch transcription is tested against autograd on the CPU
// (tests/test_torch_guidance.py, tests/test_torch_frozen_kernel.py).
//
// Semantics shared with the Pallas kernels: argmins take the earliest index
// (strict <); lanes in s order; exact pairs e outer, nn inner; coarse pairs
// the ego disc nearest the neighbor's disc centroid, then the neighbor disc
// nearest that ego disc.  With BF16 each rollout summand is rounded to bf16
// and summed in fp32, and the summed cotangent of each summand is rounded
// to bf16, as jax.grad of the Pallas kernel's bf16 cumsum does.  Gradient
// ties: the min over neighbors routes its whole gradient to the earliest
// minimal k (jnp.minimum splits exact ties 0.5/0.5); clips follow jnp.clip
// (0.5 at a boundary).  Both differ only on measure-zero ties.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#define MAXT 32
#define MAXK 16
#define MAXNL 8
#define MAXS 64
#define BLOCK 32  // candidate columns per block, one per guidance thread

enum { F_INLINE = 1, F_CLIP = 2, F_QUIRK = 4, F_COARSE = 8, F_BF16 = 16 };

struct Params {
  int bs, T, R, M, S, K, nLe, nLn, nt2, niters, flags;
  float tau, dt, mul_w, mul_a, lr;
  float axe[MAXNL];
};

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float sq(float x) { return x * x; }

// d/dx of jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi)
__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
  float f1 = x > lo ? 1.f : (x == lo ? 0.5f : 0.f);
  float f2 = x < hi ? 1.f : (x == hi ? 0.5f : 0.f);
  return f1 * f2;
}
// d/dx of jnp.clip(x, lo) = maximum(lo, x)
__device__ __forceinline__ float max_grad(float x, float lo) {
  return x > lo ? 1.f : (x == lo ? 0.5f : 0.f);
}

__device__ __forceinline__ float logaddexp(float a, float b) {
  float amax = fmaxf(a, b);
  return amax + log1pf(expf(-fabsf(a - b)));
}

// log-sum-exp of x[0..n-1] as (m, S): value m + log(S), weights
// exp(x_i - m) / S
__device__ __forceinline__ void lse_stats(const float* x, int n, float& m,
                                          float& S) {
  m = x[0];
  for (int i = 1; i < n; ++i) m = fmaxf(m, x[i]);
  S = 0.f;
  for (int i = 0; i < n; ++i) S += expf(x[i] - m);
}

struct Scene {  // shared-memory views of one scene's constants
  const float* lanes;  // [3][S][3]
  const float* ndx;    // [K][nLn][T]
  const float* ndy;
  const float* crad;   // [K][T]
  const float* cval;
};

struct Column {  // one candidate column's per-row constants
  float P[6], vf, df, sf, valid, th0, v0;
  int j;         // lane / maneuver of the column
  bool keep;     // r < M: lane-keep formula, else lane change
};

// Euler rollout by prefix sums (state before each step), recentred at 0.
__device__ void rollout(const float* w, const float* a, const Column& col,
                        const Params& p, float* x, float* y, float* th,
                        float* v, float* c, float* s) {
  const bool bf = p.flags & F_BF16;
  float sw = 0.f, sa = 0.f, sx = 0.f, sy = 0.f;
  for (int t = 0; t < p.T; ++t) {
    th[t] = col.th0 + p.dt * sw;
    v[t] = col.v0 + p.dt * sa;
    c[t] = cosf(th[t]);
    s[t] = sinf(th[t]);
    x[t] = sx;
    y[t] = sy;
    float ww = w[t] * p.mul_w, aa = a[t] * p.mul_a;
    float dx = v[t] * c[t] * p.dt, dy = v[t] * s[t] * p.dt;
    if (bf) { ww = rbf(ww); aa = rbf(aa); dx = rbf(dx); dy = rbf(dy); }
    sw += ww; sa += aa; sx += dx; sy += dy;
  }
}

// Frozen selections at (w, a): lane segment per t, disc pair per (k, t).
__device__ void freeze(const float* w, const float* a, const Column& col,
                       const Scene& sc, const Params& p, unsigned char* seg,
                       unsigned char* pe, unsigned char* pn) {
  float x[MAXT], y[MAXT], th[MAXT], v[MAXT], c[MAXT], s[MAXT];
  rollout(w, a, col, p, x, y, th, v, c, s);
  const float* L = sc.lanes + col.j * p.S * 3;
  const int T = p.T;
  for (int t = 0; t < T; ++t) {
    float best = 1e30f;
    int bi = 0;
    float pd_prev = sqrtf(sq(x[t] - L[0]) + sq(y[t] - L[1]));
    for (int q = 0; q < p.S - 1; ++q) {
      float pd_next = sqrtf(sq(x[t] - L[(q + 1) * 3])
                            + sq(y[t] - L[(q + 1) * 3 + 1]));
      float segc = pd_prev + pd_next;
      if (segc < best) { best = segc; bi = q; }
      pd_prev = pd_next;
    }
    seg[t] = (unsigned char)bi;
  }
  for (int k = 0; k < p.K; ++k) {
    for (int t = 0; t < T; ++t) {
      int be = 0, bn = 0;
      if (p.flags & F_COARSE) {
        float ncx = sc.ndx[(k * p.nLn) * T + t];
        float ncy = sc.ndy[(k * p.nLn) * T + t];
        for (int nn = 1; nn < p.nLn; ++nn) {
          ncx = ncx + sc.ndx[(k * p.nLn + nn) * T + t];
          ncy = ncy + sc.ndy[(k * p.nLn + nn) * T + t];
        }
        ncx = ncx / (float)p.nLn;
        ncy = ncy / (float)p.nLn;
        float beste = 1e30f, exs = 0.f, eys = 0.f;
        for (int e = 0; e < p.nLe; ++e) {
          float exd = x[t] + p.axe[e] * c[t];
          float eyd = y[t] + p.axe[e] * s[t];
          float de = sq(exd - ncx) + sq(eyd - ncy);
          if (de < beste) { beste = de; be = e; exs = exd; eys = eyd; }
        }
        float best2 = 1e30f;
        for (int nn = 0; nn < p.nLn; ++nn) {
          float d2 = sq(exs - sc.ndx[(k * p.nLn + nn) * T + t])
                     + sq(eys - sc.ndy[(k * p.nLn + nn) * T + t]);
          if (d2 < best2) { best2 = d2; bn = nn; }
        }
      } else {
        float best2 = 1e30f;
        for (int e = 0; e < p.nLe; ++e) {
          float exd = x[t] + p.axe[e] * c[t];
          float eyd = y[t] + p.axe[e] * s[t];
          for (int nn = 0; nn < p.nLn; ++nn) {
            float d2 = sq(exd - sc.ndx[(k * p.nLn + nn) * T + t])
                       + sq(eyd - sc.ndy[(k * p.nLn + nn) * T + t]);
            if (d2 < best2) { best2 = d2; be = e; bn = nn; }
          }
        }
      }
      pe[k * MAXT + t] = (unsigned char)be;
      pn[k * MAXT + t] = (unsigned char)bn;
    }
  }
}

// The frozen lane segment of one step: its end points, the heading of its
// first point, and whether it is the lane's first / last segment.
struct LaneSel {
  float x2, y2, th2, x3, y3;
  bool first, last;
};

// Selections as indices: the in-kernel freeze's segment per t and disc pair
// per (k, t), into the scene's lanes and disc centres in shared memory.
struct IdxSel {
  const float* L;  // the column's lane, [S][3]
  const float* ndx;  // [K][nLn][T]
  const float* ndy;
  const unsigned char* seg;  // [MAXT]
  const unsigned char* pe;   // [MAXK * MAXT] ego disc
  const unsigned char* pn;   // [MAXK * MAXT] neighbor disc
  __device__ __forceinline__ LaneSel lane(int t, const Params& p) const {
    const int sg = seg[t];
    return LaneSel{L[sg * 3], L[sg * 3 + 1], L[sg * 3 + 2], L[(sg + 1) * 3],
                   L[(sg + 1) * 3 + 1], sg == 0, sg == p.S - 2};
  }
  __device__ __forceinline__ void disc(int k, int t, const Params& p,
                                       float& ax, float& nx,
                                       float& ny) const {
    ax = p.axe[pe[k * MAXT + t]];
    const int ni = (k * p.nLn + pn[k * MAXT + t]) * p.T + t;
    nx = ndx[ni];
    ny = ndy[ni];
  }
};

// Selections as frozen payload values of one column (b, r), in device
// memory with r minor, so a warp's loads of one (t) or (k, t) coalesce.
struct PaySel {
  const float* lane_pay[7];  // x2 y2 th2 x3 y3 first last at (b, t=0, r)
  const float* disc_pay[3];  // axe nx ny at (b, k=0, t=0, r)
  int R;
  __device__ __forceinline__ LaneSel lane(int t, const Params&) const {
    const size_t o = (size_t)t * R;
    const float* const* q = lane_pay;
    return LaneSel{q[0][o], q[1][o], q[2][o], q[3][o], q[4][o],
                   q[5][o] > 0.f, q[6][o] > 0.f};
  }
  __device__ __forceinline__ void disc(int k, int t, const Params& p,
                                       float& ax, float& nx,
                                       float& ny) const {
    const size_t o = ((size_t)k * p.T + t) * R;
    ax = disc_pay[0][o];
    nx = disc_pay[1][o];
    ny = disc_pay[2][o];
  }
};

// Lane-distance pieces at step t against the frozen segment.
struct LaneT {
  float x2, y2, th2, x3, y3, area, bc, normal, l2d, l2d1, d0, sgn;
  float nc, ba, aa, dpre, d;
};

__device__ __forceinline__ LaneT lane_terms(float x, float y,
                                            const LaneSel& ls,
                                            const Params& p) {
  LaneT o;
  o.x2 = ls.x2; o.y2 = ls.y2; o.th2 = ls.th2;
  o.x3 = ls.x3; o.y3 = ls.y3;
  o.area = x * (o.y2 - o.y3) + o.x2 * (o.y3 - y) + o.x3 * (y - o.y2);
  float bottom = sqrtf(sq(o.x2 - o.x3) + sq(o.y2 - o.y3));
  o.bc = fmaxf(bottom, 1e-7f);
  o.normal = bottom != 0.f ? 1.f : 0.f;
  o.l2d = sqrtf(fmaxf(sq(x - o.x2) + sq(y - o.y2), 1e-3f));
  o.d0 = o.normal * o.area / o.bc + (1.f - o.normal) * o.l2d;
  o.nc = 1.f; o.ba = 0.f; o.aa = 0.f; o.l2d1 = 0.f; o.sgn = 0.f;
  float d = o.d0;
  if (p.flags & F_INLINE) {
    o.l2d1 = sqrtf(fmaxf(sq(x - o.x3) + sq(y - o.y3), 1e-3f));
    bool behind = ((x - o.x2) * (o.x3 - o.x2)
                   + (y - o.y2) * (o.y3 - o.y2)) <= 0.f;
    bool ahead = ((x - o.x3) * (o.x2 - o.x3)
                  + (y - o.y3) * (o.y2 - o.y3)) <= 0.f;
    bool ba = ls.first && behind;
    bool aa = ls.last && ahead;
    o.ba = ba ? 1.f : 0.f;
    o.aa = aa ? 1.f : 0.f;
    o.nc = (ba || aa) ? 0.f : 1.f;
    o.sgn = d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
    d = o.nc * d + o.ba * o.l2d * o.sgn + o.aa * o.l2d1 * o.sgn;
  }
  o.dpre = d;
  if (p.flags & F_CLIP) d = fminf(fmaxf(d, -5.f), 5.f);
  o.d = d;
  return o;
}

// Eventually(0, nt2, Always(0, T, g)) with z = -g*tau: suffix
// s_t = logaddexp(z_t, s_{t+1}) (serial), value lse(-s[:nt2]) / tau.
__device__ float ev_alw_fwd(const float* z, int T, int nt2, float tau,
                            float* suf, float& m2, float& S2) {
  suf[T - 1] = z[T - 1];
  for (int t = T - 2; t >= 0; --t) suf[t] = logaddexp(z[t], suf[t + 1]);
  float tmp[MAXT];
  for (int t = 0; t < nt2; ++t) tmp[t] = -suf[t];
  lse_stats(tmp, nt2, m2, S2);
  return (m2 + logf(S2)) / tau;
}

// d ev / d g_u = sum_{t <= min(u, nt2-1)} q_t exp(z_u - s_t), with
// q = softmax(-s[:nt2]); accumulated as B_u = B_{u-1} exp(s_u - s_{u-1}) + q_u
__device__ void ev_alw_bwd(const float* z, const float* suf, int T, int nt2,
                           float m2, float S2, float gout, float* gg) {
  float B = 0.f;
  for (int u = 0; u < T; ++u) {
    if (u > 0) B *= expf(suf[u] - suf[u - 1]);
    if (u < nt2) B += expf(-suf[u] - m2) / S2;
    gg[u] += gout * expf(z[u] - suf[u]) * B;
  }
}

// Robustness of one column at (w, a) and, when `gw`/`ga` are given, the
// gradient of dL/dscore * score with respect to (w, a).  `sel` is IdxSel or
// PaySel; `sc` supplies the disc radii and validity.
template <class Sel>
__device__ float score_grad(const float* w, const float* a,
                            const Column& col, const Scene& sc,
                            const Sel& sel, const Params& p, float thres,
                            float gscale, float* gw, float* ga) {
  const int T = p.T;
  const float tau = p.tau;
  float x[MAXT], y[MAXT], th[MAXT], v[MAXT], c[MAXT], s[MAXT];
  rollout(w, a, col, p, x, y, th, v, c, s);

  float d[MAXT], tha[MAXT], mnd[MAXT];
  unsigned char kmin[MAXT];
  for (int t = 0; t < T; ++t) {
    LaneT lt = lane_terms(x[t], y[t], sel.lane(t, p), p);
    d[t] = lt.d;
    tha[t] = 1.f - cosf(lt.th2 - th[t]);
    float best = 0.f;
    int kb = 0;
    for (int k = 0; k < p.K; ++k) {
      float ax, nx, ny;
      sel.disc(k, t, p, ax, nx, ny);
      float exd = x[t] + ax * c[t], eyd = y[t] + ax * s[t];
      float d2 = sq(exd - nx) + sq(eyd - ny);
      float per = sqrtf(d2 + 1e-12f) - sc.crad[k * T + t];
      float vk = sc.cval[k * T + t];
      float masked = fminf(fmaxf(per, -5.f), 20.f) * vk + (1.f - vk) * 100.f;
      if (k == 0 || masked < best) { best = masked; kb = k; }
    }
    mnd[t] = best;
    kmin[t] = (unsigned char)kb;
  }

  const float* P = col.P;
  // z arrays (z = -g * tau) of the Always clauses shared by both formulas
  float zv1[MAXT], zv2[MAXT], zsf[MAXT];
  for (int t = 0; t < T; ++t) {
    zv1[t] = -((v[t] - P[0]) / col.vf) * tau;
    zv2[t] = -((-v[t] + P[1]) / col.vf) * tau;
    zsf[t] = -((mnd[t] - P[4]) / col.sf) * tau;
  }
  float m_v1, S_v1, m_v2, S_v2, m_sf, S_sf;
  lse_stats(zv1, T, m_v1, S_v1);
  lse_stats(zv2, T, m_v2, S_v2);
  lse_stats(zsf, T, m_sf, S_sf);
  float alw_v1 = -(m_v1 + logf(S_v1)) / tau;
  float alw_v2 = -(m_v2 + logf(S_v2)) / tau;
  float alw_sf = -(m_sf + logf(S_sf)) / tau;

  float rows[6], xr[6], mr, Sr, score;
  int nrows;
  // keep: lane-offset band and heading over the current lane
  float zd1[MAXT], zd2[MAXT], zth[MAXT], m_d1 = 0.f, S_d1 = 1.f,
        m_d2 = 0.f, S_d2 = 1.f, m_th = 0.f, S_th = 1.f;
  // change: Eventually-Always of the band and of the heading
  float zb[MAXT], sufb[MAXT], sufh[MAXT], mb = 0.f, Sb = 1.f, mh = 0.f,
        Sh = 1.f;
  if (col.keep) {
    for (int t = 0; t < T; ++t) {
      zd1[t] = -((d[t] - P[2]) / col.df) * tau;
      zd2[t] = -((-d[t] + P[3]) / col.df) * tau;
      zth[t] = -((P[5] - tha[t]) / P[5]) * tau;
    }
    lse_stats(zd1, T, m_d1, S_d1);
    lse_stats(zd2, T, m_d2, S_d2);
    lse_stats(zth, T, m_th, S_th);
    rows[0] = alw_v1; rows[1] = alw_v2;
    rows[2] = -(m_d1 + logf(S_d1)) / tau;
    rows[3] = -(m_d2 + logf(S_d2)) / tau;
    rows[4] = -(m_th + logf(S_th)) / tau;
    rows[5] = alw_sf;
    nrows = 6;
  } else {
    for (int t = 0; t < T; ++t) {
      float ga_ = (d[t] - P[2]) / col.df, gb_ = (-d[t] + P[3]) / col.df;
      float xa = -ga_ * tau, xb = -gb_ * tau;
      float m = fmaxf(xa, xb);
      float band = -(m + logf(expf(xa - m) + expf(xb - m))) / tau;
      zb[t] = -band * tau;
      zth[t] = -((P[5] - tha[t]) / P[5]) * tau;
    }
    rows[0] = alw_v1; rows[1] = alw_v2;
    rows[2] = ev_alw_fwd(zb, T, p.nt2, tau, sufb, mb, Sb);
    rows[3] = ev_alw_fwd(zth, T, p.nt2, tau, sufh, mh, Sh);
    rows[4] = alw_sf;
    nrows = 5;
  }
  for (int i = 0; i < nrows; ++i) xr[i] = -rows[i] * tau;
  lse_stats(xr, nrows, mr, Sr);
  score = -(mr + logf(Sr)) / tau;
  if (gw == nullptr) return score;

  // ---- backward -----------------------------------------------------
  float gs = (thres - score > 0.f) ? -col.valid * gscale : 0.f;
  float gr[6];
  for (int i = 0; i < nrows; ++i) gr[i] = gs * (expf(xr[i] - mr) / Sr);
  float gv[MAXT], gd[MAXT], gtha[MAXT], gmnd[MAXT];
  for (int t = 0; t < T; ++t) { gv[t] = 0.f; gd[t] = 0.f; gtha[t] = 0.f; gmnd[t] = 0.f; }
  const float g_v1 = gr[0], g_v2 = gr[1], g_sf = gr[nrows - 1];
  for (int t = 0; t < T; ++t) {
    gv[t] += g_v1 * (expf(zv1[t] - m_v1) / S_v1) / col.vf;
    gv[t] -= g_v2 * (expf(zv2[t] - m_v2) / S_v2) / col.vf;
    gmnd[t] += g_sf * (expf(zsf[t] - m_sf) / S_sf) / col.sf;
  }
  if (col.keep) {
    for (int t = 0; t < T; ++t) {
      gd[t] += gr[2] * (expf(zd1[t] - m_d1) / S_d1) / col.df;
      gd[t] -= gr[3] * (expf(zd2[t] - m_d2) / S_d2) / col.df;
      gtha[t] -= gr[4] * (expf(zth[t] - m_th) / S_th) / P[5];
    }
  } else {
    float gband[MAXT], gth_[MAXT];
    for (int t = 0; t < T; ++t) { gband[t] = 0.f; gth_[t] = 0.f; }
    ev_alw_bwd(zb, sufb, T, p.nt2, mb, Sb, gr[2], gband);
    ev_alw_bwd(zth, sufh, T, p.nt2, mh, Sh, gr[3], gth_);
    for (int t = 0; t < T; ++t) {
      float xa = -((d[t] - P[2]) / col.df) * tau;
      float xb = -((-d[t] + P[3]) / col.df) * tau;
      float m = fmaxf(xa, xb);
      float ea = expf(xa - m), eb = expf(xb - m);
      float pa = ea / (ea + eb), pb = eb / (ea + eb);
      gd[t] += gband[t] * (pa / col.df - pb / col.df);
      gtha[t] -= gth_[t] / P[5];
    }
  }

  float gx[MAXT], gy[MAXT], gth[MAXT], gc[MAXT], gsn[MAXT];
  for (int t = 0; t < T; ++t) {
    gx[t] = 0.f; gy[t] = 0.f; gc[t] = 0.f; gsn[t] = 0.f;
    LaneT lt = lane_terms(x[t], y[t], sel.lane(t, p), p);
    // heading deviation 1 - cos(th2 - th)
    gth[t] = -gtha[t] * sinf(lt.th2 - th[t]);
    // lane distance
    float g = gd[t];
    if (p.flags & F_CLIP) g *= clip_grad(lt.dpre, -5.f, 5.f);
    float gd0 = g * lt.nc;
    float gl2d = g * lt.ba * lt.sgn + gd0 * (1.f - lt.normal);
    float gl2d1 = g * lt.aa * lt.sgn;
    float garea = gd0 * lt.normal / lt.bc;
    gx[t] += garea * (lt.y2 - lt.y3);
    gy[t] += garea * (lt.x3 - lt.x2);
    {
      float q = sq(x[t] - lt.x2) + sq(y[t] - lt.y2);
      float gq = gl2d * 0.5f / lt.l2d * max_grad(q, 1e-3f);
      gx[t] += gq * 2.f * (x[t] - lt.x2);
      gy[t] += gq * 2.f * (y[t] - lt.y2);
    }
    if (p.flags & F_INLINE) {
      float q = sq(x[t] - lt.x3) + sq(y[t] - lt.y3);
      float gq = gl2d1 * 0.5f / lt.l2d1 * max_grad(q, 1e-3f);
      gx[t] += gq * 2.f * (x[t] - lt.x3);
      gy[t] += gq * 2.f * (y[t] - lt.y3);
    }
    // clearance to the nearest frozen pair
    {
      int k = kmin[t];
      float vk = sc.cval[k * T + t];
      float ax, nx, ny;
      sel.disc(k, t, p, ax, nx, ny);
      float dxk = x[t] + ax * c[t] - nx;
      float dyk = y[t] + ax * s[t] - ny;
      float dist = sqrtf(sq(dxk) + sq(dyk) + 1e-12f);
      float per = dist - sc.crad[k * T + t];
      float gper = gmnd[t] * vk * clip_grad(per, -5.f, 20.f);
      float gd2 = gper * 0.5f / dist;
      gx[t] += gd2 * 2.f * dxk;
      gy[t] += gd2 * 2.f * dyk;
      gc[t] += gd2 * 2.f * dxk * ax;
      gsn[t] += gd2 * 2.f * dyk * ax;
    }
  }

  // rollout backward: x_t = sum_{i<t} (v_i c_i) dt, likewise y
  const bool bf = p.flags & F_BF16;
  float accx = 0.f, accy = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    float GX = bf ? rbf(accx) : accx, GY = bf ? rbf(accy) : accy;
    accx += gx[t];
    accy += gy[t];
    float tx = GX * p.dt, ty = GY * p.dt;
    gv[t] += tx * c[t] + ty * s[t];
    gc[t] += tx * v[t];
    gsn[t] += ty * v[t];
    gth[t] += -s[t] * gc[t] + c[t] * gsn[t];
  }
  // th_t = th0 + dt sum_{i<t} w_i mul_w, v_t = v0 + dt sum_{i<t} a_i mul_a
  float accw = 0.f, acca = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    float GW = bf ? rbf(accw) : accw, GA = bf ? rbf(acca) : acca;
    accw += p.dt * gth[t];
    acca += p.dt * gv[t];
    gw[t] = GW * p.mul_w;
    ga[t] = GA * p.mul_a;
  }
  return score;
}

// ---- shared by the kernels --------------------------------------------

// Fill Params from a C entry's arguments; false if a size is beyond the
// fixed arrays above.
static inline bool fill_params(Params& p, int bs, int T, int R, int M, int S,
                               int K, int nLe, int nLn, int nt2, int niters,
                               float tau, float dt, float mul_w, float mul_a,
                               float lr, double ego_L, double re, int flags) {
  if (T > MAXT || K > MAXK || nLe > MAXNL || nLn > MAXNL || S > MAXS ||
      S < 2 || nt2 < 1 || nt2 > T)
    return false;
  p.bs = bs; p.T = T; p.R = R; p.M = M; p.S = S; p.K = K; p.nLe = nLe;
  p.nLn = nLn; p.nt2 = nt2; p.niters = niters; p.flags = flags;
  p.tau = tau; p.dt = dt; p.mul_w = mul_w; p.mul_a = mul_a; p.lr = lr;
  for (int e = 0; e < MAXNL; ++e) {
    double alpha = e < nLe ? (double)e / (nLe > 1 ? nLe - 1 : 1) : 0.0;
    p.axe[e] = (float)((-ego_L / 2 + re) * (1 - alpha)
                       + (ego_L / 2 - re) * alpha);
  }
  return true;
}

// Floats of shared memory that one scene's constants take.
__host__ __device__ inline size_t scene_floats(const Params& p) {
  return (size_t)(3 * p.S * 3 + 2 * p.K * p.nLn * p.T + 2 * p.K * p.T);
}

// Copy scene b's disc radii and validity (2 K T floats) into shared memory
// (all threads of the block take part; the caller synchronises before
// reading them).  The lanes and disc centres stay unset: enough for PaySel.
__device__ Scene load_clear(float* smem, const float* __restrict__ crad,
                            const float* __restrict__ cvalid, int b,
                            const Params& p) {
  const int nk = p.K * p.T;
  float* s_crad = smem;
  float* s_cval = s_crad + nk;
  for (int i = threadIdx.x; i < nk; i += blockDim.x) {
    s_crad[i] = crad[(size_t)b * nk + i];
    s_cval[i] = cvalid[(size_t)b * nk + i];
  }
  return Scene{nullptr, nullptr, nullptr, s_crad, s_cval};
}

// Copy all of scene b's constants into shared memory (scene_floats(p)
// floats), as load_clear does.
__device__ Scene load_scene(float* smem, const float* __restrict__ lanes,
                            const float* __restrict__ ndx,
                            const float* __restrict__ ndy,
                            const float* __restrict__ crad,
                            const float* __restrict__ cvalid, int b,
                            const Params& p) {
  const int nl = 3 * p.S * 3, nd = p.K * p.nLn * p.T;
  float* s_lanes = smem;
  float* s_ndx = s_lanes + nl;
  float* s_ndy = s_ndx + nd;
  for (int i = threadIdx.x; i < nl; i += blockDim.x)
    s_lanes[i] = lanes[(size_t)b * nl + i];
  for (int i = threadIdx.x; i < nd; i += blockDim.x) {
    s_ndx[i] = ndx[(size_t)b * nd + i];
    s_ndy[i] = ndy[(size_t)b * nd + i];
  }
  Scene sc = load_clear(s_ndy + nd, crad, cvalid, b, p);
  sc.lanes = s_lanes;
  sc.ndx = s_ndx;
  sc.ndy = s_ndy;
  return sc;
}

// Column (b, r)'s per-row constants.
__device__ Column load_column(const float* __restrict__ stlp,
                              const float* __restrict__ nf,
                              const float* __restrict__ valid,
                              const float* __restrict__ scal, int b, int r,
                              const Params& p) {
  const int R = p.R;
  Column col;
  for (int i = 0; i < 6; ++i) col.P[i] = stlp[((size_t)b * 6 + i) * R + r];
  col.vf = nf[((size_t)b * 3 + 0) * R + r];
  col.df = nf[((size_t)b * 3 + 1) * R + r];
  col.sf = nf[((size_t)b * 3 + 2) * R + r];
  col.valid = valid[(size_t)b * R + r];
  col.th0 = scal[b * 2];
  col.v0 = scal[b * 2 + 1];
  col.j = r / p.M;
  col.keep = r < p.M;
  return col;
}

// `niters` Adam steps, each followed by the beta trust-region clip around
// the start, for one column on the selections `sel`: w, a (T values each)
// hold the posterior mean on entry and the guided mean on return.
template <class Sel>
__device__ void adam_clip(float* w, float* a, const Column& col,
                          const Scene& sc, const Sel& sel, const Params& p,
                          float beta, float thres, float gscale) {
  const int T = p.T;
  float w0[MAXT], a0[MAXT];
  float mw[MAXT], vw[MAXT], ma[MAXT], va[MAXT], gw[MAXT], ga[MAXT];
  for (int t = 0; t < T; ++t) {
    w0[t] = w[t]; a0[t] = a[t];
    mw[t] = 0.f; vw[t] = 0.f; ma[t] = 0.f; va[t] = 0.f;
  }
  const float b1 = 0.9f, b2 = 0.999f, omb1 = (float)(1.0 - 0.9),
              omb2 = (float)(1.0 - 0.999), eps = 1e-8f;
  const bool quirk = p.flags & F_QUIRK;
  double b1p = 1.0, b2p = 1.0;
  for (int it = 0; it < p.niters; ++it) {
    score_grad(w, a, col, sc, sel, p, thres, gscale, gw, ga);
    b1p *= 0.9;
    b2p *= 0.999;
    const float c1 = (float)(1.0 - b1p), c2 = (float)(1.0 - b2p);
    for (int t = 0; t < T; ++t) {
      mw[t] = b1 * mw[t] + omb1 * gw[t];
      vw[t] = b2 * vw[t] + omb2 * gw[t] * gw[t];
      ma[t] = b1 * ma[t] + omb1 * ga[t];
      va[t] = b2 * va[t] + omb2 * ga[t] * ga[t];
      float nw = w[t] - p.lr * (mw[t] / c1) / (sqrtf(vw[t] / c2) + eps);
      float na = a[t] - p.lr * (ma[t] / c1) / (sqrtf(va[t] / c2) + eps);
      float dw, da;
      if (quirk) {
        dw = fminf(fabsf(nw - w0[t]), beta);
        da = fminf(fabsf(na - a0[t]), beta);
      } else {
        dw = fminf(fmaxf(nw - w0[t], -beta), beta);
        da = fminf(fmaxf(na - a0[t], -beta), beta);
      }
      w[t] = w0[t] + dw;
      a[t] = a0[t] + da;
    }
  }
}

// The guided update of one column: freeze at (w, a), then adam_clip on the
// frozen indices.  w, a (T values each) hold the posterior mean on entry
// and the guided mean on return.
__device__ void guided_update(float* w, float* a, const Column& col,
                              const Scene& sc, const Params& p, float beta,
                              float thres, float gscale) {
  unsigned char seg[MAXT], pe[MAXK * MAXT], pn[MAXK * MAXT];
  freeze(w, a, col, sc, p, seg, pe, pn);
  const IdxSel sel{sc.lanes + col.j * p.S * 3, sc.ndx, sc.ndy, seg, pe, pn};
  adam_clip(w, a, col, sc, sel, p, beta, thres, gscale);
}
