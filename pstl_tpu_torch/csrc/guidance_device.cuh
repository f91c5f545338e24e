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
// What bounds it on the H100 and what the design does about it.  A column's
// update is tiny (about 50 k fp32 operations, a few hundred bytes), and a
// launch has only bs*R columns (3072 on the main path), so neither bytes
// nor operations bound it: the latency of one column's dependent chain of
// sqrtf / expf / logf / cosf / sinf does.  So a column is spread over a
// WARP, lane = time step (T <= 32): every per-step quantity (state,
// distances, clause terms, gradients, Adam moments) is one scalar in a
// register of its lane, and no array is indexed by a run-time t.  What
// crosses time steps is a warp shuffle:
//   - the four exclusive prefix sums of the rollout and the four exclusive
//     suffix sums of its backward are Hillis-Steele scans (excl_prefix,
//     excl_suffix);
//   - the (max, sum) statistics of each Always clause are butterfly
//     reductions (lse_stats), which leave the same bits in every lane;
//   - the suffix logaddexp of Eventually-Always is the doubling scan the
//     Pallas kernel uses (`_ev_alw`: doubling steps, -1e30 beyond T),
//     and its backward, the recurrence B_u = a_u B_{u-1} + q_u, is a scan
//     of the affine maps (a_u, q_u) (all a_u in [0, 1], all q_u >= 0: no
//     cancellation);
//   - the softmin over the 5-6 clause rows is computed by every lane alike.
// The K loop (argmin over neighbors) and the S-1 segment search stay serial
// inside a lane, so the tie rules below hold as before.  The frozen
// selection of a lane is one segment index and K disc pairs packed into
// two 64-bit words of 4-bit fields (nLe, nLn <= 8 < 16, K <= 16).  Lanes
// t >= T run the same code on step T-1's constants and feed identities into
// every scan and reduction (0 to a sum, -inf to a max, -1e30 to the
// logaddexp scan); all 32 lanes reach every shuffle.
//
// Semantics shared with the Pallas kernels: argmins take the earliest index
// (strict <); lanes in s order; exact pairs e outer, nn inner; coarse pairs
// the ego disc nearest the neighbor's disc centroid, then the neighbor disc
// nearest that ego disc.  With BF16 each rollout summand is rounded to bf16
// and summed in fp32, and the summed cotangent of each summand is rounded
// to bf16, as jax.grad of the Pallas kernel's bf16 cumsum does.  Gradient
// ties: the min over neighbors routes its whole gradient to the earliest
// minimal k (jnp.minimum splits exact ties 0.5/0.5); clips follow jnp.clip
// (0.5 at a boundary).  Both differ only on measure-zero ties.  A divisor
// that is the same for the whole column and used more than once (tau, the
// norm factors, P5, a softmin's sum, Adam's bias corrections) is inverted
// once, by an IEEE division, and multiplied: within an ulp of the quotient,
// and about a fifth of the kernel's time less.  sqrtf, expf, logf, cosf,
// sinf and every other division are the accurate ones (no fast-math flag:
// tests/torch_guidance_twin.py has the same forms on the CPU).  The scans
// sum in another order than a serial loop: with BF16 the summands have 8
// significant bits and the fp32 sums are almost always exact; without it a
// sum can differ by an ulp.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#define MAXT 32   // a column's horizon fits a warp
#define MAXK 16   // 4-bit fields of a 64-bit word
#define MAXNL 8
#define MAXS 64
#define FULL_MASK 0xffffffffu

enum { F_INLINE = 1, F_CLIP = 2, F_QUIRK = 4, F_COARSE = 8, F_BF16 = 16 };

struct Params {
  int bs, T, R, M, S, K, nLe, nLn, nt2, niters, flags;
  float tau, rtau, dt, mul_w, mul_a, lr;  // rtau = 1 / tau
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

// ---- what crosses time steps: warp scans and reductions ----------------

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, d));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL_MASK, v, d);
  return v;
}

// The scans below always take the five doubling steps of a full warp, so
// they unroll into straight-line code and the independent ones of a pass
// (the four of the rollout, the four of its backward, the two of the
// Eventually-Always pair) interleave; beyond T a step only adds identities.

// sum of v over the lanes below this one; lanes t >= T hold 0
__device__ __forceinline__ float excl_prefix(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float n = __shfl_up_sync(FULL_MASK, v, d);
    if (lane >= d) v += n;
  }
  const float e = __shfl_up_sync(FULL_MASK, v, 1);
  return lane > 0 ? e : 0.f;
}

// sum of v over the lanes above this one; lanes t >= T hold 0
__device__ __forceinline__ float excl_suffix(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float n = __shfl_down_sync(FULL_MASK, v, d);
    if (lane + d < 32) v += n;
  }
  const float e = __shfl_down_sync(FULL_MASK, v, 1);
  return lane < 31 ? e : 0.f;
}

// log-sum-exp over the lanes that are `on` of their term z, as (m, S):
// value m + log(S), this lane's weight e / S with e = exp(z - m) (0 when
// off).  m and S come out the same in every lane.
__device__ __forceinline__ void lse_stats(float z, bool on, float& m,
                                          float& S, float& e) {
  m = warp_max(on ? z : -INFINITY);
  e = on ? expf(z - m) : 0.f;
  S = warp_sum(e);
}

struct Scene {  // shared-memory views of one scene's constants
  const float* lanes;  // [3][S][3]
  const float* ndx;    // [K][nLn][T]
  const float* ndy;
  const float* crad;   // [K][T]
  const float* cval;
  const float* axe;    // [MAXNL] ego disc offsets
};

struct Column {  // one candidate column's per-row constants
  float P[6], rvf, rdf, rsf, rP5, valid, th0, v0;  // r* = 1 / (vf, df, sf, P5)
  int j;         // lane / maneuver of the column
  bool keep;     // r < M: lane-keep formula, else lane change
};

struct State {  // the rollout at this lane's step (state before the step)
  float x, y, th, v, c, s;
};

// Euler rollout by prefix sums, recentred at 0; `w`, `a` are this lane's
// controls (0 in lanes t >= T).
__device__ __forceinline__ State rollout(float w, float a, const Column& col,
                                         const Params& p, int lane) {
  const bool bf = p.flags & F_BF16;
  const bool live = lane < p.T;
  float ww = w * p.mul_w, aa = a * p.mul_a;
  if (bf) { ww = rbf(ww); aa = rbf(aa); }
  if (!live) { ww = 0.f; aa = 0.f; }
  State st;
  st.th = col.th0 + p.dt * excl_prefix(ww, lane);
  st.v = col.v0 + p.dt * excl_prefix(aa, lane);
  st.c = cosf(st.th);
  st.s = sinf(st.th);
  float dx = st.v * st.c * p.dt, dy = st.v * st.s * p.dt;
  if (bf) { dx = rbf(dx); dy = rbf(dy); }
  if (!live) { dx = 0.f; dy = 0.f; }
  st.x = excl_prefix(dx, lane);
  st.y = excl_prefix(dy, lane);
  return st;
}

// The frozen lane segment of one step: its end points, the heading of its
// first point, and whether it is the lane's first / last segment.
struct LaneSel {
  float x2, y2, th2, x3, y3;
  bool first, last;
};

// Selections as indices: the in-kernel freeze's segment of this lane's step
// and its disc pair per k (4 bits each), into the scene's lanes and disc
// centres in shared memory.
struct IdxSel {
  const float* L;    // the column's lane, [S][3]
  const float* ndx;  // [K][nLn][T]
  const float* ndy;
  const float* axe;  // [MAXNL]
  int seg;
  unsigned long long pe, pn;  // ego / neighbor disc of pair k at bits 4k..
  __device__ __forceinline__ LaneSel lane(int, const Params& p) const {
    return LaneSel{L[seg * 3], L[seg * 3 + 1], L[seg * 3 + 2],
                   L[(seg + 1) * 3], L[(seg + 1) * 3 + 1], seg == 0,
                   seg == p.S - 2};
  }
  __device__ __forceinline__ void disc(int k, int t, const Params& p,
                                       float& ax, float& nx,
                                       float& ny) const {
    ax = axe[(int)(pe >> (4 * k)) & 15];
    const int ni = (k * p.nLn + ((int)(pn >> (4 * k)) & 15)) * p.T + t;
    nx = ndx[ni];
    ny = ndy[ni];
  }
};

// Frozen selections of this lane's step t at (w, a).
__device__ __forceinline__ IdxSel freeze(float w, float a, const Column& col,
                                         const Scene& sc, const Params& p,
                                         int lane, int t) {
  const State st = rollout(w, a, col, p, lane);
  const int T = p.T;
  IdxSel sel{sc.lanes + col.j * p.S * 3, sc.ndx, sc.ndy, sc.axe, 0, 0ull,
             0ull};
  const float* L = sel.L;
  {
    float best = 1e30f;
    int bi = 0;
    float pd_prev = sqrtf(sq(st.x - L[0]) + sq(st.y - L[1]));
    for (int q = 0; q < p.S - 1; ++q) {
      float pd_next = sqrtf(sq(st.x - L[(q + 1) * 3])
                            + sq(st.y - L[(q + 1) * 3 + 1]));
      float segc = pd_prev + pd_next;
      if (segc < best) { best = segc; bi = q; }
      pd_prev = pd_next;
    }
    sel.seg = bi;
  }
  for (int k = 0; k < p.K; ++k) {
    const float* kx = sc.ndx + (k * p.nLn) * T + t;  // disc nn at kx[nn * T]
    const float* ky = sc.ndy + (k * p.nLn) * T + t;
    int be = 0, bn = 0;
    if (p.flags & F_COARSE) {
      float ncx = kx[0], ncy = ky[0];
      for (int nn = 1; nn < p.nLn; ++nn) {
        ncx = ncx + kx[nn * T];
        ncy = ncy + ky[nn * T];
      }
      ncx = ncx / (float)p.nLn;
      ncy = ncy / (float)p.nLn;
      float beste = 1e30f, exs = 0.f, eys = 0.f;
      for (int e = 0; e < p.nLe; ++e) {
        float exd = st.x + sc.axe[e] * st.c;
        float eyd = st.y + sc.axe[e] * st.s;
        float de = sq(exd - ncx) + sq(eyd - ncy);
        if (de < beste) { beste = de; be = e; exs = exd; eys = eyd; }
      }
      float best2 = 1e30f;
      for (int nn = 0; nn < p.nLn; ++nn) {
        float d2 = sq(exs - kx[nn * T]) + sq(eys - ky[nn * T]);
        if (d2 < best2) { best2 = d2; bn = nn; }
      }
    } else {
      float best2 = 1e30f;
      for (int e = 0; e < p.nLe; ++e) {
        float exd = st.x + sc.axe[e] * st.c;
        float eyd = st.y + sc.axe[e] * st.s;
        for (int nn = 0; nn < p.nLn; ++nn) {
          float d2 = sq(exd - kx[nn * T]) + sq(eyd - ky[nn * T]);
          if (d2 < best2) { best2 = d2; be = e; bn = nn; }
        }
      }
    }
    sel.pe |= (unsigned long long)be << (4 * k);
    sel.pn |= (unsigned long long)bn << (4 * k);
  }
  return sel;
}

// Selections as frozen payload values of one column (b, r), in device
// memory with r minor: lane t of the column's warp reads its own step.
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

// Lane-distance pieces at one step against the frozen segment.
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

// Eventually(0, nt2, Always(0, T, g)) with z = -g*tau in lane t: the suffix
// s_t = logaddexp(z_t, s_{t+1}) by a doubling scan (-1e30 is an exact
// identity of logaddexp in fp32), value lse(-s[:nt2]) * rtau.  Leaves this
// lane's suffix in `suf` and the statistics of the outer lse in (e2, S2).
__device__ __forceinline__ float ev_alw_fwd(float z, int lane, int T, int nt2,
                                            float rtau, float& suf,
                                            float& e2, float& S2) {
  float s = lane < T ? z : -1e30f;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    float n = __shfl_down_sync(FULL_MASK, s, k);
    if (lane + k >= T) n = -1e30f;
    s = logaddexp(s, n);
  }
  suf = s;
  float m2;
  lse_stats(-s, lane < nt2, m2, S2, e2);
  return (m2 + logf(S2)) * rtau;
}

// d ev / d g_u = sum_{t <= min(u, nt2-1)} q_t exp(z_u - s_t), with
// q = softmax(-s[:nt2]) = e2 / S2.  With B_u = B_{u-1} exp(s_u - s_{u-1})
// + q_u it is gout exp(z_u - s_u) B_u; the recurrence is an inclusive scan
// of the affine maps B -> a_u B + q_u.
__device__ __forceinline__ float ev_alw_bwd(float z, float suf, float e2,
                                            float S2, int lane, int nt2,
                                            float gout) {
  const float sp = __shfl_up_sync(FULL_MASK, suf, 1);
  float A = lane > 0 ? expf(suf - sp) : 0.f;
  float B = lane < nt2 ? e2 / S2 : 0.f;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const float Ap = __shfl_up_sync(FULL_MASK, A, k);
    const float Bp = __shfl_up_sync(FULL_MASK, B, k);
    if (lane >= k) {
      B = A * Bp + B;
      A = A * Ap;
    }
  }
  return gout * expf(z - suf) * B;
}

// Robustness of one column at (w, a) and the gradient of
// dL/dscore * score with respect to this lane's (w, a) in (gw, ga).  `sel`
// is IdxSel or PaySel, `ls` its lane segment at this lane's step t
// (min(lane, T-1)); `sc` supplies the disc radii and validity.
template <class Sel>
__device__ float score_grad(float w, float a, const Column& col,
                            const Scene& sc, const Sel& sel,
                            const LaneSel& ls, const Params& p, int lane,
                            int t, float thres, float gscale, float& gw,
                            float& ga) {
  const int T = p.T;
  const float tau = p.tau, rtau = p.rtau;
  const bool live = lane < T;
  const State st = rollout(w, a, col, p, lane);
  const float x = st.x, y = st.y, th = st.th, v = st.v, c = st.c, s = st.s;

  const LaneT lt = lane_terms(x, y, ls, p);
  const float d = lt.d;
  const float tha = 1.f - cosf(lt.th2 - th);
  float mnd = 0.f;
  int kmin = 0;
  for (int k = 0; k < p.K; ++k) {
    float ax, nx, ny;
    sel.disc(k, t, p, ax, nx, ny);
    float exd = x + ax * c, eyd = y + ax * s;
    float d2 = sq(exd - nx) + sq(eyd - ny);
    float per = sqrtf(d2 + 1e-12f) - sc.crad[k * T + t];
    float vk = sc.cval[k * T + t];
    float masked = fminf(fmaxf(per, -5.f), 20.f) * vk + (1.f - vk) * 100.f;
    if (k == 0 || masked < mnd) { mnd = masked; kmin = k; }
  }

  const float* P = col.P;
  // z = -g * tau of the Always clauses shared by both formulas
  const float zv1 = -((v - P[0]) * col.rvf) * tau;
  const float zv2 = -((-v + P[1]) * col.rvf) * tau;
  const float zsf = -((mnd - P[4]) * col.rsf) * tau;
  const float zth = -((P[5] - tha) * col.rP5) * tau;
  float m_v1, S_v1, e_v1, m_v2, S_v2, e_v2, m_sf, S_sf, e_sf;
  lse_stats(zv1, live, m_v1, S_v1, e_v1);
  lse_stats(zv2, live, m_v2, S_v2, e_v2);
  lse_stats(zsf, live, m_sf, S_sf, e_sf);
  const float alw_v1 = -(m_v1 + logf(S_v1)) * rtau;
  const float alw_v2 = -(m_v2 + logf(S_v2)) * rtau;
  const float alw_sf = -(m_sf + logf(S_sf)) * rtau;

  // the band terms of the lane offset
  const float xa = -((d - P[2]) * col.rdf) * tau;
  const float xb = -((-d + P[3]) * col.rdf) * tau;
  float rows[6];
  // keep: lane-offset band and heading over the current lane
  float S_d1 = 1.f, e_d1 = 0.f, S_d2 = 1.f, e_d2 = 0.f, S_th = 1.f,
        e_th = 0.f;
  // change: Eventually-Always of the band and of the heading
  float zb = 0.f, sufb = 0.f, sufh = 0.f, eb2 = 0.f, Sb = 1.f, eh2 = 0.f,
        Sh = 1.f;
  rows[0] = alw_v1;
  rows[1] = alw_v2;
  if (col.keep) {
    float m_d1, m_d2, m_th;
    lse_stats(xa, live, m_d1, S_d1, e_d1);
    lse_stats(xb, live, m_d2, S_d2, e_d2);
    lse_stats(zth, live, m_th, S_th, e_th);
    rows[2] = -(m_d1 + logf(S_d1)) * rtau;
    rows[3] = -(m_d2 + logf(S_d2)) * rtau;
    rows[4] = -(m_th + logf(S_th)) * rtau;
    rows[5] = alw_sf;
  } else {
    float m = fmaxf(xa, xb);
    float band = -(m + logf(expf(xa - m) + expf(xb - m))) * rtau;
    zb = -band * tau;
    rows[2] = ev_alw_fwd(zb, lane, T, p.nt2, rtau, sufb, eb2, Sb);
    rows[3] = ev_alw_fwd(zth, lane, T, p.nt2, rtau, sufh, eh2, Sh);
    rows[4] = alw_sf;
    rows[5] = INFINITY;  // no sixth row: exp(-inf) adds 0 to the softmin
  }
  // softmin over the rows, the same in every lane
  float xr[6], mr, Sr = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) xr[i] = -rows[i] * tau;
  mr = xr[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) mr = fmaxf(mr, xr[i]);
#pragma unroll
  for (int i = 0; i < 6; ++i) Sr += expf(xr[i] - mr);
  const float score = -(mr + logf(Sr)) * rtau;

  // ---- backward -----------------------------------------------------
  const float gs = (thres - score > 0.f) ? -col.valid * gscale : 0.f;
  const float gsr = gs / Sr;
  float gr[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) gr[i] = gsr * expf(xr[i] - mr);
  const float g_sf = col.keep ? gr[5] : gr[4];
  float gv = gr[0] * (e_v1 / S_v1) * col.rvf;
  gv -= gr[1] * (e_v2 / S_v2) * col.rvf;
  const float gmnd = g_sf * (e_sf / S_sf) * col.rsf;
  float gd, gtha;
  if (col.keep) {
    gd = gr[2] * (e_d1 / S_d1) * col.rdf;
    gd -= gr[3] * (e_d2 / S_d2) * col.rdf;
    gtha = -(gr[4] * (e_th / S_th) * col.rP5);
  } else {
    const float gband = ev_alw_bwd(zb, sufb, eb2, Sb, lane, p.nt2, gr[2]);
    const float gth_ = ev_alw_bwd(zth, sufh, eh2, Sh, lane, p.nt2, gr[3]);
    float m = fmaxf(xa, xb);
    float ea = expf(xa - m), eb = expf(xb - m);
    float rab = 1.f / (ea + eb);
    float pa = ea * rab, pb = eb * rab;
    gd = gband * (pa * col.rdf - pb * col.rdf);
    gtha = -(gth_ * col.rP5);
  }

  float gx = 0.f, gy = 0.f, gc = 0.f, gsn = 0.f;
  // heading deviation 1 - cos(th2 - th)
  float gth = -gtha * sinf(lt.th2 - th);
  // lane distance
  {
    float g = gd;
    if (p.flags & F_CLIP) g *= clip_grad(lt.dpre, -5.f, 5.f);
    float gd0 = g * lt.nc;
    float gl2d = g * lt.ba * lt.sgn + gd0 * (1.f - lt.normal);
    float gl2d1 = g * lt.aa * lt.sgn;
    float garea = gd0 * lt.normal / lt.bc;
    gx += garea * (lt.y2 - lt.y3);
    gy += garea * (lt.x3 - lt.x2);
    {
      float q = sq(x - lt.x2) + sq(y - lt.y2);
      float gq = gl2d * 0.5f / lt.l2d * max_grad(q, 1e-3f);
      gx += gq * 2.f * (x - lt.x2);
      gy += gq * 2.f * (y - lt.y2);
    }
    if (p.flags & F_INLINE) {
      float q = sq(x - lt.x3) + sq(y - lt.y3);
      float gq = gl2d1 * 0.5f / lt.l2d1 * max_grad(q, 1e-3f);
      gx += gq * 2.f * (x - lt.x3);
      gy += gq * 2.f * (y - lt.y3);
    }
  }
  // clearance to the nearest frozen pair
  {
    const int k = kmin;
    float vk = sc.cval[k * T + t];
    float ax, nx, ny;
    sel.disc(k, t, p, ax, nx, ny);
    float dxk = x + ax * c - nx;
    float dyk = y + ax * s - ny;
    float dist = sqrtf(sq(dxk) + sq(dyk) + 1e-12f);
    float per = dist - sc.crad[k * T + t];
    float gper = gmnd * vk * clip_grad(per, -5.f, 20.f);
    float gd2 = gper * 0.5f / dist;
    gx += gd2 * 2.f * dxk;
    gy += gd2 * 2.f * dyk;
    gc += gd2 * 2.f * dxk * ax;
    gsn += gd2 * 2.f * dyk * ax;
  }

  // rollout backward: x_t = sum_{i<t} (v_i c_i) dt, likewise y
  const bool bf = p.flags & F_BF16;
  float GX = excl_suffix(live ? gx : 0.f, lane);
  float GY = excl_suffix(live ? gy : 0.f, lane);
  if (bf) { GX = rbf(GX); GY = rbf(GY); }
  {
    float tx = GX * p.dt, ty = GY * p.dt;
    gv += tx * c + ty * s;
    gc += tx * v;
    gsn += ty * v;
    gth += -s * gc + c * gsn;
  }
  // th_t = th0 + dt sum_{i<t} w_i mul_w, v_t = v0 + dt sum_{i<t} a_i mul_a
  float GW = excl_suffix(live ? p.dt * gth : 0.f, lane);
  float GA = excl_suffix(live ? p.dt * gv : 0.f, lane);
  if (bf) { GW = rbf(GW); GA = rbf(GA); }
  gw = GW * p.mul_w;
  ga = GA * p.mul_a;
  return score;
}

// ---- shared by the kernels --------------------------------------------

// Fill Params from a C entry's arguments; false if a size is beyond the
// limits above.
static inline bool fill_params(Params& p, int bs, int T, int R, int M, int S,
                               int K, int nLe, int nLn, int nt2, int niters,
                               float tau, float dt, float mul_w, float mul_a,
                               float lr, double ego_L, double re, int flags) {
  if (T < 1 || T > MAXT || K < 1 || K > MAXK || nLe < 1 || nLe > MAXNL ||
      nLn < 1 || nLn > MAXNL || S > MAXS || S < 2 || nt2 < 1 || nt2 > T)
    return false;
  p.bs = bs; p.T = T; p.R = R; p.M = M; p.S = S; p.K = K; p.nLe = nLe;
  p.nLn = nLn; p.nt2 = nt2; p.niters = niters; p.flags = flags;
  p.tau = tau; p.rtau = 1.f / tau; p.dt = dt; p.mul_w = mul_w;
  p.mul_a = mul_a; p.lr = lr;
  for (int e = 0; e < MAXNL; ++e) {
    double alpha = e < nLe ? (double)e / (nLe > 1 ? nLe - 1 : 1) : 0.0;
    p.axe[e] = (float)((-ego_L / 2 + re) * (1 - alpha)
                       + (ego_L / 2 - re) * alpha);
  }
  return true;
}

// Floats of shared memory that one scene's constants take.
__host__ __device__ inline size_t scene_floats(const Params& p) {
  return (size_t)(3 * p.S * 3 + 2 * p.K * p.nLn * p.T + 2 * p.K * p.T
                  + MAXNL);
}

// Copy scene b's disc radii and validity (2 K T floats) into shared memory
// (all threads of the block take part; the caller synchronises before
// reading them).  The lanes, disc centres and offsets stay unset: enough
// for PaySel.
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
  return Scene{nullptr, nullptr, nullptr, s_crad, s_cval, nullptr};
}

// Copy all of scene b's constants and the ego disc offsets into shared
// memory (scene_floats(p) floats), as load_clear does.
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
  float* s_axe = s_ndy + nd;
  for (int i = threadIdx.x; i < nl; i += blockDim.x)
    s_lanes[i] = lanes[(size_t)b * nl + i];
  for (int i = threadIdx.x; i < nd; i += blockDim.x) {
    s_ndx[i] = ndx[(size_t)b * nd + i];
    s_ndy[i] = ndy[(size_t)b * nd + i];
  }
  if (threadIdx.x < MAXNL) s_axe[threadIdx.x] = p.axe[threadIdx.x];
  Scene sc = load_clear(s_axe + MAXNL, crad, cvalid, b, p);
  sc.lanes = s_lanes;
  sc.ndx = s_ndx;
  sc.ndy = s_ndy;
  sc.axe = s_axe;
  return sc;
}

// Column (b, r)'s per-row constants (the same in every lane of its warp).
__device__ Column load_column(const float* __restrict__ stlp,
                              const float* __restrict__ nf,
                              const float* __restrict__ valid,
                              const float* __restrict__ scal, int b, int r,
                              const Params& p) {
  const int R = p.R;
  Column col;
#pragma unroll
  for (int i = 0; i < 6; ++i) col.P[i] = stlp[((size_t)b * 6 + i) * R + r];
  col.rvf = 1.f / nf[((size_t)b * 3 + 0) * R + r];
  col.rdf = 1.f / nf[((size_t)b * 3 + 1) * R + r];
  col.rsf = 1.f / nf[((size_t)b * 3 + 2) * R + r];
  col.rP5 = 1.f / col.P[5];
  col.valid = valid[(size_t)b * R + r];
  col.th0 = scal[b * 2];
  col.v0 = scal[b * 2 + 1];
  col.j = r / p.M;
  col.keep = r < p.M;
  return col;
}

// `niters` Adam steps, each followed by the beta trust-region clip around
// the start, for one column on the selections `sel`: w, a (this lane's
// step) hold the posterior mean on entry and the guided mean on return.
template <class Sel>
__device__ void adam_clip(float& w, float& a, const Column& col,
                          const Scene& sc, const Sel& sel, const Params& p,
                          int lane, float beta, float thres, float gscale) {
  const int t = min(lane, p.T - 1);
  const LaneSel ls = sel.lane(t, p);
  const float w0 = w, a0 = a;
  float mw = 0.f, vw = 0.f, ma = 0.f, va = 0.f;
  const float b1 = 0.9f, b2 = 0.999f, omb1 = (float)(1.0 - 0.9),
              omb2 = (float)(1.0 - 0.999), eps = 1e-8f;
  const bool quirk = p.flags & F_QUIRK;
  double b1p = 1.0, b2p = 1.0;
  for (int it = 0; it < p.niters; ++it) {
    float gw, ga;
    score_grad(w, a, col, sc, sel, ls, p, lane, t, thres, gscale, gw, ga);
    b1p *= 0.9;
    b2p *= 0.999;
    const float rc1 = 1.f / (float)(1.0 - b1p);
    const float rc2 = 1.f / (float)(1.0 - b2p);
    mw = b1 * mw + omb1 * gw;
    vw = b2 * vw + omb2 * gw * gw;
    ma = b1 * ma + omb1 * ga;
    va = b2 * va + omb2 * ga * ga;
    float nw = w - p.lr * (mw * rc1) / (sqrtf(vw * rc2) + eps);
    float na = a - p.lr * (ma * rc1) / (sqrtf(va * rc2) + eps);
    float dw, da;
    if (quirk) {
      dw = fminf(fabsf(nw - w0), beta);
      da = fminf(fabsf(na - a0), beta);
    } else {
      dw = fminf(fmaxf(nw - w0, -beta), beta);
      da = fminf(fmaxf(na - a0, -beta), beta);
    }
    w = w0 + dw;
    a = a0 + da;
  }
}

// The guided update of one column by its warp: freeze at (w, a), then
// adam_clip on the frozen indices.  w, a hold this lane's step of the
// posterior mean on entry (0 in lanes t >= T) and of the guided mean on
// return.  Every lane of the warp must call it.
__device__ void guided_update(float& w, float& a, const Column& col,
                              const Scene& sc, const Params& p, int lane,
                              float beta, float thres, float gscale) {
  const IdxSel sel = freeze(w, a, col, sc, p, lane, min(lane, p.T - 1));
  adam_clip(w, a, col, sc, sel, p, lane, beta, thres, gscale);
}
