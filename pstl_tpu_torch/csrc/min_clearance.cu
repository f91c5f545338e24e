// Masked minimum anchor-disc clearance of an ego trajectory against K
// neighbor tracks, and its VJP, for Hopper (sm_90a).  Two entries:
//
//   pstl_min_clearance_fwd  replaces the Pallas TPU kernel of
//     `_min_clearance_fwd` (pstl_tpu/ops/pallas_kernels.py), whose block
//     function is `_fwd_block`: out[r, t] = min over k of the clearance of
//     the ego's nL discs to neighbor k's nL discs, clipped to [-5, 20],
//     100 for an invalid neighbor.
//   pstl_min_clearance_bwd  replaces `_min_clearance_bwd` (`_bwd_block`):
//     d_ego[r, t, :3] from the cotangent g[r, t], recomputing the forward
//     (no residuals), splitting exact ties over k and over the nL*nL disc
//     pairs as jnp.min's VJP does, gated by the strict clip interior
//     (-5 < clearance < 20) and the neighbor's validity.
//
// Layouts (float32, contiguous): ego (n, T, 3) rows (x, y, th); nei
// (n, K, T, 7) rows (valid, x, y, th, -, L, W); g and out (n, T); d_ego
// (n, T, 3).  The ego disc offsets along the heading are c0*(1-a_i) +
// c1*a_i with a_i = i/(nL-1), c0 = -L/2 + W/2 and c1 = L/2 - W/2 rounded to
// float32 by the caller; a neighbor's are the same blend of its own
// -L/2 + W/2 and L/2 - W/2, computed here.  Both follow the TPU kernel's
// iota/(nL-1) blend (not a linspace).  Squared distances are rounded
// product by product (__fmul_rn / __fadd_rn, no FMA contraction), so the
// tie tests d2 == d2min and masked == out compare values computed the same
// way in both passes and in the plain PyTorch version; the min over disc
// pairs is taken on d2 and the square root after it (+1e-12 inside).
//
// Design.  One thread per (row, t): n*T threads (163,840 at n = 8192,
// T = 20), 256 to a block, no shared memory.  A thread keeps its ego discs
// in registers and loops over k, building each neighbor's discs from its
// 7 floats in registers.  The backward first finds the minimum and its
// tie count (the masked clearances of the K neighbors in a small local
// array), then recomputes the disc geometry of the tied neighbors only and
// routes the cotangent through their tied disc pairs.
//
// What bounds it on the H100: bytes.  At the main shapes (n = 8192, K = 8,
// T = 20, nL = 4) the forward reads 1.97 MB of ego states and 36.7 MB of
// neighbor rows and writes 0.66 MB (39.3 MB: 11.7 us at 3.35 TB/s); the
// backward also reads g and writes d_ego (41.3 MB: 12.3 us).  Its
// arithmetic, ~0.17 GFLOP, is ~2.5 us at the fp32 peak.  The neighbor rows
// are the bytes: for one k, a warp's 32 threads (consecutive t of two or
// three rows) read two or three contiguous runs of 28-byte records, up to
// T*28 = 560 bytes each, so the loads stay close to coalesced.  The
// caller repeats each scene's neighbors M times (one copy per candidate
// row, as the TPU kernel takes them); reading them once per scene would
// cut the bytes ~M-fold and is left to later work.

#include <cuda_runtime.h>
#include <math.h>

#define MC_MAXK 64
#define MC_MAXNL 8
#define MC_BLOCK 256

namespace {

struct Ego {
  float ex[MC_MAXNL], ey[MC_MAXNL], ax[MC_MAXNL], cth, sth;
};

__device__ __forceinline__ float blend(float lo, float hi, int i, int nL) {
  const float a = (float)i / (float)(nL > 1 ? nL - 1 : 1);
  return __fadd_rn(__fmul_rn(lo, __fsub_rn(1.f, a)), __fmul_rn(hi, a));
}

__device__ __forceinline__ void ego_discs(const float* e, int nL, float c0,
                                          float c1, Ego& g) {
  const float x = e[0], y = e[1], th = e[2];
  g.cth = cosf(th);
  g.sth = sinf(th);
  for (int i = 0; i < nL; ++i) {
    g.ax[i] = blend(c0, c1, i, nL);
    g.ex[i] = __fadd_rn(x, __fmul_rn(g.ax[i], g.cth));
    g.ey[i] = __fadd_rn(y, __fmul_rn(g.ax[i], g.sth));
  }
}

// neighbor k's disc centres, its radius and validity
__device__ __forceinline__ void nei_discs(const float* v, int nL, float* nx,
                                          float* ny, float& rn, float& valid) {
  valid = v[0];
  const float Ln = v[5], Wn = v[6];
  rn = __fdiv_rn(Wn, 2.f);
  const float hL = __fdiv_rn(Ln, 2.f);
  const float h0 = __fadd_rn(-hL, rn), h1 = __fsub_rn(hL, rn);
  const float c = cosf(v[3]), s = sinf(v[3]);
  for (int j = 0; j < nL; ++j) {
    const float a = blend(h0, h1, j, nL);
    nx[j] = __fadd_rn(v[1], __fmul_rn(a, c));
    ny[j] = __fadd_rn(v[2], __fmul_rn(a, s));
  }
}

__device__ __forceinline__ float pair_d2(float ex, float ey, float nx,
                                         float ny) {
  const float dx = __fsub_rn(ex, nx), dy = __fsub_rn(ey, ny);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

struct NeiClear {
  float nx[MC_MAXNL], ny[MC_MAXNL], d2min, dist, per, valid, masked;
};

__device__ __forceinline__ void clearance(const Ego& g, const float* v,
                                          int nL, float re, NeiClear& c) {
  float rn;
  nei_discs(v, nL, c.nx, c.ny, rn, c.valid);
  float d2min = INFINITY;
  for (int i = 0; i < nL; ++i)
    for (int j = 0; j < nL; ++j)
      d2min = fminf(d2min, pair_d2(g.ex[i], g.ey[i], c.nx[j], c.ny[j]));
  c.d2min = d2min;
  c.dist = sqrtf(__fadd_rn(d2min, 1e-12f));
  c.per = __fsub_rn(__fsub_rn(c.dist, re), rn);
  const float clipped = fminf(fmaxf(c.per, -5.f), 20.f);
  c.masked = __fadd_rn(__fmul_rn(clipped, c.valid),
                       __fmul_rn(__fsub_rn(1.f, c.valid), 100.f));
}

__global__ void min_clearance_fwd_kernel(const float* __restrict__ ego,
                                         const float* __restrict__ nei,
                                         float* __restrict__ out, int n,
                                         int T, int K, int nL, float c0,
                                         float c1, float re) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * T) return;
  const int r = idx / T, t = idx - r * T;
  Ego g;
  ego_discs(ego + (size_t)idx * 3, nL, c0, c1, g);
  float best = INFINITY;
  for (int k = 0; k < K; ++k) {
    NeiClear c;
    clearance(g, nei + (((size_t)r * K + k) * T + t) * 7, nL, re, c);
    best = fminf(best, c.masked);
  }
  out[idx] = best;
}

__global__ void min_clearance_bwd_kernel(const float* __restrict__ ego,
                                         const float* __restrict__ nei,
                                         const float* __restrict__ gout,
                                         float* __restrict__ d_ego, int n,
                                         int T, int K, int nL, float c0,
                                         float c1, float re) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * T) return;
  const int r = idx / T, t = idx - r * T;
  Ego g;
  ego_discs(ego + (size_t)idx * 3, nL, c0, c1, g);
  const float* row = nei + ((size_t)r * K * T + t) * 7;
  const size_t kstride = (size_t)T * 7;
  float masked[MC_MAXK];
  float best = INFINITY;
  for (int k = 0; k < K; ++k) {
    NeiClear c;
    clearance(g, row + k * kstride, nL, re, c);
    masked[k] = c.masked;
    best = fminf(best, c.masked);
  }
  int cntK = 0;
  for (int k = 0; k < K; ++k) cntK += masked[k] == best;
  const float gk = __fmul_rn(gout[idx], __fdiv_rn(1.f, (float)max(cntK, 1)));
  float g_ex[MC_MAXNL], g_ey[MC_MAXNL];
  for (int i = 0; i < nL; ++i) g_ex[i] = g_ey[i] = 0.f;
  for (int k = 0; k < K; ++k) {
    if (masked[k] != best) continue;
    NeiClear c;
    clearance(g, row + k * kstride, nL, re, c);
    if (!(c.per > -5.f && c.per < 20.f) || c.valid == 0.f) continue;
    const float gate = __fmul_rn(gk, c.valid);
    int cnt = 0;
    for (int i = 0; i < nL; ++i)
      for (int j = 0; j < nL; ++j)
        cnt += pair_d2(g.ex[i], g.ey[i], c.nx[j], c.ny[j]) == c.d2min;
    const float gkn = __fdiv_rn(__fdiv_rn(gate, (float)max(cnt, 1)), c.dist);
    for (int i = 0; i < nL; ++i) {
      float sx = 0.f, sy = 0.f;
      for (int j = 0; j < nL; ++j) {
        if (pair_d2(g.ex[i], g.ey[i], c.nx[j], c.ny[j]) != c.d2min) continue;
        sx = __fadd_rn(sx, __fsub_rn(g.ex[i], c.nx[j]));
        sy = __fadd_rn(sy, __fsub_rn(g.ey[i], c.ny[j]));
      }
      g_ex[i] = __fadd_rn(g_ex[i], __fmul_rn(sx, gkn));
      g_ey[i] = __fadd_rn(g_ey[i], __fmul_rn(sy, gkn));
    }
  }
  float gx = 0.f, gy = 0.f, gth = 0.f;
  for (int i = 0; i < nL; ++i) {
    gx = __fadd_rn(gx, g_ex[i]);
    gy = __fadd_rn(gy, g_ey[i]);
    gth = __fadd_rn(gth,
                    __fadd_rn(__fmul_rn(g_ex[i], __fmul_rn(-g.ax[i], g.sth)),
                              __fmul_rn(g_ey[i], __fmul_rn(g.ax[i], g.cth))));
  }
  float* o = d_ego + (size_t)idx * 3;
  o[0] = gx;
  o[1] = gy;
  o[2] = gth;
}

bool bad_sizes(int n, int T, int K, int nL) {
  return n < 0 || T <= 0 || K <= 0 || K > MC_MAXK || nL <= 0 ||
         nL > MC_MAXNL || (long long)n * T > 0x7fffffffLL;
}

}  // namespace

extern "C" int pstl_min_clearance_fwd(const float* ego, const float* nei,
                                      float* out, int n, int T, int K,
                                      int nL, float c0, float c1, float re,
                                      void* stream) {
  if (bad_sizes(n, T, K, nL)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = (n * T + MC_BLOCK - 1) / MC_BLOCK;
  min_clearance_fwd_kernel<<<blocks, MC_BLOCK, 0, (cudaStream_t)stream>>>(
      ego, nei, out, n, T, K, nL, c0, c1, re);
  return (int)cudaGetLastError();
}

extern "C" int pstl_min_clearance_bwd(const float* ego, const float* nei,
                                      const float* g, float* d_ego, int n,
                                      int T, int K, int nL, float c0,
                                      float c1, float re, void* stream) {
  if (bad_sizes(n, T, K, nL)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = (n * T + MC_BLOCK - 1) / MC_BLOCK;
  min_clearance_bwd_kernel<<<blocks, MC_BLOCK, 0, (cudaStream_t)stream>>>(
      ego, nei, g, d_ego, n, T, K, nL, c0, c1, re);
  return (int)cudaGetLastError();
}
