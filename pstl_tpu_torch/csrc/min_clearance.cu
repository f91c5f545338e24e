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
// (n / m, K, T, 7) rows (valid, x, y, th, -, L, W), one set per scene; g and
// out (n, T); d_ego (n, T, 3).  m = rows_per_scene: row r meets the
// neighbors of scene r / m, the order of torch.repeat_interleave(x, m, 0).
// m = 1 is one neighbor set per row, the TPU kernel's layout.  The ego disc
// offsets along the heading are c0*(1-a_i) + c1*a_i with a_i = i/(nL-1),
// c0 = -L/2 + W/2 and c1 = L/2 - W/2 rounded to float32 by the caller; a
// neighbor's are the same blend of its own -L/2 + W/2 and L/2 - W/2,
// computed here.  Both follow the TPU kernel's iota/(nL-1) blend (not a
// linspace).  Squared distances are rounded product by product (__fmul_rn /
// __fadd_rn, no FMA contraction), so the tie tests d2 == d2min and
// masked == best compare values computed the same way in both passes and in
// the plain PyTorch version; the min over disc pairs is taken on d2 and the
// square root after it (+1e-12 inside).
//
// Design.  The TPU kernel tiles rows and takes a copy of the neighbors per
// row; here a block's shared memory holds a scene's neighbor discs, built
// once, and every candidate row of the block reads them from there.
//   Block.  `rows` candidate rows of one scene x all T (m >= rows: a scene
//   takes ceil(m / rows) blocks), or rows / m whole scenes (m < rows; fewer
//   where their discs would not fit shared memory), rows = MC_ROWS.  A
//   thread takes several (row, t) in turn where a block has more than
//   MC_THREADS of them, and the block size balances the turns.
//   Phase A.  One thread per (scene, k, t) of the block, t fastest: it reads
//   its 7-float record (neighboring threads read neighboring records, so a
//   warp's loads cover one contiguous run), runs cosf / sinf and the nL
//   blends once, and writes the discs to dynamic shared memory as
//   structure-of-arrays with t fastest: nx[k][j][t], ny[k][j][t], rn[k][t],
//   valid[k][t]: K*T*(2*nL+2) floats a scene (6.4 KB at K = 8, T = 20,
//   nL = 4).  The thread's own ego state is loaded and turned into discs
//   before the barrier, so both loads are in flight together.
//   Phase B.  One thread per (row, t), t fastest: a warp's lanes read
//   consecutive words of nx[k][j][:] and lanes of other rows at the same t
//   the same word (a broadcast), so no bank conflicts.  The ego discs stay in
//   registers; the disc-pair loop is fully unrolled for nL = MC_NLT (a
//   template parameter) and, for any other nL, unrolled to MC_MAXNL with
//   guards, so the arrays stay in registers there too.
//   Backward.  Pass 1 is the forward, keeping the minimum over k and its tie
//   count (a smaller value resets the count, an equal one adds one), and
//   among the tied neighbors those whose gate is open (strictly inside the
//   clip, valid): their number and the first one's k.  Pass 2 walks from
//   that k until it has met them all: it recomputes a neighbor's masked
//   clearance from the shared discs and, where that equals the minimum and
//   the gate is open, routes the cotangent through the tied disc pairs.  An
//   element whose minimum is a clipped or invalid neighbor has no pass 2.
//   Nothing per k is kept between the passes.
//
// What bounds it on the H100: operations.  At the main shapes (n = 8192 =
// 128 scenes x 64, K = 8, T = 20, nL = 4) the function's own operands are
// 1.97 MB of ego states, 0.57 MB of neighbors and 0.66 MB of output (under
// 1 us at 3.35 TB/s; the backward adds g and d_ego), while the K * nL * nL
// pairs of a (row, t) are ~870 float32 operations forward and ~1,030 with
// the VJP's routing: 2.1 / 2.5 us at the 67 TFLOP/s peak, which counts
// fused multiply-adds that this arithmetic, rounded product by product,
// cannot use.

#include <cuda_runtime.h>
#include <math.h>

#define MC_ROWS 64
#define MC_THREADS 640
#define MC_NLT 4
#define MC_MAXNL 8
#define MC_SMEM_MAX 232448

namespace {

// NLT > 0: nL == NLT at compile time; NLT == 0: any nL <= MC_MAXNL
template <int NLT>
struct Ego {
  static constexpr int CAP = NLT ? NLT : MC_MAXNL;
  float ex[CAP], ey[CAP], ax[CAP], cth, sth;
};

__device__ __forceinline__ float blend(float lo, float hi, int i, int nL) {
  const float a = (float)i / (float)(nL > 1 ? nL - 1 : 1);
  return __fadd_rn(__fmul_rn(lo, __fsub_rn(1.f, a)), __fmul_rn(hi, a));
}

template <int NLT>
__device__ __forceinline__ void ego_discs(const float* e, int nL, float c0,
                                          float c1, Ego<NLT>& g) {
  const float x = e[0], y = e[1], th = e[2];
  g.cth = cosf(th);
  g.sth = sinf(th);
#pragma unroll
  for (int i = 0; i < Ego<NLT>::CAP; ++i) {
    if (i < nL) {
      g.ax[i] = blend(c0, c1, i, nL);
      g.ex[i] = __fadd_rn(x, __fmul_rn(g.ax[i], g.cth));
      g.ey[i] = __fadd_rn(y, __fmul_rn(g.ax[i], g.sth));
    }
  }
}

// Phase A: the discs of the block's `entries` (scene, k, t) records, read
// from `rec` (their first record), into shared memory.  Per scene:
// nx[K][nL][T], ny[K][nL][T], rn[K][T], valid[K][T].
__device__ __forceinline__ void stage_discs(const float* __restrict__ rec,
                                            float* sm, int entries, int T,
                                            int K, int nL) {
  const int KT = K * T, scene_floats = KT * (2 * nL + 2);
  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    const int ls = e / KT, kt = e - ls * KT;
    const int k = kt / T, t = kt - k * T;
    const float* v = rec + (size_t)e * 7;
    const float valid = v[0], x = v[1], y = v[2], th = v[3];
    const float Ln = v[5], Wn = v[6];
    const float rn = __fdiv_rn(Wn, 2.f);
    const float hL = __fdiv_rn(Ln, 2.f);
    const float h0 = __fadd_rn(-hL, rn), h1 = __fsub_rn(hL, rn);
    const float c = cosf(th), s = sinf(th);
    float* sc = sm + ls * scene_floats;
    float* px = sc + k * nL * T + t;
    float* py = px + KT * nL;
    for (int j = 0; j < nL; ++j) {
      const float a = blend(h0, h1, j, nL);
      px[j * T] = __fadd_rn(x, __fmul_rn(a, c));
      py[j * T] = __fadd_rn(y, __fmul_rn(a, s));
    }
    sc[2 * KT * nL + kt] = rn;
    sc[2 * KT * nL + KT + kt] = valid;
  }
}

__device__ __forceinline__ float pair_d2(float ex, float ey, float nx,
                                         float ny) {
  const float dx = __fsub_rn(ex, nx), dy = __fsub_rn(ey, ny);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

struct NeiClear {
  float d2min, dist, per, valid, masked;
  // the VJP's gate: strictly inside the clip, and a valid neighbor
  __device__ __forceinline__ bool open() const {
    return per > -5.f && per < 20.f && valid != 0.f;
  }
};

// the clearance to one neighbor, whose discs start at px / py (stride T)
template <int NLT>
__device__ __forceinline__ void clearance(const Ego<NLT>& g, const float* px,
                                          const float* py, float rn,
                                          float valid, int T, int nL,
                                          float re, NeiClear& c) {
  float d2min = INFINITY;
#pragma unroll
  for (int j = 0; j < Ego<NLT>::CAP; ++j) {
    if (j < nL) {
      const float nx = px[j * T], ny = py[j * T];
#pragma unroll
      for (int i = 0; i < Ego<NLT>::CAP; ++i)
        if (i < nL) d2min = fminf(d2min, pair_d2(g.ex[i], g.ey[i], nx, ny));
    }
  }
  c.d2min = d2min;
  c.valid = valid;
  c.dist = sqrtf(__fadd_rn(d2min, 1e-12f));
  c.per = __fsub_rn(__fsub_rn(c.dist, re), rn);
  const float clipped = fminf(fmaxf(c.per, -5.f), 20.f);
  c.masked = __fadd_rn(__fmul_rn(clipped, valid),
                       __fmul_rn(__fsub_rn(1.f, valid), 100.f));
}

// What a block covers: scenes [s_lo, s_lo + n_sc) and the rows
// [r_lo, r_lo + n_rows) among theirs.  `chunks` blocks share a scene, `rows`
// rows each, or a block holds `spb` whole scenes; chunks or spb is 1.
struct Span {
  int s_lo, n_sc, r_lo, n_rows;
};

__device__ __forceinline__ Span block_span(int n, int m, int rows, int spb,
                                           int chunks) {
  Span b;
  const int c = blockIdx.x % chunks;
  b.s_lo = (blockIdx.x / chunks) * spb;
  b.n_sc = min(spb, n / m - b.s_lo);
  b.r_lo = b.s_lo * m + c * rows;
  b.n_rows = chunks > 1 ? min(rows, m - c * rows) : b.n_sc * m;
  return b;
}

template <int NLT>
__global__ void __launch_bounds__(MC_THREADS)
min_clearance_fwd_kernel(const float* __restrict__ ego,
                         const float* __restrict__ nei,
                         float* __restrict__ out, int n, int T, int K,
                         int nL_, int m, int rows, int spb, int chunks,
                         float c0, float c1, float re) {
  extern __shared__ float sm[];
  const int nL = NLT ? NLT : nL_;
  const Span b = block_span(n, m, rows, spb, chunks);
  const int KT = K * T, scene_floats = KT * (2 * nL + 2);
  const int items = b.n_rows * T;
  const size_t first = (size_t)b.r_lo * T;
  int item = threadIdx.x;
  Ego<NLT> g;
  if (item < items) ego_discs<NLT>(ego + (first + item) * 3, nL, c0, c1, g);
  stage_discs(nei + (size_t)b.s_lo * KT * 7, sm, b.n_sc * KT, T, K, nL);
  __syncthreads();
  while (item < items) {
    const int lr = item / T, t = item - lr * T;
    const float* sc = sm + ((b.r_lo + lr) / m - b.s_lo) * scene_floats + t;
    const float* rn = sc + 2 * KT * nL;
    float best = INFINITY;
    for (int k = 0; k < K; ++k) {
      NeiClear c;
      const float* px = sc + k * nL * T;
      clearance<NLT>(g, px, px + KT * nL, rn[k * T], rn[KT + k * T], T, nL,
                     re, c);
      best = fminf(best, c.masked);
    }
    out[first + item] = best;
    item += blockDim.x;
    if (item < items) ego_discs<NLT>(ego + (first + item) * 3, nL, c0, c1, g);
  }
}

template <int NLT>
__global__ void __launch_bounds__(MC_THREADS)
min_clearance_bwd_kernel(const float* __restrict__ ego,
                         const float* __restrict__ nei,
                         const float* __restrict__ gout,
                         float* __restrict__ d_ego, int n, int T, int K,
                         int nL_, int m, int rows, int spb, int chunks,
                         float c0, float c1, float re) {
  extern __shared__ float sm[];
  constexpr int CAP = Ego<NLT>::CAP;
  const int nL = NLT ? NLT : nL_;
  const Span b = block_span(n, m, rows, spb, chunks);
  const int KT = K * T, scene_floats = KT * (2 * nL + 2);
  const int items = b.n_rows * T;
  const size_t first = (size_t)b.r_lo * T;
  int item = threadIdx.x;
  Ego<NLT> g;
  if (item < items) ego_discs<NLT>(ego + (first + item) * 3, nL, c0, c1, g);
  stage_discs(nei + (size_t)b.s_lo * KT * 7, sm, b.n_sc * KT, T, K, nL);
  __syncthreads();
  while (item < items) {
    const int lr = item / T, t = item - lr * T;
    const float* sc = sm + ((b.r_lo + lr) / m - b.s_lo) * scene_floats + t;
    const float* rn = sc + 2 * KT * nL;
    // pass 1: the minimum over k and its tie count; among the ties, how
    // many have an open gate (`routes`) and the first of them (`kroute`)
    float best = INFINITY;
    int ties = 0, routes = 0, kroute = 0;
    for (int k = 0; k < K; ++k) {
      NeiClear c;
      const float* px = sc + k * nL * T;
      clearance<NLT>(g, px, px + KT * nL, rn[k * T], rn[KT + k * T], T, nL,
                     re, c);
      if (c.masked < best) {
        best = c.masked;
        ties = 1;
        routes = 0;
      } else if (c.masked == best) {
        ++ties;
      } else {
        continue;
      }
      if (c.open() && routes++ == 0) kroute = k;
    }
    const float gk =
        __fmul_rn(gout[first + item], __fdiv_rn(1.f, (float)max(ties, 1)));
    float g_ex[CAP], g_ey[CAP];
#pragma unroll
    for (int i = 0; i < CAP; ++i) g_ex[i] = g_ey[i] = 0.f;
    // pass 2: recompute from the first routing k on, route at every tie
    // whose gate is open
    for (int k = kroute; k < K && routes > 0; ++k) {
      NeiClear c;
      const float* px = sc + k * nL * T;
      const float* py = px + KT * nL;
      clearance<NLT>(g, px, py, rn[k * T], rn[KT + k * T], T, nL, re, c);
      if (c.masked != best || !c.open()) continue;
      --routes;
      const float gate = __fmul_rn(gk, c.valid);
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < CAP; ++i)
#pragma unroll
        for (int j = 0; j < CAP; ++j)
          if (i < nL && j < nL)
            cnt += pair_d2(g.ex[i], g.ey[i], px[j * T], py[j * T]) == c.d2min;
      const float gkn =
          __fdiv_rn(__fdiv_rn(gate, (float)max(cnt, 1)), c.dist);
#pragma unroll
      for (int i = 0; i < CAP; ++i) {
        if (i < nL) {
          float sx = 0.f, sy = 0.f;
#pragma unroll
          for (int j = 0; j < CAP; ++j) {
            if (j < nL) {
              const float nx = px[j * T], ny = py[j * T];
              if (pair_d2(g.ex[i], g.ey[i], nx, ny) == c.d2min) {
                sx = __fadd_rn(sx, __fsub_rn(g.ex[i], nx));
                sy = __fadd_rn(sy, __fsub_rn(g.ey[i], ny));
              }
            }
          }
          g_ex[i] = __fadd_rn(g_ex[i], __fmul_rn(sx, gkn));
          g_ey[i] = __fadd_rn(g_ey[i], __fmul_rn(sy, gkn));
        }
      }
    }
    float gx = 0.f, gy = 0.f, gth = 0.f;
#pragma unroll
    for (int i = 0; i < CAP; ++i) {
      if (i < nL) {
        gx = __fadd_rn(gx, g_ex[i]);
        gy = __fadd_rn(gy, g_ey[i]);
        gth = __fadd_rn(
            gth, __fadd_rn(__fmul_rn(g_ex[i], __fmul_rn(-g.ax[i], g.sth)),
                           __fmul_rn(g_ey[i], __fmul_rn(g.ax[i], g.cth))));
      }
    }
    float* o = d_ego + (first + item) * 3;
    o[0] = gx;
    o[1] = gy;
    o[2] = gth;
    item += blockDim.x;
    if (item < items) ego_discs<NLT>(ego + (first + item) * 3, nL, c0, c1, g);
  }
}

// The launch: rows of a scene a block, scenes a block (spb), blocks a scene
// (chunks), grid, block and shared-memory sizes.
struct Plan {
  int rows, spb, chunks, blocks, threads;
  size_t smem;
};

// False for sizes the kernels do not take.
bool make_plan(int n, int T, int K, int nL, int m, Plan& p) {
  if (n < 0 || T <= 0 || K <= 0 || nL <= 0 || nL > MC_MAXNL || m <= 0 ||
      n % m != 0 || (long long)n * T > 0x7fffffffLL ||
      (long long)(n / m) * K * T > 0x7fffffffLL)
    return false;
  const long long scene_bytes = 4LL * K * T * (2 * nL + 2);
  if (scene_bytes > MC_SMEM_MAX) return false;
  const int scenes = n / m;
  const int fit = (int)(MC_SMEM_MAX / scene_bytes);
  p.rows = MC_ROWS;
  p.chunks = m >= p.rows ? (m + p.rows - 1) / p.rows : 1;
  p.spb = m >= p.rows ? 1 : min(min(p.rows / m, fit), max(scenes, 1));
  const long long blocks = p.chunks > 1
                               ? (long long)scenes * p.chunks
                               : ((long long)scenes + p.spb - 1) / p.spb;
  if (blocks > 0x7fffffffLL) return false;
  p.blocks = (int)blocks;
  // the block's (row, t) items in equal turns of at most MC_THREADS
  const long long items = (long long)(p.chunks > 1 ? p.rows : p.spb * m) * T;
  const long long turns = (items + MC_THREADS - 1) / MC_THREADS;
  p.threads = (int)(((items + turns - 1) / turns + 31) / 32) * 32;
  p.smem = (size_t)(p.spb * scene_bytes);
  return true;
}

// a launch with more than 48 KB of shared memory opts into it first
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int NLT>
int launch_fwd(const Plan& p, const float* ego, const float* nei, float* out,
               int n, int T, int K, int nL, int m, float c0, float c1,
               float re, cudaStream_t stream) {
  const cudaError_t err = allow_smem(min_clearance_fwd_kernel<NLT>, p.smem);
  if (err != cudaSuccess) return (int)err;
  min_clearance_fwd_kernel<NLT><<<p.blocks, p.threads, p.smem, stream>>>(
      ego, nei, out, n, T, K, nL, m, p.rows, p.spb, p.chunks, c0, c1, re);
  return (int)cudaGetLastError();
}

template <int NLT>
int launch_bwd(const Plan& p, const float* ego, const float* nei,
               const float* g, float* d_ego, int n, int T, int K, int nL,
               int m, float c0, float c1, float re, cudaStream_t stream) {
  const cudaError_t err = allow_smem(min_clearance_bwd_kernel<NLT>, p.smem);
  if (err != cudaSuccess) return (int)err;
  min_clearance_bwd_kernel<NLT><<<p.blocks, p.threads, p.smem, stream>>>(
      ego, nei, g, d_ego, n, T, K, nL, m, p.rows, p.spb, p.chunks, c0, c1,
      re);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pstl_min_clearance_fwd(const float* ego, const float* nei,
                                      float* out, int n, int T, int K,
                                      int nL, int rows_per_scene, float c0,
                                      float c1, float re, void* stream) {
  Plan p;
  if (!make_plan(n, T, K, nL, rows_per_scene, p))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (MC_NLT != 0 && nL == MC_NLT)
    return launch_fwd<MC_NLT>(p, ego, nei, out, n, T, K, nL, rows_per_scene,
                              c0, c1, re, (cudaStream_t)stream);
  return launch_fwd<0>(p, ego, nei, out, n, T, K, nL, rows_per_scene, c0, c1,
                       re, (cudaStream_t)stream);
}

extern "C" int pstl_min_clearance_bwd(const float* ego, const float* nei,
                                      const float* g, float* d_ego, int n,
                                      int T, int K, int nL,
                                      int rows_per_scene, float c0, float c1,
                                      float re, void* stream) {
  Plan p;
  if (!make_plan(n, T, K, nL, rows_per_scene, p))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (MC_NLT != 0 && nL == MC_NLT)
    return launch_bwd<MC_NLT>(p, ego, nei, g, d_ego, n, T, K, nL,
                              rows_per_scene, c0, c1, re,
                              (cudaStream_t)stream);
  return launch_bwd<0>(p, ego, nei, g, d_ego, n, T, K, nL, rows_per_scene, c0,
                       c1, re, (cudaStream_t)stream);
}
