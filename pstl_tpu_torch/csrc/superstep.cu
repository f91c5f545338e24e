// One whole DDPM denoise step for Hopper (sm_90a), for every scene at once:
// the split-layer-1 epsilon MLP, the posterior mean mu = (x - c1*eps)/c2,
// optionally the fused guidance update (freeze + Adam + trust-region clip),
// and the noise term x_next = mu + c3*z.
//
// Replaces the Pallas TPU kernel `_kernel_superstep` in
// pstl_tpu/ops/pallas_guidance.py (via `superstep_call`), with its MLP
// helper `_eps_mlp_k`.  The guided update is the device code of
// guidance_device.cuh, the same copy that csrc/guidance_fused.cu runs.
//
// Numerics follow `_eps_mlp_k`: layer 1 is base + te + WnwT.xw + WnaT.xa
// summed in fp32 (operands rounded to the compute dtype, products exact in
// fp32), then ReLU and a rounding to the compute dtype; each mid layer the
// same; the output layer stays fp32 and adds the residual x.  The compute
// dtype is that of the weights, base and te: bf16 on the main path, or fp32.
//
// What bounds it on the H100, at the main shapes (16 scenes x R=192 columns,
// hidden 256, one mid layer, T=20): the MLP is 2*(40*256 + 256*256 +
// 256*40) = 172 kFLOP per column, 0.53 GFLOP per launch, half a
// microsecond at the tensor cores' bf16 rate; about 4.5 MB move per launch
// (x, z and the output in fp32, 3 x 0.98 MB; the per-plan layer-1 term
// `base` in bf16, 1.6 MB; the weights, 0.16 MB, come from L2 after the first
// block), about 1.4 us at 3.35 TB/s.  Neither is near the time a launch
// takes: the MLP phase is bound by the latency of its three dependent layers
// (weights from L2, activations through shared memory, a block barrier
// between layers), the guided phase by the latency of a column's chain as in
// guidance_fused.cu.
//
// Design.  One block per (scene, SS_COLS = 16 columns), SS_WARPS = 16 warps,
// SS_MINB = 2 blocks an SM: the guided phase then has one warp per column
// and all 3072 warps of the main path resident at once (64 registers a
// thread, about 300 bytes of spills; 32 columns on 16 warps without a
// register cap run two chains a warp in turn and take 1.1x as long, 32
// columns on 8 warps 1.8x; scripts/geometry_sweep.py measures these).
//
// bf16 (the main path): the MLP runs on the tensor cores as
// mma.sync.aligned.m16n8k16 (bf16 x bf16 products, fp32 accumulators: the
// arithmetic `_eps_mlp_k` asks for).  A block's products are SS_COLS x 256 x
// 256: far too small for wgmma's 64-row tiles, shared-memory descriptors and
// warpgroup scheduling to buy anything, and mma.sync needs none of that.
// The candidate columns are the M dimension: activations live in shared
// memory as bf16 (they are rounded to it between layers anyway), column
// major with the features contiguous and a row stride of 16 bytes more than
// a multiple of 64, so ldmatrix reads A fragments without bank conflicts.
// The weights are the B operand (W^T, (out, in) row major, is "col" B): the
// host packs each matrix once per plan into fragment order, zero-padded to
// multiples of 32 features (ops/superstep_kernel.py: pack_b), so a lane's B
// fragments of two k-steps are one 16-byte load, a warp's load one 512-byte
// line, and every weight is read once per block.  A warp owns groups of
// SS_NTW output tiles (8 features each) and keeps SS_NTW x SS_COLS/16
// accumulator tiles in registers; the epilogue adds the bias (layer 1:
// ((base + te) + Wnw.xw) + Wna.xa with the two products in accumulators of
// their own), applies ReLU, rounds to bf16 and stores pairs.  Layer 1's
// depth T is padded to 32 with zeros, the output layer's 2T rows to a
// multiple of 8 and masked.  The posterior keeps its __f*_rn roundings.
//
// fp32 (the reference passes and the CPU-parity configuration): CUDA cores,
// in-order FMAs over k, fp32 activations in shared memory; TF32 would lose
// the 1e-5 agreement these passes are held to.  The path is chosen by the
// dtype of the caller's weights.
//
// Guided phase: every warp of the block takes columns of the block's tile of
// posterior means in turn (one warp per column, lane = time step); the
// guided means go back into the tile, and after a last barrier all threads
// write x_next with row-contiguous stores.  `guided` is a launch argument
// from the static trigger schedule, so no branch depends on data.

#include "guidance_device.cuh"

#define SS_WARPS 16   // warps a block
#define SS_COLS 16    // candidate columns a block, a multiple of 16
#define SS_NTW 2      // output tiles a warp accumulates at once: 1, 2 or 4
#define SS_MINB 2     // blocks an SM must hold: 64 registers a thread
#define SS_THREADS (SS_WARPS * 32)
#define SS_MT (SS_COLS / 16)   // 16-column M tiles
#define SS_CP (SS_COLS + 1)    // row stride of the posterior-mean tile
#define SS_XS 40               // row stride of the bf16 x tiles: 32 + 8
#define MAXMID 8
#define MAXH 512
#define MAX_SMEM (227 * 1024)

typedef __nv_bfloat16 bf16;

struct Mlp {
  const void* base;     // (bs, h1, R) layer-1 term of feature/highlevel/stlp
  const void* te;       // (h1,) layer-1 term of this step's timestep
  const void* WnwT;     // (h1, T) noise block of layer 1, control w
  const void* WnaT;     // (h1, T) control a
  const void* W[MAXMID];  // mid layer i: (dims[i+1], dims[i]) = W^T
  const void* b[MAXMID];  // (dims[i+1],)
  const void* WowT;     // (T, dims[nmid]) output rows of control w
  const void* WoaT;
  const void* bow;      // (T,)
  const void* boa;
  // bf16 only: the matrices above in B-fragment order (pack_b)
  const uint4* pWnw;
  const uint4* pWna;
  const uint4* pW[MAXMID];
  const uint4* pWo;     // rows [WowT; WoaT]
  int dims[MAXMID + 1];  // dims[0] = h1; dims[i+1] = width after mid layer i
  int nmid;
};

struct SceneArgs {  // the guidance operands, as guidance_fused.cu takes them
  const float* lanes; const float* ndx; const float* ndy; const float* crad;
  const float* cvalid; const float* stlp; const float* nf;
  const float* valid; const float* scal;
};

__host__ __device__ inline int pad32(int n) { return (n + 31) & ~31; }

__device__ __forceinline__ float ld_bf16(const void* p, size_t i) {
  unsigned int u = __ldg(static_cast<const unsigned short*>(p) + i);
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float ld_f32(const void* p, size_t i) {
  return __ldg(static_cast<const float*>(p) + i);
}

// ---- shared by both dtypes: guidance on the tile, then x_next -----------

// smu: [2][T][SS_CP] posterior means of the block's columns (w rows, then a
// rows).  All threads of the block call it after a barrier that follows the
// last write to smu.
__device__ void guide_and_store(float* smu, const Scene& sc,
                                const SceneArgs& g,
                                const float* __restrict__ z,
                                const float* __restrict__ gvec,
                                float* __restrict__ out, const Params& p,
                                int b, int r0, int guided) {
  const int T = p.T, R = p.R;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (guided) {
    const float beta = gvec[0], thres = gvec[1], gscale = gvec[2];
    for (int c = warp; c < SS_COLS; c += SS_WARPS) {
      const int r = r0 + c;
      if (r >= R) continue;  // the whole warp skips a dead column
      const Column col = load_column(g.stlp, g.nf, g.valid, g.scal, b, r, p);
      float w = lane < T ? smu[lane * SS_CP + c] : 0.f;
      float a = lane < T ? smu[(T + lane) * SS_CP + c] : 0.f;
      guided_update(w, a, col, sc, p, lane, beta, thres, gscale);
      if (lane < T) {
        smu[lane * SS_CP + c] = w;
        smu[(T + lane) * SS_CP + c] = a;
      }
    }
    __syncthreads();
  }
  const float c3 = gvec[5];
  for (int i = threadIdx.x; i < 2 * T * SS_COLS; i += SS_THREADS) {
    const int c = i % SS_COLS, ct = i / SS_COLS;  // ct = ctrl * T + t
    if (r0 + c >= R) continue;
    const int ctrl = ct / T, t = ct % T;
    const size_t o = (((size_t)b * T + t) * 2 + ctrl) * R + r0 + c;
    out[o] = __fadd_rn(smu[ct * SS_CP + c], __fmul_rn(c3, z[o]));
  }
}

// ---- bf16: the MLP on the tensor cores ----------------------------------

__device__ __forceinline__ void ldmatrix_x4(unsigned& r0, unsigned& r1,
                                            unsigned& r2, unsigned& r3,
                                            const void* row) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += A (16 x 16, row) . B (16 x 8, col), bf16 operands.  The tensor core
// sums the 16 exact products of a k-step from zero; the step's sum joins the
// running sum by an fp32 add outside it.  An accumulator kept inside the
// tensor core is rounded toward zero at every step, a bias of several ulp
// over a 256-deep sum that turns into many more one-step bf16 rounding
// differences of the activations against an fp32 matrix product than
// round-to-nearest adds give.
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  float t0, t1, t2, t3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(t0), "=f"(t1), "=f"(t2), "=f"(t3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f));
  d[0] += t0;
  d[1] += t1;
  d[2] += t2;
  d[3] += t3;
}

// acc[i][mt] += hT (columns mt*16.., features 0..32*k32) . W^T of output
// tile i of the group at Bp.  hT: [SS_COLS][stride] bf16 in shared memory;
// Bp: [tile][k32][32 lanes] uint4 = the lane's (b0, b1) of k-steps 2kk and
// 2kk + 1.
template <int NTW>
__device__ __forceinline__ void tile_dot(const bf16* hT, int stride,
                                         const uint4* __restrict__ Bp,
                                         int k32, int lane,
                                         float (&acc)[NTW][SS_MT][4]) {
  // ldmatrix x4: lanes 0-15 give the rows of features 0-7, 16-31 of 8-15
  const bf16* row = hT + (lane % 16) * stride + (lane / 16) * 8;
#pragma unroll 2
  for (int kk = 0; kk < k32; ++kk) {
    uint4 bq[NTW];
#pragma unroll
    for (int i = 0; i < NTW; ++i)
      bq[i] = __ldg(Bp + ((size_t)i * k32 + kk) * 32 + lane);
#pragma unroll
    for (int mt = 0; mt < SS_MT; ++mt) {
      const bf16* pa = row + mt * 16 * stride + kk * 32;
      unsigned a0, a1, a2, a3;
      ldmatrix_x4(a0, a1, a2, a3, pa);
#pragma unroll
      for (int i = 0; i < NTW; ++i)
        mma_bf16(acc[i][mt], a0, a1, a2, a3, bq[i].x, bq[i].y);
      ldmatrix_x4(a0, a1, a2, a3, pa + 16);
#pragma unroll
      for (int i = 0; i < NTW; ++i)
        mma_bf16(acc[i][mt], a0, a1, a2, a3, bq[i].z, bq[i].w);
    }
  }
}

template <int NTW>
__device__ __forceinline__ void zero_acc(float (&acc)[NTW][SS_MT][4]) {
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int mt = 0; mt < SS_MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][mt][e] = 0.f;
}

__device__ __forceinline__ void store_pair(bf16* hT, int stride, int col,
                                           int j, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(hT + col * stride + j) =
      __floats2bfloat162_rn(v0, v1);
}

__global__ void __launch_bounds__(SS_THREADS, SS_MINB) superstep_bf16_kernel(
    const float* __restrict__ x, const float* __restrict__ z, Mlp m,
    SceneArgs g, const float* __restrict__ gvec, float* __restrict__ out,
    Params p, int hstride, int guided) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * SS_COLS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gq = lane / 4, q = lane % 4;  // the fragments' row and pair
  const int T = p.T, R = p.R;
  const float c1 = gvec[3], c2 = gvec[4];

  bf16* act0 = reinterpret_cast<bf16*>(smem_raw);   // [SS_COLS][hstride]
  bf16* act1 = act0 + SS_COLS * hstride;
  bf16* xw = act1 + SS_COLS * hstride;              // [SS_COLS][SS_XS]
  bf16* xa = xw + SS_COLS * SS_XS;
  float* smu = reinterpret_cast<float*>(xa + SS_COLS * SS_XS);
  float* scene = smu + 2 * T * SS_CP;
  Scene sc{};
  if (guided)
    sc = load_scene(scene, g.lanes, g.ndx, g.ndy, g.crad, g.cvalid, b, p);
  // x rounded to bf16, features t contiguous, zero beyond T and R
  for (int i = threadIdx.x; i < 32 * SS_COLS; i += SS_THREADS) {
    const int c = i % SS_COLS, t = i / SS_COLS, r = r0 + c;
    float vw = 0.f, va = 0.f;
    if (t < T && r < R) {
      const size_t o = (((size_t)b * T + t) * 2) * R + r;
      vw = x[o];
      va = x[o + R];
    }
    xw[c * SS_XS + t] = __float2bfloat16_rn(vw);
    xa[c * SS_XS + t] = __float2bfloat16_rn(va);
  }
  __syncthreads();

  // layer 1: ((base + te) + WnwT.xw) + WnaT.xa, ReLU, round
  const int h1 = m.dims[0];
  for (int grp = warp; grp < pad32(h1) / (8 * SS_NTW); grp += SS_WARPS) {
    float aw[SS_NTW][SS_MT][4], aa[SS_NTW][SS_MT][4];
    zero_acc(aw);
    zero_acc(aa);
    tile_dot<SS_NTW>(xw, SS_XS, m.pWnw + (size_t)grp * SS_NTW * 32, 1, lane,
                     aw);
    tile_dot<SS_NTW>(xa, SS_XS, m.pWna + (size_t)grp * SS_NTW * 32, 1, lane,
                     aa);
#pragma unroll
    for (int i = 0; i < SS_NTW; ++i) {
      const int j = (grp * SS_NTW + i) * 8 + 2 * q;
#pragma unroll
      for (int mt = 0; mt < SS_MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int c = mt * 16 + gq + 8 * hf, r = r0 + c;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = 0.f;
            if (j + e < h1) {
              const float bv = r < R
                  ? ld_bf16(m.base, ((size_t)b * h1 + j + e) * R + r) : 0.f;
              const float bt = bv + ld_bf16(m.te, j + e);
              v[e] = fmaxf((bt + aw[i][mt][hf * 2 + e])
                           + aa[i][mt][hf * 2 + e], 0.f);
            }
          }
          store_pair(act0, hstride, c, j, v[0], v[1]);
        }
    }
  }
  __syncthreads();

  // mid layers: W.h + b, ReLU, round
  bf16* hcur = act0;
  bf16* hnext = act1;
  for (int l = 0; l < m.nmid; ++l) {
    const int k32 = pad32(m.dims[l]) / 32, nout = m.dims[l + 1];
    for (int grp = warp; grp < pad32(nout) / (8 * SS_NTW); grp += SS_WARPS) {
      float acc[SS_NTW][SS_MT][4];
      zero_acc(acc);
      tile_dot<SS_NTW>(hcur, hstride,
                       m.pW[l] + (size_t)grp * SS_NTW * k32 * 32, k32, lane,
                       acc);
#pragma unroll
      for (int i = 0; i < SS_NTW; ++i) {
        const int j = (grp * SS_NTW + i) * 8 + 2 * q;
        const float b0 = j < nout ? ld_bf16(m.b[l], j) : 0.f;
        const float b1 = j + 1 < nout ? ld_bf16(m.b[l], j + 1) : 0.f;
#pragma unroll
        for (int mt = 0; mt < SS_MT; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int c = mt * 16 + gq + 8 * hf;
            const float v0 = j < nout
                ? fmaxf(acc[i][mt][hf * 2] + b0, 0.f) : 0.f;
            const float v1 = j + 1 < nout
                ? fmaxf(acc[i][mt][hf * 2 + 1] + b1, 0.f) : 0.f;
            store_pair(hnext, hstride, c, j, v0, v1);
          }
      }
    }
    __syncthreads();
    bf16* tmp = hcur;
    hcur = hnext;
    hnext = tmp;
  }

  // output layer (fp32) + residual, and the posterior mean into the tile
  const int k32o = pad32(m.dims[m.nmid]) / 32;
  for (int nt = warp; nt < (2 * T + 7) / 8; nt += SS_WARPS) {
    float acc[1][SS_MT][4];
    zero_acc(acc);
    tile_dot<1>(hcur, hstride, m.pWo + (size_t)nt * k32o * 32, k32o, lane,
                acc);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = nt * 8 + 2 * q + e;  // row of [WowT; WoaT]
      if (j >= 2 * T) continue;
      const int ctrl = j >= T ? 1 : 0, t = j - ctrl * T;
      const float bias = ld_bf16(ctrl ? m.boa : m.bow, t);
#pragma unroll
      for (int mt = 0; mt < SS_MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int c = mt * 16 + gq + 8 * hf, r = r0 + c;
          const float xv = r < R
              ? x[(((size_t)b * T + t) * 2 + ctrl) * R + r] : 0.f;
          const float eps = __fadd_rn(acc[0][mt][hf * 2 + e] + bias, xv);
          smu[j * SS_CP + c] =
              __fdiv_rn(__fsub_rn(xv, __fmul_rn(c1, eps)), c2);
        }
    }
  }
  __syncthreads();
  guide_and_store(smu, sc, g, z, gvec, out, p, b, r0, guided);
}

// ---- fp32: the MLP on the CUDA cores, FMAs in k order --------------------

// acc[q] = sum_k W[row0 + q][k] * h[k][col], k in order, for q < nr <= 4;
// W is row-major with nin columns, h is [nin][SS_COLS] in shared memory.
__device__ __forceinline__ void dot4(const void* W, int row0, int nr,
                                     int nin, const float* h, int col,
                                     float* acc) {
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = 0.f;
  for (int k = 0; k < nin; ++k) {
    const float hv = h[k * SS_COLS + col];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < nr)
        acc[q] = fmaf(ld_f32(W, (size_t)(row0 + q) * nin + k), hv, acc[q]);
  }
}

__global__ void __launch_bounds__(SS_THREADS, SS_MINB) superstep_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ z, Mlp m,
    SceneArgs g, const float* __restrict__ gvec, float* __restrict__ out,
    Params p, int hmax, int guided) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * SS_COLS;
  // a thread's column, and its group of 4 output rows at a time
  const int col = threadIdx.x % SS_COLS, grp = threadIdx.x / SS_COLS;
  const int ngrp = SS_THREADS / SS_COLS;
  const int r = r0 + col;
  const bool live = r < p.R;
  const int T = p.T, R = p.R;
  const float c1 = gvec[3], c2 = gvec[4];

  float* xin = reinterpret_cast<float*>(smem_raw);  // [2][T][SS_COLS]
  float* hA = xin + 2 * T * SS_COLS;                // [hmax][SS_COLS]
  float* hB = hA + (size_t)hmax * SS_COLS;
  float* smu = hB + (size_t)hmax * SS_COLS;         // [2][T][SS_CP]
  float* scene = smu + 2 * T * SS_CP;
  Scene sc{};
  if (guided)
    sc = load_scene(scene, g.lanes, g.ndx, g.ndy, g.crad, g.cvalid, b, p);
  for (int i = threadIdx.x; i < 2 * T * SS_COLS; i += SS_THREADS) {
    const int l = i % SS_COLS, ct = i / SS_COLS, rr = r0 + l;
    const int c = ct / T, t = ct % T;
    xin[i] = rr < R ? x[(((size_t)b * T + t) * 2 + c) * R + rr] : 0.f;
  }
  __syncthreads();

  // layer 1: ((base + te) + WnwT.xw) + WnaT.xa, ReLU
  const int h1 = m.dims[0];
  for (int i0 = grp * 4; i0 < h1; i0 += ngrp * 4) {
    const int nr = min(4, h1 - i0);
    float aw[4], aa[4];
    dot4(m.WnwT, i0, nr, T, xin, col, aw);
    dot4(m.WnaT, i0, nr, T, xin + T * SS_COLS, col, aa);
    for (int q = 0; q < nr; ++q) {
      const int i = i0 + q;
      const float bv = live ? ld_f32(m.base, ((size_t)b * h1 + i) * R + r)
                            : 0.f;
      const float v = ((bv + ld_f32(m.te, i)) + aw[q]) + aa[q];
      hA[i * SS_COLS + col] = fmaxf(v, 0.f);
    }
  }
  __syncthreads();

  // mid layers: W.h + b, ReLU
  float* hcur = hA;
  float* hnext = hB;
  for (int l = 0; l < m.nmid; ++l) {
    const int nin = m.dims[l], nout = m.dims[l + 1];
    for (int i0 = grp * 4; i0 < nout; i0 += ngrp * 4) {
      const int nr = min(4, nout - i0);
      float acc[4];
      dot4(m.W[l], i0, nr, nin, hcur, col, acc);
      for (int q = 0; q < nr; ++q) {
        const int i = i0 + q;
        hnext[i * SS_COLS + col] = fmaxf(acc[q] + ld_f32(m.b[l], i), 0.f);
      }
    }
    __syncthreads();
    float* tmp = hcur;
    hcur = hnext;
    hnext = tmp;
  }

  // output layer + residual, and the posterior mean into the tile
  const int hlast = m.dims[m.nmid];
  const int ngc = (T + 3) / 4;
  for (int gi = grp; gi < 2 * ngc; gi += ngrp) {
    const int c = gi / ngc, t0 = (gi % ngc) * 4, nr = min(4, T - t0);
    float acc[4];
    dot4(c ? m.WoaT : m.WowT, t0, nr, hlast, hcur, col, acc);
    for (int q = 0; q < nr; ++q) {
      const int t = t0 + q;
      const float xv = live ? x[(((size_t)b * T + t) * 2 + c) * R + r] : 0.f;
      const float eps = __fadd_rn(acc[q] + ld_f32(c ? m.boa : m.bow, t), xv);
      smu[(c * T + t) * SS_CP + col] =
          __fdiv_rn(__fsub_rn(xv, __fmul_rn(c1, eps)), c2);
    }
  }
  __syncthreads();
  guide_and_store(smu, sc, g, z, gvec, out, p, b, r0, guided);
}

// Raise the kernel's dynamic shared-memory limit when `smem` needs it.
static int ensure_smem(const void* kernel, size_t smem, size_t& opted) {
  if (smem <= opted) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  opted = smem;
  return 0;
}

// x, z, out: (bs, T, 2, R) fp32.  base, te and the weights in the compute
// dtype (bf16 when `bf16`, else fp32), row-major as listed in Mlp; midW,
// midb and dims are host arrays of nmid, nmid and nmid + 1 entries.  With
// `bf16` the matrices are read only in fragment order: pWnw, pWna, pmidW
// (a host array of nmid entries) and pWo, as pack_b lays them out.  gvec:
// 8 fp32 on the device, [beta, thres, gscale, c1, c2, c3, 0, 0].
extern "C" int pstl_superstep(
    const float* x, const float* z, const void* base, const void* te,
    const void* WnwT, const void* WnaT, const void* const* midW,
    const void* const* midb, const int* dims, int nmid, const void* WowT,
    const void* WoaT, const void* bow, const void* boa, const void* pWnw,
    const void* pWna, const void* const* pmidW, const void* pWo,
    const float* lanes, const float* ndx, const float* ndy,
    const float* crad, const float* cvalid, const float* stlp,
    const float* nf, const float* valid, const float* scal,
    const float* gvec, float* out, int bs, int T, int R, int M, int S, int K,
    int nLe, int nLn, int nt2, int niters, float tau, float dt, float mul_w,
    float mul_a, float lr, double ego_L, double re, int flags, int bf16_,
    int guided, void* stream) {
  Params p;
  if (!fill_params(p, bs, T, R, M, S, K, nLe, nLn, nt2, niters, tau, dt,
                   mul_w, mul_a, lr, ego_L, re, flags))
    return (int)cudaErrorInvalidValue;
  if (nmid < 0 || nmid > MAXMID) return (int)cudaErrorInvalidValue;
  Mlp m;
  m.base = base; m.te = te; m.WnwT = WnwT; m.WnaT = WnaT;
  m.WowT = WowT; m.WoaT = WoaT; m.bow = bow; m.boa = boa; m.nmid = nmid;
  m.pWnw = static_cast<const uint4*>(pWnw);
  m.pWna = static_cast<const uint4*>(pWna);
  m.pWo = static_cast<const uint4*>(pWo);
  int hmax = 0;
  for (int i = 0; i <= nmid; ++i) {
    if (dims[i] < 1 || dims[i] > MAXH) return (int)cudaErrorInvalidValue;
    m.dims[i] = dims[i];
    hmax = dims[i] > hmax ? dims[i] : hmax;
  }
  for (int i = 0; i < MAXMID; ++i) {
    m.W[i] = i < nmid ? midW[i] : nullptr;
    m.b[i] = i < nmid ? midb[i] : nullptr;
    m.pW[i] = i < nmid && bf16_ ? static_cast<const uint4*>(pmidW[i])
                                : nullptr;
  }
  const SceneArgs g{lanes, ndx, ndy, crad, cvalid, stlp, nf, valid, scal};
  const size_t tail = sizeof(float)
      * (2 * (size_t)T * SS_CP + (guided ? scene_floats(p) : 0));
  const dim3 grid((p.R + SS_COLS - 1) / SS_COLS, p.bs);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16_) {
    if (!pWnw || !pWna || !pWo) return (int)cudaErrorInvalidValue;
    const int hstride = pad32(hmax) + 8;
    const size_t smem = sizeof(bf16)
        * (2 * (size_t)SS_COLS * hstride + 2 * SS_COLS * SS_XS) + tail;
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    static size_t opted = 48 * 1024;
    if (int e = ensure_smem((const void*)superstep_bf16_kernel, smem, opted))
      return e;
    superstep_bf16_kernel<<<grid, SS_THREADS, smem, s>>>(
        x, z, m, g, gvec, out, p, hstride, guided);
  } else {
    const size_t smem = sizeof(float)
        * (2 * (size_t)T * SS_COLS + 2 * (size_t)hmax * SS_COLS) + tail;
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    static size_t opted = 48 * 1024;
    if (int e = ensure_smem((const void*)superstep_f32_kernel, smem, opted))
      return e;
    superstep_f32_kernel<<<grid, SS_THREADS, smem, s>>>(
        x, z, m, g, gvec, out, p, hmax, guided);
  }
  return (int)cudaGetLastError();
}
