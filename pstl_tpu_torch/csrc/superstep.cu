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
// same; the output layer stays fp32 and adds the residual x.  `WT` is the
// compute dtype of the weights, base and te (bf16 on the main path, or
// fp32).  Sums run over k in order with FMA, so they differ from a library
// matmul's order by fp32 rounding.
//
// What bounds it on the H100, at the main shapes (16 scenes x R=192 columns,
// hidden 256, one mid layer, T=20): the MLP is 2*(40*256 + 256*256 +
// 256*40) = 172 kFLOP per column, 0.53 GFLOP per launch, about 8 us at the
// CUDA cores' fp32 rate; about 4.5 MB move per launch (x, z and the output
// in fp32, 3 x 0.98 MB; the per-plan layer-1 term `base` in bf16, 1.6 MB;
// the weights, 0.16 MB, come from L2 after the first block), about 1.4 us
// at 3.35 TB/s.  The guided update is latency-bound as in
// guidance_fused.cu (~0.77 ms a launch there) and dominates a guided step.
//
// Design.  One block per (scene, 32 columns) as in guidance_fused.cu, with
// 256 threads.  MLP phase: the block's activations (hidden x 32 columns,
// fp32, two buffers) sit in shared memory; each warp owns 4 output rows at
// a time, each lane one column, so the weights are warp-wide broadcast
// loads through the read-only cache and the activations conflict-free
// shared loads.  Guidance phase: warp 0 runs the per-column guided update,
// one thread per column, on the posterior mean left in shared memory.
// `guided` is a launch argument from the static trigger schedule, so no
// branch depends on data.  Later work: tensor cores (mma.sync / wgmma) for
// the MLP, more threads per column for the guidance.

#include "guidance_device.cuh"

#define SS_THREADS 256
#define SS_WARPS (SS_THREADS / 32)
#define MAXMID 8
#define MAXH 512
#define MAX_SMEM (227 * 1024)

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
  int dims[MAXMID + 1];  // dims[0] = h1; dims[i+1] = width after mid layer i
  int nmid;
};

struct F32W {  // fp32 compute dtype
  static __device__ __forceinline__ float ld(const void* p, size_t i) {
    return __ldg(static_cast<const float*>(p) + i);
  }
  static __device__ __forceinline__ float rnd(float x) { return x; }
};

struct BF16W {  // bf16 compute dtype: widen exactly, round to nearest even
  static __device__ __forceinline__ float ld(const void* p, size_t i) {
    unsigned int u = __ldg(static_cast<const unsigned short*>(p) + i);
    return __uint_as_float(u << 16);
  }
  static __device__ __forceinline__ float rnd(float x) { return rbf(x); }
};

// acc[q] = sum_k W[row0 + q][k] * h[k][lane], k in order, for q < nr <= 4;
// W is row-major with nin columns, h is [nin][BLOCK] in shared memory.
template <class WP>
__device__ __forceinline__ void dot4(const void* W, int row0, int nr,
                                     int nin, const float* h, int lane,
                                     float* acc) {
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = 0.f;
  for (int k = 0; k < nin; ++k) {
    const float hv = h[k * BLOCK + lane];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < nr)
        acc[q] = fmaf(WP::ld(W, (size_t)(row0 + q) * nin + k), hv, acc[q]);
  }
}

template <class WP>
__global__ void __launch_bounds__(SS_THREADS) superstep_kernel(
    const float* __restrict__ x, const float* __restrict__ z, Mlp m,
    const float* __restrict__ lanes, const float* __restrict__ ndx,
    const float* __restrict__ ndy, const float* __restrict__ crad,
    const float* __restrict__ cvalid, const float* __restrict__ stlp,
    const float* __restrict__ nf, const float* __restrict__ valid,
    const float* __restrict__ scal, const float* __restrict__ gvec,
    float* __restrict__ out, Params p, int hmax, int guided) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * BLOCK;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = r0 + lane;
  const bool live = r < p.R;
  const int T = p.T, R = p.R;
  const float c1 = gvec[3], c2 = gvec[4], c3 = gvec[5];

  const size_t nsc = guided ? scene_floats(p) : 0;
  float* xin = smem + nsc;                 // [2][T][BLOCK] x in the dtype
  float* hA = xin + 2 * T * BLOCK;         // [hmax][BLOCK]
  float* hB = hA + (size_t)hmax * BLOCK;
  float* smu = hB + (size_t)hmax * BLOCK;  // [2][T][BLOCK] posterior mean
  Scene sc{};
  if (guided) sc = load_scene(smem, lanes, ndx, ndy, crad, cvalid, b, p);
  for (int i = threadIdx.x; i < 2 * T * BLOCK; i += SS_THREADS) {
    const int l = i % BLOCK, ct = i / BLOCK, rr = r0 + l;
    const int c = ct / T, t = ct % T;
    xin[i] = rr < R ? WP::rnd(x[(((size_t)b * T + t) * 2 + c) * R + rr])
                    : 0.f;
  }
  __syncthreads();

  // layer 1: ((base + te) + WnwT.xw) + WnaT.xa, ReLU, round
  const int h1 = m.dims[0];
  for (int i0 = warp * 4; i0 < h1; i0 += SS_WARPS * 4) {
    const int nr = min(4, h1 - i0);
    float aw[4], aa[4];
    dot4<WP>(m.WnwT, i0, nr, T, xin, lane, aw);
    dot4<WP>(m.WnaT, i0, nr, T, xin + T * BLOCK, lane, aa);
    for (int q = 0; q < nr; ++q) {
      const int i = i0 + q;
      const float bv = live ? WP::ld(m.base, ((size_t)b * h1 + i) * R + r)
                            : 0.f;
      const float v = ((bv + WP::ld(m.te, i)) + aw[q]) + aa[q];
      hA[i * BLOCK + lane] = WP::rnd(fmaxf(v, 0.f));
    }
  }
  __syncthreads();

  // mid layers: W.h + b, ReLU, round
  float* hcur = hA;
  float* hnext = hB;
  for (int l = 0; l < m.nmid; ++l) {
    const int nin = m.dims[l], nout = m.dims[l + 1];
    for (int i0 = warp * 4; i0 < nout; i0 += SS_WARPS * 4) {
      const int nr = min(4, nout - i0);
      float acc[4];
      dot4<WP>(m.W[l], i0, nr, nin, hcur, lane, acc);
      for (int q = 0; q < nr; ++q) {
        const int i = i0 + q;
        hnext[i * BLOCK + lane] = WP::rnd(fmaxf(acc[q] + WP::ld(m.b[l], i),
                                                0.f));
      }
    }
    __syncthreads();
    float* tmp = hcur;
    hcur = hnext;
    hnext = tmp;
  }

  // output layer (fp32) + residual, posterior, and (unguided) the noise
  const int hlast = m.dims[m.nmid];
  const int ngc = (T + 3) / 4;
  for (int g = warp; g < 2 * ngc; g += SS_WARPS) {
    const int c = g / ngc, t0 = (g % ngc) * 4, nr = min(4, T - t0);
    float acc[4];
    dot4<WP>(c ? m.WoaT : m.WowT, t0, nr, hlast, hcur, lane, acc);
    for (int q = 0; q < nr; ++q) {
      const int t = t0 + q;
      const size_t o = (((size_t)b * T + t) * 2 + c) * R + r;
      const float xv = live ? x[o] : 0.f;
      const float eps = __fadd_rn(acc[q] + WP::ld(c ? m.boa : m.bow, t), xv);
      const float mu = __fdiv_rn(__fsub_rn(xv, __fmul_rn(c1, eps)), c2);
      if (guided)
        smu[(c * T + t) * BLOCK + lane] = mu;
      else if (live)
        out[o] = __fadd_rn(mu, __fmul_rn(c3, z[o]));
    }
  }
  if (!guided) return;
  __syncthreads();
  if (warp != 0 || !live) return;

  Column col = load_column(stlp, nf, valid, scal, b, r, p);
  float w[MAXT], a[MAXT];
  for (int t = 0; t < T; ++t) {
    w[t] = smu[t * BLOCK + lane];
    a[t] = smu[(T + t) * BLOCK + lane];
  }
  guided_update(w, a, col, sc, p, gvec[0], gvec[1], gvec[2]);
  for (int t = 0; t < T; ++t) {
    const size_t ow = (((size_t)b * T + t) * 2) * R + r, oa = ow + R;
    out[ow] = __fadd_rn(w[t], __fmul_rn(c3, z[ow]));
    out[oa] = __fadd_rn(a[t], __fmul_rn(c3, z[oa]));
  }
}

template <class WP>
static int launch(const float* x, const float* z, const Mlp& m,
                  const float* lanes, const float* ndx, const float* ndy,
                  const float* crad, const float* cvalid, const float* stlp,
                  const float* nf, const float* valid, const float* scal,
                  const float* gvec, float* out, const Params& p, int hmax,
                  int guided, size_t smem, cudaStream_t stream) {
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        superstep_kernel<WP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  dim3 grid((p.R + BLOCK - 1) / BLOCK, p.bs);
  superstep_kernel<WP><<<grid, SS_THREADS, smem, stream>>>(
      x, z, m, lanes, ndx, ndy, crad, cvalid, stlp, nf, valid, scal, gvec,
      out, p, hmax, guided);
  return (int)cudaGetLastError();
}

// x, z, out: (bs, T, 2, R) fp32.  base, te and the weights in the compute
// dtype (bf16 when `bf16`, else fp32), row-major as listed in Mlp; midW,
// midb and dims are host arrays of nmid, nmid and nmid + 1 entries.  gvec:
// 8 fp32 on the device, [beta, thres, gscale, c1, c2, c3, 0, 0].
extern "C" int pstl_superstep(
    const float* x, const float* z, const void* base, const void* te,
    const void* WnwT, const void* WnaT, const void* const* midW,
    const void* const* midb, const int* dims, int nmid, const void* WowT,
    const void* WoaT, const void* bow, const void* boa, const float* lanes,
    const float* ndx, const float* ndy, const float* crad,
    const float* cvalid, const float* stlp, const float* nf,
    const float* valid, const float* scal, const float* gvec, float* out,
    int bs, int T, int R, int M, int S, int K, int nLe, int nLn, int nt2,
    int niters, float tau, float dt, float mul_w, float mul_a, float lr,
    double ego_L, double re, int flags, int bf16, int guided,
    void* stream) {
  Params p;
  if (!fill_params(p, bs, T, R, M, S, K, nLe, nLn, nt2, niters, tau, dt,
                   mul_w, mul_a, lr, ego_L, re, flags))
    return (int)cudaErrorInvalidValue;
  if (nmid < 0 || nmid > MAXMID) return (int)cudaErrorInvalidValue;
  Mlp m;
  m.base = base; m.te = te; m.WnwT = WnwT; m.WnaT = WnaT;
  m.WowT = WowT; m.WoaT = WoaT; m.bow = bow; m.boa = boa; m.nmid = nmid;
  int hmax = 0;
  for (int i = 0; i <= nmid; ++i) {
    if (dims[i] < 1 || dims[i] > MAXH) return (int)cudaErrorInvalidValue;
    m.dims[i] = dims[i];
    hmax = dims[i] > hmax ? dims[i] : hmax;
  }
  for (int i = 0; i < MAXMID; ++i) {
    m.W[i] = i < nmid ? midW[i] : nullptr;
    m.b[i] = i < nmid ? midb[i] : nullptr;
  }
  const size_t smem = sizeof(float)
      * ((guided ? scene_floats(p) : 0) + 4 * (size_t)T * BLOCK
         + 2 * (size_t)hmax * BLOCK);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<BF16W>(x, z, m, lanes, ndx, ndy, crad, cvalid, stlp,
                              nf, valid, scal, gvec, out, p, hmax, guided,
                              smem, s)
              : launch<F32W>(x, z, m, lanes, ndx, ndy, crad, cvalid, stlp,
                             nf, valid, scal, gvec, out, p, hmax, guided,
                             smem, s);
}
