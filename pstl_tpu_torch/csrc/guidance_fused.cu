// Fused STL-guidance step for Hopper (sm_90a): in-kernel freeze of the
// discrete selections at the posterior mean, then `niters` Adam steps on
// the hinge loss sum_r relu(thres - score_r) * valid_r * gscale, each
// followed by the beta_t trust-region clip.
//
// Replaces the Pallas TPU kernel `_kernel_fused` in
// pstl_tpu/ops/pallas_guidance.py (entry `guidance_adam_cm(fuse_freeze=True)`),
// and, through the same launch, `_kernel_fused_f2` (`guidance_pallas_fold2`):
// that kernel's column-chunk grid with the scene constants broadcast inside
// the kernel is what this grid of (scene, 32-column) blocks with the scene
// constants in shared memory already does.  The device code (freeze, the
// hand-written forward and backward, the Adam loop) lives in
// guidance_device.cuh, shared with csrc/superstep.cu.
//
// Design.  One thread per candidate column r (a column's work is a serial
// program: a T-step rollout, where-chain argmins, a forward and a backward
// pass, an Adam loop), one block per (scene, chunk of 32 columns).  The
// scene's lanes, neighbor disc centres, radii and validity (about 7 KB at
// T=20, K=8, nL=4, S=15) sit in shared memory; the freeze is kept as small
// indices (one segment per t, one (ego disc, neighbor disc) pair per (k, t))
// that index shared memory, instead of hundreds of frozen floats per column.
//
// What bounds it on the H100: neither bytes nor FLOPs.  Per launch it reads
// and writes under 1 MB and does about 10 MFLOP per scene-batch, but it has
// only bs*R threads (3072 on the main path: 96 blocks of one warp on 132 SMs)
// and each runs a long dependent chain of transcendentals, with its per-t
// arrays in local memory.  It is latency-bound; the first version keeps the
// code simple and correct.  Later work: more threads per column (split the
// K clearance loop), registers instead of local arrays, CUDA graphs over
// the 99-step sampler loop.

#include "guidance_device.cuh"

__global__ void guidance_fused_kernel(
    const float* __restrict__ muw, const float* __restrict__ mua,
    const float* __restrict__ lanes, const float* __restrict__ ndx,
    const float* __restrict__ ndy, const float* __restrict__ crad,
    const float* __restrict__ cvalid, const float* __restrict__ stlp,
    const float* __restrict__ nf, const float* __restrict__ valid,
    const float* __restrict__ scal, const float* __restrict__ gvec,
    float* __restrict__ outw, float* __restrict__ outa, Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int T = p.T, R = p.R;
  Scene sc = load_scene(smem, lanes, ndx, ndy, crad, cvalid, b, p);
  __syncthreads();
  if (r >= R) return;

  Column col = load_column(stlp, nf, valid, scal, b, r, p);
  float w[MAXT], a[MAXT];
  for (int t = 0; t < T; ++t) {
    size_t o = ((size_t)b * T + t) * R + r;
    w[t] = muw[o];
    a[t] = mua[o];
  }
  guided_update(w, a, col, sc, p, gvec[0], gvec[1], gvec[2]);
  for (int t = 0; t < T; ++t) {
    size_t o = ((size_t)b * T + t) * R + r;
    outw[o] = w[t];
    outa[o] = a[t];
  }
}

extern "C" int pstl_guidance_fused(
    const float* muw, const float* mua, const float* lanes, const float* ndx,
    const float* ndy, const float* crad, const float* cvalid,
    const float* stlp, const float* nf, const float* valid,
    const float* scal, const float* gvec, float* outw, float* outa, int bs,
    int T, int R, int M, int S, int K, int nLe, int nLn, int nt2, int niters,
    float tau, float dt, float mul_w, float mul_a, float lr, double ego_L,
    double re, int flags, void* stream) {
  Params p;
  if (!fill_params(p, bs, T, R, M, S, K, nLe, nLn, nt2, niters, tau, dt,
                   mul_w, mul_a, lr, ego_L, re, flags))
    return (int)cudaErrorInvalidValue;
  size_t smem = sizeof(float) * scene_floats(p);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid((R + BLOCK - 1) / BLOCK, bs);
  guidance_fused_kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
      muw, mua, lanes, ndx, ndy, crad, cvalid, stlp, nf, valid, scal, gvec,
      outw, outa, p);
  return (int)cudaGetLastError();
}
