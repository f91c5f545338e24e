// STL-guidance step on frozen payloads for Hopper (sm_90a): `niters` Adam
// steps on the hinge loss sum_r relu(thres - score_r) * valid_r * gscale,
// each followed by the beta_t trust-region clip, with the discrete
// selections (lane segment per t, disc pair per (k, t)) frozen outside the
// kernel by CandMinorGuidanceLoss.freeze_cm and read as values.
//
// Replaces the Pallas TPU kernel `_kernel` in pstl_tpu/ops/pallas_guidance.py
// (:367, entry `guidance_adam_cm(fuse_freeze=False)`), and, through the same
// launch, its scene-folded variant `_kernel_f` (:435, `guidance_pallas_fold`):
// folding every scene into (T, bs*R) lane tiles widens the TPU's vector ops,
// while each column's loss stays its own, so this grid of (scene, 32-column)
// blocks computes the same thing.  The forward, the hand-written backward and
// the Adam loop are the device code of guidance_device.cuh (adam_clip with
// the PaySel selection policy), the copy csrc/guidance_fused.cu runs with
// IdxSel after its in-kernel freeze.
//
// Design.  One thread per candidate column r, one block per (scene, chunk of
// 32 columns).  The scene's disc radii and validity (2 x K x T floats) sit
// in shared memory; the ten payloads of the column are read from device
// memory where the loop needs them, r minor so that a warp's 32 loads of one
// (t) or (k, t) are one coalesced 128-byte line.  They are read again in
// every Adam iteration rather than staged in local arrays: staging 3 x K x T
// floats per thread would be 1.9 KB of local memory per column, which is the
// same memory path with no reuse across threads.
//
// What bounds it on the H100: per launch it reads 7 x bs*T*R + 3 x bs*K*T*R
// floats of payload (7.6 MB at the main shapes, bs=16, T=20, R=192, K=8),
// once per Adam iteration (3 x, mostly from L2, which holds 50 MB), and a
// few MB of the rest: a few microseconds of HBM time at 3.35 TB/s.  As in
// guidance_fused.cu, the kernel has bs*R threads (3072: 96 one-warp blocks
// on 132 SMs), each a long dependent chain of transcendentals with its
// per-t arrays in local memory, so it is latency-bound.  Later work: more
// threads per column (split the K clearance loop), registers in place of
// local arrays, CUDA graphs over the sampler loop.

#include "guidance_device.cuh"

struct Payloads {
  const float* lane[7];  // x2 y2 th2 x3 y3 first last, each (bs, T, R)
  const float* clr[3];   // axe nx ny, each (bs, K, T, R)
};

__global__ void guidance_frozen_kernel(
    const float* __restrict__ muw, const float* __restrict__ mua,
    Payloads pay, const float* __restrict__ crad,
    const float* __restrict__ cvalid, const float* __restrict__ stlp,
    const float* __restrict__ nf, const float* __restrict__ valid,
    const float* __restrict__ scal, const float* __restrict__ gvec,
    float* __restrict__ outw, float* __restrict__ outa, Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int T = p.T, R = p.R;
  Scene sc = load_clear(smem, crad, cvalid, b, p);
  __syncthreads();
  if (r >= R) return;

  Column col = load_column(stlp, nf, valid, scal, b, r, p);
  PaySel sel;
  for (int i = 0; i < 7; ++i)
    sel.lane_pay[i] = pay.lane[i] + (size_t)b * T * R + r;
  for (int i = 0; i < 3; ++i)
    sel.disc_pay[i] = pay.clr[i] + (size_t)b * p.K * T * R + r;
  sel.R = R;
  float w[MAXT], a[MAXT];
  for (int t = 0; t < T; ++t) {
    size_t o = ((size_t)b * T + t) * R + r;
    w[t] = muw[o];
    a[t] = mua[o];
  }
  adam_clip(w, a, col, sc, sel, p, gvec[0], gvec[1], gvec[2]);
  for (int t = 0; t < T; ++t) {
    size_t o = ((size_t)b * T + t) * R + r;
    outw[o] = w[t];
    outa[o] = a[t];
  }
}

// muw, mua, the seven lane payloads, outw, outa: (bs, T, R) fp32; the three
// disc payloads (bs, K, T, R); crad, cvalid (bs, K, T); stlp (bs, 6, R); nf
// (bs, 3, R); valid (bs, R); scal (bs, 2); gvec 3 fp32 on the device,
// [beta, thres, gscale].  Returns the CUDA error of the launch.
extern "C" int pstl_guidance_frozen(
    const float* muw, const float* mua, const float* x2, const float* y2,
    const float* th2, const float* x3, const float* y3, const float* first,
    const float* last, const float* axe, const float* nx, const float* ny,
    const float* crad, const float* cvalid, const float* stlp,
    const float* nf, const float* valid, const float* scal,
    const float* gvec, float* outw, float* outa, int bs, int T, int R, int M,
    int S, int K, int nLe, int nLn, int nt2, int niters, float tau, float dt,
    float mul_w, float mul_a, float lr, double ego_L, double re, int flags,
    void* stream) {
  Params p;
  if (!fill_params(p, bs, T, R, M, S, K, nLe, nLn, nt2, niters, tau, dt,
                   mul_w, mul_a, lr, ego_L, re, flags))
    return (int)cudaErrorInvalidValue;
  Payloads pay{{x2, y2, th2, x3, y3, first, last}, {axe, nx, ny}};
  size_t smem = sizeof(float) * 2 * (size_t)K * T;
  dim3 grid((R + BLOCK - 1) / BLOCK, bs);
  guidance_frozen_kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
      muw, mua, pay, crad, cvalid, stlp, nf, valid, scal, gvec, outw, outa,
      p);
  return (int)cudaGetLastError();
}
