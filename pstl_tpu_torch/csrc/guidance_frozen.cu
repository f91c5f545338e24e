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
// while each column's loss stays its own, so this grid of (scene, column
// chunk) blocks computes the same thing.  The forward, the hand-written
// backward and the Adam loop are the device code of guidance_device.cuh
// (adam_clip with the PaySel selection policy), the copy
// csrc/guidance_fused.cu runs with IdxSel after its in-kernel freeze.
//
// Design.  It moved with the fused kernel to the shared device code's new
// shape: one WARP per candidate column, lane = time step (see the header),
// a block of GZ_WARPS = 8 warps on GZ_COLS = 8 consecutive columns of one
// scene, GZ_MINB = 3 blocks an SM (80 registers a thread, so that all 3072
// warps of the main path are resident at once, as in guidance_fused.cu).  The
// scene's disc radii and validity (2 x K x T floats) sit in shared memory.
// The column's controls pass through a shared-memory tile as in
// guidance_fused.cu.  The seven lane payloads of a lane's step are read once
// into registers; the three disc payloads per (k, t) are read from device
// memory in every Adam iteration (K x 3 values a lane would not fit in
// registers without a run-time index).
//
// What bounds it on the H100: per launch it reads 7 x bs*T*R + 3 x bs*K*T*R
// floats of payload (7.6 MB at the main shapes, bs=16, T=20, R=192, K=8),
// the disc part once per Adam iteration (3 x, mostly from L2), and a few MB
// of the rest: a few microseconds of HBM time at 3.35 TB/s.  The payloads
// are r-minor (the layout `freeze_cm` makes and the TPU kernel wants), so a
// warp's load of one (k) is T sectors of which it uses 4 bytes each: the
// neighboring columns' warps of the block use the rest from L1.  The kernel
// is bound by the latency of a column's chain and these strided loads, not
// by bytes or operations.  A layout of its own for the payloads (t minor,
// or staged per block) is this kernel's open design question.

#include "guidance_device.cuh"

struct Payloads {
  const float* lane[7];  // x2 y2 th2 x3 y3 first last, each (bs, T, R)
  const float* clr[3];   // axe nx ny, each (bs, K, T, R)
};

#define GZ_WARPS 8   // warps a block
#define GZ_COLS 8    // candidate columns a block
#define GZ_MINB 3   // blocks an SM must hold: 80 registers a thread
#define GZ_TS (MAXT + 1)  // tile row stride: lanes of a column hit 32 banks

__global__ void __launch_bounds__(GZ_WARPS * 32, GZ_MINB)
guidance_frozen_kernel(
    const float* __restrict__ muw, const float* __restrict__ mua,
    Payloads pay, const float* __restrict__ crad,
    const float* __restrict__ cvalid, const float* __restrict__ stlp,
    const float* __restrict__ nf, const float* __restrict__ valid,
    const float* __restrict__ scal, const float* __restrict__ gvec,
    float* __restrict__ outw, float* __restrict__ outa, Params p) {
  extern __shared__ float smem[];
  __shared__ float tile[2][GZ_COLS][GZ_TS];  // [w|a][column][t]
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * GZ_COLS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int T = p.T, R = p.R;
  Scene sc = load_clear(smem, crad, cvalid, b, p);
  for (int i = threadIdx.x; i < T * GZ_COLS; i += blockDim.x) {
    const int c = i % GZ_COLS, t = i / GZ_COLS;
    const size_t o = ((size_t)b * T + t) * R + r0 + c;
    const bool in = r0 + c < R;
    tile[0][c][t] = in ? muw[o] : 0.f;
    tile[1][c][t] = in ? mua[o] : 0.f;
  }
  __syncthreads();

  const float beta = gvec[0], thres = gvec[1], gscale = gvec[2];
  for (int c = warp; c < GZ_COLS; c += GZ_WARPS) {
    const int r = r0 + c;
    if (r >= R) continue;  // the whole warp skips a dead column
    const Column col = load_column(stlp, nf, valid, scal, b, r, p);
    PaySel sel;
    for (int i = 0; i < 7; ++i)
      sel.lane_pay[i] = pay.lane[i] + (size_t)b * T * R + r;
    for (int i = 0; i < 3; ++i)
      sel.disc_pay[i] = pay.clr[i] + (size_t)b * p.K * T * R + r;
    sel.R = R;
    float w = lane < T ? tile[0][c][lane] : 0.f;
    float a = lane < T ? tile[1][c][lane] : 0.f;
    adam_clip(w, a, col, sc, sel, p, lane, beta, thres, gscale);
    if (lane < T) {
      tile[0][c][lane] = w;
      tile[1][c][lane] = a;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < T * GZ_COLS; i += blockDim.x) {
    const int c = i % GZ_COLS, t = i / GZ_COLS;
    if (r0 + c >= R) continue;
    const size_t o = ((size_t)b * T + t) * R + r0 + c;
    outw[o] = tile[0][c][t];
    outa[o] = tile[1][c][t];
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
  dim3 grid((R + GZ_COLS - 1) / GZ_COLS, bs);
  guidance_frozen_kernel<<<grid, GZ_WARPS * 32, smem, (cudaStream_t)stream>>>(
      muw, mua, pay, crad, cvalid, stlp, nf, valid, scal, gvec, outw, outa,
      p);
  return (int)cudaGetLastError();
}
