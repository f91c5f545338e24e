// Fused STL-guidance step for Hopper (sm_90a): in-kernel freeze of the
// discrete selections at the posterior mean, then `niters` Adam steps on
// the hinge loss sum_r relu(thres - score_r) * valid_r * gscale, each
// followed by the beta_t trust-region clip.
//
// Replaces the Pallas TPU kernel `_kernel_fused` in
// pstl_tpu/ops/pallas_guidance.py (entry `guidance_adam_cm(fuse_freeze=True)`),
// and, through the same launch, `_kernel_fused_f2` (`guidance_pallas_fold2`)
// and `_kernel_fused_f` (`guidance_pallas_fold`): those kernels' column-chunk
// grid or scene fold with the scene constants broadcast inside the kernel is
// what this grid of (scene, column chunk) blocks with the scene constants in
// shared memory already does.  The device code (freeze, the hand-written
// forward and backward, the Adam loop) lives in guidance_device.cuh, shared
// with csrc/superstep.cu.
//
// What bounds it on the H100: neither bytes nor operations.  Per launch it
// reads and writes under 1 MB and does about 160 M fp32 operations, a few
// microseconds of either; the time is the latency of one column's dependent
// chain (a freeze, then three forward and backward passes, each a rollout
// with cosf / sinf, K clearances with sqrtf, softmins with expf / logf) and
// how many such chains the card runs at once.
//
// Design.  One WARP per candidate column, lane = time step (see the header):
// the bs*R = 3072 columns of the main path are 3072 warps, about 23 on each
// of the 132 SMs.  They must all be resident at once, or the launch takes a
// second wave of whole chains: a block is GF_WARPS = 8 warps on GF_COLS = 8
// consecutive columns of one scene, and GF_MINB = 3 blocks an SM caps a
// thread at 80 registers (ptxas then spills about 140 bytes a thread, which
// stay in L1).  Uncapped (127 registers, 16 warps an SM, two waves) the
// launch takes 1.4x as long; 64 registers spill too much; 16 columns on 8
// warps run two chains in turn (scripts/geometry_sweep.py measures these).
// The scene's lanes, neighbor disc centres, radii, validity and the ego disc
// offsets (about 7 KB at T=20, K=8, nL=4, S=15) sit in shared memory, loaded
// once per block.  muw / mua / out are r-minor, so a warp's own loads of one
// column would be T strided sectors: the block stages its (T, GF_COLS) tile
// through shared memory with row-contiguous loads and stores instead.  The
// freeze is kept as one segment index and two 64-bit words of 4-bit disc
// indices per lane, not as frozen floats.  What is left of the time is the
// chain itself, with its precise divisions and sqrtf.

#include "guidance_device.cuh"

#define GF_WARPS 8   // warps a block
#define GF_COLS 8    // candidate columns a block
#define GF_MINB 3   // blocks an SM must hold: 80 registers a thread
#define GF_TS (MAXT + 1)  // tile row stride: lanes of a column hit 32 banks

__global__ void __launch_bounds__(GF_WARPS * 32, GF_MINB)
guidance_fused_kernel(
    const float* __restrict__ muw, const float* __restrict__ mua,
    const float* __restrict__ lanes, const float* __restrict__ ndx,
    const float* __restrict__ ndy, const float* __restrict__ crad,
    const float* __restrict__ cvalid, const float* __restrict__ stlp,
    const float* __restrict__ nf, const float* __restrict__ valid,
    const float* __restrict__ scal, const float* __restrict__ gvec,
    float* __restrict__ outw, float* __restrict__ outa, Params p) {
  extern __shared__ float smem[];
  __shared__ float tile[2][GF_COLS][GF_TS];  // [w|a][column][t]
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * GF_COLS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int T = p.T, R = p.R;
  Scene sc = load_scene(smem, lanes, ndx, ndy, crad, cvalid, b, p);
  for (int i = threadIdx.x; i < T * GF_COLS; i += blockDim.x) {
    const int c = i % GF_COLS, t = i / GF_COLS;
    const size_t o = ((size_t)b * T + t) * R + r0 + c;
    const bool in = r0 + c < R;
    tile[0][c][t] = in ? muw[o] : 0.f;
    tile[1][c][t] = in ? mua[o] : 0.f;
  }
  __syncthreads();

  const float beta = gvec[0], thres = gvec[1], gscale = gvec[2];
  for (int c = warp; c < GF_COLS; c += GF_WARPS) {
    const int r = r0 + c;
    if (r >= R) continue;  // the whole warp skips a dead column
    const Column col = load_column(stlp, nf, valid, scal, b, r, p);
    float w = lane < T ? tile[0][c][lane] : 0.f;
    float a = lane < T ? tile[1][c][lane] : 0.f;
    guided_update(w, a, col, sc, p, lane, beta, thres, gscale);
    if (lane < T) {
      tile[0][c][lane] = w;
      tile[1][c][lane] = a;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < T * GF_COLS; i += blockDim.x) {
    const int c = i % GF_COLS, t = i / GF_COLS;
    if (r0 + c >= R) continue;
    const size_t o = ((size_t)b * T + t) * R + r0 + c;
    outw[o] = tile[0][c][t];
    outa[o] = tile[1][c][t];
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
  if (smem + sizeof(float) * 2 * GF_COLS * GF_TS > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  dim3 grid((R + GF_COLS - 1) / GF_COLS, bs);
  guidance_fused_kernel<<<grid, GF_WARPS * 32, smem, (cudaStream_t)stream>>>(
      muw, mua, lanes, ndx, ndy, crad, cvalid, stlp, nf, valid, scal, gvec,
      outw, outa, p);
  return (int)cudaGetLastError();
}
