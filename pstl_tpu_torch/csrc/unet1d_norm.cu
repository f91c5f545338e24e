// The activation pass between two convolutions of ConditionalUnet1D (the
// eps network of models/unet1d.py), on channels-last activations, for Hopper
// (sm_90a).  One entry, pstl_unet1d_norm, takes a Conv1dBlock's convolution
// output y (n, L, C) in the compute dtype T (bf16 on the main path, or fp32)
// and writes the next convolution's input:
//
//   v   = y + bias[c]                                  (fp32)
//   per row and group of C / G channels over all L positions:
//   mu  = sum(v) / (L C/G),  var = sum((v - mu)^2) / (L C/G)
//   a   = gamma[c] / sqrt(var + eps),  u = y a + ((bias[c] - mu) a + beta[c])
//                                                      GroupNorm
//   m   = u tanh(log(1 + e^u))                         Mish (see mish())
//   out = s[r, c] * m + b[r, c]   FiLM, s = film[r, :C], b = film[r, C:]
//       | m + film[r, c]          FiLM without the scale
//       | m + res32[r, l, c]      the residual stream (an identity residual)
//       | m + (res[r, l, c] + res_bias[c])   a 1x1 residual convolution's
//       | m                       (the final block)
//
// stored as T, and, where the next residual block reads it as its identity
// input, also as fp32 (out32).  It replaces no TPU kernel: the JAX package
// has no U-Net.  It replaces, on the card, a cast to fp32, PyTorch's
// GroupNorm (statistics and normalization), Mish, the FiLM or residual sum
// and the cast back, each a pass over the activations, and it reads and
// writes the layout (n, L, C) in which cuDNN's NHWC convolutions take and
// give them, so that no transpose sits between two convolutions.
//
// What bounds it on the H100: bytes.  At the main shapes a row is at most
// L C = 5,120 elements (10 KB in bf16); the arithmetic is ~40 operations an
// element (one expf and one division among them), below the ~20 a byte that
// the CUDA cores' 67 TFLOP/s allow.  A U-Net pass at 3,072 rows runs it 25
// times over 330 M elements: 1.32 GB of bf16 in and out, plus the FiLM, the
// residual reads and the fp32 stream writes, 2.29 GB, 0.68 ms at 3.35 TB/s.
//
// Design.  One block takes one row (one sample): its GroupNorm statistics
// are then the block's own, with no second pass over memory and no atomics,
// so the result is the same to the bit on every run, as a captured graph's
// replay must be.  A thread owns one 16-byte vector of channels (8 bf16 or
// 4 fp32; a group is C / G channels, a multiple of 8, so a vector lies in
// one group) at the positions l0, l0 + P, ...: the block has VC * P threads
// for VC = C / vector vectors a position and P positions a pass, P chosen by
// the wrapper (ops/unet1d_norm.py) so that a block has about UN_THREADS
// threads.  The row is copied once into shared memory with cp.async (no
// registers held while the loads are in flight; a thread reads back only
// the vectors it copied, conflict-free), so a block keeps few registers
// (UN_MINB blocks of UN_MAXB threads an SM) and many rows of an SM are in
// flight at once, in different phases.  The group sums are per-thread
// partial sums, reduced in a fixed order through shared memory by one thread
// a group; the mean is taken first, then the sum of squared deviations
// around it; the last pass reads the per-row FiLM once and the residual per
// vector, and writes 16-byte vectors.  A thread's per-channel terms (the
// folded scale and shift, the FiLM pair kept packed) stay in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define UN_THREADS 128
#define UN_MAXB 512
#define UN_MINB 2
#define UN_MAXG 32
#define UN_SMEM_MAX 49152

namespace {

template <typename T>
struct Pack;

// 16 bytes of T: N elements, kept as a uint4 (4 registers) and unpacked to
// float where used.
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <typename T>
__device__ uint4 raw(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T>
__device__ void load(const T* p, float* v) {
  Pack<T>::unpack(raw(p), v);
}

// N floats (a multiple of 4) from / to fp32 memory, 16 bytes at a time.
template <int N>
__device__ void load_f32(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4) load(p + i, v + i);
}

template <int N>
__device__ void store_f32(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4) Pack<float>::store(p + i, v + i);
}

__device__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// The sum over each group of the threads' partial sums s, in a fixed order
// (positions slot by slot, then the group's vectors): dst[g] for g < G.
// Thread t owns vector t % VC of positions t / VC + k P, so group g's
// threads are q VC + g GV + i for q < P, i < GV.
__device__ void group_sums(float s, float* part, float* dst, int VC, int P,
                           int GV, int G) {
  const int t = threadIdx.x;
  part[t] = s;
  __syncthreads();
  if (t < G) {
    float a = 0.f;
    for (int q = 0; q < P; ++q)
      for (int i = 0; i < GV; ++i) a += part[q * VC + t * GV + i];
    dst[t] = a;
  }
  __syncthreads();
}

// Mish, u tanh(softplus(u)), as u n / (n + 2) with n = e^u (e^u + 2)
// (tanh(log(1 + e^u)) written out): one expf and one division, where
// tanhf(log1pf(expf(u))) costs about a hundred instructions an element.
// Above u = 20, n / (n + 2) is 1 in fp32 (and n would overflow above 44):
// Mish is u there.
__device__ float mish(float u) {
  if (u > 20.f) return u;
  const float e = expf(u);
  const float n = e * (e + 2.f);
  return u * (n / (n + 2.f));
}

template <typename T>
__global__ void __launch_bounds__(UN_MAXB, UN_MINB)
    norm_mish_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const T* __restrict__ film, int film_scale,
                     const float* __restrict__ res32,
                     const T* __restrict__ res, const T* __restrict__ res_bias,
                     T* __restrict__ out, float* __restrict__ out32, int L,
                     int C, int G, float eps) {
  constexpr int N = Pack<T>::N;
  extern __shared__ uint4 row[];  // (L, VC) vectors
  __shared__ float part[UN_MAXB];
  __shared__ float stat[2 * UN_MAXG];
  const int VC = C / N;
  const int B = blockDim.x;
  const int P = B / VC;
  const int GV = C / G / N;
  const int t = threadIdx.x;
  const int c0 = (t % VC) * N;
  const int g = c0 / (C / G);
  const int nv = L * VC;  // the row's vectors; thread t owns t, t + B, ...
  const float count = (float)(L * (C / G));
  const long long base = (long long)blockIdx.x * L * C;
  const T* yr = y + base;

  for (int k = t; k < nv; k += B) cp_async16(&row[k], yr + (long long)k * N);
  asm volatile("cp.async.wait_all;\n" ::);

  float b[N], v[N];
  load(bias + c0, b);
  float s = 0.f;
  for (int k = t; k < nv; k += B) {
    Pack<T>::unpack(row[k], v);
#pragma unroll
    for (int i = 0; i < N; ++i) s += v[i] + b[i];
  }
  group_sums(s, part, stat, VC, P, GV, G);
  const float mean = stat[g] / count;
  float ss = 0.f;
  for (int k = t; k < nv; k += B) {
    Pack<T>::unpack(row[k], v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float d = (v[i] + b[i]) - mean;
      ss += d * d;
    }
  }
  group_sums(ss, part, stat + UN_MAXG, VC, P, GV, G);
  const float rstd = 1.f / sqrtf(stat[UN_MAXG + g] / count + eps);

  // u = y a + sh: GroupNorm's scale a and shift sh with the bias folded in
  float a[N], sh[N];
  load_f32<N>(gamma + c0, a);
  load_f32<N>(beta + c0, sh);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i] *= rstd;
    sh[i] += (b[i] - mean) * a[i];
  }
  uint4 f0 = make_uint4(0, 0, 0, 0), f1 = f0;  // FiLM (or res_bias), packed
  if (film != nullptr) {
    const T* f = film + (long long)blockIdx.x * (film_scale ? 2 * C : C) + c0;
    f0 = raw(f);
    if (film_scale) f1 = raw(f + C);
  } else if (res != nullptr) {
    f1 = raw(res_bias + c0);
  }
#pragma unroll 2
  for (int k = t; k < nv; k += B) {
    const long long off = base + (long long)k * N;
    float r[N], fa[N], fb[N], o[N];
    if (res32 != nullptr) {
      load_f32<N>(res32 + off, r);
    } else if (res != nullptr) {
      load(res + off, r);
    }
    Pack<T>::unpack(row[k], v);
    Pack<T>::unpack(f0, fa);
    Pack<T>::unpack(f1, fb);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float m = mish(v[i] * a[i] + sh[i]);
      if (film != nullptr) {
        o[i] = film_scale ? fa[i] * m + fb[i] : m + fa[i];
      } else if (res32 != nullptr) {
        o[i] = m + r[i];
      } else if (res != nullptr) {
        o[i] = m + (r[i] + fb[i]);
      } else {
        o[i] = m;
      }
    }
    Pack<T>::store(out + off, o);
    if (out32 != nullptr) store_f32<N>(out32 + off, o);
  }
}

}  // namespace

// dtype 0: T = bf16, 1: T = fp32.  film, res32, res (with res_bias) and out32
// may each be null; at most one of film, res32 and res is given.  threads =
// VC * P as ops/unet1d_norm.py computes it; the geometry is checked here
// too, so that a wrong one is refused, not run.
extern "C" int pstl_unet1d_norm(int dtype, const void* y, const void* bias,
                                const float* gamma, const float* beta,
                                const void* film, int film_scale,
                                const float* res32, const void* res,
                                const void* res_bias, void* out, float* out32,
                                int n, int L, int C, int G, float eps,
                                int threads, void* stream) {
  const int N = dtype == 0 ? 8 : 4;
  const long long smem = (long long)L * C * (dtype == 0 ? 2 : 4);
  if ((dtype != 0 && dtype != 1) || n < 0 || L < 1 || G < 1 || G > UN_MAXG ||
      C % G != 0 || (C / G) % 8 != 0 || threads < 1 || threads > UN_MAXB ||
      threads % (C / N) != 0 || smem > UN_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    norm_mish_kernel<__nv_bfloat16><<<n, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(y),
        static_cast<const __nv_bfloat16*>(bias), gamma, beta,
        static_cast<const __nv_bfloat16*>(film), film_scale, res32,
        static_cast<const __nv_bfloat16*>(res),
        static_cast<const __nv_bfloat16*>(res_bias),
        static_cast<__nv_bfloat16*>(out), out32, L, C, G, eps);
  else
    norm_mish_kernel<float><<<n, threads, smem, s>>>(
        static_cast<const float*>(y), static_cast<const float*>(bias), gamma,
        beta, static_cast<const float*>(film), film_scale, res32,
        static_cast<const float*>(res), static_cast<const float*>(res_bias),
        static_cast<float*>(out), out32, L, C, G, eps);
  return (int)cudaGetLastError();
}
