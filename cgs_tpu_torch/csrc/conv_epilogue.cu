// Convolution epilogue, NHWC: bias, activation and, where the block has
// one, the 2x2 max-pool, in one pass over a convolution's output.
//
//   out[n, y, x, c] = max over the pool window of a(y_in + bias[c])
//
// y_in (N, H, W, C) NHWC (a channels_last convolution output seen through
// permute(0, 2, 3, 1)), f32 or bf16; out (N, H/p, W/p, C), p = 1 or 2,
// NHWC, in y_in's type or f32. a is the identity, ReLU, LeakyReLU (slope
// given) or the sigmoid.
//
// Replaces no Pallas kernel: on the TPU, XLA fused these epilogues into
// the convolution (cgs_tpu/models/critic.py, cgs_tpu/models/decoder.py),
// so the JAX package never wrote one. On CUDA, `aten::_convolution` calls
// cuDNN without the bias and then runs `output.add_(bias)`; on a
// channels_last tensor that add broadcasts over N, H and W and takes a
// non-vectorised elementwise kernel. The ReLU and the LeakyReLU are a
// pass each, and `MaxPool2d(2)` reads the activation once more and
// writes int64 indices beside its output, which an eval forward never
// reads. The critic's first block moves its 64x64 output five times that
// way, about 23 B an element where 5 B do (read once, write a quarter).
//
// Bound on an H100 SXM: bytes. Each input element is read once and each
// output element written once; the arithmetic (an add, an activation,
// three compares) is far below the card's rate. The chfak-5 critic's
// first block at batch 8192 in f32 reads 5.37 GB and writes 1.34 GB:
// 2.00 ms at 3.35 TB/s.
//
// Design. A thread owns one output pixel by one 16-byte channel vector
// (4 f32 or 8 bf16 channels) and keeps that vector's bias in registers:
// a block is `ppb` pixels by the C/V vectors of a pixel, so each thread
// keeps one channel vector if it strides over pixels. Loads and stores
// are 16 bytes (two stores where a bf16 input gives an f32 output); with
// the pool, a thread's four loads are its window's four pixels, and the
// warp's loads of each row together cover a contiguous range. Nothing
// else is written: no indices, no intermediate. The loads take the
// read-only path (`__ldg`), the stores are streaming (`__stcs`), and the
// grid covers the tensor at one step a thread: on an H100 at the main
// path's shapes (batch 8192) that reads 86-92% of the byte bound, where
// evict-first loads (`__ldcs`) over a grid of 16 blocks an SM read
// 71-80%, and more pixels a thread changed nothing. C that is no
// multiple of the vector width (C = 1: the mask head's last convolution,
// whose whole pass moves 4% of the first block's bytes) goes one element
// per thread, with coalesced 2- or 4-byte loads; so do buffers that are
// not 16-byte aligned.
//
// Bit-equality with the eager chain. The sum is taken in f32 and rounded
// to the input's type, as `add_` on a tensor of that type does (the
// bias arrives in that type, as autocast casts it). The activation runs
// in f32 on that value and is rounded to the output's type, as ATen's
// activations do with their f32 arithmetic: ReLU is `max(v, 0)` with a
// NaN passed through, LeakyReLU `v > 0 ? v : v * slope`, the sigmoid
// `1 / (1 + expf(-v))`, built without fast-math, as ATen's is. The pool
// keeps the first of its window's values, in row order, that is greater
// than all before it or NaN, as ATen's `max_pool_forward_nhwc` does, so
// signed zeros and NaNs come out as they would there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Act { kNone = 0, kRelu = 1, kLeaky = 2, kSigmoid = 3 };

// a bf16 element is moved as its 16 bits
using bf16 = uint16_t;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// a(y + b): the sum rounded to E, the activation in f32 rounded to O
template <typename E, typename O, int ACT>
__device__ __forceinline__ float epilogue(E y, float b, float slope) {
  const float s = to_f(from_f<E>(__fadd_rn(to_f(y), b)));
  float a = s;
  if (ACT == kRelu) a = isnan(s) ? s : fmaxf(s, 0.0f);
  if (ACT == kLeaky) a = s > 0.0f ? s : __fmul_rn(s, slope);
  if (ACT == kSigmoid) a = 1.0f / (1.0f + expf(-s));
  return to_f(from_f<O>(a));
}

// the running max of a pool window, as max_pool_forward_nhwc keeps it
__device__ __forceinline__ float pool_max(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

template <typename T, int V>
union Vec {
  uint4 u[(V * sizeof(T) + 15) / 16];
  T e[V];
};

template <typename O, int V>
__device__ __forceinline__ void store(O* dst, const float* v) {
  Vec<O, V> o;
#pragma unroll
  for (int j = 0; j < V; ++j) o.e[j] = from_f<O>(v[j]);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < (int)(V * sizeof(O) / 16); ++k) __stcs(d + k, o.u[k]);
}

// one output pixel by one channel vector a thread and step; the block is
// ppb pixels by cv vectors
template <typename E, typename O, int ACT, int POOL>
__global__ void __launch_bounds__(kThreads)
    bias_act_pool_vec(const E* __restrict__ y, const E* __restrict__ bias,
                      O* __restrict__ out, int64_t n_pix, int64_t Wo,
                      int64_t C, uint32_t cv, uint32_t ppb, float slope) {
  constexpr int V = 16 / sizeof(E);
  const uint32_t v = threadIdx.x % cv;  // blockDim.x = ppb * cv
  const int64_t c0 = (int64_t)v * V;
  float b[V];
  {
    Vec<E, V> bv;
    bv.u[0] = __ldg(reinterpret_cast<const uint4*>(bias + c0));
#pragma unroll
    for (int j = 0; j < V; ++j) b[j] = to_f(bv.e[j]);
  }
  const int64_t W = Wo * POOL;
  const int64_t off[4] = {0, C, W * C, (W + 1) * C};  // a pool window
  for (int64_t p = (int64_t)blockIdx.x * ppb + threadIdx.x / cv; p < n_pix;
       p += (int64_t)gridDim.x * ppb) {
    int64_t q = p * C + c0;
    if (POOL == 2) {
      // output pixel p = (row, ox), row = n * Ho + oy: its window's
      // top-left input pixel is 2 row * W + 2 ox
      const int64_t row = p / Wo;
      q = (2 * row * W + 2 * (p - row * Wo)) * C + c0;
    }
    Vec<E, V> in[POOL * POOL];
#pragma unroll
    for (int k = 0; k < POOL * POOL; ++k)
      in[k].u[0] = __ldg(reinterpret_cast<const uint4*>(y + q + off[k]));
    float r[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      r[j] = epilogue<E, O, ACT>(in[0].e[j], b[j], slope);
      if (POOL == 2) {  // from -inf, the first value always wins
#pragma unroll
        for (int k = 1; k < 4; ++k)
          r[j] = pool_max(r[j], epilogue<E, O, ACT>(in[k].e[j], b[j], slope));
      }
    }
    store<O, V>(out + p * C + c0, r);
  }
}

// one output element a thread and step: any C, any alignment
template <typename E, typename O, int ACT, int POOL>
__global__ void __launch_bounds__(kThreads)
    bias_act_pool_scalar(const E* __restrict__ y, const E* __restrict__ bias,
                         O* __restrict__ out, int64_t total, int64_t Wo,
                         int64_t C, float slope) {
  const int64_t W = Wo * POOL;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    // C = 1 (the mask head) takes no 64-bit division, which would cost
    // more than the element's bytes
    const int64_t c = C == 1 ? 0 : e % C;
    const float b = to_f(bias[c]);
    if (POOL == 1) {
      out[e] = from_f<O>(epilogue<E, O, ACT>(y[e], b, slope));
      continue;
    }
    const int64_t p = e / C, row = p / Wo;
    const E* src = y + (2 * row * W + 2 * (p - row * Wo)) * C + c;
    const int64_t off[4] = {0, C, W * C, (W + 1) * C};
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      m = pool_max(m, epilogue<E, O, ACT>(src[off[k]], b, slope));
    out[e] = from_f<O>(m);
  }
}

// a grid that covers the work in one step a thread, as far as it can
unsigned grid_for(int64_t items, int64_t per_block) {
  const int64_t want = (items + per_block - 1) / per_block;
  return (unsigned)(want < 0x7fffffff ? want : 0x7fffffff);
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename E, typename O, int ACT, int POOL>
int launch(const void* y_, const void* bias_, void* out_, int64_t N,
           int64_t H, int64_t W, int64_t C, float slope, cudaStream_t s) {
  constexpr int64_t V = 16 / sizeof(E);
  const E* y = static_cast<const E*>(y_);
  const E* bias = static_cast<const E*>(bias_);
  O* out = static_cast<O*>(out_);
  const int64_t Wo = W / POOL, n_pix = N * (H / POOL) * Wo;
  const int64_t cv = C / V;
  if (C % V == 0 && cv <= kThreads && aligned(y) && aligned(bias) &&
      aligned(out)) {
    const int64_t ppb = kThreads / cv;
    bias_act_pool_vec<E, O, ACT, POOL>
        <<<grid_for(n_pix, ppb), (unsigned)(ppb * cv), 0, s>>>(
            y, bias, out, n_pix, Wo, C, (uint32_t)cv, (uint32_t)ppb, slope);
  } else {
    bias_act_pool_scalar<E, O, ACT, POOL>
        <<<grid_for(n_pix * C, kThreads), kThreads, 0, s>>>(
            y, bias, out, n_pix * C, Wo, C, slope);
  }
  return (int)cudaGetLastError();
}

template <typename E, typename O, int ACT>
int by_pool(int64_t pool, const void* y, const void* bias, void* out,
            int64_t N, int64_t H, int64_t W, int64_t C, float slope,
            cudaStream_t s) {
  if (pool == 1) return launch<E, O, ACT, 1>(y, bias, out, N, H, W, C, slope, s);
  if (pool == 2) return launch<E, O, ACT, 2>(y, bias, out, N, H, W, C, slope, s);
  return (int)cudaErrorInvalidValue;
}

template <typename E, typename O>
int by_act(int64_t act, int64_t pool, const void* y, const void* bias,
           void* out, int64_t N, int64_t H, int64_t W, int64_t C,
           float slope, cudaStream_t s) {
  switch (act) {
    case kNone:
      return by_pool<E, O, kNone>(pool, y, bias, out, N, H, W, C, slope, s);
    case kRelu:
      return by_pool<E, O, kRelu>(pool, y, bias, out, N, H, W, C, slope, s);
    case kLeaky:
      return by_pool<E, O, kLeaky>(pool, y, bias, out, N, H, W, C, slope, s);
    case kSigmoid:
      return by_pool<E, O, kSigmoid>(pool, y, bias, out, N, H, W, C, slope,
                                     s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y (N, H, W, C) and bias (C,) in the input type (bf16 when in_bf16),
// out (N, H/pool, W/pool, C) in the output type (bf16 when out_bf16; an
// f32 input takes an f32 output); act: 0 none, 1 ReLU, 2 LeakyReLU of
// `slope`, 3 sigmoid; pool 1 or 2 (H and W even). Returns
// cudaGetLastError() after the launch.
extern "C" int cgs_bias_act_pool(const void* y, const void* bias, void* out,
                                 int64_t N, int64_t H, int64_t W, int64_t C,
                                 int64_t act, int64_t pool, float slope,
                                 int64_t in_bf16, int64_t out_bf16,
                                 void* stream) {
  if (N * H * W * C == 0) return 0;
  if (pool == 2 && (H % 2 || W % 2)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!in_bf16 && !out_bf16)
    return by_act<float, float>(act, pool, y, bias, out, N, H, W, C, slope,
                                s);
  if (in_bf16 && out_bf16)
    return by_act<bf16, bf16>(act, pool, y, bias, out, N, H, W, C, slope, s);
  if (in_bf16)
    return by_act<bf16, float>(act, pool, y, bias, out, N, H, W, C, slope,
                               s);
  return (int)cudaErrorInvalidValue;
}
