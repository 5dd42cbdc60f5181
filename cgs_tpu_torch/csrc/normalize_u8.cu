// uint8 -> float32 ingest: out[i] = float(in[i]) * float32(1/255).
//
// Replaces cgs_tpu/ops/pallas_kernels.py:normalize_u8 (_normalize_kernel).
//
// Bound on an H100 SXM: bytes. Each element reads 1 byte and writes 4,
// so the least time is 5 * numel / 3.35 TB/s (a 8192 x 64x64x3 batch:
// 503 MB, 0.150 ms). The arithmetic (one multiply per element) is
// noise next to that.
//
// Design: each thread reads 16 bytes with one 128-bit load and writes
// 16 floats with four 128-bit stores, so a warp moves 512 contiguous
// bytes in and 2 KiB out per step, with no shared memory and no
// reuse. A grid-stride loop covers any numel; the tail of fewer than
// 16 bytes, and a buffer not aligned to 16 bytes, go one element per
// thread.
//
// It multiplies by the f32 constant 0x3B808081 == float(1/255), as
// the JAX kernel and its plain path do; x / 255.f rounds differently
// for many byte values.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_unit(uint32_t b) {
  return __fmul_rn(__uint2float_rn(b), __uint_as_float(0x3B808081u));
}

__global__ void normalize_u8_vec16(const uint4* __restrict__ in,
                                   float4* __restrict__ out, int64_t nvec) {
  for (int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; v < nvec;
       v += (int64_t)gridDim.x * blockDim.x) {
    const uint4 p = in[v];
    const uint32_t w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[4 * v + k] = make_float4(to_unit(w[k] & 0xFFu),
                                   to_unit((w[k] >> 8) & 0xFFu),
                                   to_unit((w[k] >> 16) & 0xFFu),
                                   to_unit(w[k] >> 24));
    }
  }
}

__global__ void normalize_u8_scalar(const uint8_t* __restrict__ in,
                                    float* __restrict__ out, int64_t lo,
                                    int64_t n) {
  for (int64_t i = lo + blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < n; i += (int64_t)gridDim.x * blockDim.x) {
    out[i] = to_unit(in[i]);
  }
}

int grid_for(int64_t work, int threads) {
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = 132 * 32;  // enough blocks in flight on 132 SMs
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" int cgs_normalize_u8(const void* in, void* out, int64_t n,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  int64_t lo = 0;
  const bool aligned = ((uintptr_t)in % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (aligned && n >= 16) {
    const int64_t nvec = n / 16;
    normalize_u8_vec16<<<grid_for(nvec, threads), threads, 0, s>>>(
        (const uint4*)in, (float4*)out, nvec);
    lo = nvec * 16;
  }
  if (lo < n) {
    normalize_u8_scalar<<<grid_for(n - lo, threads), threads, 0, s>>>(
        (const uint8_t*)in, (float*)out, lo, n);
  }
  return (int)cudaGetLastError();
}
