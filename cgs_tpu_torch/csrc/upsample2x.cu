// Nearest-neighbour x2 upsample, NHWC: (B, H, W, C) -> (B, 2H, 2W, C),
// out[b, 2h+dy, 2w+dx, c] = in[b, h, w, c].
//
// Replaces cgs_tpu/ops/pallas_upsample.py:upsample2x_pallas
// (_up2_forward / _up2_kernel).
//
// Bound on an H100 SXM: bytes. It reads the input once and writes four
// times as much, so the least time is 5 * in_bytes / 3.35 TB/s (the
// chfak-5 32->64 step at batch 8192 in f32: 1.34 GB in, 5.37 GB out,
// 2.0 ms). There is no arithmetic.
//
// Design: the copy is bit-exact whatever the element type, so the
// kernel moves raw units of U bytes, U the largest of 16, 8, 4, 2, 1
// that divides both the pixel's bytes (C * element size) and the two
// pointers' alignment. Each thread loads one unit of one input pixel
// once and stores it to the four output pixels it maps to, so there is
// no shared memory and no re-read; neighbouring threads take
// neighbouring units of a pixel and then neighbouring pixels, so the
// loads and each of the four stores are contiguous across a warp.
// Any C and W work: the TPU kernel's W*C % 128 == 0 and W*C <= 512
// limits do not apply. Indices are 64-bit (outputs pass 2^31 bytes).
//
// The backward, cgs_upsample2x_bwd, is the adjoint: a 2x2 sum-pool,
//   dx[b, i, j, c] = (g[b, 2i, 2j, c] + g[b, 2i, 2j+1, c])
//                  + (g[b, 2i+1, 2j, c] + g[b, 2i+1, 2j+1, c]),
// the TPU version's _up2_bwd (pallas_upsample.py:132, a jnp
// reduce_window). Bound: bytes, 5 * dx_bytes / 3.35 TB/s (it reads four
// times what it writes). The gradient it receives is a channel slice of
// the gradient of the decoder's next torch.cat, a view that is not
// contiguous, so the kernel takes g's four element strides and reads
// the slice in place (either memory format) with no copy. One thread
// per output element, neighbouring threads on neighbouring channels of
// dx. f32 and bf16; bf16 sums in f32 in the order above and rounds
// once, as the plain version (ops/upsample.py:upsample2x_bwd_plain)
// does, with explicitly rounded adds so the two are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void upsample2x_kernel(const T* __restrict__ in,
                                  T* __restrict__ out, int64_t total,
                                  int64_t H, int64_t W, int64_t upp) {
  // upp: units per pixel; total: input units
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t u = i % upp;
    const int64_t pix = i / upp;
    const int64_t w = pix % W;
    const int64_t bh = pix / W;  // b * H + h
    const T v = in[i];
    // output row 2*(b*H + h) == row (b, 2h) of the (B, 2H) output rows
    const int64_t row = 2 * bh;
    const int64_t rstride = 2 * W * upp;  // units per output row
    const int64_t o = row * rstride + (2 * w) * upp + u;
    out[o] = v;
    out[o + upp] = v;
    out[o + rstride] = v;
    out[o + rstride + upp] = v;
  }
}

int grid_for(int64_t work, int threads) {
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = (int64_t)132 * 64;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <typename T>
void launch(const void* in, void* out, int64_t B, int64_t H, int64_t W,
            int64_t pixel_bytes, cudaStream_t s) {
  const int64_t upp = pixel_bytes / (int64_t)sizeof(T);
  const int64_t total = B * H * W * upp;
  const int threads = 256;
  upsample2x_kernel<T><<<grid_for(total, threads), threads, 0, s>>>(
      (const T*)in, (T*)out, total, H, W, upp);
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void upsample2x_bwd_kernel(const T* __restrict__ g,
                                      T* __restrict__ dx, int64_t total,
                                      int64_t H, int64_t W, int64_t C,
                                      int64_t sb, int64_t sh, int64_t sw,
                                      int64_t sc) {
  // total: dx elements, (B, H, W, C) contiguous
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t c = i % C;
    const int64_t pix = i / C;
    const int64_t j = pix % W;
    const int64_t bi = pix / W;  // b * H + i
    const int64_t r = bi % H;
    const int64_t b = bi / H;
    const T* p = g + b * sb + (2 * r) * sh + (2 * j) * sw + c * sc;
    const float top = __fadd_rn(load_f32(p), load_f32(p + sw));
    const float bot = __fadd_rn(load_f32(p + sh), load_f32(p + sh + sw));
    store(dx + i, __fadd_rn(top, bot));
  }
}

template <typename T>
void launch_bwd(const void* g, void* dx, int64_t B, int64_t H, int64_t W,
                int64_t C, int64_t sb, int64_t sh, int64_t sw, int64_t sc,
                cudaStream_t s) {
  const int64_t total = B * H * W * C;
  const int threads = 256;
  upsample2x_bwd_kernel<T><<<grid_for(total, threads), threads, 0, s>>>(
      (const T*)g, (T*)dx, total, H, W, C, sb, sh, sw, sc);
}

}  // namespace

// g: (B, 2H, 2W, C) with element strides (sb, sh, sw, sc); dx: (B, H,
// W, C) contiguous; bf16 != 0 selects bfloat16, else float32.
extern "C" int cgs_upsample2x_bwd(const void* g, void* dx, int64_t B,
                                  int64_t H, int64_t W, int64_t C,
                                  int64_t sb, int64_t sh, int64_t sw,
                                  int64_t sc, int64_t bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    launch_bwd<__nv_bfloat16>(g, dx, B, H, W, C, sb, sh, sw, sc, s);
  } else {
    launch_bwd<float>(g, dx, B, H, W, C, sb, sh, sw, sc, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int cgs_upsample2x(const void* in, void* out, int64_t B,
                              int64_t H, int64_t W, int64_t pixel_bytes,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t align = (uintptr_t)in | (uintptr_t)out | (uintptr_t)pixel_bytes;
  if (align % 16 == 0) {
    launch<uint4>(in, out, B, H, W, pixel_bytes, s);
  } else if (align % 8 == 0) {
    launch<uint2>(in, out, B, H, W, pixel_bytes, s);
  } else if (align % 4 == 0) {
    launch<uint32_t>(in, out, B, H, W, pixel_bytes, s);
  } else if (align % 2 == 0) {
    launch<uint16_t>(in, out, B, H, W, pixel_bytes, s);
  } else {
    launch<uint8_t>(in, out, B, H, W, pixel_bytes, s);
  }
  return (int)cudaGetLastError();
}
