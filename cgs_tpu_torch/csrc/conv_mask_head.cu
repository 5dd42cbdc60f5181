// The decoder's whole mask head, NHWC f32, in one pass:
//
//   y0[n, y, x, o] = sum over (dy, dx, c) of
//                    w0[o, c, dy, dx] * in[n, y + dy - 1, x + dx - 1, c]
//   h              = leaky_relu(y0 + b0)          (zero outside the frame)
//   mask[n, y, x]  = sigmoid(b2 + sum over (dy, dx, o) of
//                      w2[0, o, dy, dx] * h[n, y + dy - 1, x + dx - 1, o])
//
// in (N, H, 64, C) contiguous, the last skip join seen through
// permute(0, 2, 3, 1); wt (C, 3, 3, 16) contiguous, w0 with the output
// channel last; b0 (16,); w2 (1, 16, 3, 3) at any strides; b2 (1,); mask
// (N, H, 64) f32, which is the (N, 1, H, 64) mask in either memory
// format. All f32, 1 <= C <= kMaxC.
//
// Replaces no Pallas kernel: on the TPU, XLA ran the head's first
// convolution and fused the epilogues into it (cgs_tpu/models/decoder.py).
// On CUDA the eval forward ran `masker.0` through cuDNN (at C = 43 an NCHW
// implicit GEMM between two layout transposes, 29.3 + 5.9 ms at batch
// 8192 on an H100; at C = 11 its NHWC direct kernel, 10.7 ms), wrote its
// 2.15 GB output y0, and `mask_head.cu` read it back for the rest.
//
// Bound on an H100 SXM: operations. masker.0 is 2 * 9 * 16 * C FLOP a
// pixel, 415 GFLOP at batch 8192 and C = 43, 6.2 ms at 67 TFLOP/s in f32
// on the CUDA cores (no tensor core: the configurations run f32 with TF32
// off); the join is read once, 5.77 GB, 1.72 ms at 3.35 TB/s. A GEMM
// library tile wastes most of itself on 16 output channels and a depth
// of 9 C, which is no tile multiple.
//
// Design. A block takes one frame and walks down it in tiles of kRows = 8
// rows of y0. For a tile it streams the input's 10 rows (with the halo)
// in chunks of kChunk = 8 channels into a double-buffered ring in shared
// memory with 4-byte `cp.async` (a pixel of an odd C is no 16-byte
// vector; the rows and channels past the frame or past C are zero-filled
// by the copy), and the chunk's weights, one contiguous piece of wt, with
// 16-byte ones. While one chunk lands, the block computes on the other: a
// thread owns 8 neighbouring pixels of one row and 8 of the 16 output
// channels, 64 sums in registers; for each 4 input channels and kernel
// row it takes the 10 pixels its outputs read as float4s (a row's pixels
// padded by 4 floats after each 8, so that the 8 threads of a quarter
// warp, 8 pixels apart, hit 8 distinct bank groups), then for each of the
// 3 taps and 4 channels the 8 weights as 2 float4s: 768 FFMA for 34
// shared loads. A chunk of 4 channels closes an odd C. At the tile's end
// it writes h = leaky_relu(y0 + b0) into a ring of 10 rows of h (float4
// chunks swizzled by column, as `mask_head.cu` keeps them), the tile's 8
// rows after the last 2 of the one before, and emits the 8 mask rows that
// now have both neighbours with `mask_head.cu`'s arithmetic: a column and
// 4 rows a thread, three partial sums an output. A last pass emits the
// frame's last row. y0 and h never leave the SM; nothing is computed
// twice.
//
// Shared memory: 95.9 KB a block, two blocks an SM; the 255-register cap
// of two 128-thread blocks holds the 64 sums, the 40 floats of input and
// the weights ahead. On the card (C = 43, batch 8192) this runs at ~46%
// of the FLOP bound; without the input's copies it would run at ~59%:
// a chunk of a pixel's channels is 32 bytes at any alignment, so the
// copies move about twice the bytes they keep, from L2.
//
// Rounding: y0 summed in f32 in this kernel's order (not cuDNN's), then
// h = a(y0 + b0) as `bias_act_pool` rounds it, the mask as `mask_head.cu`
// in f32. The tests hold it against a float64 evaluation of the head.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kW = 64;         // the frame's width: a block's columns
constexpr int kMid = 16;       // masker.0's output channels
constexpr int kMaxC = 128;     // the widest join the route takes
constexpr int kRows = 8;       // rows of y0 a tile
// a row: 8 threads of 8 neighbouring pixels, for each half of the output
// channels
constexpr int kThreads = kRows * 16;
constexpr int kChunk = 8;      // input channels a stage
constexpr int kCols = kW + 2;  // with the zero columns either side
// a row of a stage: kCols pixels of kChunk floats, and 4 floats of
// padding after each 8 pixels, so that the 8 threads of a quarter warp,
// 8 pixels apart, read 8 distinct bank groups
constexpr int kInRow = kCols * kChunk + (kCols / 8 + 1) * 4;
constexpr int kInRows = kRows + 2;
constexpr int kInBuf = kInRows * kInRow;            // floats a stage
constexpr int kWBuf = kChunk * 9 * kMid;            // floats a stage
constexpr int kHBuf = (kRows + 2) * kW * kMid;
// the shared layout, in floats: the input ring, the weight ring, h, the
// mask's weights as [chunk][tap] float4s, b0
constexpr int kOffW = 2 * kInBuf;
constexpr int kOffH = kOffW + 2 * kWBuf;
constexpr int kOffW2 = kOffH + kHBuf;
constexpr int kOffB0 = kOffW2 + 9 * kMid;
constexpr int kSmemFloats = kOffB0 + kMid;
static_assert(kThreads * 40 == kInRows * kW * kChunk, "input: 40 a thread");
static_assert(kInRow % 4 == 0 && kOffW % 4 == 0 && kOffH % 4 == 0 &&
                  kOffW2 % 4 == 0 && kWBuf % 4 == 0,
              "float4 alignment");

// pixel p (0 and kCols - 1 the zero columns) of a stage's row
__device__ __forceinline__ int px_at(int p) {
  return p * kChunk + (p / 8) * 4;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// mask_head.cu's placement of h: chunk q of pixel (row r, column p) in
// rows of kW pixels, the chunk order swizzled by p
__device__ __forceinline__ int chunk_at(int r, int p, int q) {
  return (r * kW + p) * 4 + (q ^ ((p >> 1) & 3));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// mask rows y_top + g * 4 .. + 3 of column j from h rows (ring rows)
// g * 4 .. g * 4 + 5, those inside the frame stored
__device__ __forceinline__ void emit(const float4* hs, const float4* w2s,
                                     float bias, float* out, int H, int j,
                                     int g, int y_top) {
  float acc[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) acc[i][ky] = 0.0f;
#pragma unroll 1
  for (int q = 0; q < kMid / 4; ++q) {
    float4 w[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) w[k] = w2s[q * 9 + k];
#pragma unroll
    for (int rr = 0; rr < 6; ++rr) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int p = j + kx - 1;
        float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p >= 0 && p < kW) h = hs[chunk_at(g * 4 + rr, p, q)];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ky = rr - i;
          if (ky < 0 || ky > 2) continue;
          const float4 wk = w[ky * 3 + kx];
          float a = acc[i][ky];
          a = fmaf(h.x, wk.x, a);
          a = fmaf(h.y, wk.y, a);
          a = fmaf(h.z, wk.z, a);
          a = fmaf(h.w, wk.w, a);
          acc[i][ky] = a;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = y_top + g * 4 + i;
    if (y < 0 || y >= H) continue;
    const float s = __fadd_rn((acc[i][0] + acc[i][1]) + acc[i][2], bias);
    __stcs(out + (int64_t)y * kW + j, 1.0f / (1.0f + expf(-s)));
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    conv_mask_head_fwd(const float* __restrict__ in,
                       const float* __restrict__ wt,
                       const float* __restrict__ b0,
                       const float* __restrict__ w2, int64_t s2c,
                       int64_t s2y, int64_t s2x,
                       const float* __restrict__ b2,
                       float* __restrict__ out, int H, int C, float slope) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ins = smem;
  float* wsm = smem + kOffW;
  float4* hs = reinterpret_cast<float4*>(smem + kOffH);
  float4* w2s = reinterpret_cast<float4*>(smem + kOffW2);
  float* b0s = smem + kOffB0;

  const int tid = threadIdx.x;
  const int64_t n = blockIdx.x;
  const float* frame = in + n * H * kW * C;
  out += n * H * kW;

  // the zero columns of both input stages, the two h rows above the
  // frame, the mask's weights and b0
  for (int i = tid; i < 2 * kInRows * 2 * kChunk; i += kThreads) {
    const int c = i % kChunk, side = i / kChunk % 2, r = i / (2 * kChunk);
    ins[r * kInRow + px_at(side * (kCols - 1)) + c] = 0.0f;
  }
  for (int i = tid; i < 2 * kW * 4; i += kThreads)
    hs[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < 9 * kMid; i += kThreads) {   // i = o * 9 + tap
    const int o = i / 9, k = i - o * 9;
    reinterpret_cast<float*>(w2s)[((o >> 2) * 9 + k) * 4 + (o & 3)] =
        w2[o * s2c + (k / 3) * s2y + (k % 3) * s2x];
  }
  if (tid < kMid) b0s[tid] = b0[tid];
  const float bias2 = b2[0];

  const int chunks = (C + kChunk - 1) / kChunk;
  const int tiles = (H + kRows - 1) / kRows;
  const int steps = tiles * chunks;

  // stage s: tile s / chunks, channels (s % chunks) * kChunk + 0..7
  auto issue = [&](int s) {
    const int t = s / chunks, c0 = (s - t * chunks) * kChunk;
    float* dst = ins + (s & 1) * kInBuf;
    // element tid + 128 i: channel tid % 8, column tid / 8 + 16 (i % 4),
    // row i / 4 of the tile's 10
    const int c = tid % kChunk, col = tid / kChunk;
    const bool c_in = c0 + c < C;
#pragma unroll
    for (int i = 0; i < 40; ++i) {
      const int r = i / 4, x = col + 16 * (i % 4);
      const int y = t * kRows - 1 + r;
      const bool ok = c_in && y >= 0 && y < H;
      const float* src =
          ok ? frame + ((int64_t)y * kW + x) * C + c0 + c : frame;
      cp_async4(dst + r * kInRow + px_at(x + 1) + c, src, ok);
    }
    float* wdst = wsm + (s & 1) * kWBuf;
    // the chunk's weights, wt[c0 .. c0 + 7][tap][16] contiguous, in
    // 16-byte pieces; those of channels past C zero-filled
    const float* wsrc = wt + (int64_t)c0 * 9 * kMid;
    const int valid = min(kChunk, C - c0) * 9 * kMid / 4;
    for (int i = tid; i < kWBuf / 4; i += kThreads)
      cp_async16(wdst + 4 * i, i < valid ? wsrc + 4 * i : wt, i < valid);
  };

  // the thread's row of the tile, its pixels 8 g .. 8 g + 7 and its
  // output channels 8 half .. 8 half + 7: a quarter warp holds a row's 8
  // pixel groups
  const int g = tid % 8, half = tid / 8 % 2, rr = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[p][o] = 0.0f;

  issue(0);
  cp_async_commit();
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) issue(s + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const int t = s / chunks, k = s - t * chunks;
    const int quads = min(kChunk, C - k * kChunk + 3) / 4;
    const float* ib = ins + (s & 1) * kInBuf;
    const float* wb = wsm + (s & 1) * kWBuf;
#pragma unroll 1
    for (int q = 0; q < quads; ++q) {
#pragma unroll 1
      for (int ky = 0; ky < 3; ++ky) {
        // the 10 input pixels the 8 outputs and their 3 taps read, 4
        // channels each
        const float* arow = ib + (rr + ky) * kInRow + 4 * q;
        float4 a[10];
#pragma unroll
        for (int m = 0; m < 10; ++m)
          a[m] = *reinterpret_cast<const float4*>(arow + px_at(8 * g + m));
        const float* wrow = wb + (4 * q * 9 + ky * 3) * kMid + 8 * half;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float4* wp =
                reinterpret_cast<const float4*>(wrow + (cc * 9 + kx) * kMid);
            const float4 w4a = wp[0], w4b = wp[1];
            const float w[8] = {w4a.x, w4a.y, w4a.z, w4a.w,
                                w4b.x, w4b.y, w4b.z, w4b.w};
#pragma unroll
            for (int p = 0; p < 8; ++p) {
              const float av = comp(a[p + kx], cc);
#pragma unroll
              for (int o = 0; o < 8; ++o)
                acc[p][o] = fmaf(av, w[o], acc[p][o]);
            }
          }
        }
      }
    }
    __syncthreads();   // the stage is read: the next issue may refill it

    if (k == chunks - 1) {
      // h of the tile's rows into ring rows 2..9, zero below the frame
      const int y = t * kRows + rr;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = 4 * qq + e;
            const float z = __fadd_rn(acc[p][o], b0s[8 * half + o]);
            v[e] = y < H ? (z > 0.0f ? z : __fmul_rn(z, slope)) : 0.0f;
            acc[p][o] = 0.0f;
          }
          hs[chunk_at(rr + 2, 8 * g + p, 2 * half + qq)] =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
      __syncthreads();
      // mask rows t * 8 - 1 .. t * 8 + 6: a column and 4 rows a thread
      emit(hs, w2s, bias2, out, H, tid % kW, tid / kW, t * kRows - 1);
      __syncthreads();
      // the tile's last two h rows become the next tile's first two
      for (int i = tid; i < 2 * kW * 4; i += kThreads)
        hs[i] = hs[kRows * kW * 4 + i];
    }
  }
  // the frame's last mask row, tiles * 8 - 1, where it is in the frame:
  // h below the last tile is zero
  __syncthreads();
  for (int i = tid; i < kW * 4; i += kThreads)
    hs[2 * kW * 4 + i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if (tid < kW) emit(hs, w2s, bias2, out, H, tid, 0, tiles * kRows - 1);
}

}  // namespace

// in (N, H, 64, C) contiguous; wt (C, 3, 3, 16) contiguous and 16-byte
// aligned; b0 (16,) contiguous; w2 (1, 16, 3, 3) at element strides (s2c,
// s2y, s2x) over its last three dims; b2 (1,); out (N, H, 64); all f32;
// 1 <= C <= kMaxC. Returns cudaGetLastError() after the launch.
extern "C" int cgs_conv_mask_head(const void* in, const void* wt,
                                  const void* b0, const void* w2,
                                  int64_t s2c, int64_t s2y, int64_t s2x,
                                  const void* b2, void* out, int64_t N,
                                  int64_t H, int64_t W, int64_t C,
                                  float slope, void* stream) {
  if (W != kW || C < 1 || C > kMaxC || N > 0x7fffffff || H > 0x7fffffff ||
      (reinterpret_cast<uintptr_t>(wt) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (N * H == 0) return 0;
  // on the current card, each launch: two blocks an SM need the largest
  // carve-out
  constexpr size_t smem = sizeof(float) * kSmemFloats;
  cudaError_t e = cudaFuncSetAttribute(
      conv_mask_head_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(conv_mask_head_fwd,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  conv_mask_head_fwd<<<(unsigned)N, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const float*>(wt),
      static_cast<const float*>(b0), static_cast<const float*>(w2),
      s2c, s2y, s2x, static_cast<const float*>(b2), static_cast<float*>(out),
      (int)H, (int)C, slope);
  return (int)cudaGetLastError();
}
