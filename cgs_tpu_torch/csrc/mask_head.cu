// The mask head after its first convolution, NHWC, in one pass:
//
//   mask[n, y, x] = sigmoid(b2 + sum over (dy, dx, c) of
//                           w2[0, c, dy, dx] * h[n, y + dy - 1, x + dx - 1, c])
//   h = leaky_relu(y0 + b0)    (zero outside the frame)
//
// y0 (N, H, W, C) NHWC (the channels_last output of `masker.0` seen through
// permute(0, 2, 3, 1), made without its bias), f32 or bf16; b0 (C,), w2
// (1, C, 3, 3) at any strides and b2 (1,) in y0's type; mask (N, H, W) f32,
// which is the (N, 1, H, W) mask in either memory format. C <= 64.
//
// Replaces no Pallas kernel: on the TPU, XLA fused the head's epilogues
// into its convolutions (cgs_tpu/models/decoder.py). On CUDA the eval
// forward ran the LeakyReLU as one `bias_act_pool` pass, which wrote the
// whole 16-channel activation only for the next convolution to read it
// back; `masker.2`, 16 channels to 1, as cuDNN's
// `conv2d_grouped_direct_kernel` (10.5 ms at batch 8192 on an H100,
// whatever the critic); and the sigmoid as a second `bias_act_pool`.
//
// Bound on an H100 SXM: bytes. The head reads y0 once and writes one f32 a
// pixel: at batch 8192, 64 x 64 and C = 16 in f32 that is 2.15 GB read and
// 0.13 GB written, 0.68 ms at 3.35 TB/s; its 144 multiply-adds a pixel,
// 9.7 GFLOP, take 0.14 ms at 67 TFLOP/s. Handing each h value to the nine
// outputs that read it costs shared-memory bandwidth of the same order:
// on the card the arithmetic phase alone takes ~0.6 ms of the ~1 ms, so
// the design keeps that traffic to one pass over h a strip.
//
// Design. A block takes a strip of one frame, ROWS rows of up to kTileW =
// 64 columns, and loads the strip's (ROWS + 2)-row halo once, in 16-byte
// vectors where C and the buffer allow, kLoadsInFlight a thread in
// flight. It applies leaky_relu(y0 + b0) on load, once an element, and
// keeps h in shared memory as f32 (a bf16 h is exact in f32), zero outside
// the frame: the zeros are the convolution's padding of h, not leaky(0 +
// b0). A pixel's channels sit in float4 chunks whose order is swizzled by
// the pixel's column, so that eight neighbouring columns reading one chunk
// hit eight distinct bank groups. w2 and b0 sit in shared memory too. Each
// thread then owns one column and RPT rows of outputs: it walks the RPT +
// 2 input rows it needs once, chunk by chunk, each float4 of h feeding up
// to three outputs, with three partial sums an output (one a kernel row)
// in f32. Stores are one f32 a lane, coalesced, streaming. Halo rows are
// re-read by the neighbouring strip from L2, not HBM: the strips of a
// frame are neighbouring blocks.
//
// The main path (C = 16, W = 64: FULL) takes strips of 16 rows, 256
// threads, 4 rows a thread. Its strip spans the frame, so the tile holds
// no halo columns (past the edges the arithmetic reads zeros), and a
// thread loads the same (column, vector) of each row, with no division
// and that vector's b0 in registers. At 72.6 KB of shared memory and at
// most 85 registers a thread, three blocks fit an SM, one loading while
// the others compute. Other widths and frames take strips of 4 rows with
// the halo columns, and any C up to 64 by a loop over its chunks.
//
// Rounding, as the eager chain rounds: h = a(y0 + b0) with the sum and the
// LeakyReLU rounded to y0's type, as `bias_act_pool` does; the products
// summed in f32; in bf16 that sum rounded to bf16 as cuDNN's output is,
// then b2 added and the sum rounded to bf16 as `add_` does; the sigmoid in
// f32. The order of the sum is not cuDNN's, so the mask is not bit-equal
// to the eager chain's: the tests hold both against a float64 evaluation
// of the same head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 64;          // output columns a block
constexpr int kMaxC = 64;
constexpr int kLoadsInFlight = 8;   // 16-byte loads a thread issues at once
constexpr int kRows = 16;           // output rows a block (main path)
constexpr int kRowsPerThread = 4;   // output rows a thread

// a bf16 element is moved as its 16 bits
using bf16 = uint16_t;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, bf16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// leaky_relu(y + b), the sum and the activation each rounded to E
template <typename E>
__device__ __forceinline__ float leaky(E y, float b, float slope) {
  const float s = round_to(__fadd_rn(to_f(y), b), E());
  return round_to(s > 0.0f ? s : __fmul_rn(s, slope), E());
}

// one 16-byte load of y0, seen as its elements
template <typename E>
union Vec16 {
  uint4 u;
  E e[16 / sizeof(E)];
};

// the shared-memory float4 of chunk q of tile pixel (row r, column p) in
// rows of `pitch` pixels; with a multiple of 4 chunks a pixel, the chunk
// order is swizzled by p
__device__ __forceinline__ int chunk_at(int r, int p, int q, int cq,
                                        int pitch) {
  const int s = (cq & 3) == 0 ? q ^ ((p >> 1) & 3) : q;
  return (r * pitch + p) * cq + s;
}

// CQ: float4 chunks a pixel (C / 4 rounded up), fixed at compile time, or
// 0 for any; VEC: y0 read in 16-byte vectors (C * sizeof(E) a multiple of
// 16, y0 16-byte aligned), else element by element; FULL: CQ fixed, VEC,
// and W = kTileW, so that a strip spans its frame's width; ROWS output
// rows a block, RPT a thread
template <typename E, int CQ, bool VEC, bool FULL, int ROWS, int RPT>
__global__ void __launch_bounds__(kTileW * ROWS / RPT, FULL ? 3 : 1)
    mask_head_fwd(const E* __restrict__ y, const E* __restrict__ b0,
                  const E* __restrict__ w2, int64_t sw_c, int64_t sw_y,
                  int64_t sw_x, const E* __restrict__ b2,
                  float* __restrict__ out, int H, int W, int C, int cq_any,
                  int tiles_y, int tiles_x, float slope) {
  constexpr int kThreads = kTileW * ROWS / RPT;
  // the tile's pixels a row: the strip's columns, and but for a strip
  // that spans its frame, the two beside it
  constexpr int kPitch = FULL ? kTileW : kTileW + 2;
  constexpr int kHaloPix = (ROWS + 2) * (kTileW + 2);
  const int cq = CQ ? CQ : cq_any;
  extern __shared__ float4 smem[];
  float4* wsm = smem;                    // [cq][9] w2, chunk by tap
  float* bsm = reinterpret_cast<float*>(smem + 9 * cq);   // [4 cq] b0
  float4* tile = smem + 10 * cq;         // [ROWS + 2][kPitch][cq] h

  const int tid = threadIdx.x;
  const int tiles = tiles_y * tiles_x;
  const int64_t n = blockIdx.x / tiles;
  const int t = blockIdx.x - (int)n * tiles;
  const int y_top = (t / tiles_x) * ROWS - 1;     // the halo's first row
  const int x_left = (t % tiles_x) * kTileW - 1;  // ... and first column

  for (int i = tid; i < 36 * cq; i += kThreads) {  // i = c * 9 + tap
    const int c = i / 9, k = i - c * 9;
    const float v = c < C ? to_f(w2[c * sw_c + (k / 3) * sw_y +
                                    (k % 3) * sw_x])
                          : 0.0f;
    reinterpret_cast<float*>(wsm)[((c >> 2) * 9 + k) * 4 + (c & 3)] = v;
  }
  for (int c = tid; c < 4 * cq; c += kThreads)
    bsm[c] = c < C ? to_f(b0[c]) : 0.0f;
  __syncthreads();

  const E* frame = y + n * H * W * C;
  if constexpr (FULL) {
    // the halo's two columns are the frame's padding, left out of the
    // tile, and a thread takes the same (column, vector) slots of every
    // row it loads: no division, no bounds but the rows'
    constexpr int V = 16 / sizeof(E);
    constexpr int kv = CQ * 4 / V;                 // vectors a pixel
    constexpr int at_once = kThreads / (kTileW * kv);   // rows a pass
    static_assert(kThreads % (kTileW * kv) == 0, "a pass takes whole rows");
    const int col = tid / kv % kTileW, k = tid % kv;
    const E* src = frame + (int64_t)col * C + k * V;
    float bk[V];   // the slot's channels of b0, for every row
#pragma unroll
    for (int e = 0; e < V; ++e) bk[e] = bsm[k * V + e];
#pragma unroll 1
    for (int r0 = tid / (kTileW * kv); r0 < ROWS + 2;
         r0 += at_once * kLoadsInFlight) {
      Vec16<E> raw[kLoadsInFlight];
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int r = r0 + u * at_once, gy = y_top + r;
        raw[u].u = make_uint4(0, 0, 0, 0);
        if (r < ROWS + 2 && gy >= 0 && gy < H)
          raw[u].u = __ldg(
              reinterpret_cast<const uint4*>(src + (int64_t)gy * W * C));
      }
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int r = r0 + u * at_once, gy = y_top + r;
        if (r >= ROWS + 2) break;
        const bool in = gy >= 0 && gy < H;
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in) {
            h.x = leaky(raw[u].e[e], bk[e], slope);
            h.y = leaky(raw[u].e[e + 1], bk[e + 1], slope);
            h.z = leaky(raw[u].e[e + 2], bk[e + 2], slope);
            h.w = leaky(raw[u].e[e + 3], bk[e + 3], slope);
          }
          tile[chunk_at(r, col, (k * V + e) >> 2, CQ, kPitch)] = h;
        }
      }
    }
  } else if (VEC) {
    // item = (halo pixel, vector of V channels), the vectors fastest: a
    // warp's loads of one row cover a contiguous range
    constexpr int V = 16 / sizeof(E);
    const int kv = CQ ? CQ * 4 / V : C / V;
    const int items = kHaloPix * kv;
#pragma unroll 1
    for (int base = tid; base < items; base += kThreads * kLoadsInFlight) {
      Vec16<E> raw[kLoadsInFlight];
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int i = base + u * kThreads;
        const int pix = i / kv, k = i - pix * kv;
        const int r = pix / (kTileW + 2), p = pix - r * (kTileW + 2);
        const int gy = y_top + r, gx = x_left + p;
        raw[u].u = make_uint4(0, 0, 0, 0);
        if (i < items && gy >= 0 && gy < H && gx >= 0 && gx < W)
          raw[u].u = __ldg(reinterpret_cast<const uint4*>(
              frame + ((int64_t)gy * W + gx) * C + k * V));
      }
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int i = base + u * kThreads;
        if (i >= items) break;
        const int pix = i / kv, k = i - pix * kv;
        const int r = pix / (kTileW + 2), p = pix - r * (kTileW + 2);
        const int gy = y_top + r, gx = x_left + p;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < V; j += 4) {
          const int c = k * V + j;
          float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in) {
            h.x = leaky(raw[u].e[j], bsm[c], slope);
            h.y = leaky(raw[u].e[j + 1], bsm[c + 1], slope);
            h.z = leaky(raw[u].e[j + 2], bsm[c + 2], slope);
            h.w = leaky(raw[u].e[j + 3], bsm[c + 3], slope);
          }
          tile[chunk_at(r, p, c >> 2, cq, kPitch)] = h;
        }
      }
    }
  } else {
    // item = (halo pixel, chunk of 4 channels), read element by element
    const int items = kHaloPix * cq;
#pragma unroll 1
    for (int i = tid; i < items; i += kThreads) {
      const int pix = i / cq, q = i - pix * cq;
      const int r = pix / (kTileW + 2), p = pix - r * (kTileW + 2);
      const int gy = y_top + r, gx = x_left + p;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const E* src = frame + ((int64_t)gy * W + gx) * C;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * q + j;
          if (c < C) v[j] = leaky(src[c], bsm[c], slope);
        }
      }
      tile[chunk_at(r, p, q, cq, kPitch)] =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();

  // a thread: column j of the strip, output rows g * RPT .. + RPT - 1; it
  // reads tile columns j + kx - 1, or j + kx with the halo columns, and a
  // strip that spans its frame reads zeros past its edges
  const int j = tid % kTileW, g = tid / kTileW;
  const int p0 = FULL ? j - 1 : j;
  const bool in_l = !FULL || j > 0, in_r = !FULL || j < kTileW - 1;
  float acc[RPT][3];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) acc[i][ky] = 0.0f;
#pragma unroll 1
  for (int q = 0; q < cq; ++q) {
    float4 w[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) w[k] = wsm[q * 9 + k];
#pragma unroll
    for (int rr = 0; rr < RPT + 2; ++rr) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
        if ((kx != 0 || in_l) && (kx != 2 || in_r))
          h = tile[chunk_at(g * RPT + rr, p0 + kx, q, cq, kPitch)];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
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

  const float bias = to_f(b2[0]);
  const int gx = x_left + 1 + j;
  if (gx >= W) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int gy = y_top + 1 + g * RPT + i;
    if (gy >= H) break;
    const float z = round_to((acc[i][0] + acc[i][1]) + acc[i][2], E());
    const float s = round_to(__fadd_rn(z, bias), E());
    __stcs(out + (n * H + gy) * W + gx, 1.0f / (1.0f + expf(-s)));
  }
}

template <typename E, int CQ, bool VEC, bool FULL, int ROWS, int RPT>
int launch(const void* y, const void* b0, const void* w2, int64_t sw_c,
           int64_t sw_y, int64_t sw_x, const void* b2, void* out, int64_t N,
           int64_t H, int64_t W, int64_t C, float slope, cudaStream_t s) {
  const int cq = (int)((C + 3) / 4);
  const size_t smem =
      sizeof(float4) *
      ((size_t)10 * cq +
       (size_t)(ROWS + 2) * (FULL ? kTileW : kTileW + 2) * cq);
  auto kernel = mask_head_fwd<E, CQ, VEC, FULL, ROWS, RPT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t tiles_y = (H + ROWS - 1) / ROWS;
  const int64_t tiles_x = (W + kTileW - 1) / kTileW;
  const int64_t blocks = N * tiles_y * tiles_x;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kTileW * ROWS / RPT, smem, s>>>(
      static_cast<const E*>(y), static_cast<const E*>(b0),
      static_cast<const E*>(w2), sw_c, sw_y, sw_x, static_cast<const E*>(b2),
      static_cast<float*>(out), (int)H, (int)W, (int)C, cq, (int)tiles_y,
      (int)tiles_x, slope);
  return (int)cudaGetLastError();
}

// C = 16 at W = 64 in 16-byte vectors: the main path's strips; any other
// shape or alignment: strips of kRowsPerThread rows, whose halo fits in
// shared memory up to C = 64
template <typename E>
int by_width(const void* y, const void* b0, const void* w2, int64_t sw_c,
             int64_t sw_y, int64_t sw_x, const void* b2, void* out,
             int64_t N, int64_t H, int64_t W, int64_t C, float slope,
             cudaStream_t s) {
  constexpr int64_t V = 16 / sizeof(E);
  constexpr int R = kRowsPerThread;
  const bool vec = C % V == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  if (vec && C == 16 && W == kTileW)
    return launch<E, 4, true, true, kRows, R>(y, b0, w2, sw_c, sw_y, sw_x, b2,
                                              out, N, H, W, C, slope, s);
  if (vec)
    return launch<E, 0, true, false, R, R>(y, b0, w2, sw_c, sw_y, sw_x, b2,
                                           out, N, H, W, C, slope, s);
  return launch<E, 0, false, false, R, R>(y, b0, w2, sw_c, sw_y, sw_x, b2,
                                          out, N, H, W, C, slope, s);
}

}  // namespace

// y0 (N, H, W, C) contiguous, b0 (C,) and b2 (1,) contiguous, w2 (1, C, 3,
// 3) at element strides (sw_c, sw_y, sw_x) over its last three dims, all in
// the input type (bf16 when in_bf16, else f32); out (N, H, W) f32;
// 1 <= C <= 64. Returns cudaGetLastError() after the launch.
extern "C" int cgs_mask_head(const void* y0, const void* b0, const void* w2,
                             int64_t sw_c, int64_t sw_y, int64_t sw_x,
                             const void* b2, void* out, int64_t N, int64_t H,
                             int64_t W, int64_t C, float slope,
                             int64_t in_bf16, void* stream) {
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  if (N * H * W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return by_width<bf16>(y0, b0, w2, sw_c, sw_y, sw_x, b2, out, N, H, W, C,
                          slope, s);
  return by_width<float>(y0, b0, w2, sw_c, sw_y, sw_x, b2, out, N, H, W, C,
                         slope, s);
}
