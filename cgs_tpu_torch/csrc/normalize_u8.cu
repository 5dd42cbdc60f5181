// Gather-shift-normalise ingest: uint8 frames -> float32 (or bf16) in
// [0, 1], gathered by index from up to three banks and rolled along W,
// written into one buffer.
//
// Replaces cgs_tpu/ops/pallas_kernels.py:normalize_u8 (_normalize_kernel)
// together with the ops XLA fuses around it in a train step
// (cgs_tpu/train/loops.py one_step: jnp.take, concatenate, shift_batch's
// jnp.roll, ingest).
//
// The function. Segments k = 0, 1, 2 are laid end to end in the output;
// segment k is (bank_k uint8 (M_k, H, W, C) contiguous, idx_k int64 (n_k,)
// or none, shift s_k, labels_k float32 (M_k,) or none). For output frame
// r of segment k, local row i = r - start_k and source frame
// f = idx_k[i] (i when there is no index):
//
//   out[r, h, w, c] = float(bank_k[f, h, (w - s_k) mod W, c]) * 0x3B808081
//   labels_out[r]   = labels_k[f]                 (where labels_k is given)
//
// which is jnp.roll(jnp.take(bank, idx), s, axis=2) then ingest, in
// torch.roll's sign convention for any signed s. The multiply is by the
// f32 constant float(1/255) with __fmul_rn, as the JAX kernel and the
// plain path do (x / 255.f rounds differently for many byte values). In
// bf16 the f32 product is rounded to nearest even, which is what
// `.to(torch.bfloat16)` of the f32 result gives. The indices are not
// checked here: the callers validate them on the host.
//
// Bound on an H100 SXM: bytes. Each element reads 1 byte and writes 4
// (2 in bf16): a serve batch of 8192 64x64x3 frames moves 503 MB in f32,
// 0.150 ms at 3.35 TB/s (0.090 ms in bf16). A masker step's 128 frames
// move 7.9 MB (2.35 us); at that size the launch costs more than the
// bytes, so the design's aim there is one launch for the whole ingest.
//
// Design. A frame row (W * C bytes, 192 for 64x64x3) is the unit. One
// block takes a group of consecutive output rows: it reads each row's
// source frame index once, stages the source rows in shared memory with
// 16-byte loads (each row followed by a copy of its first 16 bytes, so a
// read that wraps around the roll needs no test), then builds the rolled
// output from shared memory: consecutive threads write consecutive
// 16-byte chunks (4 floats or 8 bf16), so a warp store covers 512
// contiguous bytes. Global loads and stores stay 16-byte aligned whatever
// the shift, because the roll happens in shared memory, where a funnel
// shift of two 32-bit words extracts the 4 bytes at any byte offset. A
// batch larger than the L2 cache is written with streaming stores; a
// train step's output stays in L2 for the first convolution. Rows that
// are not a multiple of 16 bytes, or buffers not 16-byte aligned, go one
// element per thread (`ingest_any`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSeg = 3;           // segments per launch
static_assert(kMaxSeg == 3, "pick and locate select among 3 segments");
constexpr int kMaxRowsPerBlock = 64;
constexpr int kThreads = 256;
constexpr int64_t kMaxStagedRow = 32 * 1024;  // well inside 48 KB of smem
constexpr int64_t kStreamingBytes = 64ll << 20;    // > the 50 MB L2

struct Segs {
  const uint8_t* bank[kMaxSeg];
  const int64_t* idx[kMaxSeg];   // null: the bank's rows in order
  const float* lab[kMaxSeg];     // null: no labels
  int64_t end[kMaxSeg];          // one past the segment's last output
                                 // frame; unused segments end at the total
  int64_t shift_bytes[kMaxSeg];  // ((s mod W) + W) mod W, times C
};

struct Src {
  const uint8_t* frame;  // the source frame's first byte
  int64_t shift_bytes;
  const float* lab;
  int64_t f;             // source frame index within its bank
};

// v[k] by selects, so the kernel reads the parameters where they are
// instead of copying them to local memory to index them
template <class T>
__device__ __forceinline__ T pick(const T (&v)[kMaxSeg], int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ Src locate(const Segs& s, int64_t r,
                                      int64_t frame_bytes) {
  const int k = (r >= s.end[0]) + (r >= s.end[1]);  // end[2] is the total
  const int64_t i = r - (k == 0 ? 0 : (k == 1 ? s.end[0] : s.end[1]));
  const int64_t* idx = pick(s.idx, k);
  const int64_t f = idx ? idx[i] : i;
  return {pick(s.bank, k) + f * frame_bytes, pick(s.shift_bytes, k),
          pick(s.lab, k), f};
}

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float to_unit(uint32_t b) {
  return __fmul_rn(__uint2float_rn(b), __uint_as_float(0x3B808081u));
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// 4 bytes -> 4 floats; 2 bytes -> 2 bf16 packed in 32 bits
__device__ __forceinline__ float4 unit4(uint32_t w) {
  return make_float4(to_unit(w & 0xFFu), to_unit((w >> 8) & 0xFFu),
                     to_unit((w >> 16) & 0xFFu), to_unit(w >> 24));
}

__device__ __forceinline__ uint32_t bf16x2(uint32_t lo_byte,
                                           uint32_t hi_byte) {
  return bf16_bits(to_unit(lo_byte)) | (bf16_bits(to_unit(hi_byte)) << 16);
}

template <bool kBF16>
__global__ void __launch_bounds__(kThreads)
ingest_rows(Segs segs, int64_t H, int RB, int rows_per_block,
            int64_t total_rows, void* __restrict__ out,
            float* __restrict__ lab_out, bool streaming) {
  extern __shared__ __align__(16) uint8_t stage[];   // rows x (RB + 16)
  __shared__ int64_t row_shift[kMaxRowsPerBlock];
  const int stride = RB + 16;
  const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
  const int nrows = (int)min64(rows_per_block, total_rows - row0);
  const int vecs = RB / 16;
  const int64_t frame_bytes = H * RB;

  for (int t = threadIdx.x; t < nrows * vecs; t += blockDim.x) {
    const int r = t / vecs;
    const int v = t - r * vecs;
    const int64_t g = row0 + r;
    const int64_t n = g / H;
    const int64_t h = g - n * H;
    const Src src = locate(segs, n, frame_bytes);
    const uint4 val =
        reinterpret_cast<const uint4*>(src.frame + h * RB)[v];
    uint8_t* row = stage + r * stride;
    reinterpret_cast<uint4*>(row)[v] = val;
    if (v == 0) {
      reinterpret_cast<uint4*>(row + RB)[0] = val;   // the wrap copy
      row_shift[r] = src.shift_bytes;
      if (h == 0 && lab_out && src.lab) lab_out[n] = src.lab[src.f];
    }
  }
  __syncthreads();

  constexpr int E = kBF16 ? 8 : 4;     // elements per 16-byte store
  const int chunks = RB / E;
  for (int t = threadIdx.x; t < nrows * chunks; t += blockDim.x) {
    const int r = t / chunks;
    const int e = (t - r * chunks) * E;
    int p = e - (int)row_shift[r];
    if (p < 0) p += RB;
    const uint32_t* w =
        reinterpret_cast<const uint32_t*>(stage + r * stride + (p & ~3));
    const int sh = (p & 3) * 8;
    const uint32_t b0 = __funnelshift_r(w[0], w[1], sh);
    const int64_t o = (row0 + r) * RB + e;
    if (kBF16) {
      const uint32_t b1 = __funnelshift_r(w[1], w[2], sh);
      const uint4 v = make_uint4(
          bf16x2(b0 & 0xFFu, (b0 >> 8) & 0xFFu),
          bf16x2((b0 >> 16) & 0xFFu, b0 >> 24),
          bf16x2(b1 & 0xFFu, (b1 >> 8) & 0xFFu),
          bf16x2((b1 >> 16) & 0xFFu, b1 >> 24));
      uint4* dst = reinterpret_cast<uint4*>(
          static_cast<uint16_t*>(out) + o);
      if (streaming) __stcs(dst, v); else *dst = v;
    } else {
      const float4 v = unit4(b0);
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + o);
      if (streaming) __stcs(dst, v); else *dst = v;
    }
  }
}

template <bool kBF16>
__global__ void ingest_any(Segs segs, int64_t H, int64_t RB, int64_t total,
                           void* __restrict__ out,
                           float* __restrict__ lab_out) {
  const int64_t frame_bytes = H * RB;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t g = i / RB;
    const int64_t j = i - g * RB;
    const int64_t n = g / H;
    const int64_t h = g - n * H;
    const Src src = locate(segs, n, frame_bytes);
    int64_t q = j - src.shift_bytes;
    if (q < 0) q += RB;
    const float v = to_unit(src.frame[h * RB + q]);
    if (kBF16) {
      static_cast<uint16_t*>(out)[i] = (uint16_t)bf16_bits(v);
    } else {
      static_cast<float*>(out)[i] = v;
    }
    if (h == 0 && j == 0 && lab_out && src.lab) lab_out[n] = src.lab[src.f];
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }


}  // namespace

// desc: host int64 array, 5 per segment: (bank, idx or 0, n, shift,
// labels or 0). Frames are (H, W, C) bytes. out is (sum n, H, W, C)
// float32, or bf16 when out_bf16 != 0; labels_out (sum n,) float32 or
// null, written at the frames of segments that have labels.
extern "C" int cgs_normalize_u8(const void* desc, int64_t nseg, int64_t H,
                                int64_t W, int64_t C, void* out,
                                void* labels_out, int64_t out_bf16,
                                void* stream) {
  if (nseg < 1 || nseg > kMaxSeg || H < 1 || W < 1 || C < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t* d = static_cast<const int64_t*>(desc);
  Segs segs = {};
  const int64_t RB = W * C;
  bool staged = RB % 16 == 0 && RB <= kMaxStagedRow && aligned16(out);
  int64_t frames = 0;
  for (int k = 0; k < nseg; ++k) {
    const int64_t* s = d + 5 * k;
    segs.bank[k] = reinterpret_cast<const uint8_t*>(s[0]);
    segs.idx[k] = reinterpret_cast<const int64_t*>(s[1]);
    frames += s[2];
    segs.end[k] = frames;
    segs.shift_bytes[k] = ((s[3] % W) + W) % W * C;
    segs.lab[k] = reinterpret_cast<const float*>(s[4]);
    staged = staged && aligned16(segs.bank[k]);
  }
  for (int k = (int)nseg; k < kMaxSeg; ++k) segs.end[k] = frames;
  const int64_t rows = frames * H;
  if (rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  float* lab = static_cast<float*>(labels_out);
  const bool bf16 = out_bf16 != 0;
  if (staged) {
    const int per =
        (int)(RB >= 3072 ? 1 : min64(kMaxRowsPerBlock, 3072 / RB));
    const int64_t blocks = (rows + per - 1) / per;
    const size_t smem = (size_t)per * (RB + 16);
    const bool streaming = rows * RB * (bf16 ? 2 : 4) > kStreamingBytes;
    if (bf16) {
      ingest_rows<true><<<(unsigned)blocks, kThreads, smem, st>>>(
          segs, H, (int)RB, per, rows, out, lab, streaming);
    } else {
      ingest_rows<false><<<(unsigned)blocks, kThreads, smem, st>>>(
          segs, H, (int)RB, per, rows, out, lab, streaming);
    }
  } else {
    const int64_t total = rows * RB;
    const int64_t cap = (int64_t)132 * 32;
    const int blocks = (int)min64((total + kThreads - 1) / kThreads, cap);
    if (bf16) {
      ingest_any<true><<<blocks, kThreads, 0, st>>>(segs, H, RB, total, out,
                                                    lab);
    } else {
      ingest_any<false><<<blocks, kThreads, 0, st>>>(segs, H, RB, total,
                                                     out, lab);
    }
  }
  return (int)cudaGetLastError();
}
