// Gather-shift-normalise ingest: uint8 frames -> float32 (or bf16) in
// [0, 1], gathered by index from up to three banks for R seeds and rolled
// along W by a shift of each seed's own, written into one buffer.
//
// Replaces cgs_tpu/ops/pallas_kernels.py:normalize_u8 (_normalize_kernel)
// together with the ops XLA fuses around it in a train step
// (cgs_tpu/train/loops.py one_step: jnp.take, concatenate, shift_batch's
// jnp.roll, ingest), and, for R seeds, the same under the seed-parallel
// runner's vmap (cgs_tpu/sandbox/seed_parallel.py: each seed its own
// index stacks and its own shift key).
//
// The function. Segments k = 0, 1, 2 are laid end to end in the output,
// and inside segment k the R seeds are laid end to end, n_k frames each
// (segment-major, seed-major within a segment: R = 1 is the plain joined
// batch). Segment k is (bank_k uint8 (M_k, H, W, C) contiguous, idx_k
// int64 (R, n_k) contiguous or none (R = 1 only), labels_k float32 (M_k,)
// or none), and seed r rolls it by s_{r,k}. For output frame q of segment
// k, local row i = q - start_k (seed r = i / n_k) and source frame
// f = idx_k[i] (i when there is no index):
//
//   out[q, h, w, c] = float(bank_k[f, h, (w - s_{r,k}) mod W, c]) * 0x3B808081
//   labels_out[q]   = labels_k[f]                 (where labels_k is given)
//
// which is jnp.roll(jnp.take(bank, idx_k[r]), s_{r,k}, axis=2) then
// ingest, in torch.roll's sign convention for any signed s. The multiply
// is by the f32 constant float(1/255) with __fmul_rn, as the JAX kernel
// and the plain path do (x / 255.f rounds differently for many byte
// values). In bf16 the f32 product is rounded to nearest even, which is
// what `.to(torch.bfloat16)` of the f32 result gives. The indices are not
// checked here: the callers validate them on the host.
//
// Bound on an H100 SXM: bytes. Each element reads 1 byte and writes 4
// (2 in bf16): a serve batch of 8192 64x64x3 frames moves 503 MB in f32,
// 0.150 ms at 3.35 TB/s (0.090 ms in bf16). A masker step's 128 frames
// move 7.9 MB (2.35 us) per seed; at that size the launch costs more than
// the bytes, so the design's aim there is one launch for the whole ingest
// of a step, whatever R is.
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
// element per thread (`ingest_any`). Both kernels are templates on the
// descriptor: one seed (`Segs`) passes today's three shifts, so a serve
// batch or a serial step launches with the parameter block it always
// had; R seeds (`SeededSegs`) pass a table of kMaxSeeds x kMaxSeg shifts
// in the parameter block, a __grid_constant__, so a row reads its seed's
// shift where it lies, and only the thread that stages a row's first 16
// bytes looks it up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSeg = 3;           // segments per launch
constexpr int kMaxSeeds = 64;        // seeds per launch
static_assert(kMaxSeg == 3, "pick and locate select among 3 segments");
constexpr int kMaxRowsPerBlock = 64;
constexpr int kThreads = 256;
constexpr int64_t kMaxStagedRow = 32 * 1024;  // well inside 48 KB of smem
constexpr int64_t kStreamingBytes = 64ll << 20;    // > the 50 MB L2

struct Segs {                    // one seed
  const uint8_t* bank[kMaxSeg];
  const int64_t* idx[kMaxSeg];   // null: the bank's rows in order
  const float* lab[kMaxSeg];     // null: no labels
  int64_t end[kMaxSeg];          // one past the segment's last output
                                 // frame; unused segments end at the total
  int64_t shift_bytes[kMaxSeg];  // ((s mod W) + W) mod W, times C
};

struct SeededSegs {              // R > 1 seeds
  const uint8_t* bank[kMaxSeg];
  const int64_t* idx[kMaxSeg];   // (R, n) rows
  const float* lab[kMaxSeg];
  int64_t end[kMaxSeg];
  int64_t n[kMaxSeg];            // frames per seed (at least 1)
  // seed r, segment k at [r * kMaxSeg + k]: ((s mod W) + W) mod W, times C
  int32_t shift_bytes[kMaxSeeds * kMaxSeg];
};

struct Src {
  const uint8_t* frame;  // the source frame's first byte
  const float* lab;
  int64_t f;             // source frame index within its bank
  int64_t i;             // output frame within its segment, all seeds
  int k;                 // segment
};

// v[k] by selects, so the kernel reads the parameters where they are
// instead of copying them to local memory to index them
template <class T>
__device__ __forceinline__ T pick(const T (&v)[kMaxSeg], int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}

template <class D>
__device__ __forceinline__ Src locate(const D& s, int64_t r,
                                      int64_t frame_bytes) {
  const int k = (r >= s.end[0]) + (r >= s.end[1]);  // end[2] is the total
  const int64_t i = r - (k == 0 ? 0 : (k == 1 ? s.end[0] : s.end[1]));
  const int64_t* idx = pick(s.idx, k);
  const int64_t f = idx ? idx[i] : i;
  return {pick(s.bank, k) + f * frame_bytes, pick(s.lab, k), f, i, k};
}

// the source's roll in bytes: its segment's shift, and with R seeds its
// seed's (a segment holds far fewer than 2^32 frames)
__device__ __forceinline__ int64_t shift_of(const Segs& s, const Src& src) {
  return pick(s.shift_bytes, src.k);
}

__device__ __forceinline__ int64_t shift_of(const SeededSegs& s,
                                            const Src& src) {
  const int seed = (int)((uint32_t)src.i / (uint32_t)pick(s.n, src.k));
  return s.shift_bytes[seed * kMaxSeg + src.k];
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

template <bool kBF16, class D>
__global__ void __launch_bounds__(kThreads)
ingest_rows(const __grid_constant__ D segs, int64_t H, int RB,
            int rows_per_block, int64_t total_rows, void* __restrict__ out,
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
      row_shift[r] = shift_of(segs, src);
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

template <bool kBF16, class D>
__global__ void ingest_any(const __grid_constant__ D segs, int64_t H,
                           int64_t RB, int64_t total, void* __restrict__ out,
                           float* __restrict__ lab_out) {
  const int64_t frame_bytes = H * RB;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t g = i / RB;
    const int64_t j = i - g * RB;
    const int64_t n = g / H;
    const int64_t h = g - n * H;
    const Src src = locate(segs, n, frame_bytes);
    int64_t q = j - shift_of(segs, src);
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

// the banks, index rows, labels and ends of nseg segments of nseeds
// seeds each; returns the total frames, or -1 on a bad descriptor
template <class D>
int64_t fill(D& segs, const int64_t* d, int64_t nseg, int64_t nseeds) {
  int64_t frames = 0;
  for (int k = 0; k < nseg; ++k) {
    const int64_t* s = d + 4 * k;
    if (s[2] < 0 || (s[1] == 0 && nseeds != 1)) {
      return -1;   // R seeds need index rows
    }
    segs.bank[k] = reinterpret_cast<const uint8_t*>(s[0]);
    segs.idx[k] = reinterpret_cast<const int64_t*>(s[1]);
    frames += nseeds * s[2];
    segs.end[k] = frames;
    segs.lab[k] = reinterpret_cast<const float*>(s[3]);
  }
  for (int k = (int)nseg; k < kMaxSeg; ++k) segs.end[k] = frames;
  return frames;
}

template <class D>
int launch(const D& segs, int64_t nseg, int64_t frames, int64_t H,
           int64_t RB, void* out, float* lab, bool bf16,
           cudaStream_t st) {
  const int64_t rows = frames * H;
  if (rows == 0) return 0;
  bool staged = RB % 16 == 0 && RB <= kMaxStagedRow && aligned16(out);
  for (int k = 0; k < nseg; ++k) staged = staged && aligned16(segs.bank[k]);
  if (staged) {
    const int per =
        (int)(RB >= 3072 ? 1 : min64(kMaxRowsPerBlock, 3072 / RB));
    const int64_t blocks = (rows + per - 1) / per;
    const size_t smem = (size_t)per * (RB + 16);
    const bool streaming = rows * RB * (bf16 ? 2 : 4) > kStreamingBytes;
    if (bf16) {
      ingest_rows<true, D><<<(unsigned)blocks, kThreads, smem, st>>>(
          segs, H, (int)RB, per, rows, out, lab, streaming);
    } else {
      ingest_rows<false, D><<<(unsigned)blocks, kThreads, smem, st>>>(
          segs, H, (int)RB, per, rows, out, lab, streaming);
    }
  } else {
    const int64_t total = rows * RB;
    const int64_t cap = (int64_t)132 * 32;
    const int blocks = (int)min64((total + kThreads - 1) / kThreads, cap);
    if (bf16) {
      ingest_any<true, D><<<blocks, kThreads, 0, st>>>(segs, H, RB, total,
                                                       out, lab);
    } else {
      ingest_any<false, D><<<blocks, kThreads, 0, st>>>(segs, H, RB, total,
                                                        out, lab);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// desc: host int64 array, 4 per segment: (bank, idx or 0, n per seed,
// labels or 0); shifts: host int64 (nseeds, nseg), seed r's shift of
// segment k at [r * nseg + k]. Frames are (H, W, C) bytes. out is
// (nseeds * sum n, H, W, C) float32, or bf16 when out_bf16 != 0, in
// segment-major, seed-major order; labels_out (nseeds * sum n,) float32
// or null, written at the frames of segments that have labels.
extern "C" int cgs_normalize_u8(const void* desc, int64_t nseg,
                                int64_t nseeds, const void* shifts,
                                int64_t H, int64_t W, int64_t C, void* out,
                                void* labels_out, int64_t out_bf16,
                                void* stream) {
  if (nseg < 1 || nseg > kMaxSeg || nseeds < 1 || nseeds > kMaxSeeds ||
      H < 1 || W < 1 || C < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t* d = static_cast<const int64_t*>(desc);
  const int64_t* sh = static_cast<const int64_t*>(shifts);
  const int64_t RB = W * C;
  float* lab = static_cast<float*>(labels_out);
  cudaStream_t st = (cudaStream_t)stream;
  const bool bf16 = out_bf16 != 0;
  if (nseeds == 1) {
    Segs segs = {};
    const int64_t frames = fill(segs, d, nseg, 1);
    if (frames < 0) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < nseg; ++k) {
      segs.shift_bytes[k] = ((sh[k] % W) + W) % W * C;
    }
    return launch(segs, nseg, frames, H, RB, out, lab, bf16, st);
  }
  SeededSegs segs = {};
  const int64_t frames = fill(segs, d, nseg, nseeds);
  if (frames < 0) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < kMaxSeg; ++k) {
    segs.n[k] = k < nseg && d[4 * k + 2] > 0 ? d[4 * k + 2] : 1;
    for (int64_t r = 0; r < nseeds && k < nseg; ++r) {
      segs.shift_bytes[r * kMaxSeg + k] =
          (int32_t)((((sh[r * nseg + k] % W) + W) % W) * C);
    }
  }
  return launch(segs, nseg, frames, H, RB, out, lab, bf16, st);
}
