// Nearest-neighbour upsample into a channel concat, NHWC: the decoder's
// skip joins, and their gradient.
//
//   out[b, y, x, c] = skip[b, y, x, c - So]         So <= c < So + Cs
//                   = in[b, y / f, x / f, c - Uo]    Uo <= c < Uo + Cu
//
// skip (B, fH, fW, Cs), in (B, H, W, Cu), out (B, fH, fW, Cs + Cu), f = 2
// or 4. Skip first (So = 0, Uo = Cs): out = cat([skip, up_f(in)],
// channels), the JAX decoder's channel order
// (cgs_tpu/models/decoder.py:124-138). Upsampled first (Uo = 0, So = Cu):
// out = cat([up_f(in), skip]), the order of the model zoo's U-Nets
// (cgs_tpu/models/zoo.py:316-322, 348-351, 391-398). A runtime flag picks
// the order; the two orders differ only in these two channel offsets.
// Cs = 0 is the plain upsample. The x4 join (the bottleneck) is one
// launch.
//
// Replaces cgs_tpu/ops/pallas_upsample.py:upsample2x_pallas (forward
// _up2_kernel; backward _up2_bwd, a 2x2 sum-pool) together with the
// concat that XLA fused into the repeat in the JAX decoder
// (cgs_tpu/models/decoder.py:20-22). Unfused, every upsampled tensor was
// written, read back by torch.cat and written again.
//
// Bound on an H100 SXM: bytes. The forward moves |skip| + |in| + |out|
// with no arithmetic; the backward reads g once and writes d_skip and dx
// once, with 3 (x2) or 15 (x4) adds per dx element. At 3.35 TB/s the
// five chfak-5 joins at batch 8192 in f32 take at least 4.0 ms.
//
// Forward design. One block per (frame, input row): the f output rows it
// writes are one contiguous range of out, f * fW * (Cs + Cu) elements,
// fed by one contiguous range of skip (f * fW * Cs) and one of in
// (W * Cu). The block stages both inputs in shared memory with 16-byte
// loads, then writes its output range as 16-byte stores, each chunk
// assembled element by element from shared memory wherever it falls
// across the skip/upsample boundary. So the 43-channel head join (172 B
// per f32 pixel, 86 B per bf16 one) moves at the full vector width
// though no pixel is 16-byte aligned: the block's range is. A scalar head
// and tail cover ranges whose ends are not 16-byte aligned (ragged
// shapes). The copy is exact: raw 32- or 16-bit elements move, so f32
// and bf16 are one kernel, bit-equal to torch.cat([skip, upsample(in)]).
// Block-local indices are 32-bit and divided by multiply-high with magic
// numbers from the host; offsets into the tensors are 64-bit.
//
// Backward design (cgs_upsample2x_bwd). It reads the concat buffer's
// gradient g once and writes d_skip, a dense copy of the skip channels
// (only when it is asked for), and dx, the f x f sum-pool of the
// upsampled channels: per 2x2 level (g00 + g01) + (g10 + g11), summed in
// f32 with explicitly rounded adds and rounded once to the working type.
// The x4 join rounds each first-level sum to the working type before the
// second level, as the chained plain version does
// (ops/upsample.py:upcat_bwd_plain), so bf16 is bit-equal too. cuDNN's
// dgrad hands g over in either memory format, so the kernel takes g's
// four element strides. When g is channels_last-dense (what the H100
// delivers), one block per (frame, input row) stages its f rows of g
// with 16-byte loads and writes d_skip and dx as 16-byte stores, as the
// forward does; otherwise one thread per output element reads g in
// place through its strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // per block on an H100, opted in

// n / d for n < 2^31 and 1 <= d < 2^31, by multiply-high
struct Divider {
  uint32_t magic, shift;
};

Divider make_divider(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  return {(uint32_t)(((1ull << 32) * ((1ull << s) - d)) / d + 1), s};
}

__device__ __forceinline__ uint32_t divide(uint32_t n, Divider v) {
  return (__umulhi(n, v.magic) + n) >> v.shift;
}

// shared <- global, n elements; 16-byte loads where src is aligned
template <typename E>
__device__ __forceinline__ void stage(E* dst, const E* __restrict__ src,
                                      uint32_t n) {
  constexpr uint32_t V = 16 / sizeof(E);
  uint32_t done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint32_t nv = n / V;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (uint32_t i = threadIdx.x; i < nv; i += blockDim.x) d[i] = __ldg(s + i);
    done = nv * V;
  }
  for (uint32_t i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// dst[0, n) <- elements [0, n) of src's range: 16-byte stores over the
// aligned middle, one element at a time at the unaligned ends
template <typename E, typename Src>
__device__ __forceinline__ void emit(E* __restrict__ dst, uint32_t n,
                                     const Src& src) {
  constexpr uint32_t V = 16 / sizeof(E);
  uint32_t head = (uint32_t)(((16 - (reinterpret_cast<uintptr_t>(dst) & 15))
                              & 15) / sizeof(E));
  if (head > n) head = n;
  const uint32_t nv = (n - head) / V;
  const uint32_t tail = head + nv * V;
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  for (uint32_t k = threadIdx.x; k < nv; k += blockDim.x) {
    union {
      uint4 v;
      E e[V];
    } u;
    src.template get<V>(head + k * V, u.e);
    d[k] = u.v;
  }
  for (uint32_t i = threadIdx.x; i < head + (n - tail); i += blockDim.x) {
    const uint32_t e = i < head ? i : tail + (i - head);
    src.template get<1>(e, dst + e);
  }
}

// the forward's output range of one block: f rows x fW pixels x Ct
template <typename E>
struct CatSource {
  const E* skip;  // shared: f rows x fW pixels x Cs
  const E* in;    // shared: W pixels x Cu
  uint32_t Cs, Cu, Ct, fW, fshift;
  uint32_t so, uo;  // the first channel of the skip, of the upsampled
  Divider by_ct, by_fw;

  template <int N>
  __device__ __forceinline__ void get(uint32_t e, E* out) const {
    uint32_t pix = divide(e, by_ct);
    uint32_t c = e - pix * Ct;
    uint32_t p = pix - divide(pix, by_fw) * fW;  // column in its row
#pragma unroll
    for (int j = 0; j < N; ++j) {
      out[j] = c - so < Cs ? skip[pix * Cs + (c - so)]
                           : in[(p >> fshift) * Cu + (c - uo)];
      if (++c == Ct) {
        c = 0;
        ++pix;
        if (++p == fW) p = 0;
      }
    }
  }
};

template <typename E>
__global__ void __launch_bounds__(kThreads)
    upsample_cat_fwd(const E* __restrict__ skip, const E* __restrict__ in,
                     E* __restrict__ out, int64_t rows, uint32_t n_skip,
                     uint32_t n_in, uint32_t n_out, uint32_t in_off,
                     CatSource<E> src) {
  extern __shared__ uint4 smem[];
  E* s_skip = reinterpret_cast<E*>(smem);
  E* s_in = s_skip + in_off;
  src.skip = s_skip;
  src.in = s_in;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    stage(s_skip, skip + r * n_skip, n_skip);
    stage(s_in, in + r * n_in, n_in);
    __syncthreads();
    emit(out + r * n_out, n_out, src);
    __syncthreads();
  }
}

unsigned grid_rows(int64_t rows) {
  return (unsigned)(rows < 0x7fffffff ? rows : 0x7fffffff);
}

// opt in above 48 KB; a failure leaves no error behind for the next call
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

template <typename E>
int launch_fwd(const void* skip, const void* in, void* out, int64_t B,
               int64_t H, int64_t W, int64_t Cs, int64_t Cu,
               uint32_t fshift, bool up_first, cudaStream_t s) {
  constexpr int64_t V = 16 / sizeof(E);
  const int64_t f = 1 << fshift, fW = W << fshift, Ct = Cs + Cu;
  const int64_t n_skip = f * fW * Cs, n_in = W * Cu, n_out = f * fW * Ct;
  if (B * H == 0 || n_out == 0) return 0;
  if (n_out >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int64_t in_off = (n_skip + V - 1) / V * V;
  const size_t smem = (size_t)(in_off + (n_in + V - 1) / V * V) * sizeof(E);
  const int err = allow_smem(upsample_cat_fwd<E>, smem);
  if (err) return err;
  const CatSource<E> src{nullptr, nullptr, (uint32_t)Cs, (uint32_t)Cu,
                         (uint32_t)Ct, (uint32_t)fW, fshift,
                         up_first ? (uint32_t)Cu : 0u,
                         up_first ? 0u : (uint32_t)Cs,
                         make_divider((uint32_t)Ct),
                         make_divider((uint32_t)fW)};
  upsample_cat_fwd<E><<<grid_rows(B * H), kThreads, smem, s>>>(
      (const E*)skip, (const E*)in, (E*)out, B * H, (uint32_t)n_skip,
      (uint32_t)n_in, (uint32_t)n_out, (uint32_t)in_off, src);
  return (int)cudaGetLastError();
}

// -- backward ----------------------------------------------------------

struct F32 {
  using E = uint32_t;
  static __device__ __forceinline__ float load(E v) {
    return __uint_as_float(v);
  }
  static __device__ __forceinline__ E store(float x) {
    return __float_as_uint(x);
  }
};

struct BF16 {
  using E = uint16_t;
  static __device__ __forceinline__ float load(E v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  }
  static __device__ __forceinline__ E store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

// (g00 + g01) + (g10 + g11) at p, in f32
template <typename Ty>
__device__ __forceinline__ float pool2(const typename Ty::E* p, int64_t sh,
                                       int64_t sw) {
  const float top = __fadd_rn(Ty::load(p[0]), Ty::load(p[sw]));
  const float bot = __fadd_rn(Ty::load(p[sh]), Ty::load(p[sh + sw]));
  return __fadd_rn(top, bot);
}

// a first-level sum of the x4 join, rounded to the working type
template <typename Ty>
__device__ __forceinline__ float pool2_rounded(const typename Ty::E* p,
                                               int64_t sh, int64_t sw) {
  return Ty::load(Ty::store(pool2<Ty>(p, sh, sw)));
}

// dx of the f x f block whose top-left element is at p
template <typename Ty>
__device__ __forceinline__ typename Ty::E pool(const typename Ty::E* p,
                                               int64_t sh, int64_t sw,
                                               uint32_t fshift) {
  if (fshift == 1) return Ty::store(pool2<Ty>(p, sh, sw));
  const float top = __fadd_rn(pool2_rounded<Ty>(p, sh, sw),
                              pool2_rounded<Ty>(p + 2 * sw, sh, sw));
  const float bot = __fadd_rn(pool2_rounded<Ty>(p + 2 * sh, sh, sw),
                              pool2_rounded<Ty>(p + 2 * sh + 2 * sw, sh, sw));
  return Ty::store(__fadd_rn(top, bot));
}

// d_skip range of one block, from its f rows of g in shared memory
template <typename E>
struct SkipSource {
  const E* g;
  uint32_t Cs, Ct, so;
  Divider by_cs;

  template <int N>
  __device__ __forceinline__ void get(uint32_t e, E* out) const {
    uint32_t pix = divide(e, by_cs);
    uint32_t c = e - pix * Cs;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      out[j] = g[pix * Ct + so + c];
      if (++c == Cs) {
        c = 0;
        ++pix;
      }
    }
  }
};

// dx range of one block (one input row), from the same f rows
template <typename Ty>
struct PoolSource {
  using E = typename Ty::E;
  const E* g;
  uint32_t uo, Cu, Ct, fW, fshift;
  Divider by_cu;

  template <int N>
  __device__ __forceinline__ void get(uint32_t e, E* out) const {
    uint32_t j = divide(e, by_cu);
    uint32_t c = e - j * Cu;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      out[k] = pool<Ty>(g + (j << fshift) * Ct + uo + c, (int64_t)fW * Ct,
                        Ct, fshift);
      if (++c == Cu) {
        c = 0;
        ++j;
      }
    }
  }
};

template <typename Ty>
__global__ void __launch_bounds__(kThreads) upsample_cat_bwd_staged(
    const typename Ty::E* __restrict__ g, typename Ty::E* __restrict__ dskip,
    typename Ty::E* __restrict__ dx, int64_t rows, uint32_t n_g,
    uint32_t n_skip, uint32_t n_in, SkipSource<typename Ty::E> skip_src,
    PoolSource<Ty> pool_src) {
  using E = typename Ty::E;
  extern __shared__ uint4 smem[];
  E* s_g = reinterpret_cast<E*>(smem);
  skip_src.g = s_g;
  pool_src.g = s_g;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    stage(s_g, g + r * n_g, n_g);
    __syncthreads();
    if (dskip != nullptr) emit(dskip + r * n_skip, n_skip, skip_src);
    emit(dx + r * n_in, n_in, pool_src);
    __syncthreads();
  }
}

template <typename Ty>
__global__ void __launch_bounds__(kThreads) upsample_cat_bwd_strided(
    const typename Ty::E* __restrict__ g, typename Ty::E* __restrict__ dskip,
    typename Ty::E* __restrict__ dx, int64_t B, int64_t H, int64_t W,
    int64_t Cs, int64_t Cu, uint32_t fshift, int64_t so, int64_t uo,
    int64_t sb, int64_t sh, int64_t sw, int64_t sc) {
  const int64_t fH = H << fshift, fW = W << fshift;
  const int64_t n_skip = dskip != nullptr ? B * fH * fW * Cs : 0;
  const int64_t n_dx = B * H * W * Cu;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  for (int64_t i = first; i < n_skip; i += step) {
    const int64_t c = i % Cs, pix = i / Cs;
    const int64_t x = pix % fW, by = pix / fW;
    dskip[i] = g[(by / fH) * sb + (by % fH) * sh + x * sw + (so + c) * sc];
  }
  for (int64_t i = first; i < n_dx; i += step) {
    const int64_t c = i % Cu, pix = i / Cu;
    const int64_t j = pix % W, bi = pix / W;
    dx[i] = pool<Ty>(g + (bi / H) * sb + ((bi % H) << fshift) * sh +
                         (j << fshift) * sw + (uo + c) * sc,
                     sh, sw, fshift);
  }
}

template <typename Ty>
int launch_bwd(const void* g, void* dskip, void* dx, int64_t B, int64_t H,
               int64_t W, int64_t Cs, int64_t Cu, uint32_t fshift,
               bool up_first, int64_t sb, int64_t sh, int64_t sw, int64_t sc,
               cudaStream_t s) {
  using E = typename Ty::E;
  const int64_t f = 1 << fshift, fH = H << fshift, fW = W << fshift;
  const int64_t Ct = Cs + Cu;
  const int64_t so = up_first ? Cu : 0, uo = up_first ? 0 : Cs;
  const int64_t n_g = f * fW * Ct;
  if (B * H == 0 || n_g == 0) return 0;
  if (Cs == 0) dskip = nullptr;
  const size_t smem = (size_t)n_g * sizeof(E);
  const bool dense = sc == 1 && sw == Ct && sh == fW * Ct &&
                     sb == fH * fW * Ct;
  if (dense && smem <= kMaxSmem) {
    const int err = allow_smem(upsample_cat_bwd_staged<Ty>, smem);
    if (err) return err;
    const SkipSource<E> skip_src{nullptr, (uint32_t)Cs, (uint32_t)Ct,
                                 (uint32_t)so,
                                 make_divider(Cs > 0 ? (uint32_t)Cs : 1)};
    const PoolSource<Ty> pool_src{nullptr,      (uint32_t)uo, (uint32_t)Cu,
                                  (uint32_t)Ct, (uint32_t)fW, fshift,
                                  make_divider(Cu > 0 ? (uint32_t)Cu : 1)};
    upsample_cat_bwd_staged<Ty><<<grid_rows(B * H), kThreads, smem, s>>>(
        (const E*)g, (E*)dskip, (E*)dx, B * H, (uint32_t)n_g,
        (uint32_t)(f * fW * Cs), (uint32_t)(W * Cu), skip_src, pool_src);
  } else {
    const int64_t work = B * H * W * (Cu + (dskip != nullptr ? f * f * Cs : 0));
    int64_t blocks = (work + kThreads - 1) / kThreads;
    const int64_t cap = (int64_t)132 * 64;
    blocks = blocks < cap ? (blocks > 0 ? blocks : 1) : cap;
    upsample_cat_bwd_strided<Ty><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const E*)g, (E*)dskip, (E*)dx, B, H, W, Cs, Cu, fshift, so, uo, sb,
        sh, sw, sc);
  }
  return (int)cudaGetLastError();
}

int fshift_of(int64_t factor) {
  return factor == 2 ? 1 : factor == 4 ? 2 : 0;
}

}  // namespace

// skip (B, fH, fW, Cs) (may be null when Cs = 0), in (B, H, W, Cu) and
// out (B, fH, fW, Cs + Cu), all contiguous NHWC; factor f in {2, 4};
// up_first != 0 puts the upsampled channels first; elem_bytes 4
// (float32) or 2 (bfloat16).
extern "C" int cgs_upsample2x(const void* skip, const void* in, void* out,
                              int64_t B, int64_t H, int64_t W, int64_t Cs,
                              int64_t Cu, int64_t factor, int64_t up_first,
                              int64_t elem_bytes, void* stream) {
  const int fshift = fshift_of(factor);
  if (fshift == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4)
    return launch_fwd<uint32_t>(skip, in, out, B, H, W, Cs, Cu, fshift,
                                up_first != 0, s);
  if (elem_bytes == 2)
    return launch_fwd<uint16_t>(skip, in, out, B, H, W, Cs, Cu, fshift,
                                up_first != 0, s);
  return (int)cudaErrorInvalidValue;
}

// g: (B, fH, fW, Cs + Cu) with element strides (sb, sh, sw, sc), the
// upsampled channels first when up_first != 0; dskip (B, fH, fW, Cs)
// contiguous or null (not wanted); dx (B, H, W, Cu) contiguous; factor f
// in {2, 4}; bf16 != 0 selects bfloat16, else float32.
extern "C" int cgs_upsample2x_bwd(const void* g, void* dskip, void* dx,
                                  int64_t B, int64_t H, int64_t W,
                                  int64_t Cs, int64_t Cu, int64_t factor,
                                  int64_t up_first, int64_t sb, int64_t sh,
                                  int64_t sw,
                                  int64_t sc, int64_t bf16, void* stream) {
  const int fshift = fshift_of(factor);
  if (fshift == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_bwd<BF16>(g, dskip, dx, B, H, W, Cs, Cu, fshift,
                            up_first != 0, sb, sh, sw, sc, s);
  return launch_bwd<F32>(g, dskip, dx, B, H, W, Cs, Cu, fshift,
                         up_first != 0, sb, sh, sw, sc, s);
}
