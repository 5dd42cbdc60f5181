// The two counterfactual merges of the masker step and their gradient.
//
//   merge_pair:      rep = a * (1 - z) + z * b,   inj = b * (1 - z) + z * a
//   merge_pair_bwd:  da  = gr * (1 - z) + gi * z
//                    db  = gr * z + gi * (1 - z)
//                    dz  = sum over c = 0, 1, 2 of (gr - gi) * (b - a)
//
// Replaces cgs_tpu/ops/pallas_kernels.py:merge_pair (_merge_kernel) and
// :merge_pair_bwd (_merge_bwd_kernel), with the channel sum of dz that
// cgs_tpu/ops/merge.py:_merge_both_bwd does after the TPU kernel fused
// in.
//
// Layout: a, b (and rep, inj, da, db) are NCHW frames stored
// channels_last, i.e. the memory is NHWC: element (n, p, c) of pixel
// p = h * W + w at (n * P + p) * C + c. z and dz hold one float per
// pixel, (N, 1, H, W). The TPU kernel took z pre-broadcast to (N, H*W*3)
// (pallas_kernels.py:broadcast_mask); here z is read once per pixel and
// used for every channel, so the 3x mask copy is never made.
//
// Where the forward writes: rep and inj are two pointers, which the
// wrapper (cgs_tpu_torch/ops/kernels.py:merge_pair) sets to the two halves
// of one (2N, C, H, W) channels_last buffer, the critic's fused batch; a
// and b may likewise be the halves of the ingest's joined batch. So the
// masker step makes no torch.cat of either pair. The backward takes the
// gradient of that joined buffer as one pointer g with its (n, c, pixel)
// element strides, as autograd hands it over: gr is its first N frames
// and gi starts N frames later.
//
// Bound on an H100 SXM (3.35 TB/s): bytes; there are ~10 flops per
// pixel. The forward reads a, b (12 B/pixel each) and z (4 B) and writes
// rep and inj: 52 B per pixel, 0.00407 ms at the masker step's N = 64
// (4096 pixels a frame) and 0.521 ms at N = 8192. The backward writes
// only the gradients autograd asks for. The masker step asks for dz
// alone (the frames need no gradient): it reads a, b, gr and gi and
// writes dz, 52 B per pixel, 0.00407 ms at N = 64 and 0.521 ms at
// N = 8192; all three outputs also read z and write da and db, 80 B per
// pixel, 0.00626 ms and 0.801 ms.
//
// Design of the forward: a thread takes 4 consecutive floats of a and of
// b (one float4 each) and writes one float4 of rep and of inj, so
// consecutive lanes touch consecutive 16-byte chunks and a warp's load or
// store covers 512 contiguous bytes; the (at most two) z values of its
// elements' pixels, e / 3, come from L1, which neighbouring lanes share.
// (A thread per 4 whole pixels, 3 float4 of each frame at a 48-byte
// stride between lanes, read 1.56 ms at N = 8192 on an H100 SXM, against
// 0.86 ms for one thread per pixel, most likely for those strided
// 16-byte accesses.) The last numel % 4 elements go one at a time in the
// same launch; another channel count or an unaligned frame buffer, one
// pixel per thread.
//
// Design of the backward: one kernel per set of requested outputs (a
// template on da, db, dz), so the dz-only kernel never reads z and never
// writes da or db. With C == 3, a channels_last-dense gradient and every
// buffer 16-byte aligned, a block of 256 threads takes a tile of 1024
// pixels (3072 floats, 768 float4 per tensor): each thread loads float4
// number t, t + 256 and t + 512 of the tile from a, b, gr and gi (12
// loads in flight, consecutive lanes on consecutive 16 bytes), computes
// the 12 products d = (gr - gi) * (b - a) and stages them in shared
// memory; then thread t reads the 12 products of pixels 4t..4t+3 (float4
// 3t, 3t+1, 3t+2: conflict-free, 8 lanes of a quarter-warp cover all 32
// banks) and writes their four dz = ((d0 + d1) + d2) as one float4. When
// da and db are asked for, they are written from the same float4s, each
// element's z read from the tile's z staged in shared memory. Index
// math inside a tile is 32-bit. Tiles may span frames; the last
// npix % 1024 pixels are taken one per thread by one more block of the
// same launch. An NCHW-dense gradient, another channel count or a buffer
// off a 16-byte boundary take a per-pixel kernel (a block row per frame,
// so no division per pixel) that reads the gradient through its strides.
//
// Bit-equality with the plain PyTorch version
// (cgs_tpu_torch/ops/kernels.py:merge_pair_plain and
// merge_pair_bwd_plain): every product, difference and sum is an
// explicitly rounded intrinsic in the plain version's order (keep =
// 1 - z, then a * keep and z * b, then the add; dz = (d0 + d1) + d2), so
// nvcc cannot contract a multiply and an add into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void merge_px(float av, float bv, float zp,
                                         float keep, float* r, float* i) {
  *r = __fadd_rn(__fmul_rn(av, keep), __fmul_rn(zp, bv));
  *i = __fadd_rn(__fmul_rn(bv, keep), __fmul_rn(zp, av));
}

// C == 3, a, b, rep and inj 16-byte aligned: thread v takes the float4
// v of a, b, rep and inj, i.e. elements 4v..4v+3, whose pixels e / 3
// span at most two z values; thread v == nvec takes the numel % 4
// elements left
__global__ void merge_pair_vec4(const float4* __restrict__ a,
                                const float4* __restrict__ b,
                                const float* __restrict__ z,
                                float4* __restrict__ rep,
                                float4* __restrict__ inj, int64_t numel) {
  const int64_t nvec = numel / 4;
  for (int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       v <= nvec; v += (int64_t)gridDim.x * blockDim.x) {
    if (v == nvec) {
      const float* af = reinterpret_cast<const float*>(a);
      const float* bf = reinterpret_cast<const float*>(b);
      float* rf = reinterpret_cast<float*>(rep);
      float* jf = reinterpret_cast<float*>(inj);
      for (int64_t e = 4 * nvec; e < numel; ++e) {
        const float zp = z[e / 3];
        merge_px(af[e], bf[e], zp, __fsub_rn(1.0f, zp), &rf[e], &jf[e]);
      }
      continue;
    }
    const float4 x = a[v];
    const float4 y = b[v];
    const float av[4] = {x.x, x.y, x.z, x.w};
    const float bv[4] = {y.x, y.y, y.z, y.w};
    float rv[4], iv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float zp = z[(4 * v + j) / 3];
      merge_px(av[j], bv[j], zp, __fsub_rn(1.0f, zp), &rv[j], &iv[j]);
    }
    rep[v] = make_float4(rv[0], rv[1], rv[2], rv[3]);
    inj[v] = make_float4(iv[0], iv[1], iv[2], iv[3]);
  }
}

__global__ void merge_pair_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  const float* __restrict__ z,
                                  float* __restrict__ rep,
                                  float* __restrict__ inj, int64_t npix,
                                  int64_t C) {
  for (int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; p < npix;
       p += (int64_t)gridDim.x * blockDim.x) {
    const float zp = z[p];
    const float keep = __fsub_rn(1.0f, zp);
    for (int64_t c = 0; c < C; ++c) {
      const int64_t i = p * C + c;
      merge_px(a[i], b[i], zp, keep, &rep[i], &inj[i]);
    }
  }
}

// ---- the backward ------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTilePix = 4 * kThreads;  // pixels of a tile: 4 per thread
constexpr int kTileVec = 3 * kThreads;  // float4 of a tile per tensor (C = 3)

__device__ __forceinline__ float dprod(float r, float g, float av,
                                       float bv) {
  return __fmul_rn(__fsub_rn(r, g), __fsub_rn(bv, av));
}

__device__ __forceinline__ float da_of(float r, float g, float zp,
                                       float keep) {
  return __fadd_rn(__fmul_rn(r, keep), __fmul_rn(g, zp));
}

__device__ __forceinline__ float db_of(float r, float g, float zp,
                                       float keep) {
  return __fadd_rn(__fmul_rn(r, zp), __fmul_rn(g, keep));
}

// One pixel, any C: a, b, da and db point at its C elements (unit
// stride, channels_last), gr and gi at its gradient elements (stride
// sc); zp is its z, read only when da or db is asked for.
template <bool DA, bool DB, bool DZ>
__device__ __forceinline__ void bwd_pixel(const float* a, const float* b,
                                          float zp, const float* gr,
                                          const float* gi, int64_t sc,
                                          float* da, float* db, float* dz,
                                          int64_t C) {
  const float keep = __fsub_rn(1.0f, zp);
  float acc = 0.0f;
  for (int64_t c = 0; c < C; ++c) {
    const float r = gr[c * sc], g = gi[c * sc];
    if (DA) da[c] = da_of(r, g, zp, keep);
    if (DB) db[c] = db_of(r, g, zp, keep);
    if (DZ) {
      const float d = dprod(r, g, a[c], b[c]);
      acc = c == 0 ? d : __fadd_rn(acc, d);  // ((d0 + d1) + d2) ...
    }
  }
  if (DZ) *dz = acc;
}

// C == 3, the gradient channels_last-dense (so gr and gi share a's
// element offsets), every buffer 16-byte aligned: block x < ntiles takes
// tile x (module comment); block ntiles the npix % kTilePix pixels left.
template <bool DA, bool DB, bool DZ>
__global__ void __launch_bounds__(kThreads)
    merge_pair_bwd_tile(const float4* __restrict__ a,
                        const float4* __restrict__ b,
                        const float4* __restrict__ z,
                        const float4* __restrict__ gr,
                        const float4* __restrict__ gi,
                        float4* __restrict__ da, float4* __restrict__ db,
                        float4* __restrict__ dz, int64_t npix) {
  __shared__ float4 s_d[DZ ? kTileVec : 1];
  __shared__ float4 s_z4[(DA || DB) ? kThreads : 1];
  const int t = threadIdx.x;
  const int64_t tile = blockIdx.x;
  if (tile == npix / kTilePix) {
    const float* zf = reinterpret_cast<const float*>(z);
    for (int64_t p = tile * kTilePix + t; p < npix; p += kThreads) {
      const int64_t e = 3 * p;
      bwd_pixel<DA, DB, DZ>(
          reinterpret_cast<const float*>(a) + e,
          reinterpret_cast<const float*>(b) + e,
          (DA || DB) ? zf[p] : 0.0f, reinterpret_cast<const float*>(gr) + e,
          reinterpret_cast<const float*>(gi) + e, 1,
          reinterpret_cast<float*>(da) + e, reinterpret_cast<float*>(db) + e,
          reinterpret_cast<float*>(dz) + p, 3);
    }
    return;
  }
  const int64_t v0 = tile * kTileVec;  // the tile's first float4
  float4 r[3], g[3], x[3], y[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int64_t v = v0 + k * kThreads + t;
    r[k] = gr[v];
    g[k] = gi[v];
    if (DZ) {
      x[k] = a[v];
      y[k] = b[v];
    }
  }
  if (DA || DB) {
    s_z4[t] = z[tile * kThreads + t];
    __syncthreads();
  }
  const float* s_z = reinterpret_cast<const float*>(s_z4);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int v = k * kThreads + t;  // float4 of the tile: elements 4v..4v+3
    const float rv[4] = {r[k].x, r[k].y, r[k].z, r[k].w};
    const float gv[4] = {g[k].x, g[k].y, g[k].z, g[k].w};
    if (DZ) {
      const float av[4] = {x[k].x, x[k].y, x[k].z, x[k].w};
      const float bv[4] = {y[k].x, y[k].y, y[k].z, y[k].w};
      s_d[v] = make_float4(dprod(rv[0], gv[0], av[0], bv[0]),
                           dprod(rv[1], gv[1], av[1], bv[1]),
                           dprod(rv[2], gv[2], av[2], bv[2]),
                           dprod(rv[3], gv[3], av[3], bv[3]));
    }
    if (DA || DB) {
      float dav[4], dbv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float zp = s_z[(4 * v + j) / 3];
        const float keep = __fsub_rn(1.0f, zp);
        dav[j] = da_of(rv[j], gv[j], zp, keep);
        dbv[j] = db_of(rv[j], gv[j], zp, keep);
      }
      if (DA) da[v0 + v] = make_float4(dav[0], dav[1], dav[2], dav[3]);
      if (DB) db[v0 + v] = make_float4(dbv[0], dbv[1], dbv[2], dbv[3]);
    }
  }
  if (DZ) {
    __syncthreads();
    const float4 p0 = s_d[3 * t], p1 = s_d[3 * t + 1], p2 = s_d[3 * t + 2];
    // pixel 4t + i's three products are q[3i], q[3i + 1], q[3i + 2]
    const float q[12] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y,
                         p1.z, p1.w, p2.x, p2.y, p2.z, p2.w};
    float o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = __fadd_rn(__fadd_rn(q[3 * i], q[3 * i + 1]), q[3 * i + 2]);
    dz[tile * kThreads + t] = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// Any C, the gradient in any layout its strides describe (sn, sc, sp:
// frame, channel, pixel), any alignment: one thread per pixel, block row
// y walks the frames, so the frame index needs no division.
template <bool DA, bool DB, bool DZ>
__global__ void merge_pair_bwd_px(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  const float* __restrict__ z,
                                  const float* __restrict__ g,
                                  float* __restrict__ da,
                                  float* __restrict__ db,
                                  float* __restrict__ dz, int64_t N,
                                  int64_t P, int64_t C, int64_t sn,
                                  int64_t sc, int64_t sp) {
  for (int64_t n = blockIdx.y; n < N; n += gridDim.y) {
    for (int64_t q = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; q < P;
         q += (int64_t)gridDim.x * blockDim.x) {
      const int64_t p = n * P + q, e = p * C;
      const float* gr = g + n * sn + q * sp;
      bwd_pixel<DA, DB, DZ>(a + e, b + e, (DA || DB) ? z[p] : 0.0f, gr,
                            gr + N * sn, sc, da + e, db + e, dz + p, C);
    }
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <bool DA, bool DB, bool DZ>
void launch_bwd(const float* a, const float* b, const float* z,
                const float* g, float* da, float* db, float* dz, int64_t N,
                int64_t P, int64_t C, int64_t sn, int64_t sc, int64_t sp,
                cudaStream_t s) {
  const int64_t npix = N * P;
  const float* gi = g + N * sn;
  const bool tiled =
      C == 3 && sc == 1 && sp == 3 && sn == 3 * P && aligned16(g) &&
      aligned16(gi) &&
      (!DZ || (aligned16(a) && aligned16(b) && aligned16(dz))) &&
      (!(DA || DB) || aligned16(z)) && (!DA || aligned16(da)) &&
      (!DB || aligned16(db));
  if (tiled) {
    const int64_t blocks = npix / kTilePix + (npix % kTilePix != 0);
    merge_pair_bwd_tile<DA, DB, DZ><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float4*)a, (const float4*)b, (const float4*)z,
        (const float4*)g, (const float4*)gi, (float4*)da, (float4*)db,
        (float4*)dz, npix);
  } else {
    const int64_t bx = (P + kThreads - 1) / kThreads;
    const dim3 grid((unsigned)(bx < 1024 ? bx : 1024),
                    (unsigned)(N < 65535 ? N : 65535));
    merge_pair_bwd_px<DA, DB, DZ><<<grid, kThreads, 0, s>>>(
        a, b, z, g, da, db, dz, N, P, C, sn, sc, sp);
  }
}

int grid_for(int64_t work, int threads) {
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = (int64_t)132 * 32;  // enough blocks for 132 SMs
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" int cgs_merge_pair(const void* a, const void* b, const void* z,
                              void* rep, void* inj, int64_t npix, int64_t C,
                              void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 3 && aligned16(a) && aligned16(b) && aligned16(rep) &&
      aligned16(inj)) {
    merge_pair_vec4<<<grid_for(3 * npix / 4 + 1, threads), threads, 0,
                      s>>>((const float4*)a, (const float4*)b,
                           (const float*)z, (float4*)rep, (float4*)inj,
                           3 * npix);
  } else {
    merge_pair_kernel<<<grid_for(npix, threads), threads, 0, s>>>(
        (const float*)a, (const float*)b, (const float*)z, (float*)rep,
        (float*)inj, npix, C);
  }
  return (int)cudaGetLastError();
}

// g: the (2N, C, H, W) gradient of merge_pair's joined output, element
// strides (g_sn, g_sc, g_sp). da, db and dz are the outputs asked for; a
// null pointer is one not asked for (at least one must be asked for, and
// N * P > 0).
extern "C" int cgs_merge_pair_bwd(const void* a, const void* b,
                                  const void* z, const void* g, void* da,
                                  void* db, void* dz, int64_t N, int64_t P,
                                  int64_t C, int64_t g_sn, int64_t g_sc,
                                  int64_t g_sp, void* stream) {
  const float *fa = (const float*)a, *fb = (const float*)b,
              *fz = (const float*)z, *fg = (const float*)g;
  float *fda = (float*)da, *fdb = (float*)db, *fdz = (float*)dz;
  cudaStream_t s = (cudaStream_t)stream;
#define CGS_BWD(DA, DB, DZ)                                                \
  launch_bwd<DA, DB, DZ>(fa, fb, fz, fg, fda, fdb, fdz, N, P, C, g_sn, g_sc, \
                         g_sp, s)
  switch ((da != nullptr) | (db != nullptr) << 1 | (dz != nullptr) << 2) {
    case 1: CGS_BWD(true, false, false); break;
    case 2: CGS_BWD(false, true, false); break;
    case 3: CGS_BWD(true, true, false); break;
    case 4: CGS_BWD(false, false, true); break;
    case 5: CGS_BWD(true, false, true); break;
    case 6: CGS_BWD(false, true, true); break;
    case 7: CGS_BWD(true, true, true); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef CGS_BWD
  return (int)cudaGetLastError();
}
