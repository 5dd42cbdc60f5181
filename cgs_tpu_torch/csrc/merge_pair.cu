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
// (pallas_kernels.py:broadcast_mask); here each thread reads its
// pixel's z once and uses it for every channel, so the 3x mask copy is
// never made. The gradients gr and gi arrive in whatever layout
// autograd hands over (cuDNN's data-gradient may come back NCHW or
// NHWC), so the backward takes their element strides (n, c, p) and
// reads either layout in place.
//
// Bound on an H100 SXM: bytes. The forward reads a, b (12 B/pixel
// each) and z (4 B) and writes rep and inj: 52 B per pixel; the
// backward reads a, b, gr, gi and z and writes da, db and dz: 80 B per
// pixel. The masker step (N = 64, 4096 pixels) moves 13.6 MB and
// 21.0 MB: 4.1 us and 6.3 us at 3.35 TB/s, so at that size a launch
// costs more than the traffic. There are ~10 flops per pixel.
//
// Where the forward writes: rep and inj are two pointers, which the
// wrapper (cgs_tpu_torch/ops/kernels.py:merge_pair) sets to the two halves
// of one (2N, C, H, W) channels_last buffer, the critic's fused batch; a
// and b may likewise be the halves of the ingest's joined batch. So the
// masker step makes no torch.cat of either pair.
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
// pixel per thread. The backward: one thread per pixel, grid-stride, no
// shared memory. Each input element is read once. Bit-equality with the
// plain PyTorch version (cgs_tpu_torch/ops/kernels.py:merge_pair_plain
// and merge_pair_bwd_plain): every product, difference and sum is an
// explicitly rounded intrinsic in the plain version's order (keep =
// 1 - z, then a * keep and z * b, then the add; dz = (d0 + d1) + d2),
// so nvcc cannot contract a multiply and an add into an FMA.

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

__global__ void merge_pair_bwd_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ z, const float* __restrict__ gr,
    const float* __restrict__ gi, float* __restrict__ da,
    float* __restrict__ db, float* __restrict__ dz, int64_t npix,
    int64_t P, int64_t C, int64_t gr_sn, int64_t gr_sc, int64_t gr_sp,
    int64_t gi_sn, int64_t gi_sc, int64_t gi_sp) {
  for (int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; p < npix;
       p += (int64_t)gridDim.x * blockDim.x) {
    const int64_t n = p / P;
    const int64_t q = p - n * P;  // pixel within its frame
    const float zp = z[p];
    const float keep = __fsub_rn(1.0f, zp);
    const float* grp = gr + n * gr_sn + q * gr_sp;
    const float* gip = gi + n * gi_sn + q * gi_sp;
    float acc = 0.0f;
    for (int64_t c = 0; c < C; ++c) {
      const int64_t i = p * C + c;
      const float av = a[i];
      const float bv = b[i];
      const float r = grp[c * gr_sc];
      const float g = gip[c * gi_sc];
      da[i] = __fadd_rn(__fmul_rn(r, keep), __fmul_rn(g, zp));
      db[i] = __fadd_rn(__fmul_rn(r, zp), __fmul_rn(g, keep));
      const float d = __fmul_rn(__fsub_rn(r, g), __fsub_rn(bv, av));
      acc = c == 0 ? d : __fadd_rn(acc, d);  // ((d0 + d1) + d2) ...
    }
    dz[p] = acc;
  }
}

int grid_for(int64_t work, int threads) {
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = (int64_t)132 * 32;  // enough blocks for 132 SMs
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

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

extern "C" int cgs_merge_pair_bwd(const void* a, const void* b,
                                  const void* z, const void* gr,
                                  const void* gi, void* da, void* db,
                                  void* dz, int64_t npix, int64_t P,
                                  int64_t C, int64_t gr_sn, int64_t gr_sc,
                                  int64_t gr_sp, int64_t gi_sn,
                                  int64_t gi_sc, int64_t gi_sp,
                                  void* stream) {
  const int threads = 256;
  merge_pair_bwd_kernel<<<grid_for(npix, threads), threads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)z, (const float*)gr,
      (const float*)gi, (float*)da, (float*)db, (float*)dz, npix, P, C,
      gr_sn, gr_sc, gr_sp, gi_sn, gi_sc, gi_sp);
  return (int)cudaGetLastError();
}
