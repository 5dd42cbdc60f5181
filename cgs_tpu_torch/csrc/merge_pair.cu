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
// Design: one thread per pixel, grid-stride, no shared memory; each
// input element is read once. Bit-equality with the plain PyTorch
// version (cgs_tpu_torch/ops/kernels.py:merge_pair_plain and
// merge_pair_bwd_plain): every product, difference and sum is an
// explicitly rounded intrinsic in the plain version's order (keep =
// 1 - z, then a * keep and z * b, then the add; dz = (d0 + d1) + d2),
// so nvcc cannot contract a multiply and an add into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
      const float av = a[i];
      const float bv = b[i];
      rep[i] = __fadd_rn(__fmul_rn(av, keep), __fmul_rn(zp, bv));
      inj[i] = __fadd_rn(__fmul_rn(bv, keep), __fmul_rn(zp, av));
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

}  // namespace

extern "C" int cgs_merge_pair(const void* a, const void* b, const void* z,
                              void* rep, void* inj, int64_t npix, int64_t C,
                              void* stream) {
  const int threads = 256;
  merge_pair_kernel<<<grid_for(npix, threads), threads, 0,
                      (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)z, (float*)rep,
      (float*)inj, npix, C);
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
