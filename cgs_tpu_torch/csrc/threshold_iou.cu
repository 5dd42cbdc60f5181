// Fused threshold + IoU counts: over every element i,
//   inter = count of (mask[i] > thr) && (gt[i] > 0)
//   union = count of (mask[i] > thr) || (gt[i] > 0)
// written to out[0] and out[1] (int64) by the kernel itself.
//
// Replaces cgs_tpu/ops/pallas_kernels.py:threshold_iou
// (_thresh_iou_kernel).
//
// Bound on an H100 SXM: bytes. Each element reads 4 bytes of mask and
// 1 byte of ground truth, so the least time is 5 * numel / 3.35 TB/s
// (the 2450 x 64x64 eval set: 50.2 MB, 0.0150 ms). A compare and two adds
// per element are noise next to that.
//
// Design: the TPU kernel carried one running sum through its sequential
// grid; here blocks run in any order. One launch does everything, so a
// call is one device operation (no fill of the counts, no second launch
// for a ragged tail):
// - The grid is the number of blocks the occupancy calculator puts on
//   one SM times the SM count (at most kMaxBlocks), so every SM is full.
// - Each thread counts in 32-bit registers over a grid-stride loop that
//   takes 16 elements per thread per iteration when the mask is 16-byte
//   and gt 4-byte aligned: 4 float4 of mask and 4 uchar4 of gt, each
//   load from consecutive lanes at consecutive addresses (a warp load
//   covers 512 contiguous bytes of mask, 128 of gt), all 8 in flight
//   before the compares. The units left over, the numel % 4 ragged
//   elements, and unaligned inputs go element by element in the same
//   launch.
// - Each block reduces its counts (warp shuffles, one shared-memory
//   pass) to 64 bits and writes them to its slot of a scratch buffer.
//   Then it fences and takes a ticket from a counter beside the slots;
//   the block that draws the last ticket sums every slot and writes the
//   two counts, then sets the ticket back to 0 for the next call. There
//   are no atomics on the counts, and integer sums give the same result
//   in any order, so the counts are exact and the same on every run.
// The scratch (kMaxBlocks slot pairs and the ticket, zeroed once) is
// owned by the caller, one per stream (ops/kernels.py:threshold_iou):
// calls that share it must run one after another. Counts are integers
// throughout (a float count would round above 2^24). The comparison is
// strict (>), as in the eval harness.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 2048;  // slot pairs of the caller's scratch
constexpr int kMaxDevices = 64;

typedef unsigned long long u64;

__device__ __forceinline__ void count1(float m, uint8_t g, float thr,
                                       unsigned& inter, unsigned& uni) {
  const bool h = m > thr, t = g > 0;
  inter += (h && t);
  uni += (h || t);
}

__device__ __forceinline__ void count4(float4 m, uchar4 g, float thr,
                                       unsigned& inter, unsigned& uni) {
  count1(m.x, g.x, thr, inter, uni);
  count1(m.y, g.y, thr, inter, uni);
  count1(m.z, g.z, thr, inter, uni);
  count1(m.w, g.w, thr, inter, uni);
}

// a and b summed over the block; the totals are valid in thread 0
__device__ __forceinline__ void block_sum(u64& a, u64& b) {
  __shared__ u64 s_a[kWarps], s_b[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xFFFFFFFFu, a, off);
    b += __shfl_down_sync(0xFFFFFFFFu, b, off);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    s_a[warp] = a;
    s_b[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 1; k < kWarps; ++k) {
      a += s_a[k];
      b += s_b[k];
    }
  }
  __syncthreads();  // s_a and s_b may be reused
}

// partials: 2 * gridDim.x slots (inter, union per block), ticket: 0 on
// entry and on exit; out: the two counts
__global__ void __launch_bounds__(kThreads)
    threshold_iou_kernel(const float* __restrict__ mask,
                         const uint8_t* __restrict__ gt, int64_t n, int vec,
                         float thr, u64* __restrict__ partials,
                         unsigned int* __restrict__ ticket,
                         u64* __restrict__ out) {
  // per-thread counts stay below 2^32 until numel passes ~5e14
  unsigned int inter = 0, uni = 0;
  const int64_t T = (int64_t)gridDim.x * kThreads;
  const int64_t tid = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  int64_t lo = 0;  // elements the vector loops took
  if (vec) {
    const float4* m4 = reinterpret_cast<const float4*>(mask);
    const uchar4* g4 = reinterpret_cast<const uchar4*>(gt);
    const int64_t n4 = n / 4;
    // thread tid takes units tid + m * T, m = 0, 1, 2, ...: four at a
    // time while all four exist, then one at a time
    int64_t u = tid;
    for (; u + 3 * T < n4; u += 4 * T) {
      float4 m[4];
      uchar4 g[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m[k] = m4[u + k * T];
        g[k] = g4[u + k * T];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) count4(m[k], g[k], thr, inter, uni);
    }
    for (; u < n4; u += T) count4(m4[u], g4[u], thr, inter, uni);
    lo = 4 * n4;
  }
  for (int64_t i = lo + tid; i < n; i += T)
    count1(mask[i], gt[i], thr, inter, uni);

  u64 bi = inter, bu = uni;
  block_sum(bi, bu);
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = bi;
    partials[2 * blockIdx.x + 1] = bu;
    __threadfence();  // the slot is visible before the ticket is taken
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: every other block fenced its slot before its ticket
  __threadfence();
  u64 ti = 0, tu = 0;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += kThreads) {
    ti += __ldcg(&partials[2 * k]);
    tu += __ldcg(&partials[2 * k + 1]);
  }
  block_sum(ti, tu);
  if (threadIdx.x == 0) {
    out[0] = ti;
    out[1] = tu;
    *ticket = 0;
  }
}

// blocks of one full wave on the current device, computed once per device
int wave_blocks() {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 1;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, threshold_iou_kernel, kThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int w = per_sm * sms;
    cached[dev] = w < 1 ? 1 : (w < kMaxBlocks ? w : kMaxBlocks);
  }
  return cached[dev];
}

}  // namespace

// scratch: 2 * kMaxBlocks + 1 int64, zeroed before its first use and
// used by one stream; out: 2 int64
extern "C" int cgs_threshold_iou(const void* mask, const void* gt, int64_t n,
                                 float thr, void* out, void* scratch,
                                 void* stream) {
  const int vec = ((uintptr_t)mask % 16 == 0) && ((uintptr_t)gt % 4 == 0);
  // a thread takes 16 elements an iteration on the vector path, 1 off it
  const int64_t per_thread = vec ? 16 : 1;
  const int64_t want =
      (n + per_thread * kThreads - 1) / (per_thread * kThreads);
  const int wave = wave_blocks();
  const int blocks = (int)(want < 1 ? 1 : (want < wave ? want : wave));
  u64* partials = (u64*)scratch;
  unsigned int* ticket = (unsigned int*)(partials + 2 * kMaxBlocks);
  threshold_iou_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)mask, (const uint8_t*)gt, n, vec, thr, partials, ticket,
      (u64*)out);
  return (int)cudaGetLastError();
}
