// Per-query predicate match counts over packed label bitmaps, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/bitmap_filter.py::selectivity_count (the
// Pallas TPU kernel `_kernel`, which reuses `_predicate_mask_block`).
//
// What bounds it on this card: the [N, W] uint32 bitmaps are read once
// per group of queries and nothing else is large, so it is bytes bound:
// at N = 1M rows, W = 7 words the bitmaps are 28 MB (about 8 µs at
// 3.35 TB/s), and the predicate work is a few integer operations per
// word and query.
//
// Design. The TPU kernel accumulates counts in VMEM across a sequential
// grid of base blocks; on Hopper blocks run in no order, so:
//   * grid = (group of kGroup queries, row split). A block keeps its
//     queries' words in shared memory and reads each row's words once for
//     all kGroup queries, so the bitmaps are read Q/kGroup times (mostly
//     from L2, which holds them) instead of Q times.
//   * Each thread counts the rows it visits in registers; a warp shuffle
//     and a shared-memory pass sum the counts of the block, and a second
//     kernel sums the splits of each query in a fixed order. No atomics:
//     the counts are exact int32 over the real N rows (no padding, so no
//     padding correction) and the same on every run.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;

template <int PRED>
__global__ void __launch_bounds__(kThreads)
selectivity_split_kernel(const uint32_t* __restrict__ qbm,
                         const uint32_t* __restrict__ bm,
                         int* __restrict__ part, int nq, int n, int w,
                         int rows_per_split) {
  extern __shared__ uint32_t sq[];   // [kGroup, w] query words
  __shared__ int red[kGroup][kWarps];
  const int q0 = blockIdx.x * kGroup, split = blockIdx.y;
  const int nq_blk = min(kGroup, nq - q0);
  for (int i = threadIdx.x; i < kGroup * w; i += kThreads) {
    const int g = i / w;
    sq[i] = g < nq_blk ? qbm[(size_t)(q0 + g) * w + (i - g * w)] : 0u;
  }
  __syncthreads();

  int cnt[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) cnt[g] = 0;
  const long long row0 = (long long)split * rows_per_split;
  const int row1 = (int)min((long long)n, row0 + rows_per_split);
  for (int r = (int)row0 + threadIdx.x; r < row1; r += kThreads) {
    const uint32_t* row = bm + (size_t)r * w;
    bool ok[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) ok[g] = PRED != 2;
    for (int i = 0; i < w; ++i) {
      const uint32_t b = row[i];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const uint32_t qw = sq[g * w + i];
        if (PRED == 0) ok[g] = ok[g] && b == qw;
        else if (PRED == 1) ok[g] = ok[g] && (b & qw) == qw;
        else ok[g] = ok[g] || (b & qw) != 0u;
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) cnt[g] += ok[g] ? 1 : 0;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    int c = cnt[g];
    for (int off = 16; off > 0; off >>= 1)
      c += __shfl_xor_sync(kFullMask, c, off);
    if (lane == 0) red[g][warp] = c;
  }
  __syncthreads();
  if (threadIdx.x < nq_blk) {
    int s = 0;
    for (int wi = 0; wi < kWarps; ++wi) s += red[threadIdx.x][wi];
    part[(size_t)split * nq + q0 + threadIdx.x] = s;
  }
}

__global__ void selectivity_sum_kernel(const int* __restrict__ part,
                                       int* __restrict__ out, int nq,
                                       int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  int s = 0;
  for (int sp = 0; sp < splits; ++sp) s += part[(size_t)sp * nq + i];
  out[i] = s;
}

}  // namespace
}  // namespace repro_torch

// qbms [nq, w] u32, bitmaps [n, w] u32 -> out [nq] i32 match counts,
// through the scratch part [splits, nq]. Device pointers; nothing is
// allocated or synchronised here. Returns the cudaError_t of the launches.
extern "C" int selectivity_launch(const uint32_t* qbm, const uint32_t* bm,
                                  int* part, int* out, int nq, int n, int w,
                                  int pred, int splits, void* stream_ptr) {
  using namespace repro_torch;
  if (nq <= 0 || n < 0 || w <= 0 || splits < 1 || splits > 65535 ||
      pred < 0 || pred > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rows_per_split = (n + splits - 1) / splits;
  const dim3 grid((nq + kGroup - 1) / kGroup, splits);
  const size_t smem = sizeof(uint32_t) * kGroup * w;
  if (pred == 0)
    selectivity_split_kernel<0><<<grid, kThreads, smem, stream>>>(
        qbm, bm, part, nq, n, w, rows_per_split);
  else if (pred == 1)
    selectivity_split_kernel<1><<<grid, kThreads, smem, stream>>>(
        qbm, bm, part, nq, n, w, rows_per_split);
  else
    selectivity_split_kernel<2><<<grid, kThreads, smem, stream>>>(
        qbm, bm, part, nq, n, w, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  selectivity_sum_kernel<<<(nq + 255) / 256, 256, 0, stream>>>(part, out, nq,
                                                               splits);
  return static_cast<int>(cudaGetLastError());
}
