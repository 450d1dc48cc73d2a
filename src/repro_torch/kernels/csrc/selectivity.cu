// Per-query predicate match counts over packed label bitmaps, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/bitmap_filter.py::selectivity_count (the
// Pallas TPU kernel `_kernel`, which reuses `_predicate_mask_block`).
//
// What bounds it on this card: operations. The work is one 32-bit logic
// operation per (query, row, word): at Q = 256, N = 1M, W = 7 that is
// 1.8 G operations, 0.107 ms at 64 per clock per SM (132 SMs, 1.98 GHz),
// against 28 MB of bitmaps, 8 µs at 3.35 TB/s, if they are read once.
//
// Design:
//   * The word width W is a template parameter (instances for W <= 16).
//     Each thread holds the words of QT queries in registers (QT = 8 for
//     W <= 8, else 4), so a block of 256 threads covers 32 * QT queries:
//     at Q = 256 and W <= 8 the bitmaps stream through once a launch.
//   * Grid = (query group, row split). A block walks a contiguous row
//     range in tiles that 16-byte cp.async copies into shared memory,
//     double-buffered: the next tile is in flight while this one is
//     counted. Its 8 warps take the tile's rows in turn; every lane of a
//     warp reads the same row, so each shared-memory load is a broadcast
//     (16 bytes at a time where W is a multiple of 4) that serves QT
//     queries.
//   * One LOP3 per (query, row, word) folds the word into an
//     accumulator: EQUALITY acc |= b ^ q, AND acc |= q & ~b, OR
//     acc |= b & q; then one compare and add per (query, row) counts
//     acc == 0 (EQUALITY, AND) or acc != 0 (OR). No branches: an empty
//     query word matches every row for AND, as in the TPU kernel.
//   * W > 16 runs the chunked kernel: the queries' words come 16 at a
//     time from a [W, Q] copy (coalesced, L1-resident) into registers,
//     and serve a group of 4 rows before the next chunk, 4 queries a
//     thread.
//   * No atomics: each thread counts in registers, the block's warps sum
//     in shared memory in a fixed order, and a second kernel sums the
//     row splits of each query in a fixed order, so every run gives the
//     same exact int32 counts over the real N rows.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 16384;   // one of the two tile buffers
constexpr int kMaxRegWords = 16;    // widest W held whole in registers
constexpr int kChunk = 16;          // words a chunk, W > kMaxRegWords
constexpr int kChunkQT = 4;         // queries a thread, chunked kernel
constexpr int kRowGroup = 4;        // rows a chunk of words serves

__host__ __device__ constexpr int queries_per_thread(int w) {
  return w <= 8 ? 8 : 4;
}

// Rows in a tile: about kTileBytes of words, a multiple of 32 rows (so a
// tile starts 16-byte aligned), at least 32 and at most 1024.
int tile_rows_for(int w) {
  const int r = kTileBytes / (4 * w) / 32 * 32;
  return r < 32 ? 32 : (r > 1024 ? 1024 : r);
}

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The words of rows [row0, min(row0 + tile_rows, n)) into `dst`, by
// 16-byte cp.async; a chunk across the array's end is zero-filled past
// it. Commits one group.
__device__ __forceinline__ void load_tile(uint32_t* dst,
                                          const uint32_t* __restrict__ bm,
                                          long long row0, int n, int w,
                                          int tile_rows) {
  const long long end = min((long long)n, row0 + tile_rows);
  const long long words = (end - row0) * w;
  const uint32_t* src = bm + row0 * w;
  const int chunks = (int)((words + 3) / 4);
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const long long left = words - 4LL * c;
    cp_async16_zfill(dst + 4 * c, src + 4 * c,
                     left >= 4 ? 16 : (int)left * 4);
  }
  cp_async_commit();
}

template <int PRED>
__device__ __forceinline__ uint32_t fold(uint32_t acc, uint32_t b,
                                         uint32_t q) {
  if (PRED == 0) return acc | (b ^ q);
  if (PRED == 1) return acc | (q & ~b);
  return acc | (b & q);
}

template <int PRED>
__device__ __forceinline__ int passes(uint32_t acc) {
  return PRED == 2 ? (acc != 0u) : (acc == 0u);
}

// Each thread's counts -> part[split, q]: the warps' counts of a query
// summed in warp order. Query q0 + j * 32 + lane is slot j of a lane.
template <int QT>
__device__ __forceinline__ void write_counts(const int (&cnt)[QT], int* red,
                                             int* __restrict__ part, int q0,
                                             int nq) {
  constexpr int QB = 32 * QT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < QT; ++j) red[warp * QB + j * 32 + lane] = cnt[j];
  __syncthreads();
  for (int t = threadIdx.x; t < QB && q0 + t < nq; t += kThreads) {
    int s = 0;
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi * QB + t];
    part[(size_t)blockIdx.y * nq + q0 + t] = s;
  }
}

// W <= kMaxRegWords: every query word of the thread in registers.
template <int PRED, int W>
__global__ void __launch_bounds__(kThreads)
selectivity_regs_kernel(const uint32_t* __restrict__ qbm,
                        const uint32_t* __restrict__ bm,
                        int* __restrict__ part, int nq, int n,
                        int rows_per_block, int tile_rows) {
  constexpr int QT = queries_per_thread(W);
  constexpr int QB = 32 * QT;
  extern __shared__ __align__(16) uint32_t tiles[];   // [2, tile_rows * W]
  __shared__ int red[kWarps * QB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QB;

  uint32_t qw[QT][W];
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const int q = q0 + j * 32 + lane;
#pragma unroll
    for (int i = 0; i < W; ++i)
      qw[j][i] = q < nq ? qbm[(size_t)q * W + i] : 0u;
  }
  int cnt[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) cnt[j] = 0;

  const long long r0 = (long long)blockIdx.y * rows_per_block;
  const long long r1 = min((long long)n, r0 + rows_per_block);
  const int ntiles = r0 < r1 ? (int)((r1 - r0 + tile_rows - 1) / tile_rows)
                             : 0;
  if (ntiles > 0) load_tile(tiles, bm, r0, n, W, tile_rows);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile(tiles + ((t + 1) & 1) * tile_rows * W, bm,
                r0 + (long long)(t + 1) * tile_rows, n, W, tile_rows);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* buf = tiles + (t & 1) * tile_rows * W;
    const int rows = (int)min((long long)tile_rows,
                              r1 - r0 - (long long)t * tile_rows);
    for (int r = warp; r < rows; r += kWarps) {
      uint32_t b[W];
      if constexpr (W % 4 == 0) {
        const uint4* row = reinterpret_cast<const uint4*>(buf + r * W);
#pragma unroll
        for (int i = 0; i < W / 4; ++i) {
          const uint4 v = row[i];
          b[4 * i] = v.x;
          b[4 * i + 1] = v.y;
          b[4 * i + 2] = v.z;
          b[4 * i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) b[i] = buf[r * W + i];
      }
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        uint32_t acc = 0u;
#pragma unroll
        for (int i = 0; i < W; ++i) acc = fold<PRED>(acc, b[i], qw[j][i]);
        cnt[j] += passes<PRED>(acc);
      }
    }
    __syncthreads();   // the buffer is refilled two tiles on
  }
  write_counts<QT>(cnt, red, part, q0, nq);
}

// W > kMaxRegWords: query words kChunk at a time from qbm_t [w, nq].
template <int PRED>
__global__ void __launch_bounds__(kThreads)
selectivity_chunked_kernel(const uint32_t* __restrict__ qbm_t,
                           const uint32_t* __restrict__ bm,
                           int* __restrict__ part, int nq, int n, int w,
                           int rows_per_block, int tile_rows) {
  constexpr int QT = kChunkQT;
  constexpr int QB = 32 * QT;
  constexpr int RT = kRowGroup;
  extern __shared__ __align__(16) uint32_t tiles[];   // [2, tile_rows * w]
  __shared__ int red[kWarps * QB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QB;
  int cnt[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) cnt[j] = 0;

  const long long r0 = (long long)blockIdx.y * rows_per_block;
  const long long r1 = min((long long)n, r0 + rows_per_block);
  const int ntiles = r0 < r1 ? (int)((r1 - r0 + tile_rows - 1) / tile_rows)
                             : 0;
  if (ntiles > 0) load_tile(tiles, bm, r0, n, w, tile_rows);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile(tiles + (size_t)((t + 1) & 1) * tile_rows * w, bm,
                r0 + (long long)(t + 1) * tile_rows, n, w, tile_rows);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* buf = tiles + (size_t)(t & 1) * tile_rows * w;
    const int rows = (int)min((long long)tile_rows,
                              r1 - r0 - (long long)t * tile_rows);
    for (int g = warp * RT; g < rows; g += kWarps * RT) {
      uint32_t acc[QT][RT];
#pragma unroll
      for (int j = 0; j < QT; ++j)
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) acc[j][rr] = 0u;
      for (int c0 = 0; c0 < w; c0 += kChunk) {
        uint32_t qw[QT][kChunk];
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
#pragma unroll
          for (int j = 0; j < QT; ++j) {
            const int q = q0 + j * 32 + lane;
            qw[j][i] = (c0 + i < w && q < nq)
                           ? __ldg(qbm_t + (size_t)(c0 + i) * nq + q)
                           : 0u;
          }
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) {
          // rows past the tile's end read the last row; not counted
          const uint32_t* row = buf + (size_t)min(g + rr, rows - 1) * w + c0;
#pragma unroll
          for (int i = 0; i < kChunk; ++i) {
            if (c0 + i < w) {
              const uint32_t b = row[i];
#pragma unroll
              for (int j = 0; j < QT; ++j)
                acc[j][rr] = fold<PRED>(acc[j][rr], b, qw[j][i]);
            }
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < RT; ++rr)
        if (g + rr < rows)
#pragma unroll
          for (int j = 0; j < QT; ++j) cnt[j] += passes<PRED>(acc[j][rr]);
    }
    __syncthreads();   // the buffer is refilled two tiles on
  }
  write_counts<QT>(cnt, red, part, q0, nq);
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

template <int PRED, int W>
cudaError_t launch_regs(const uint32_t* qbm, const uint32_t* bm, int* part,
                        int nq, int n, int splits, int rows_per_block,
                        int tile_rows, cudaStream_t stream) {
  constexpr int QB = 32 * queries_per_thread(W);
  const dim3 grid((nq + QB - 1) / QB, splits);
  const size_t smem = sizeof(uint32_t) * 2 * (size_t)tile_rows * W;
  selectivity_regs_kernel<PRED, W><<<grid, kThreads, smem, stream>>>(
      qbm, bm, part, nq, n, rows_per_block, tile_rows);
  return cudaGetLastError();
}

template <int PRED>
cudaError_t launch_width(const uint32_t* qbm, const uint32_t* qbm_t,
                         const uint32_t* bm, int* part, int nq, int n,
                         int w, int splits, int rows_per_block, int tile_rows,
                         cudaStream_t stream) {
  switch (w) {
#define REPRO_SEL_W(WW)                                                      \
  case WW:                                                                   \
    return launch_regs<PRED, WW>(qbm, bm, part, nq, n, splits,              \
                                 rows_per_block, tile_rows, stream);
    REPRO_SEL_W(1) REPRO_SEL_W(2) REPRO_SEL_W(3) REPRO_SEL_W(4)
    REPRO_SEL_W(5) REPRO_SEL_W(6) REPRO_SEL_W(7) REPRO_SEL_W(8)
    REPRO_SEL_W(9) REPRO_SEL_W(10) REPRO_SEL_W(11) REPRO_SEL_W(12)
    REPRO_SEL_W(13) REPRO_SEL_W(14) REPRO_SEL_W(15) REPRO_SEL_W(16)
#undef REPRO_SEL_W
    default:
      break;
  }
  const size_t smem = sizeof(uint32_t) * 2 * (size_t)tile_rows * w;
  cudaError_t err = cudaFuncSetAttribute(
      selectivity_chunked_kernel<PRED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + 32 * kChunkQT - 1) / (32 * kChunkQT), splits);
  selectivity_chunked_kernel<PRED><<<grid, kThreads, smem, stream>>>(
      qbm_t, bm, part, nq, n, w, rows_per_block, tile_rows);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Queries a block covers at word width w (the wrapper's query group).
extern "C" int selectivity_query_group(int w) {
  using namespace repro_torch;
  return 32 * (w <= kMaxRegWords ? queries_per_thread(w) : kChunkQT);
}

// Rows in one shared-memory tile at word width w; a row split is a
// multiple of it.
extern "C" int selectivity_tile_rows(int w) {
  return repro_torch::tile_rows_for(w);
}

// qbms [nq, w] u32 (and its [w, nq] transpose qbm_t, read only for
// w > 16), bitmaps [n, w] u32 (16-byte aligned) -> out [nq] i32 match
// counts, through the scratch part [splits, nq]. Device pointers; nothing
// is allocated or synchronised here. Returns the cudaError_t of the
// launches.
extern "C" int selectivity_launch(const uint32_t* qbm, const uint32_t* qbm_t,
                                  const uint32_t* bm, int* part, int* out,
                                  int nq, int n, int w, int pred, int splits,
                                  void* stream_ptr) {
  using namespace repro_torch;
  if (nq <= 0 || n < 0 || w <= 0 || splits < 1 || splits > 65535 ||
      pred < 0 || pred > 2 ||
      (reinterpret_cast<uintptr_t>(bm) & 15) != 0 ||
      (w > kMaxRegWords && qbm_t == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int tile_rows = tile_rows_for(w);
  const long long per = ((long long)n + splits - 1) / splits;
  const long long tiles_per_block = (per + tile_rows - 1) / tile_rows;
  const long long rows_per_block =
      (tiles_per_block > 0 ? tiles_per_block : 1) * tile_rows;
  if (rows_per_block > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (pred == 0)
    err = launch_width<0>(qbm, qbm_t, bm, part, nq, n, w, splits,
                          (int)rows_per_block, tile_rows, stream);
  else if (pred == 1)
    err = launch_width<1>(qbm, qbm_t, bm, part, nq, n, w, splits,
                          (int)rows_per_block, tile_rows, stream);
  else
    err = launch_width<2>(qbm, qbm_t, bm, part, nq, n, w, splits,
                          (int)rows_per_block, tile_rows, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  selectivity_sum_kernel<<<(nq + 255) / 256, 256, 0, stream>>>(part, out, nq,
                                                               splits);
  return static_cast<int>(cudaGetLastError());
}
