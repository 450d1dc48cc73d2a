// Fused predicate mask + squared-L2 score + top-k over a packed-bitmap
// filtered base, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/masked_topk.py::masked_topk_accum (the
// Pallas TPU kernel `_accum_kernel` with `_masked_scores`,
// `_predicate_mask_block` and `_fold_topk`).
//
// What bounds it on this card: at the exact-search path's shapes
// (Q = 64 queries, N = 1M rows, D = 192, W = 7) an unfiltered scan is
// 2·Q·N·D = 24.6 GFLOP of fp32 FMA work outside the tensor cores (about
// 0.37 ms at 67 TFLOP/s) against 0.8 GB of base rows and bitmaps (about
// 0.24 ms at 3.35 TB/s). A filter removes the work of every failing
// (query, row) pair, and the bytes of every row that no query of the
// batch passes, so on selective queries the bound falls to the 28 MB
// bitmap read.
//
// Design. The TPU kernel carries a [BQ, k] top-k in VMEM across a
// sequential grid of base blocks; Hopper runs blocks in no order, so
// nothing is carried between blocks:
//   * grid = (group of kQG queries, row split). A block walks its split
//     in tiles of kTileRows rows. It reads the tile's label words into
//     shared memory and evaluates every (query, row) pair of the tile on
//     the uint32 words; a tile that no pair passes is skipped without
//     reading its vectors. Otherwise the tile's rows are read once,
//     coalesced, into shared memory and serve all kQG queries, so the
//     base is read once per query group, not once per query.
//   * Each thread owns one query and kTileRows/kLanesPerQ rows of each
//     tile, and computes the dot product of each passing pair in fp32
//     FMAs in ascending dimension order (no TF32, no tensor cores:
//     results are held to fp32 parity). Row and query stride in shared
//     memory is odd, so the kLanesPerQ threads of a query read distinct
//     banks.
//   * Each thread keeps a private top-k list ordered by (score, row id).
//     The order is total, so at the end of the split k rounds of an
//     argmin over the list heads of a query's threads (a shuffle tree
//     inside their half-warp) give the split's top-k with ties to the
//     lowest row id, as `_fold_topk` does.
//   * Many short splits keep the blocks even when the passing rows
//     bunch together (a group-sorted base puts all rows of one label set
//     side by side). Each (split, query) list goes to its own slot of
//     [splits, Q, k], with (PAD_SCORE, -1) in the slots past the split's
//     match count and id -1 at a score at or above PAD_SCORE, as in the
//     TPU kernel. The merge kernel (csrc/merge_topk.cu) folds these lists
//     in (score, split, slot) order, which is (score, row id) order here;
//     a score at or above PAD_SCORE comes out as (PAD_SCORE, -1).
// The output does not depend on the number of splits or on the order in
// which blocks run.
//
// bf16 inputs. The TPU kernel takes bf16 queries and rows and
// accumulates the dot in fp32 (`preferred_element_type=jnp.float32`).
// Here the element type is a template parameter: a bf16 value is
// converted to fp32 as it is staged into shared memory, so a bf16 x bf16
// product is exact in fp32 and the FMAs are those of the fp32 path. Norms
// stay fp32.
//
// Per-block output. The same scan also replaces
// src/repro/kernels/masked_topk.py::masked_topk_blocks (the Pallas TPU
// kernel `_block_kernel`): the top-k of every (query, block of bn rows),
// [NB, Q, k], with no fold, is the scan's output with splits of exactly
// bn rows; its fill is the one `_block_kernel`'s k-step min extraction
// leaves. Its bound is that of the fused scan plus the [NB, Q, k] output
// (8 bytes a slot: 20 MB for 256 queries at 1M rows, k = 10).

#include <cuda_bf16.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kQG = 16;                           // queries per block
constexpr int kLanesPerQ = kThreads / kQG;        // threads per query: 16
constexpr int kTileRows = 32;                     // rows per tile
constexpr int kRowsPerThread = kTileRows / kLanesPerQ;
constexpr size_t kMaxSmem = 232448;               // 227 KB opt-in limit

static_assert(kLanesPerQ == 16, "the per-query shuffle tree spans 16 lanes");

__host__ __device__ inline int padded_stride(int d) { return d | 1; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

inline size_t smem_bytes(int d, int w) {
  return sizeof(float) * ((size_t)(kQG + kTileRows) * padded_stride(d) +
                          kTileRows) +
         sizeof(uint32_t) * (size_t)(kQG + kTileRows) * w;
}

// part_d/part_i [splits, nq, k]: one sorted list per (split, query),
// (PAD_SCORE, -1) in empty slots and id -1 at a score >= PAD_SCORE.
template <int PRED, int KMAX, typename T>
__global__ void __launch_bounds__(kThreads)
masked_topk_split_kernel(const T* __restrict__ q,
                         const uint32_t* __restrict__ qbm,
                         const T* __restrict__ base,
                         const float* __restrict__ norms,
                         const uint32_t* __restrict__ bm,
                         float* __restrict__ part_d,
                         int* __restrict__ part_i, int nq, int n, int d,
                         int w, int k, int rows_per_split) {
  extern __shared__ float smem[];
  const int ds = padded_stride(d);
  float* qs = smem;                               // [kQG][ds] queries
  float* rs = qs + kQG * ds;                      // [kTileRows][ds] rows
  float* rn = rs + kTileRows * ds;                // [kTileRows] norms
  uint32_t* qb = reinterpret_cast<uint32_t*>(rn + kTileRows);  // [kQG][w]
  uint32_t* rb = qb + kQG * w;                    // [kTileRows][w]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kQG, split = blockIdx.y;
  const int nqb = min(kQG, nq - q0);
  for (int r = warp; r < kQG; r += kThreads / 32)
    for (int c = lane; c < d; c += 32)
      qs[r * ds + c] = r < nqb ? to_f32(q[(size_t)(q0 + r) * d + c]) : 0.f;
  for (int i = tid; i < kQG * w; i += kThreads)
    qb[i] = i < nqb * w ? qbm[(size_t)q0 * w + i] : 0u;

  const int qloc = tid / kLanesPerQ, sub = tid % kLanesPerQ;
  const bool live = qloc < nqb;
  float ld[KMAX];
  int li[KMAX];
  for (int j = 0; j < k; ++j) { ld[j] = INFINITY; li[j] = kEmptyId; }

  const long long row0 = (long long)split * rows_per_split;
  const int row1 = (int)min((long long)n, row0 + rows_per_split);
  for (int t0 = (int)row0; t0 < row1; t0 += kTileRows) {
    const int nr = min(kTileRows, row1 - t0);
    __syncthreads();                  // the previous tile is consumed
    for (int i = tid; i < nr * w; i += kThreads)
      rb[i] = bm[(size_t)t0 * w + i];
    __syncthreads();
    bool pass[kRowsPerThread];
    bool any = false;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = sub + j * kLanesPerQ;
      pass[j] = live && r < nr && row_passes<PRED>(rb + r * w, qb + qloc * w, w);
      any |= pass[j];
    }
    if (!__syncthreads_or(any)) continue;   // no pair passes: skip the rows
    for (int r = warp; r < nr; r += kThreads / 32)
      for (int c = lane; c < d; c += 32)
        rs[r * ds + c] = to_f32(base[(size_t)(t0 + r) * d + c]);
    for (int i = tid; i < nr; i += kThreads) rn[i] = norms[t0 + i];
    __syncthreads();
    bool mine = false;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) mine |= pass[j];
    if (!mine) continue;
    float acc[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0.f;
    const float* qv = qs + qloc * ds;
    for (int c = 0; c < d; ++c) {
      const float qc = qv[c];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j)
        acc[j] = fmaf(qc, rs[(sub + j * kLanesPerQ) * ds + c], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if (!pass[j]) continue;
      const int r = sub + j * kLanesPerQ;
      list_insert(ld, li, k, rn[r] - 2.0f * acc[j], t0 + r);
    }
  }

  // k rounds of an argmin over the list heads of each query's 16 threads
  // (a half-warp: xor offsets below 16 stay inside it)
  const size_t out0 = ((size_t)split * nq + q0 + qloc) * k;
  int head = 0;
  for (int j = 0; j < k; ++j) {
    float s = head < k ? ld[head] : INFINITY;
    int id = head < k ? li[head] : kEmptyId;
    lanes_argmin<kLanesPerQ>(s, id);
    if (live && sub == 0) {
      const bool empty = id == kEmptyId;
      part_d[out0 + j] = empty ? kPadScore : s;
      part_i[out0 + j] = (empty || s >= kPadScore) ? -1 : id;
    }
    if (id != kEmptyId && head < k && li[head] == id) ++head;
  }
}

// The split kernel's arguments, passed down the template dispatch.
struct SplitArgs {
  const void* q;
  const uint32_t* qbm;
  const void* base;
  const float* norms;
  const uint32_t* bm;
  float* part_d;
  int* part_i;
  int nq, n, d, w, k, rows_per_split;
};

template <int PRED, int KMAX, typename T>
cudaError_t launch_split(dim3 grid, size_t smem, cudaStream_t stream,
                         const SplitArgs& a) {
  auto kernel = masked_topk_split_kernel<PRED, KMAX, T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), a.qbm, static_cast<const T*>(a.base),
      a.norms, a.bm, a.part_d, a.part_i, a.nq, a.n, a.d, a.w, a.k,
      a.rows_per_split);
  return cudaGetLastError();
}

template <int PRED, typename T>
cudaError_t launch_k(dim3 grid, size_t smem, cudaStream_t stream,
                     const SplitArgs& a) {
  if (a.k <= 16) return launch_split<PRED, 16, T>(grid, smem, stream, a);
  if (a.k <= 32) return launch_split<PRED, 32, T>(grid, smem, stream, a);
  if (a.k <= 64) return launch_split<PRED, 64, T>(grid, smem, stream, a);
  return launch_split<PRED, 128, T>(grid, smem, stream, a);
}

template <typename T>
cudaError_t launch_pred(int pred, dim3 grid, size_t smem,
                        cudaStream_t stream, const SplitArgs& a) {
  if (pred == 0) return launch_k<0, T>(grid, smem, stream, a);
  if (pred == 1) return launch_k<1, T>(grid, smem, stream, a);
  return launch_k<2, T>(grid, smem, stream, a);
}

// dtype 0: float32 queries and rows; 1: bfloat16.
cudaError_t launch_scan(int dtype, int pred, int splits, size_t smem,
                        cudaStream_t stream, const SplitArgs& a) {
  const dim3 grid((a.nq + kQG - 1) / kQG, splits);
  if (dtype == 1)
    return launch_pred<__nv_bfloat16>(pred, grid, smem, stream, a);
  return launch_pred<float>(pred, grid, smem, stream, a);
}

bool bad_shape(int nq, int n, int d, int w, int pred, int k, int dtype,
               size_t smem) {
  return nq <= 0 || n < 0 || d <= 0 || w <= 0 || k < 1 || k > 128 ||
         pred < 0 || pred > 2 || dtype < 0 || dtype > 1 || smem > kMaxSmem;
}

}  // namespace
}  // namespace repro_torch

extern "C" const char* repro_torch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory the split kernel takes at (d, w); the wrapper
// refuses shapes above the card's 227 KB.
extern "C" long long masked_topk_smem_bytes(int d, int w) {
  return static_cast<long long>(repro_torch::smem_bytes(d, w));
}

// qvecs [nq, d] f32 or bf16 (dtype 0 or 1), qbms [nq, w] u32, base [n, d]
// of the queries' type, norms [n] f32, bitmaps [n, w] u32 -> out_d
// [nb, nq, k] f32, out_i [nb, nq, k] i32: the sorted top-k of each
// (block of bn rows, query), nb = max(1, ceil(n / bn)) (the last block
// ragged); (PAD_SCORE, -1) past each block's match count. All pointers
// are device memory; nothing is allocated or synchronised here. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int masked_topk_blocks_launch(const void* q, const uint32_t* qbm,
                                         const void* base, const float* norms,
                                         const uint32_t* bm, float* out_d,
                                         int* out_i, int nq, int n, int d,
                                         int w, int pred, int k, int bn,
                                         int dtype, void* stream_ptr) {
  using namespace repro_torch;
  const size_t smem = smem_bytes(d, w);
  if (bad_shape(nq, n, d, w, pred, k, dtype, smem) || bn < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = n > 0 ? ((long long)n + bn - 1) / bn : 1;
  if (nb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{q, qbm, base, norms, bm, out_d, out_i, nq,
                    n, d,   w,    k,     bn};
  return static_cast<int>(launch_scan(dtype, pred, (int)nb, smem,
                                      static_cast<cudaStream_t>(stream_ptr),
                                      a));
}
