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
//     side by side). A second kernel folds the per-split lists of each
//     query the same way. Slots past the match count come back as
//     (PAD_SCORE, -1), and a score at or above PAD_SCORE as id -1, as in
//     the TPU kernel.
// The output does not depend on the number of splits or on the order in
// which blocks run.

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

inline size_t smem_bytes(int d, int w) {
  return sizeof(float) * ((size_t)(kQG + kTileRows) * padded_stride(d) +
                          kTileRows) +
         sizeof(uint32_t) * (size_t)(kQG + kTileRows) * w;
}

template <int PRED, int KMAX>
__global__ void __launch_bounds__(kThreads)
masked_topk_split_kernel(const float* __restrict__ q,
                         const uint32_t* __restrict__ qbm,
                         const float* __restrict__ base,
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
  const int q0 = blockIdx.x * kQG, split = blockIdx.y, splits = gridDim.y;
  const int nqb = min(kQG, nq - q0);
  for (int r = warp; r < kQG; r += kThreads / 32)
    for (int c = lane; c < d; c += 32)
      qs[r * ds + c] = r < nqb ? q[(size_t)(q0 + r) * d + c] : 0.f;
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
        rs[r * ds + c] = base[(size_t)(t0 + r) * d + c];
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
      const int r = sub + j * kLanesPerQ, row = t0 + r;
      const float s = rn[r] - 2.0f * acc[j];
      if (pair_less(s, row, ld[k - 1], li[k - 1])) {
        int p = k - 1;
        while (p > 0 && pair_less(s, row, ld[p - 1], li[p - 1])) {
          ld[p] = ld[p - 1];
          li[p] = li[p - 1];
          --p;
        }
        ld[p] = s;
        li[p] = row;
      }
    }
  }

  // k rounds of an argmin over the list heads of each query's 16 threads
  // (a half-warp: xor offsets below 16 stay inside it)
  const size_t out0 = ((size_t)(q0 + qloc) * splits + split) * k;
  int head = 0;
  for (int j = 0; j < k; ++j) {
    float s = head < k ? ld[head] : INFINITY;
    int id = head < k ? li[head] : kEmptyId;
    for (int off = kLanesPerQ / 2; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(kFullMask, s, off);
      const int oi = __shfl_xor_sync(kFullMask, id, off);
      if (pair_less(os, oi, s, id)) { s = os; id = oi; }
    }
    if (live && sub == 0) { part_d[out0 + j] = s; part_i[out0 + j] = id; }
    if (id != kEmptyId && head < k && li[head] == id) ++head;
  }
}

// Fold the [splits, k] sorted lists of one query into its final top-k.
__global__ void masked_topk_merge_kernel(const float* __restrict__ part_d,
                                         const int* __restrict__ part_i,
                                         float* __restrict__ out_d,
                                         int* __restrict__ out_i, int splits,
                                         int k) {
  __shared__ float red_s[32];
  __shared__ int red_i[32];
  const int qi = blockIdx.x, t = threadIdx.x;
  const float* pd = part_d + (size_t)qi * splits * k + (size_t)t * k;
  const int* pi = part_i + (size_t)qi * splits * k + (size_t)t * k;
  int head = 0;
  for (int j = 0; j < k; ++j) {
    const bool has = t < splits && head < k;
    float s = has ? pd[head] : INFINITY;
    int id = has ? pi[head] : kEmptyId;
    block_argmin(s, id, red_s, red_i);
    if (t == 0) {
      const bool empty = id == kEmptyId;
      out_d[(size_t)qi * k + j] = empty ? kPadScore : s;
      out_i[(size_t)qi * k + j] = (empty || s >= kPadScore) ? -1 : id;
    }
    if (id != kEmptyId && has && pi[head] == id) ++head;
  }
}

template <int PRED, int KMAX>
cudaError_t launch_split(dim3 grid, size_t smem, cudaStream_t stream,
                         const float* q, const uint32_t* qbm,
                         const float* base, const float* norms,
                         const uint32_t* bm, float* part_d, int* part_i,
                         int nq, int n, int d, int w, int k,
                         int rows_per_split) {
  auto kernel = masked_topk_split_kernel<PRED, KMAX>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(q, qbm, base, norms, bm, part_d,
                                           part_i, nq, n, d, w, k,
                                           rows_per_split);
  return cudaGetLastError();
}

template <int PRED>
cudaError_t launch_pred(dim3 grid, size_t smem, cudaStream_t stream,
                        const float* q, const uint32_t* qbm,
                        const float* base, const float* norms,
                        const uint32_t* bm, float* part_d, int* part_i,
                        int nq, int n, int d, int w, int k,
                        int rows_per_split) {
  if (k <= 16)
    return launch_split<PRED, 16>(grid, smem, stream, q, qbm, base, norms,
                                  bm, part_d, part_i, nq, n, d, w, k,
                                  rows_per_split);
  if (k <= 32)
    return launch_split<PRED, 32>(grid, smem, stream, q, qbm, base, norms,
                                  bm, part_d, part_i, nq, n, d, w, k,
                                  rows_per_split);
  if (k <= 64)
    return launch_split<PRED, 64>(grid, smem, stream, q, qbm, base, norms,
                                  bm, part_d, part_i, nq, n, d, w, k,
                                  rows_per_split);
  return launch_split<PRED, 128>(grid, smem, stream, q, qbm, base, norms,
                                 bm, part_d, part_i, nq, n, d, w, k,
                                 rows_per_split);
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

// qvecs [nq, d] f32, qbms [nq, w] u32, base [n, d] f32, norms [n] f32,
// bitmaps [n, w] u32 -> out_d [nq, k] f32, out_i [nq, k] i32, through the
// scratch lists part_d/part_i [nq, splits, k]. All pointers are device
// memory; nothing is allocated or synchronised here. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int masked_topk_launch(const float* q, const uint32_t* qbm,
                                  const float* base, const float* norms,
                                  const uint32_t* bm, float* part_d,
                                  int* part_i, float* out_d, int* out_i,
                                  int nq, int n, int d, int w, int pred, int k,
                                  int splits, void* stream_ptr) {
  using namespace repro_torch;
  const size_t smem = smem_bytes(d, w);
  if (nq <= 0 || n < 0 || d <= 0 || w <= 0 || k < 1 || k > 128 ||
      splits < 1 || splits > 1024 || pred < 0 || pred > 2 ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rows_per_split = (n + splits - 1) / splits;
  const dim3 grid((nq + kQG - 1) / kQG, splits);
  cudaError_t err;
  if (pred == 0)
    err = launch_pred<0>(grid, smem, stream, q, qbm, base, norms, bm, part_d,
                         part_i, nq, n, d, w, k, rows_per_split);
  else if (pred == 1)
    err = launch_pred<1>(grid, smem, stream, q, qbm, base, norms, bm, part_d,
                         part_i, nq, n, d, w, k, rows_per_split);
  else
    err = launch_pred<2>(grid, smem, stream, q, qbm, base, norms, bm, part_d,
                         part_i, nq, n, d, w, k, rows_per_split);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int merge_threads = ((splits + 31) / 32) * 32;
  masked_topk_merge_kernel<<<nq, merge_threads, 0, stream>>>(
      part_d, part_i, out_d, out_i, splits, k);
  return static_cast<int>(cudaGetLastError());
}
