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
//   * grid = (group of kQG = 32 queries, row split). A block walks its
//     split with the tile scan of tile_scan.cuh (label tiles of 256 rows
//     double-buffered with cp.async and tested a row a lane; vector tiles
//     of 64 rows read only when some pair passes, the next one's rows in
//     flight while this one's scores are taken; a 4 x 2 register-blocked
//     fp32 FMA dot in ascending dimension order, no TF32, no tensor
//     cores), which the key kernel and fused_live.cu's delta scan share,
//     so a row's score is the same in all of them.
//   * Each query's top-k list lives in shared memory, ordered by (score,
//     row id), kept by the kLanesPerQ = 8 lanes that own the query: a
//     pair that does not beat the list's last entry is dropped at once,
//     the others go in by group_insert (each round the group's smallest
//     offer, its slot counted and the entries after it moved by all 8
//     lanes). The order is total, so the list is the split's top-k with
//     ties to the lowest row id, as `_fold_topk` gives, and it goes out
//     as it stands. (Shared memory, not per-thread lists: those live in
//     local memory, and the scan's tiles leave little L1 to cache it.)
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
// k above 128 (the live path's overfetch: k plus the tombstone count,
// 1,016 at 1,000 deletes and k = 10; a reranking stage's 100-1,000). The
// per-thread lists hold at most 128 entries, so a larger k keeps no lists
// at all: the key kernel writes one sortable 32-bit key per (query, row)
// and the select of topk_select.cuh reduces each query's keys to its
// top-k (a multi-block radix select, then a sort of the survivors). Its
// bytes: 4 per (query, row) written and read about five times; the
// wrapper cuts the queries so the keys stay under 256 MB.

// Per-block output. The same scan also replaces
// src/repro/kernels/masked_topk.py::masked_topk_blocks (the Pallas TPU
// kernel `_block_kernel`): the top-k of every (query, block of bn rows),
// [NB, Q, k], with no fold, is the scan's output with splits of exactly
// bn rows; its fill is the one `_block_kernel`'s k-step min extraction
// leaves. Its bound is that of the fused scan plus the [NB, Q, k] output
// (8 bytes a slot: 20 MB for 256 queries at 1M rows, k = 10). Above
// k = 128 the key kernel writes [Q, NB * bn] keys (the ragged last block
// padded with kNoKey) and the select reduces each (query, block) segment
// of bn keys to its top-k.

#include "topk_select.cuh"

namespace repro_torch {
namespace {

// part_d/part_i [splits, nq, k]: one sorted list per (split, query),
// (PAD_SCORE, -1) in empty slots and id -1 at a score >= PAD_SCORE. Each
// query's list lives in shared memory past the scan's, k entries.
template <int PRED, typename T>
__global__ void __launch_bounds__(kThreads, 2)
masked_topk_split_kernel(const T* __restrict__ q,
                         const uint32_t* __restrict__ qbm,
                         const T* __restrict__ base,
                         const float* __restrict__ norms,
                         const uint32_t* __restrict__ bm,
                         float* __restrict__ part_d,
                         int* __restrict__ part_i, int nq, int n, int d,
                         int w, int k, int rows_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQG, split = blockIdx.y;
  float* ls = smem + scan_smem_bytes(d, w) / sizeof(float);   // [kQG][k]
  int* li = reinterpret_cast<int*>(ls + kQG * k);              // [kQG][k]
  for (int i = tid; i < kQG * k; i += kThreads) {
    ls[i] = INFINITY;
    li[i] = kEmptyId;
  }
  __syncthreads();

  const long long row0 = (long long)split * rows_per_split;
  const int row1 = (int)min((long long)n, row0 + rows_per_split);
  scan_tiles<PRED>(
      smem, q, qbm, nq, base, norms, bm, d, w, row0, row1, DirectRows{},
      [&](int ql, int sub, bool live, int t0, int nr, const uint32_t* tm,
          const float* scq) {
        offer_tile(
            ls + ql * k, li + ql * k, k, ql, sub, live, nr, tm, scq,
            INFINITY,
            [](float x, float& key) {
              key = x;
              return true;
            },
            [&](int r) { return t0 + r; });
      });

  __syncthreads();
  const int qloc = tid / kLanesPerQ, sub = tid % kLanesPerQ;
  if (qloc >= min(kQG, nq - q0)) return;
  const size_t out0 = ((size_t)split * nq + q0 + qloc) * k;
  for (int j = sub; j < k; j += kLanesPerQ) {
    const float s = ls[qloc * k + j];
    const int id = li[qloc * k + j];
    const bool empty = id == kEmptyId;
    part_d[out0 + j] = empty ? kPadScore : s;
    part_i[out0 + j] = (empty || s >= kPadScore) ? -1 : id;
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

// Shared memory of a split-kernel block: the scan's and the k-entry lists.
size_t split_smem_bytes(int d, int w, int k) {
  return scan_smem_bytes(d, w) + (size_t)kQG * k * 8;
}

template <int PRED, typename T>
cudaError_t launch_split(dim3 grid, size_t smem, cudaStream_t stream,
                         const SplitArgs& a) {
  auto kernel = masked_topk_split_kernel<PRED, T>;
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

template <typename T>
cudaError_t launch_pred(int pred, dim3 grid, size_t smem,
                        cudaStream_t stream, const SplitArgs& a) {
  if (pred == 0) return launch_split<0, T>(grid, smem, stream, a);
  if (pred == 1) return launch_split<1, T>(grid, smem, stream, a);
  return launch_split<2, T>(grid, smem, stream, a);
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

// The select's outputs. masked_topk for k > 128: row r of the chunk is a
// query, a position its row id.
struct EmitRows {
  float* d;
  int* i;
  int k;
  __device__ __forceinline__ void operator()(int r, int j, bool valid,
                                             uint32_t key, int pos) const {
    const size_t o = (size_t)r * k + j;
    d[o] = valid ? sortable_float(key) : kPadScore;
    i[o] = valid ? pos : -1;
  }
};

// masked_topk_blocks for k > 128: row r of the chunk is the segment (query
// r / nb, block r % nb), written to [nb, nq, k] at query q0 + r / nb.
struct EmitBlocks {
  float* d;
  int* i;
  int k, nb, nq, q0, bn;
  __device__ __forceinline__ void operator()(int r, int j, bool valid,
                                             uint32_t key, int pos) const {
    const int qi = r / nb, b = r - qi * nb;
    const size_t o = ((size_t)b * nq + q0 + qi) * k + j;
    d[o] = valid ? sortable_float(key) : kPadScore;
    i[o] = valid ? b * bn + pos : -1;
  }
};

// The key kernel over the rows of `a` (dtype 0 float32, 1 bfloat16).
cudaError_t keys_for(int dtype, int pred, const SplitArgs& a, uint32_t* keys,
                     long long stride, cudaStream_t stream) {
  if (dtype == 1)
    return launch_keys(pred, static_cast<const __nv_bfloat16*>(a.q), a.qbm,
                       static_cast<const __nv_bfloat16*>(a.base), a.norms,
                       a.bm, DirectRows{}, keys, stride, 0, a.nq, a.n, a.d,
                       a.w, a.rows_per_split, stream);
  return launch_keys(pred, static_cast<const float*>(a.q), a.qbm,
                     static_cast<const float*>(a.base), a.norms, a.bm,
                     DirectRows{}, keys, stride, 0, a.nq, a.n, a.d, a.w,
                     a.rows_per_split, stream);
}

}  // namespace
}  // namespace repro_torch

extern "C" const char* repro_torch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory the split, key and fused live kernels take at
// (d, w); the wrappers refuse shapes above the card's 227 KB.
extern "C" long long tile_scan_smem_bytes(int d, int w) {
  return static_cast<long long>(repro_torch::scan_smem_bytes(d, w));
}

// The tile scan's layout, for the wrappers' messages: 0 queries a block,
// 1 rows a vector tile, 2 rows a label tile, 3 dimensions staged at once.
extern "C" int tile_scan_layout(int which) {
  using namespace repro_torch;
  const int v[4] = {kQG, kTileRows, kLabelRows, kMaxChunk};
  return which >= 0 && which < 4 ? v[which] : 0;
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
  const size_t smem = split_smem_bytes(d, w, k);
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

// Bytes of the select's workspace for r rows of m keys and k.
extern "C" long long topk_select_workspace_bytes(int r, int m, int k) {
  if (r < 1 || m < 1 || k < 1) return 0;
  return static_cast<long long>(repro_torch::plan_select(r, m, k).bytes);
}

// The k > 128 path: keys [nq, stride] u32 scratch (stride >= n, a
// multiple of 4), then the top-k of each query into out_d/out_i [nq, k]
// (raw: (PAD_SCORE, -1) past the match count); ws holds
// topk_select_workspace_bytes(nq, n, k). Inputs as
// masked_topk_blocks_launch, n >= 1; rows_per_split cuts the key scan as
// the split kernel is cut. All pointers are device memory; nothing is
// allocated or synchronised here. Returns the cudaError_t of the launches
// (0 on success).
extern "C" int masked_topk_large_launch(
    const void* q, const uint32_t* qbm, const void* base, const float* norms,
    const uint32_t* bm, uint32_t* keys, void* ws, float* out_d, int* out_i,
    int nq, int n, int d, int w, int pred, int k, int rows_per_split,
    int dtype, void* stream_ptr) {
  using namespace repro_torch;
  const long long stride = ((long long)n + 3) & ~3LL;
  if (nq <= 0 || n <= 0 || d <= 0 || w <= 0 || k < 1 || pred < 0 ||
      pred > 2 || dtype < 0 || dtype > 1 ||
      scan_smem_bytes(d, w) > kMaxSmem || rows_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const SplitArgs a{q,       qbm, base, norms, bm, nullptr, nullptr, nq,
                    n,       d,   w,    k,     rows_per_split};
  cudaError_t err = keys_for(dtype, pred, a, keys, stride, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      run_select(keys, stride, nq, n, k, ws, EmitRows{out_d, out_i, k}, stream));
}

// masked_topk_blocks for k > 128: for the chunk of nq queries starting at
// query q0 of nq_all, keys [nq, nb * bn] u32 scratch (nb = ceil(n / bn),
// the ragged last block padded with kNoKey), then the top-k of each
// (query, block) segment into out_d/out_i [nb, nq_all, k]; ws holds
// topk_select_workspace_bytes(nq * nb, bn, k). Inputs as
// masked_topk_blocks_launch (q and qbm at the chunk's first query). All
// pointers are device memory; nothing is allocated or synchronised here.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int masked_topk_blocks_large_launch(
    const void* q, const uint32_t* qbm, const void* base, const float* norms,
    const uint32_t* bm, uint32_t* keys, void* ws, float* out_d, int* out_i,
    int nq, int q0, int nq_all, int n, int d, int w, int pred, int k, int bn,
    int rows_per_split, int dtype, void* stream_ptr) {
  using namespace repro_torch;
  if (nq <= 0 || q0 < 0 || q0 + nq > nq_all || n <= 0 || d <= 0 || w <= 0 ||
      k < 1 || bn < 1 || pred < 0 || pred > 2 || dtype < 0 || dtype > 1 ||
      scan_smem_bytes(d, w) > kMaxSmem || rows_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = ((long long)n + bn - 1) / bn;
  const long long stride = nb * bn;
  if (nb > 65535 || nb * nq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (stride > n) {                    // the ragged last block's pad
    err = cudaMemset2DAsync(keys + n, (size_t)stride * 4, 0xff,
                            (size_t)(stride - n) * 4, (size_t)nq, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const SplitArgs a{q,       qbm, base, norms, bm, nullptr, nullptr, nq,
                    n,       d,   w,    k,     rows_per_split};
  err = keys_for(dtype, pred, a, keys, stride, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run_select(
      keys, bn, (int)(nq * nb), bn, k, ws,
      EmitBlocks{out_d, out_i, k, (int)nb, nq_all, q0, bn}, stream));
}
