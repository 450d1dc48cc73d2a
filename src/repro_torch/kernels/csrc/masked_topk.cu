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
//     in tiles of kTileRows rows with the tile scan of tile_scan.cuh,
//     which fused_live.cu's delta scan shares. It reads the tile's label
//     words into shared memory and evaluates every (query, row) pair of
//     the tile on the uint32 words; a tile that no pair passes is skipped
//     without reading its vectors. Otherwise the tile's rows are read
//     once, coalesced, into shared memory and serve all kQG queries, so
//     the base is read once per query group, not once per query.
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
// k above 128 (the live path's overfetch: k plus the tombstone count,
// 1,016 at 1,000 deletes and k = 10). The per-thread lists above hold at
// most 128 entries, so a larger k takes a second pair of kernels that
// keeps no lists at all:
//   * masked_keys_kernel scans with the split kernel's tile scan (so
//     every score is bit-identical to the split kernel's) and writes one
//     32-bit key per (query, row): the score's bits mapped so that
//     unsigned order is float order, or kNoKey for a pair that fails the
//     predicate or scores at or above PAD_SCORE. Bytes: 4 per (query,
//     row) written and read back, about 4x the bitmaps' 28 B a row at W
//     = 7; the wrapper cuts the queries so the keys stay under 256 MB.
//   * topk_select_kernel, one block of 1,024 threads per query: a radix
//     select (four 8-bit passes, shared-memory histograms, the lanes of a
//     warp that hit one bin adding once) finds the k-th
//     smallest key T; one ordered pass collects every key below T and the
//     lowest-row keys equal to T (a ballot prefix keeps row order), as
//     (key << 32 | row) 64-bit values; a bitonic sort orders them. The
//     64-bit value orders by (score, row id), so ties go to the lowest
//     row, as in `_fold_topk`. The sort runs in shared memory up to 16,384
//     survivors (128 KB) and in a per-query global scratch above that, so
//     any k is taken. Slots past the match count are (PAD_SCORE, -1).

// Per-block output. The same scan also replaces
// src/repro/kernels/masked_topk.py::masked_topk_blocks (the Pallas TPU
// kernel `_block_kernel`): the top-k of every (query, block of bn rows),
// [NB, Q, k], with no fold, is the scan's output with splits of exactly
// bn rows; its fill is the one `_block_kernel`'s k-step min extraction
// leaves. Its bound is that of the fused scan plus the [NB, Q, k] output
// (8 bytes a slot: 20 MB for 256 queries at 1M rows, k = 10).

#include "tile_scan.cuh"

namespace repro_torch {
namespace {

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
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQG, split = blockIdx.y;
  const int nqb = min(kQG, nq - q0);
  const int qloc = tid / kLanesPerQ, sub = tid % kLanesPerQ;
  const bool live = qloc < nqb;
  float ld[KMAX];
  int li[KMAX];
  for (int j = 0; j < k; ++j) { ld[j] = INFINITY; li[j] = kEmptyId; }

  const long long row0 = (long long)split * rows_per_split;
  const int row1 = (int)min((long long)n, row0 + rows_per_split);
  scan_tiles<PRED>(
      smem, q, qbm, nq, base, norms, bm, d, w, row0, row1, DirectRows{},
      [&](int, int p, float s) { list_insert(ld, li, k, s, p); },
      [](int, int) {});

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

// ---------------------------------------------------------------------------
// k > 128: per-(query, row) keys, then a radix select and sort per query
// ---------------------------------------------------------------------------

constexpr uint32_t kNoKey = 0xffffffffu;   // a pair that does not qualify
constexpr int kSelThreads = 1024;

// Unsigned key whose order is the float order of s (never kNoKey for a
// score below PAD_SCORE), and its inverse.
__device__ __forceinline__ uint32_t sortable_key(float s) {
  const uint32_t b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float sortable_float(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// keys [nq, n]: sortable_key(score) of each passing (query, row) pair
// whose score is below PAD_SCORE, kNoKey for every other pair. The scan
// is the split kernel's, tile for tile.
template <int PRED, typename T>
__global__ void __launch_bounds__(kThreads)
masked_keys_kernel(const T* __restrict__ q, const uint32_t* __restrict__ qbm,
                   const T* __restrict__ base,
                   const float* __restrict__ norms,
                   const uint32_t* __restrict__ bm,
                   uint32_t* __restrict__ keys, int nq, int n, int d, int w,
                   int rows_per_split) {
  extern __shared__ float smem[];
  const int qloc = threadIdx.x / kLanesPerQ;
  uint32_t* out = keys + (size_t)(blockIdx.x * kQG + qloc) * n;
  const long long row0 = (long long)blockIdx.y * rows_per_split;
  const int row1 = (int)min((long long)n, row0 + rows_per_split);
  scan_tiles<PRED>(
      smem, q, qbm, nq, base, norms, bm, d, w, row0, row1, DirectRows{},
      [&](int, int p, float s) {
        out[p] = s < kPadScore ? sortable_key(s) : kNoKey;
      },
      [&](int, int p) { out[p] = kNoKey; });
}

// One block per query: out_d/out_i [nq, k] from keys [nq, n], ordered by
// (score, row id); (PAD_SCORE, -1) past the query's match count. `cand`
// holds n2 >= min(k, n) 64-bit values (a power of two): dynamic shared
// memory when `scratch` is null, else the query's [n2] slice of it.
__global__ void __launch_bounds__(kSelThreads)
topk_select_kernel(const uint32_t* __restrict__ keys,
                   float* __restrict__ out_d, int* __restrict__ out_i, int n,
                   int k, int n2, unsigned long long* __restrict__ scratch) {
  extern __shared__ unsigned long long sel_smem[];
  __shared__ unsigned int hist[256];
  __shared__ unsigned int warp_cnt[kSelThreads / 32];
  __shared__ uint32_t s_t;
  __shared__ unsigned int s_rank, s_take, s_lt, s_eq;
  __shared__ int s_done, s_stop;
  unsigned long long* cand =
      scratch ? scratch + (size_t)blockIdx.x * n2 : sel_smem;
  const uint32_t* row = keys + (size_t)blockIdx.x * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    s_t = 0;
    s_rank = k;
    s_take = k;
    s_done = 0;
  }

  // radix select of T, the k-th smallest qualifying key, 8 bits a pass
  // from the top. kNoKey is never counted: with fewer than k qualifying
  // keys, T = kNoKey and every qualifying key is taken.
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kSelThreads) hist[i] = 0;
    __syncthreads();
    const uint32_t mask = shift == 24 ? 0u : 0xffffffffu << (shift + 8);
    const uint32_t prefix = s_t;
    for (int i0 = 0; i0 < n; i0 += kSelThreads) {
      // scores bunch into few bins: the lanes of a warp that share a bin
      // add once, through their leader
      const uint32_t key = i0 + tid < n ? row[i0 + tid] : kNoKey;
      const bool counted = key != kNoKey && (key & mask) == prefix;
      const unsigned int bin = counted ? (key >> shift) & 0xffu : 256u;
      const unsigned int peers = __match_any_sync(kFullMask, bin);
      if (counted && lane == __ffs(peers) - 1)
        atomicAdd(&hist[bin], (unsigned int)__popc(peers));
    }
    __syncthreads();
    if (tid == 0) {
      unsigned int rank = s_rank, cum = 0;
      if (shift == 24) {
        unsigned int total = 0;
        for (int b = 0; b < 256; ++b) total += hist[b];
        if (total < rank) {
          s_done = 1;
          s_t = kNoKey;
          s_rank = 0;
          s_take = total;
        }
      }
      if (!s_done) {
        int b = 0;
        while (cum + hist[b] < rank) cum += hist[b++];
        s_t = prefix | ((uint32_t)b << shift);
        s_rank = rank - cum;
      }
    }
    __syncthreads();
    if (s_done) break;
  }

  // one pass in row order: every key below T (any slot of the first
  // n_lt), and the first `need_eq` keys equal to T in row order
  const uint32_t t = s_t;
  const unsigned int need_eq = s_rank, take = s_take;
  const unsigned int n_lt = take - need_eq;
  if (tid == 0) {
    s_lt = 0;
    s_eq = 0;
    s_stop = 0;
  }
  __syncthreads();
  for (int i0 = 0; i0 < n; i0 += kSelThreads) {
    const int i = i0 + tid;
    const uint32_t key = i < n ? row[i] : kNoKey;
    const unsigned long long v = ((unsigned long long)key << 32) | (uint32_t)i;
    if (key < t) cand[atomicAdd(&s_lt, 1u)] = v;
    const bool eq = t != kNoKey && key == t;
    const unsigned int ball = __ballot_sync(kFullMask, eq);
    if (lane == 0) warp_cnt[warp] = __popc(ball);
    __syncthreads();
    unsigned int before = s_eq + __popc(ball & ((1u << lane) - 1u));
    for (int x = 0; x < warp; ++x) before += warp_cnt[x];
    if (eq && before < need_eq) cand[n_lt + before] = v;
    __syncthreads();
    // tid 0 decides the stop for all: s_lt is final for this tile here
    // (its adds precede the barrier above), and s_stop is written again
    // only after two more barriers, which every thread reads it before
    if (tid == 0) {
      unsigned int tile = 0;
      for (int x = 0; x < kSelThreads / 32; ++x) tile += warp_cnt[x];
      s_eq += tile;
      s_stop = s_lt >= n_lt && s_eq >= need_eq;
    }
    __syncthreads();
    if (s_stop) break;
  }

  // bitonic sort of the n2 slots, the unused ones past every value
  for (int i = take + tid; i < n2; i += kSelThreads) cand[i] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int x = tid; x < (n2 >> 1); x += kSelThreads) {
        const int lo = 2 * x - (x & (stride - 1)), hi = lo + stride;
        const unsigned long long a = cand[lo], b = cand[hi];
        if ((a > b) == ((lo & size) == 0)) {
          cand[lo] = b;
          cand[hi] = a;
        }
      }
      __syncthreads();
    }

  const size_t out0 = (size_t)blockIdx.x * k;
  for (int j = tid; j < k; j += kSelThreads) {
    const bool valid = (unsigned int)j < take;
    const unsigned long long v = valid ? cand[j] : 0ull;
    out_d[out0 + j] = valid ? sortable_float((uint32_t)(v >> 32)) : kPadScore;
    out_i[out0 + j] = valid ? (int)(uint32_t)v : -1;
  }
}

template <typename T>
cudaError_t launch_keys(int pred, dim3 grid, size_t smem, cudaStream_t stream,
                        const SplitArgs& a, uint32_t* keys) {
  auto kernel = pred == 0   ? masked_keys_kernel<0, T>
                : pred == 1 ? masked_keys_kernel<1, T>
                            : masked_keys_kernel<2, T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), a.qbm, static_cast<const T*>(a.base),
      a.norms, a.bm, keys, a.nq, a.n, a.d, a.w, a.rows_per_split);
  return cudaGetLastError();
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
  const size_t smem = scan_smem_bytes(d, w);
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

// The k > 128 path: keys [nq, n] u32 scratch, then the top-k of each
// query into out_d/out_i [nq, k] (raw: (PAD_SCORE, -1) past the match
// count). n2 is the power of two >= min(k, n) the sort works on; with
// `scratch` null it runs in n2 * 8 bytes of dynamic shared memory, else
// in scratch [nq, n2] u64. Inputs as masked_topk_blocks_launch, n >= 1;
// rows_per_split cuts the key scan as the split kernel is cut. All
// pointers are device memory; nothing is allocated or synchronised here.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int masked_topk_large_launch(
    const void* q, const uint32_t* qbm, const void* base, const float* norms,
    const uint32_t* bm, uint32_t* keys, unsigned long long* scratch,
    float* out_d, int* out_i, int nq, int n, int d, int w, int pred, int k,
    int n2, int rows_per_split, int dtype, void* stream_ptr) {
  using namespace repro_torch;
  const size_t smem = scan_smem_bytes(d, w);
  const size_t sort_smem = scratch ? 0 : (size_t)n2 * sizeof(unsigned long long);
  if (nq <= 0 || n <= 0 || d <= 0 || w <= 0 || k < 1 || pred < 0 ||
      pred > 2 || dtype < 0 || dtype > 1 || smem > kMaxSmem ||
      rows_per_split < 1 || n2 < 1 || (n2 & (n2 - 1)) != 0 ||
      n2 < (k < n ? k : n) || sort_smem > kMaxSmem - 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long splits = ((long long)n + rows_per_split - 1) / rows_per_split;
  if (splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const SplitArgs a{q,       qbm, base, norms, bm, nullptr, nullptr, nq,
                    n,       d,   w,    k,     rows_per_split};
  const dim3 grid((nq + kQG - 1) / kQG, (unsigned)splits);
  cudaError_t err = dtype == 1
      ? launch_keys<__nv_bfloat16>(pred, grid, smem, stream, a, keys)
      : launch_keys<float>(pred, grid, smem, stream, a, keys);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sort_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(topk_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sort_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  topk_select_kernel<<<nq, kSelThreads, sort_smem, stream>>>(
      keys, out_d, out_i, n, k, n2, scratch);
  return static_cast<int>(cudaGetLastError());
}
