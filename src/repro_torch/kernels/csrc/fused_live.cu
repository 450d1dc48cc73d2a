// Fused live read: tombstone-masked base candidates and a predicate- and
// tombstone-masked scan of the delta rows, folded into one top-k, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/masked_topk.py::fused_live_accum (the
// Pallas TPU kernel `_fused_live_kernel` with `_tombstone_bits`, which
// folds the base candidates on the first delta block and then every
// delta block into a [BQ, k] VMEM carry through `_fold_topk`).
//
// What bounds it on this card: at the live path's shapes (256 queries,
// 65,536 delta rows of 192 dims, 1,016 base candidates a query) the
// delta scan is 2·Q·ND·D = 6.4 GFLOP of fp32 FMA work on the pairs that
// pass (about 0.1 ms at 67 TFLOP/s when every pair passes) against 53 MB
// of delta rows, bitmaps and norms (16 µs at 3.35 TB/s) and 2 MB of
// candidates: operations, on unselective predicates; the bytes of the
// rows no query of a block passes are skipped, as in masked_topk.
//
// Design. Nothing is carried between blocks (Hopper runs them in no
// order); the fold is split in two, as the fused scan of masked_topk is:
//   * grid = (group of kQG queries, 1 + delta splits). Split 0 streams
//     the group's KB base candidates: each of a query's 8 owner lanes
//     takes every 8th slot, drops it if its id is < 0, its distance is
//     not finite or is at or above PAD_SCORE, or its tombstone bit is set
//     (packed little-endian words, the id clipped into range as
//     `_tombstone_bits` does), and offers the rest to the query's list in
//     shared memory (group_insert of tile_scan.cuh). KB may be in the
//     thousands: a slot is read once and never kept past the list's k
//     entries.
//   * Splits 1.. walk the delta rows with the tile scan of tile_scan.cuh,
//     the one masked_topk.cu's kernels walk the base with: the tile's row
//     numbers (through `sel`, the pruner's chosen rows, when given: the
//     gather happens there, no gathered copy is made) and their tombstone
//     bits first, then the label words; a tile no pair passes is skipped
//     without reading its vectors. The score chain is the scan's, so a
//     delta score here is bit-identical to the one the staged path's
//     masked_topk computes for the same row.
//   * Every candidate is ranked by (order_key(distance), position), the
//     position being its base slot, or KB + its delta scan index. The
//     order key is the IEEE total order (a caller's -0.0 before +0.0),
//     the order the reference's stable top-k ranks base candidates by;
//     delta scores are never -0.0. Each (split, query) list, in shared
//     memory as masked_topk's, goes to [1 + splits, Q, k], and
//     merge_topk.cu folds the lists in (key,
//     split, slot) order, which is (key, position) order here: base
//     before delta, then the earlier row, as the TPU kernel's fold gives.
//   * Ids: a base candidate keeps its id; delta row r is base_n + r.
//     Empty slots are (PAD_SCORE, -1).
//   * k above 128 (a reranking stage's candidate count on a live index):
//     the lists hold at most 128, so the read takes the keys route of
//     topk_select.cuh. One sortable 32-bit key per (query, position):
//     the cleaned base candidates at positions 0..KB-1 (kNoKey where the
//     cleanup above drops a slot), then the delta rows the scan reaches
//     at KB + p, from the key kernel with LiveRows (so every delta score
//     is the split kernel's and the staged read's); then the select over
//     the KB + NS positions, ties to the lowest position (base before
//     delta, then the earlier row), ids mapped back as above. The key
//     order is the IEEE total order of the distances, as order_key's.

#include "topk_select.cuh"

namespace repro_torch {
namespace {

constexpr int kEmptyKey = 0x7fffffff;             // after every real key

struct LiveArgs {
  const float* q;
  const uint32_t* qbm;
  const float* cand_d;
  const int* cand_i;
  const float* dvec;
  const float* dnorm;
  const uint32_t* dbm;
  const int* sel;       // [ns] delta rows to scan (-1 pads), or null: 0..ns-1
  const uint32_t* tomb;
  float* part_d;
  int* part_i;
  int kb, ns, base_n, tw, nq, d, w, k, rows_per_split;
};

template <int PRED>
__global__ void __launch_bounds__(kThreads, 2)
fused_live_split_kernel(const LiveArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int k = a.k, kb = a.kb;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQG, split = blockIdx.y;
  const int nqb = min(kQG, a.nq - q0);
  const int qloc = tid / kLanesPerQ, sub = tid % kLanesPerQ;
  const bool live = qloc < nqb;
  // each query's list of (key, position), past the scan's shared memory
  int* lk = reinterpret_cast<int*>(smem + scan_smem_bytes(a.d, a.w) /
                                              sizeof(float));   // [kQG][k]
  int* lp = lk + kQG * k;                                      // [kQG][k]
  for (int i = tid; i < kQG * k; i += kThreads) {
    lk[i] = kEmptyKey;
    lp[i] = kEmptyId;
  }
  __syncthreads();

  if (split == 0) {                 // the base candidates, slot by slot
    int* mk_ = lk + qloc * k;
    int* mp_ = lp + qloc * k;
    const size_t c0 = (size_t)(q0 + qloc) * kb;
    for (int j0 = 0; j0 < kb; j0 += kLanesPerQ) {
      const int j = j0 + sub;
      int key = kEmptyKey;
      bool ok = false;
      if (live && j < kb) {
        const float x = a.cand_d[c0 + j];
        const int id = a.cand_i[c0 + j];
        ok = id >= 0 && isfinite(x) && x < kPadScore &&
             !tombstoned(a.tomb, a.tw, id);
        key = order_key(x);
        ok = ok && pair_less(key, j, mk_[k - 1], mp_[k - 1]);
      }
      if (__any_sync(kFullMask, ok))
        group_insert<1>(mk_, mp_, k, sub, ok ? 1u : 0u, &key, &j,
                        kEmptyKey);
    }
  } else {                          // a split of the delta rows
    const long long p0 = (long long)(split - 1) * a.rows_per_split;
    const int p1 = (int)min((long long)a.ns, p0 + a.rows_per_split);
    scan_tiles<PRED>(
        smem, a.q, a.qbm, a.nq, a.dvec, a.dnorm, a.dbm, a.d, a.w, p0, p1,
        LiveRows{a.sel, a.tomb, a.tw, a.base_n},
        [&](int ql, int sb, bool lv, int t0, int nr, const uint32_t* tm,
            const float* scq) {
          offer_tile(
              lk + ql * k, lp + ql * k, k, ql, sb, lv, nr, tm, scq,
              kEmptyKey,
              [](float x, int& key) {
                key = order_key(x);
                return x < kPadScore;
              },
              [&](int r) { return kb + t0 + r; });
        });
  }

  // each query's list, ascending in (key, position), to its slot
  __syncthreads();
  if (!live) return;
  const size_t out0 = ((size_t)split * a.nq + q0 + qloc) * k;
  for (int j = sub; j < k; j += kLanesPerQ) {
    const int key = lk[qloc * k + j], pos = lp[qloc * k + j];
    const bool empty = pos == kEmptyId;
    int id = -1;
    if (!empty)
      id = pos < kb ? a.cand_i[(size_t)(q0 + qloc) * kb + pos]
                    : a.base_n + (a.sel ? a.sel[pos - kb] : pos - kb);
    a.part_d[out0 + j] = empty ? kPadScore : key_float(key);
    a.part_i[out0 + j] = id;
  }
}

template <int PRED>
cudaError_t launch_split(dim3 grid, size_t smem, cudaStream_t stream,
                         const LiveArgs& a) {
  auto kernel = fused_live_split_kernel<PRED>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// keys [nq, stride] at positions 0..kb-1: the sortable key of each base
// candidate the cleanup keeps, kNoKey for the others. grid (slot blocks,
// query).
__global__ void __launch_bounds__(256)
live_base_keys_kernel(const float* __restrict__ cand_d,
                      const int* __restrict__ cand_i, int kb,
                      const uint32_t* __restrict__ tomb, int tw,
                      uint32_t* __restrict__ keys, long long stride) {
  const int qi = blockIdx.y, j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= kb) return;
  const float x = cand_d[(size_t)qi * kb + j];
  const int id = cand_i[(size_t)qi * kb + j];
  const bool ok = id >= 0 && isfinite(x) && x < kPadScore &&
                  !tombstoned(tomb, tw, id);
  keys[(size_t)qi * stride + j] = ok ? sortable_key(x) : kNoKey;
}

// The select's output for the live read: position < kb a base slot (its
// candidate's id), else KB + the delta scan index (id base_n + its row).
struct EmitLive {
  float* d;
  int* i;
  const int* cand_i;
  const int* sel;
  int k, kb, base_n;
  __device__ __forceinline__ void operator()(int r, int j, bool valid,
                                             uint32_t key, int pos) const {
    const size_t o = (size_t)r * k + j;
    int id = -1;
    if (valid)
      id = pos < kb ? cand_i[(size_t)r * kb + pos]
                    : base_n + (sel ? sel[pos - kb] : pos - kb);
    d[o] = valid ? sortable_float(key) : kPadScore;
    i[o] = id;
  }
};

}  // namespace
}  // namespace repro_torch

// q [nq, d] f32, qbm [nq, w] u32, cand_d/cand_i [nq, kb] f32/i32 base
// candidates (global ids), dvec [nd, d] f32, dnorm [nd] f32, dbm [nd, w]
// u32 the delta mirror, sel [ns] i32 mirror rows to scan (-1 pads) or
// null to scan rows 0..ns-1, tomb [tw] u32 packed tombstones over base
// and delta ids, delta row r has id base_n + r -> part_d/part_i
// [1 + splits, nq, k], splits = ceil(ns / rows_per_split): split 0 the
// base candidates', each further one a run of rows_per_split scanned
// rows', every list ascending in (order_key(distance), position), for
// merge_topk_launch (sorted) to fold. All pointers are device memory;
// nothing is allocated or synchronised here. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int fused_live_launch(
    const float* q, const uint32_t* qbm, const float* cand_d,
    const int* cand_i, int kb, const float* dvec, const float* dnorm,
    const uint32_t* dbm, const int* sel, int ns, int base_n,
    const uint32_t* tomb, int tw, float* part_d, int* part_i, int nq, int d,
    int w, int pred, int k, int rows_per_split, void* stream_ptr) {
  using namespace repro_torch;
  const size_t smem = scan_smem_bytes(d, w) + (size_t)kQG * k * 8;
  if (nq <= 0 || d <= 0 || w <= 0 || kb < 0 || ns < 0 || tw < 1 || k < 1 ||
      k > 128 || pred < 0 || pred > 2 || rows_per_split < 1 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long splits = ((long long)ns + rows_per_split - 1) / rows_per_split;
  if (splits + 1 > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const LiveArgs a{q,   qbm,  cand_d, cand_i, dvec, dnorm, dbm, sel,
                   tomb, part_d, part_i, kb, ns, base_n, tw, nq,
                   d,   w,    k,      rows_per_split};
  const dim3 grid((nq + kQG - 1) / kQG, (unsigned)(splits + 1));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (pred == 0) err = launch_split<0>(grid, smem, stream, a);
  else if (pred == 1) err = launch_split<1>(grid, smem, stream, a);
  else err = launch_split<2>(grid, smem, stream, a);
  return static_cast<int>(err);
}

// fused_live for k > 128, for a chunk of nq queries (q, qbm, cand_d,
// cand_i, out_d, out_i at the chunk's first query): keys [nq, stride]
// u32 scratch, stride = (kb + ns) rounded up to a multiple of 4, then the
// top-k of each query's kb + ns positions into out_d/out_i [nq, k] (raw:
// (PAD_SCORE, -1) at invalid outputs); ws holds
// topk_select_workspace_bytes(nq, kb + ns, k). Other inputs as
// fused_live_launch; kb + ns >= 1. All pointers are device memory;
// nothing is allocated or synchronised here. Returns the cudaError_t of
// the launches (0 on success).
extern "C" int fused_live_large_launch(
    const float* q, const uint32_t* qbm, const float* cand_d,
    const int* cand_i, int kb, const float* dvec, const float* dnorm,
    const uint32_t* dbm, const int* sel, int ns, int base_n,
    const uint32_t* tomb, int tw, uint32_t* keys, void* ws, float* out_d,
    int* out_i, int nq, int d, int w, int pred, int k, int rows_per_split,
    void* stream_ptr) {
  using namespace repro_torch;
  const long long m = (long long)kb + ns;
  if (nq <= 0 || nq > 65535 || d <= 0 || w <= 0 || kb < 0 || ns < 0 ||
      m < 1 || m >= 0x7fffffffLL - 0xffff || tw < 1 || k < 1 || pred < 0 ||
      pred > 2 || rows_per_split < 1 || scan_smem_bytes(d, w) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long stride = (m + 3) & ~3LL;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (kb > 0) {
    live_base_keys_kernel<<<dim3((kb + 255) / 256, nq), 256, 0, stream>>>(
        cand_d, cand_i, kb, tomb, tw, keys, stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (ns > 0) {
    err = launch_keys(pred, q, qbm, dvec, dnorm, dbm,
                      LiveRows{sel, tomb, tw, base_n}, keys, stride, kb, nq,
                      ns, d, w, rows_per_split, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(
      run_select(keys, stride, nq, (int)m, k, ws,
                 EmitLive{out_d, out_i, cand_i, sel, k, kb, base_n}, stream));
}
