// Cross-shard top-k merge of per-shard candidate lists, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/masked_topk.py::merge_topk_accum (the
// Pallas TPU kernel `_merge_kernel`, which folds one shard's [BQ, K]
// block at a time into a VMEM carry through `_fold_topk`).
//
// What bounds it on this card: bytes. It reads the [S, Q, K] distances
// and ids once (8 bytes a slot) and writes [Q, k] (8 bytes a slot); on
// the sharded path (S = 4, Q <= 256, K = k = 10) that is under 100 KB,
// so a launch costs what a launch costs. Behind the multi-block exact
// search (S = 977 blocks, Q = 256, K = 10) it reads 20 MB.
//
// It is also the fold of the fused scan `masked_topk`
// (csrc/masked_topk.cu): the scan writes one sorted list per (row split,
// query), [splits, Q, k], and this kernel folds them. Equal scores there
// come from rows in ascending id order (splits in row order, each list
// ordered by (score, row)), so position order is row-id order.
//
// Design. The TPU kernel carries a [BQ, k] top-k across a sequential
// grid of shards; here a group of threads owns one query and nothing is
// carried between blocks:
//   * The query's S·K candidates are numbered shard-major (position
//     p = shard·K + slot). Thread t of the group owns lists (shards) t,
//     t + G, ...
//   * Each thread keeps one candidate in registers: the smallest of its
//     own that comes after the last winner. k rounds of an argmin over
//     these give the top-k in order; after each round only the thread
//     that won finds its next candidate. The others' candidates stay the
//     smallest after the new winner, since the winner is at most each of
//     them. No per-thread lists, so no local memory.
//   * Finding the next candidate: a thread that owns one list which is
//     ascending (the fused scan's per-split lists, the per-block lists,
//     a shard's top-k) steps to the list's next slot, one load, as a
//     merge of sorted lists does; any other thread rescans its lists.
//     The inputs need not be sorted: each thread checks its list, unless
//     the caller promises (`sorted`) that every list is ascending, as the
//     fused scan does for the lists it writes.
//   * The group is a warp (8 queries a block, a shuffle argmin a round)
//     when S <= 32; above that the whole block owns one query, one
//     thread a list up to 1,024, and a round is a shuffle argmin in each
//     warp, one barrier, and a shuffle argmin over the warps' winners
//     (double-buffered, so one barrier a round).
//   * The order is total: the key is the float's bits mapped so that
//     integer order is the IEEE total order (-0.0 before +0.0, -inf
//     first), the order in which jax.lax.top_k ranks, and equal keys go
//     to the earlier position, i.e. the earlier shard, then the earlier
//     slot, as `_fold_topk` gives. So the result does not depend on the
//     launch configuration, and no atomics are needed.
//   * The wrapper's rules are fused in: a slot with id < 0, a NaN, or a
//     distance >= PAD_SCORE counts as PAD_SCORE; the outputs past the
//     valid candidates (k may exceed S·K) are (PAD_SCORE, -1). A valid
//     output keeps the input distance's bits.
//   * Any k >= 1: the k rounds keep no lists, so nothing bounds k but the
//     output (a reranking stage's k in the hundreds merges as k = 10 does,
//     one round a slot).

#include <climits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarpThreads = 256;       // warp mode: 8 queries a block
constexpr int kMaxThreads = 1024;       // block mode: one query a block
constexpr int kEmptyKey = 0x7fffffff;   // after every float's key

// One query's candidates: list l, slot j of [s, nq, kk].
struct Lists {
  const float* __restrict__ dists;
  const int* __restrict__ ids;
  int s, nq, qi, kk;

  __device__ __forceinline__ size_t off(int l, int j) const {
    return ((size_t)l * nq + qi) * kk + j;
  }
  // The slot's key, with the invalid ones at PAD_SCORE's.
  __device__ __forceinline__ int key(int l, int j) const {
    const size_t o = off(l, j);
    const float x = dists[o];
    return order_key((ids[o] < 0 || !(x < kPadScore)) ? kPadScore : x);
  }
};

// The smallest (key, position) of lists t, t + g, ... that comes after
// (after_k, after_p); (kEmptyKey, kEmptyId) if none.
__device__ void rescan(const Lists& L, int t, int g, int after_k,
                       int after_p, int& best_k, int& best_p) {
  best_k = kEmptyKey;
  best_p = kEmptyId;
  for (int l = t; l < L.s; l += g)
#pragma unroll 4
    for (int j = 0; j < L.kk; ++j) {
      const int key = L.key(l, j), p = l * L.kk + j;
      if (pair_less(after_k, after_p, key, p) &&
          pair_less(key, p, best_k, best_p)) {
        best_k = key;
        best_p = p;
      }
    }
}

// BLOCK false: a warp per query (blockDim.x = kWarpThreads); true: the
// block per query (blockDim.x a multiple of 32, at most kMaxThreads).
template <bool BLOCK>
__global__ void __launch_bounds__(kMaxThreads)
merge_topk_kernel(const float* __restrict__ dists,
                  const int* __restrict__ ids, float* __restrict__ out_d,
                  int* __restrict__ out_i, int s, int nq, int kk, int k,
                  bool sorted) {
  __shared__ int red_k[2][32];            // each warp's winner, by round
  __shared__ int red_p[2][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = BLOCK ? blockDim.x : 32;
  const int qi = BLOCK ? blockIdx.x : blockIdx.x * (kWarpThreads / 32) + warp;
  const int t = BLOCK ? threadIdx.x : lane;
  if (!BLOCK && qi >= nq) return;         // the whole warp leaves together
  const Lists L{dists, ids, s, nq, qi, kk};

  // one ascending list: step through it; else rescan. The list's keys
  // are read with no early exit, so the loads are all in flight at once.
  bool stepping = t < s && t + g >= s;
  int cursor = 0, mine_k = kEmptyKey, mine_p = kEmptyId;
  if (stepping) {
    mine_k = L.key(t, 0);
    mine_p = t * kk;
  }
  if (stepping && !sorted) {
    int prev = mine_k;
#pragma unroll 4
    for (int j = 1; j < kk; ++j) {
      const int key = L.key(t, j);
      stepping &= prev <= key;
      prev = key;
    }
  }
  if (!stepping) rescan(L, t, g, INT_MIN, -1, mine_k, mine_p);

  const int pad_key = order_key(kPadScore);
  for (int j = 0; j < k; ++j) {
    int key = mine_k, pos = mine_p;
    lanes_argmin<32>(key, pos);
    if (BLOCK) {
      const int nw = blockDim.x >> 5;
      if (lane == 0) { red_k[j & 1][warp] = key; red_p[j & 1][warp] = pos; }
      __syncthreads();
      key = lane < nw ? red_k[j & 1][lane] : kEmptyKey;
      pos = lane < nw ? red_p[j & 1][lane] : kEmptyId;
      lanes_argmin<32>(key, pos);
    }
    if (t == 0) {
      const bool valid = key < pad_key;
      int id = -1;
      if (valid) id = ids[L.off(pos / kk, pos % kk)];
      out_d[(size_t)qi * k + j] = valid ? key_float(key) : kPadScore;
      out_i[(size_t)qi * k + j] = id;
    }
    if (pos == kEmptyId || pos != mine_p) continue;
    if (!stepping) {                      // this thread won: its next
      rescan(L, t, g, key, pos, mine_k, mine_p);
    } else if (++cursor < kk) {
      mine_k = L.key(t, cursor);
      mine_p = t * kk + cursor;
    } else {
      mine_k = kEmptyKey;
      mine_p = kEmptyId;
    }
  }
}

}  // namespace
}  // namespace repro_torch

// dists [s, nq, kk] f32, ids [s, nq, kk] i32 -> out_d [nq, k] f32, out_i
// [nq, k] i32, raw: (PAD_SCORE, -1) at invalid outputs. `sorted` != 0
// promises that every [kk] list is ascending in (distance, slot) under
// the rules above; the result is the same either way. All pointers are
// device memory; nothing is allocated or synchronised here. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int merge_topk_launch(const float* dists, const int* ids,
                                 float* out_d, int* out_i, int s, int nq,
                                 int kk, int k, int sorted,
                                 void* stream_ptr) {
  using namespace repro_torch;
  const long long c = (long long)s * kk;
  if (s < 1 || nq < 1 || kk < 1 || k < 1 ||
      c >= 0x7fffffffLL - 0xffff)   // int positions; any k (k rounds)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (s <= 32) {
    const int per_block = kWarpThreads / 32;
    merge_topk_kernel<false>
        <<<(nq + per_block - 1) / per_block, kWarpThreads, 0, stream>>>(
            dists, ids, out_d, out_i, s, nq, kk, k, sorted != 0);
  } else {
    const int threads = s >= kMaxThreads ? kMaxThreads : (s + 31) / 32 * 32;
    merge_topk_kernel<true><<<nq, threads, 0, stream>>>(
        dists, ids, out_d, out_i, s, nq, kk, k, sorted != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
