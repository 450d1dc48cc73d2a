// Cross-shard top-k merge of per-shard candidate lists, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/masked_topk.py::merge_topk_accum (the
// Pallas TPU kernel `_merge_kernel`, which folds one shard's [BQ, K]
// block at a time into a VMEM carry through `_fold_topk`).
//
// What bounds it on this card: bytes. It reads the [S, Q, K] distances
// and ids once (8 bytes a slot) and writes [Q, k] (8 bytes a slot): under
// 100 KB on the sharded path (S = 4, Q <= 256, K = k = 10), 4.2 MB for
// the staged live read's [2, 256, 1,016] lists (1.2 us at 3.35 TB/s), 20
// MB behind the multi-block exact search (S = 977 blocks, K = 10). Sorted
// lists need less: each list's head and the k winners. At the small
// shapes a launch costs what a launch costs; what the design must avoid
// is a chain of dependent loads from device memory, each a full memory
// latency.
//
// It is also the fold of the fused scan `masked_topk` (csrc/masked_topk.cu)
// and of `fused_live` (csrc/fused_live.cu): the scan writes one sorted
// list per (row split, query), [splits, Q, k], and this kernel folds them
// with the caller's promise (`sorted`) that every list is ascending.
// Equal scores there come from rows in ascending id order (splits in row
// order, each list ordered by (score, row)), so position order is row-id
// order.
//
// The order is total in every regime: a candidate's key is its
// distance's bits mapped so that integer order is the IEEE total order
// (-0.0 before +0.0, -inf first), the order in which jax.lax.top_k
// ranks, and equal keys go to the earlier position p = shard·K + slot,
// i.e. the earlier shard, then the earlier slot, as `_fold_topk` gives.
// So the result does not depend on the regime or the launch
// configuration, and no atomic decides an order. The wrapper's rules are
// fused in: a slot with id < 0, a NaN, or a distance >= PAD_SCORE counts
// as PAD_SCORE; the outputs past the valid candidates (k may exceed S·K)
// are (PAD_SCORE, -1). A valid output keeps the input distance's bits.
// Any k >= 1.
//
// Design. The TPU kernel carries a [BQ, k] top-k across a sequential
// grid of shards; here a block owns one query and nothing is carried
// between blocks. The launcher picks the regime from the candidates a
// query holds, M = S·K, and from the caller's promise that the lists are
// sorted, never from S alone:
//   * M keys that fit a block's shared memory, any lists (the staged
//     live read's have +inf holes where the base overfetch's rows are
//     tombstoned; the public entry point never assumes order): the block
//     reads each slot once. G = 32-512 threads (M / 8 keys a thread), so
//     256 queries give 256 blocks over the 132 SMs.
//     Lane t reads positions t, t + G, ... (16 bytes a thread where K is a
//     multiple of 4: one query's slots of one list are contiguous), and
//     writes each slot's 32-bit key, kNoKey for an invalid slot, to
//     shared memory (8 KB at M = 2,032), keeping its own smallest. Then
//     the survivors, a set that holds the k winners:
//       - for k <= 32 (every path's k = 10), the keys at most a bound B:
//         each warp sorts its 32 lane minima across the lanes, and B is
//         the least of the warps' k-th smallest. B is the largest of k
//         distinct candidates, so the winners are all at most B, and a
//         lane's minimum stands for M / G keys, so few keys are: one
//         ballot pass collects them (if more than 256 are, the radix
//         select below takes over);
//       - else a radix select, on 8-bit digits from the top: a shared
//         256-bin histogram of the keys that carry the digits picked so
//         far (the lanes of a warp that hit one bin add once), and one
//         warp picks the bin of the k-th key. It stops when that bin's
//         keys are all taken; after the last digit the k-th key T is
//         known, and the keys equal to T are taken in position order (a
//         ballot and a scan over the warps, tile by tile).
//     The survivors, (key << 32 | position), are distinct: up to 256 of
//     them each find their rank by counting the smaller ones (all threads
//     read the same survivor at a time, a broadcast), more are sorted
//     bitonically in shared memory. Only the k winners' ids are read. No
//     thread walks a list: every pass is G threads over shared memory, and
//     the only loads from device memory are one coalesced sweep and the k
//     ids.
//     Sorted lists take this regime too: on the card it was no slower
//     than stepping through them on the scans' folds at k = 10, the k of
//     every path.
//   * Past shared memory (the M keys and the survivors' sort over 96 KB:
//     M past about 24K keys), sorted lists (the scans' folds at k of
//     about 24 and more over a million rows): a stepping merge that reads
//     only the lists' heads and the k winners, in one kernel with no
//     workspace. Thread t owns list t (up to 1,024; a thread that owns
//     more rescans them) and keeps one candidate, its list's next slot; k
//     rounds of an argmin over the block give the top-k in order, and
//     after each round only the winner steps (one load). A round is a
//     shuffle argmin in each warp, one barrier, and a shuffle argmin over
//     the warps' winners (double-buffered, so one barrier a round).
//   * Past shared memory, other lists: a key kernel writes [Qc, M] keys
//     to the workspace, and the select of topk_select.cuh (the k > 128
//     paths' multi-block radix select) takes them, with an `Emit` that
//     maps a position back to its (shard, slot) id and the key back to
//     the input distance's bits.

#include <climits>

#include "topk_select.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxThreads = 1024;       // stepping: the block, one query
constexpr int kEmptyKey = 0x7fffffff;   // after every float's key
constexpr int kSelectThreads = 512;     // shared select: most threads
constexpr int kKeysPerThread = 8;       // ... and the keys each should read
constexpr size_t kSharedBytes = 96 * 1024;   // keys + survivors a block holds
constexpr long long kMergeKeys = 1LL << 26;  // workspace keys (256 MB)
constexpr int kKeyThreads = 256;        // key kernel: 4 keys a thread
constexpr int kBoundK = 32;             // k up to which a bound is tried
constexpr int kRankMax = 256;           // survivors ranked by counting

// One query's candidates: list l, slot j of [s, nq, kk].
struct Lists {
  const float* __restrict__ dists;
  const int* __restrict__ ids;
  int s, nq, qi, kk;

  __device__ __forceinline__ size_t off(int l, int j) const {
    return ((size_t)l * nq + qi) * kk + j;
  }
  __device__ __forceinline__ size_t off(int p) const {   // position p
    const int l = p / kk;
    return off(l, p - l * kk);
  }
  // The slot's key, with the invalid ones at PAD_SCORE's.
  __device__ __forceinline__ int key(int l, int j) const {
    const size_t o = off(l, j);
    const float x = dists[o];
    return order_key((ids[o] < 0 || !(x < kPadScore)) ? kPadScore : x);
  }
};

// The sortable key of a slot (sortable_key's order is order_key's), or
// kNoKey where the slot counts as PAD_SCORE.
__device__ __forceinline__ uint32_t slot_key(float x, int id) {
  return (id < 0 || !(x < kPadScore)) ? kNoKey : sortable_key(x);
}

// ---------------------------------------------------------------------------
// sorted lists: the stepping merge
// ---------------------------------------------------------------------------

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

// The block owns one query (blockDim.x a multiple of 32, at most
// kMaxThreads). Every list is ascending (the caller's promise).
__global__ void __launch_bounds__(kMaxThreads)
merge_step_kernel(const float* __restrict__ dists,
                  const int* __restrict__ ids, float* __restrict__ out_d,
                  int* __restrict__ out_i, int s, int nq, int kk, int k) {
  __shared__ int red_k[2][32];            // each warp's winner, by round
  __shared__ int red_p[2][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockDim.x, qi = blockIdx.x, t = threadIdx.x;
  const Lists L{dists, ids, s, nq, qi, kk};

  // a thread that owns one list steps through it; else it rescans
  const bool stepping = t < s && t + g >= s;
  int cursor = 0, mine_k = kEmptyKey, mine_p = kEmptyId;
  if (stepping) {
    mine_k = L.key(t, 0);
    mine_p = t * kk;
  } else {
    rescan(L, t, g, INT_MIN, -1, mine_k, mine_p);
  }

  const int pad_key = order_key(kPadScore);
  const int nw = blockDim.x >> 5;
  for (int j = 0; j < k; ++j) {
    int key = mine_k, pos = mine_p;
    lanes_argmin<32>(key, pos);
    if (lane == 0) { red_k[j & 1][warp] = key; red_p[j & 1][warp] = pos; }
    __syncthreads();
    key = lane < nw ? red_k[j & 1][lane] : kEmptyKey;
    pos = lane < nw ? red_p[j & 1][lane] : kEmptyId;
    lanes_argmin<32>(key, pos);
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

// ---------------------------------------------------------------------------
// any lists: the keys in shared memory, a radix select there
// ---------------------------------------------------------------------------

// The select's state, shared by the block.
struct PickState {
  unsigned int valid;    // keys that are not kNoKey
  unsigned int slot;     // the next survivor slot taken unordered
  unsigned int nbound;   // keys up to the bound
  uint32_t bound;        // the least of the warps' k-th lane minima
  uint32_t prefix;       // the digits picked so far
  unsigned int need;     // keys still to take from the picked prefix
  unsigned int below;    // valid keys below the picked prefix
  int shift;             // the lowest bit of the picked prefix
  int done;              // 0 on; 1 the picked bin is taken whole; 3 the
                         // prefix is the whole k-th key T
};

// One warp: the bin of the st.need-th key of this pass's histogram.
__device__ __forceinline__ void pick_bin(const unsigned int* hist,
                                         int shift, PickState& st) {
  const int lane = threadIdx.x & 31;
  unsigned int c[8], sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c[i] = hist[lane * 8 + i];
    sum += c[i];
  }
  unsigned int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned int o = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += o;
  }
  const unsigned int need = st.need, excl = incl - sum;
  if (excl < need && incl >= need) {      // one lane: the k-th's bins
    unsigned int run = excl;
    int i = 0;
    while (run + c[i] < need) run += c[i++];
    const unsigned int left = need - run;
    st.prefix |= (uint32_t)(lane * 8 + i) << shift;
    st.below += run;
    st.need = left;
    st.shift = shift;
    st.done = c[i] == left ? 1 : (shift == 0 ? 3 : 0);
  }
}

// Unordered survivors: every lane whose `in` is set takes a slot of
// cand, warp by warp; *slot counts them all, slots from `cap` on are not
// written.
__device__ __forceinline__ void take_unordered(bool in, uint32_t key, int p,
                                               unsigned long long* cand,
                                               unsigned int* slot,
                                               unsigned int cap = UINT_MAX) {
  const unsigned int ball = __ballot_sync(kFullMask, in);
  const int lane = threadIdx.x & 31;
  unsigned int base = 0;
  if (lane == 0 && ball) base = atomicAdd(slot, (unsigned int)__popc(ball));
  base = __shfl_sync(kFullMask, base, 0) + __popc(ball & ((1u << lane) - 1u));
  if (in && base < cap)
    cand[base] = ((unsigned long long)key << 32) | (uint32_t)p;
}

// The k-th smallest of the warp's 32 values (k <= 32): a bitonic sort
// across the lanes.
__device__ __forceinline__ uint32_t warp_kth(uint32_t v, int k) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint32_t o = __shfl_xor_sync(kFullMask, v, stride);
      const bool keep_min = ((lane & size) == 0) == ((lane & stride) == 0);
      v = keep_min ? min(v, o) : max(v, o);
    }
  return __shfl_sync(kFullMask, v, k - 1);
}

// One block a query. Dynamic shared memory: the m keys (16-byte aligned),
// then the survivors, max(pow2_at_least(min(k, m)), kRankMax) values.
// blockDim.x a multiple of 32, at most kSelectThreads. `vec`: kk % 4 ==
// 0 and both inputs 16-byte aligned.
__global__ void __launch_bounds__(kSelectThreads)
merge_select_kernel(const float* __restrict__ dists,
                    const int* __restrict__ ids, float* __restrict__ out_d,
                    int* __restrict__ out_i, int s, int nq, int kk, int k,
                    bool vec) {
  extern __shared__ __align__(16) unsigned char merge_smem[];
  __shared__ unsigned int hist[256];
  __shared__ unsigned int wsum[kSelectThreads / 32];
  __shared__ PickState st;
  const int qi = blockIdx.x, t = threadIdx.x, g = blockDim.x;
  const int lane = t & 31, warp = t >> 5;
  const int m = s * kk;
  uint32_t* keys = reinterpret_cast<uint32_t*>(merge_smem);
  unsigned long long* cand = reinterpret_cast<unsigned long long*>(
      merge_smem + (((size_t)m * 4 + 15) & ~(size_t)15));
  const Lists L{dists, ids, s, nq, qi, kk};
  if (t == 0)
    st = PickState{0u, 0u, 0u, kNoKey, 0u, (unsigned int)k, 0u, 0, 0};
  __syncthreads();

  // the keys, each slot read once, coalesced; each lane's smallest
  unsigned int mine = 0;
  uint32_t lane_min = kNoKey;
  if (vec) {
#pragma unroll 2
    for (int x = t; x < (m >> 2); x += g) {
      const size_t o = L.off(x << 2);
      const float4 dv = *reinterpret_cast<const float4*>(dists + o);
      const int4 iv = *reinterpret_cast<const int4*>(ids + o);
      const uint4 kv = make_uint4(slot_key(dv.x, iv.x), slot_key(dv.y, iv.y),
                                  slot_key(dv.z, iv.z), slot_key(dv.w, iv.w));
      mine += (kv.x != kNoKey) + (kv.y != kNoKey) + (kv.z != kNoKey) +
              (kv.w != kNoKey);
      lane_min = min(lane_min, min(min(kv.x, kv.y), min(kv.z, kv.w)));
      *reinterpret_cast<uint4*>(keys + (x << 2)) = kv;
    }
  } else {
#pragma unroll 4
    for (int p = t; p < m; p += g) {
      const size_t o = L.off(p);
      const uint32_t key = slot_key(dists[o], ids[o]);
      mine += key != kNoKey;
      lane_min = min(lane_min, key);
      keys[p] = key;
    }
  }
  mine = __reduce_add_sync(kFullMask, mine);
  if (lane == 0 && mine) atomicAdd(&st.valid, mine);
  __syncthreads();
  const unsigned int nvalid = st.valid;
  const bool all = nvalid <= (unsigned int)k;   // uniform

  // The survivors, c of them in cand in any order (the k-th key's ties in
  // position order), among them the k winners.
  //   * all valid keys, when there are at most k;
  //   * k <= kBoundK: the keys up to a bound B, the least of the warps'
  //     k-th smallest lane minima (k distinct candidates are at most B, so
  //     the winners all are), if at most kRankMax keys are;
  //   * else the radix select: the k keys below and at the k-th key T.
  unsigned int c = nvalid;
  bool bounded = false;
  if (!all && k <= kBoundK) {
    const uint32_t kth = warp_kth(lane_min, k);
    if (lane == 0 && kth != kNoKey) atomicMin(&st.bound, kth);
    __syncthreads();
    const uint32_t bound = st.bound;
    if (bound != kNoKey) {                // uniform
      for (int p0 = 0; p0 < m; p0 += g) {
        const int p = p0 + t;
        const uint32_t key = p < m ? keys[p] : kNoKey;
        take_unordered(key <= bound, key, p, cand, &st.nbound, kRankMax);
      }
      __syncthreads();
      c = st.nbound;
      bounded = c <= (unsigned int)kRankMax;
    }
  }

  if (all) {
    for (int p0 = 0; p0 < m; p0 += g) {
      const int p = p0 + t;
      const uint32_t key = p < m ? keys[p] : kNoKey;
      take_unordered(key != kNoKey, key, p, cand, &st.slot);
    }
  } else if (!bounded) {
    // the k-th key: a digit a pass, from the top
    for (int shift = 24; shift >= 0; shift -= 8) {
      const uint32_t prefix = st.prefix;
      for (int b = t; b < 256; b += g) hist[b] = 0;
      __syncthreads();
      for (int p0 = 0; p0 < m; p0 += g) {
        const int p = p0 + t;
        hist_add(hist, p < m ? keys[p] : kNoKey, prefix, shift);
      }
      __syncthreads();
      if (warp == 0) pick_bin(hist, shift, st);
      __syncthreads();
      if (st.done) break;
    }
    // keys below the k-th's bin (or T) in any order, then the keys equal
    // to T in position order
    const int done = st.done, shift = st.shift;
    const uint32_t prefix = st.prefix;
    const unsigned int below = st.below, need = st.need;
    for (int p0 = 0; p0 < m; p0 += g) {
      const int p = p0 + t;
      const uint32_t key = p < m ? keys[p] : kNoKey;
      const bool in = key != kNoKey &&
                      (done == 1 ? (key >> shift) <= (prefix >> shift)
                                 : key < prefix);
      take_unordered(in, key, p, cand, &st.slot);
    }
    if (done == 3) {
      unsigned int seen = 0;              // keys equal to T before the tile
      for (int p0 = 0; p0 < m && seen < need; p0 += g) {   // uniform
        const int p = p0 + t;
        const bool eq = p < m && keys[p] == prefix;
        const unsigned int ball = __ballot_sync(kFullMask, eq);
        if (lane == 0) wsum[warp] = __popc(ball);
        __syncthreads();
        unsigned int rank = seen + __popc(ball & ((1u << lane) - 1u));
        unsigned int tile = 0;
        for (int w = 0; w < g / 32; ++w) {
          rank += w < warp ? wsum[w] : 0u;
          tile += wsum[w];
        }
        if (eq && rank < need)
          cand[below + rank] =
              ((unsigned long long)prefix << 32) | (uint32_t)p;
        seen += tile;
        __syncthreads();                  // wsum is read before it is reused
      }
    }
    c = (unsigned int)k;
  }
  __syncthreads();

  // the winners in order, and only their ids read: up to kRankMax
  // survivors each take its rank by counting the survivors before it
  // (every thread reads the same one at a time); more are sorted
  // bitonically as (key << 32 | position)
  const int n = (int)c, out = n < k ? n : k;
  auto put = [&](int j, unsigned long long v) {
    const size_t o = (size_t)qi * k + j;
    out_d[o] = sortable_float((uint32_t)(v >> 32));
    out_i[o] = ids[L.off((int)(uint32_t)v)];
  };
  if (n <= kRankMax) {
    for (int i = t; i < n; i += g) {
      const unsigned long long v = cand[i];
      int r = 0;
      for (int j = 0; j < n; ++j) r += cand[j] < v;
      if (r < k) put(r, v);
    }
  } else {
    int n2 = 1;
    while (n2 < n) n2 <<= 1;
    for (int i = n + t; i < n2; i += g) cand[i] = ~0ull;
    __syncthreads();
    for (int size = 2; size <= n2; size <<= 1)
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int x = t; x < (n2 >> 1); x += g) {
          const int lo = 2 * x - (x & (stride - 1)), hi = lo + stride;
          const unsigned long long a = cand[lo], b = cand[hi];
          if ((a > b) == ((lo & size) == 0)) {
            cand[lo] = b;
            cand[hi] = a;
          }
        }
        __syncthreads();
      }
    for (int j = t; j < out; j += g) put(j, cand[j]);
  }
  for (int j = out + t; j < k; j += g) {
    out_d[(size_t)qi * k + j] = kPadScore;
    out_i[(size_t)qi * k + j] = -1;
  }
}

// ---------------------------------------------------------------------------
// M past shared memory: keys in the workspace, the select of topk_select
// ---------------------------------------------------------------------------

// Row r of keys [r, stride]: the keys of query q0 + r. Grid (ceil(m /
// (4 * kKeyThreads)), rows).
__global__ void __launch_bounds__(kKeyThreads)
merge_keys_kernel(const float* __restrict__ dists,
                  const int* __restrict__ ids, uint32_t* __restrict__ keys,
                  long long stride, int nq, int kk, int m, int q0) {
  const int r = blockIdx.y;
  const Lists L{dists, ids, 0, nq, q0 + r, kk};
  uint32_t* row = keys + (size_t)r * stride;
  const int p0 = blockIdx.x * 4 * kKeyThreads + threadIdx.x;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int p = p0 + x * kKeyThreads;
    if (p < m) {
      const size_t o = L.off(p);
      row[p] = slot_key(dists[o], ids[o]);
    }
  }
}

// Output slot j of row r (query q0 + r): the key's distance and the id
// at its position.
struct EmitMerge {
  const int* ids;
  float* d;
  int* i;
  int nq, kk, k, q0;
  __device__ __forceinline__ void operator()(int r, int j, bool valid,
                                             uint32_t key, int pos) const {
    const int qi = q0 + r;
    const size_t o = (size_t)qi * k + j;
    if (valid) {
      const int l = pos / kk;
      d[o] = sortable_float(key);
      i[o] = ids[((size_t)l * nq + qi) * kk + pos - l * kk];
    } else {
      d[o] = kPadScore;
      i[o] = -1;
    }
  }
};

// ---------------------------------------------------------------------------
// the regime
// ---------------------------------------------------------------------------

struct MergePlan {
  int regime;            // 0 stepping, 1 shared select, 2 workspace select
  int threads;           // regime 1: the block
  size_t smem;           // regime 1: dynamic shared memory
  int qc;                // regime 2: queries a chunk
  long long stride;      // regime 2: keys a row
  size_t keys_bytes, ws_bytes;   // regime 2: the workspace
};

inline long long pow2_ll(long long x) {
  long long p = 1;
  while (p < x) p <<= 1;
  return p;
}

inline MergePlan plan_merge(int s, int nq, int kk, int k, bool sorted) {
  MergePlan p{};
  const long long m = (long long)s * kk;
  const long long n2 = pow2_ll(k < m ? k : m);
  const size_t smem = (size_t)((m * 4 + 15) & ~15LL) +
                      (size_t)(n2 > kRankMax ? n2 : kRankMax) * 8;
  if (smem <= kSharedBytes) {
    p.regime = 1;
    p.smem = smem;
    p.threads = (int)pow2_ll((m + kKeysPerThread - 1) / kKeysPerThread);
    p.threads = p.threads < 32 ? 32 : (p.threads > kSelectThreads
                                           ? kSelectThreads : p.threads);
    return p;
  }
  if (sorted) return p;   // regime 0: one kernel, no workspace
  p.regime = 2;
  p.stride = (m + 3) & ~3LL;
  long long qc = kMergeKeys / (p.stride + 2 * n2);
  qc = qc < 1 ? 1 : (qc > nq ? nq : qc);
  p.qc = (int)(qc > 65535 ? 65535 : qc);
  p.keys_bytes = align256((size_t)p.qc * p.stride * 4);
  const int last = nq - (nq - 1) / p.qc * p.qc;
  const size_t a = plan_select(p.qc, (int)m, k).bytes;
  const size_t b = plan_select(last, (int)m, k).bytes;
  p.ws_bytes = p.keys_bytes + (a > b ? a : b);
  return p;
}

}  // namespace
}  // namespace repro_torch

// Bytes of the workspace merge_topk_launch needs for these arguments: 0
// where the lists fit the one-kernel regimes (sorted, or M = s·kk keys
// and the survivors' sort in a block's shared memory).
extern "C" long long merge_topk_workspace_bytes(int s, int nq, int kk, int k,
                                                int sorted) {
  if (s < 1 || nq < 1 || kk < 1 || k < 1) return 0;
  return (long long)repro_torch::plan_merge(s, nq, kk, k, sorted != 0)
      .ws_bytes;
}

// dists [s, nq, kk] f32, ids [s, nq, kk] i32 -> out_d [nq, k] f32, out_i
// [nq, k] i32, raw: (PAD_SCORE, -1) at invalid outputs. `sorted` != 0
// promises that every [kk] list is ascending in (distance, slot) under
// the rules above; the result is the same either way. ws holds
// merge_topk_workspace_bytes(s, nq, kk, k, sorted) bytes (may be null
// where that is 0). All pointers are device memory; nothing is allocated
// or synchronised here. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int merge_topk_launch(const float* dists, const int* ids,
                                 float* out_d, int* out_i, void* ws, int s,
                                 int nq, int kk, int k, int sorted,
                                 void* stream_ptr) {
  using namespace repro_torch;
  const long long c = (long long)s * kk;
  if (s < 1 || nq < 1 || kk < 1 || k < 1 ||
      c >= 0x7fffffffLL - 0xffff)   // int positions; any k
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const MergePlan p = plan_merge(s, nq, kk, k, sorted != 0);
  if (p.regime == 0) {
    const int threads = s >= kMaxThreads ? kMaxThreads : (s + 31) / 32 * 32;
    merge_step_kernel<<<nq, threads, 0, stream>>>(dists, ids, out_d, out_i,
                                                  s, nq, kk, k);
    return static_cast<int>(cudaGetLastError());
  }
  if (p.regime == 1) {
    if (p.smem > 32 * 1024) {             // + the static arrays: opt in
      const cudaError_t err = cudaFuncSetAttribute(
          merge_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)p.smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const bool vec = kk % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(dists) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(ids) & 15) == 0;
    merge_select_kernel<<<nq, p.threads, p.smem, stream>>>(
        dists, ids, out_d, out_i, s, nq, kk, k, vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* keys = static_cast<uint32_t*>(ws);
  void* sel = static_cast<char*>(ws) + p.keys_bytes;
  const int m = (int)c;
  for (int q0 = 0; q0 < nq; q0 += p.qc) {
    const int r = nq - q0 < p.qc ? nq - q0 : p.qc;
    const dim3 grid((m + 4 * kKeyThreads - 1) / (4 * kKeyThreads), r);
    merge_keys_kernel<<<grid, kKeyThreads, 0, stream>>>(
        dists, ids, keys, p.stride, nq, kk, m, q0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = run_select(keys, p.stride, r, m, k, sel,
                     EmitMerge{ids, out_d, out_i, nq, kk, k, q0}, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
