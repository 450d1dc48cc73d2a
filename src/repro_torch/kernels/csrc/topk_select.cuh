// The k > 128 top-k: one sortable 32-bit key per (query, position), then
// a select of each row's k smallest keys, ties to the lowest position.
// masked_topk.cu (`masked_topk` for k > 128 and `masked_topk_blocks` for
// k > 128) and fused_live.cu (`fused_live` for k > 128) share it.
//
// Keys. masked_keys_kernel scans with the tile scan of tile_scan.cuh (so
// a key's score is bit-identical to the split and fused-live kernels')
// and writes sortable_key(score) for a passing pair whose score is below
// PAD_SCORE, kNoKey for every other pair. Unsigned key order is the IEEE
// total order of the scores (-0.0 before +0.0), and the select keeps the
// key's bits, so a distance comes back as it went in.
//
// What bounds the select: bytes, the [R, M] keys (4 bytes each, 256 MB
// for 64 queries over 1M rows). The design, for Hopper:
//   * A radix select on the 8-bit digits from the top, for rows of any
//     length (the 1,024-key segments of `masked_topk_blocks` too: a
//     whole-row sort of them, one block a row, was slower on the card),
//     over a grid of (row, range of positions) with enough blocks to fill
//     the card (2,048 in all, each range at least kMinSpan keys). Each block
//     reads its range 16 bytes a thread, counts the keys that share the
//     digits picked so far in a shared histogram (the lanes of a warp
//     that hit one bin add once, through their leader), and adds it to
//     the row's global histogram. The last block of a row to finish (an
//     atomic ticket) picks the next digit: the bin that holds the k-th
//     key. A pass ends the select early when that bin's keys are all
//     taken, or when the row has at most k qualifying keys.
//   * The collect, in the same blocks: every key below the picked prefix
//     is taken (an atomic slot, in any order: the sort orders them).
//     Keys equal to the final 32-bit key T are taken in position order:
//     the last histogram pass keeps each block's count of them, so a
//     block knows how many lie before its range (blocks own contiguous
//     ranges) and ranks its own with a block-wide scan. This is the rule
//     `_fold_topk` gives: ties to the lowest position.
//   * The final sort of the <= n2 survivors, one block a row: a bitonic
//     sort of (key << 32 | position) in shared memory up to kSortSmem
//     values, in the row's global scratch above, so any k is taken. An
//     `Emit` functor maps (row, slot, key, position) to the caller's
//     output layout and ids.
#pragma once

#include "tile_scan.cuh"

namespace repro_torch {
namespace {

constexpr uint32_t kNoKey = 0xffffffffu;   // a pair that does not qualify
constexpr int kSelThreads = 256;            // histogram and collect blocks
constexpr int kSelTile = kSelThreads * 4;   // keys a block reads a step
constexpr int kSortSmem = 16384;            // survivors sorted in shared
constexpr int kSelBlocks = 2048;            // histogram blocks to aim for
constexpr int kMinSpan = 8192;              // keys a histogram block reads

// Unsigned key whose order is the float order of s (never kNoKey for a
// score below PAD_SCORE), and its inverse.
__device__ __forceinline__ uint32_t sortable_key(float s) {
  const uint32_t b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float sortable_float(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// keys[(q0 + qloc) * stride + offset + p]: the key of each (query, scan
// position) pair of this block's queries and its run of positions. The
// scan is the split kernel's, tile for tile.
template <int PRED, typename T, typename Rows>
__global__ void __launch_bounds__(kThreads, 2)
masked_keys_kernel(const T* __restrict__ q, const uint32_t* __restrict__ qbm,
                   const T* __restrict__ base,
                   const float* __restrict__ norms,
                   const uint32_t* __restrict__ bm, Rows rows,
                   uint32_t* __restrict__ keys, long long stride, int offset,
                   int nq, int n, int d, int w, int rows_per_split) {
  extern __shared__ __align__(16) float smem[];
  uint32_t* out = keys + (size_t)blockIdx.x * kQG * stride + offset;
  const long long row0 = (long long)blockIdx.y * rows_per_split;
  const int row1 = (int)min((long long)n, row0 + rows_per_split);
  scan_tiles<PRED>(
      smem, q, qbm, nq, base, norms, bm, d, w, row0, row1, rows,
      [&](int ql, int sub, bool live, int t0, int nr, const uint32_t* tm,
          const float* scq) {
        if (!live) return;
        uint32_t* o = out + (size_t)ql * stride + t0;
#pragma unroll
        for (int j = 0; j < kOwnRows; ++j) {
          const int r = sub + j * kLanesPerQ;
          if (r >= nr) continue;
          const bool pass = tm && ((tm[r] >> ql) & 1u);
          const float s = pass ? scq[r] : kPadScore;
          o[r] = s < kPadScore ? sortable_key(s) : kNoKey;
        }
      });
}

// Launch the key kernel over positions [0, n) for nq queries.
template <typename T, typename Rows>
cudaError_t launch_keys(int pred, const T* q, const uint32_t* qbm,
                        const T* base, const float* norms, const uint32_t* bm,
                        const Rows& rows, uint32_t* keys, long long stride,
                        int offset, int nq, int n, int d, int w,
                        int rows_per_split, cudaStream_t stream) {
  auto kernel = pred == 0   ? masked_keys_kernel<0, T, Rows>
                : pred == 1 ? masked_keys_kernel<1, T, Rows>
                            : masked_keys_kernel<2, T, Rows>;
  const size_t smem = scan_smem_bytes(d, w);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long splits = ((long long)n + rows_per_split - 1) / rows_per_split;
  if (splits > 65535) return cudaErrorInvalidValue;
  const dim3 grid((nq + kQG - 1) / kQG, (unsigned)splits);
  kernel<<<grid, kThreads, smem, stream>>>(q, qbm, base, norms, bm, rows, keys,
                                           stride, offset, nq, n, d, w,
                                           rows_per_split);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the select
// ---------------------------------------------------------------------------

// One row's select state; all zero before the first pass.
struct SelRow {
  unsigned int prefix;  // the digits picked so far
  unsigned int cum;     // qualifying keys below the picked prefix
  unsigned int need;    // keys still to take from the picked prefix
  unsigned int take;    // keys the row returns
  unsigned int done;    // 0 on; 1 the picked bin is taken whole; 2 every
                        // qualifying key is taken; 3 T is the whole key
  unsigned int shift;   // the lowest bit of the picked prefix
  unsigned int lt;      // collect: the next unordered slot
  unsigned int ticket;  // histogram blocks of this pass that are done
};

struct SelArgs {
  const uint32_t* keys;   // row r at keys + r * stride, positions [0, m)
  long long stride;
  int r, m, k, c, span, n2;
  bool aligned;           // 16-byte key loads
  SelRow* rows;           // [r]
  unsigned int* hist;     // [r][256]
  unsigned int* bhist;    // [r][c][256]: the last pass's block histograms
  unsigned long long* cand;   // [r][n2]
};

struct SelPlan {
  int c, span, n2;
  size_t rows_off, hist_off, bhist_off, cand_off, zero_bytes, bytes;
};

inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

inline size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

inline SelPlan plan_select(int r, int m, int k) {
  SelPlan p{};
  p.n2 = pow2_at_least(k < m ? k : m);
  long long c = (kSelBlocks + r - 1) / r;
  const long long cmax = ((long long)m + kMinSpan - 1) / kMinSpan;
  if (c > cmax) c = cmax;
  if (c < 1) c = 1;
  if (c > 65535) c = 65535;
  p.span = (int)((((long long)m + c - 1) / c + 3) & ~3LL);
  p.c = (int)(((long long)m + p.span - 1) / p.span);
  p.rows_off = 0;
  p.hist_off = align256((size_t)r * sizeof(SelRow));
  p.bhist_off = p.hist_off + align256((size_t)r * 256 * 4);
  p.zero_bytes = p.bhist_off;
  p.cand_off = p.bhist_off + align256((size_t)r * p.c * 256 * 4);
  p.bytes = p.cand_off + (size_t)r * p.n2 * 8;
  return p;
}

__device__ __forceinline__ uint4 load_keys4(const uint32_t* row, int p, int p1,
                                            bool aligned) {
  if (aligned && p + 3 < p1) return *reinterpret_cast<const uint4*>(row + p);
  uint4 v;
  v.x = p < p1 ? row[p] : kNoKey;
  v.y = p + 1 < p1 ? row[p + 1] : kNoKey;
  v.z = p + 2 < p1 ? row[p + 2] : kNoKey;
  v.w = p + 3 < p1 ? row[p + 3] : kNoKey;
  return v;
}

// Count `key` into the shared histogram h if it qualifies and carries the
// picked digits above `shift`; the lanes that hit one bin add once.
__device__ __forceinline__ void hist_add(unsigned int* h, uint32_t key,
                                         uint32_t prefix, int shift) {
  const int hi = shift + 8;
  const bool counted =
      key != kNoKey && (hi >= 32 || (key >> hi) == (prefix >> hi));
  const unsigned int bin = counted ? (key >> shift) & 0xffu : 256u;
  const unsigned int peers = __match_any_sync(kFullMask, bin);
  if (counted && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&h[bin], (unsigned int)__popc(peers));
}

// One pass of the radix select: grid (row, range). The last block of a
// row picks the digit at `shift`.
__global__ void __launch_bounds__(kSelThreads)
select_hist_kernel(SelArgs a, int shift) {
  __shared__ unsigned int h[256];
  __shared__ unsigned int wsum[kSelThreads / 32];
  __shared__ int last;
  const int r = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  SelRow* st = a.rows + r;
  if (st->done) return;                              // uniform
  const uint32_t prefix = st->prefix;
  h[tid] = 0;
  __syncthreads();
  const uint32_t* row = a.keys + (size_t)r * a.stride;
  const int p0 = c * a.span, p1 = min(a.m, p0 + a.span);
  for (int b0 = p0; b0 < p1; b0 += kSelTile) {
    const uint4 v = load_keys4(row, b0 + 4 * tid, p1, a.aligned);
    hist_add(h, v.x, prefix, shift);
    hist_add(h, v.y, prefix, shift);
    hist_add(h, v.z, prefix, shift);
    hist_add(h, v.w, prefix, shift);
  }
  __syncthreads();
  const unsigned int cnt_mine = h[tid];
  if (cnt_mine) atomicAdd(&a.hist[(size_t)r * 256 + tid], cnt_mine);
  if (shift == 0) a.bhist[((size_t)r * a.c + c) * 256 + tid] = cnt_mine;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&st->ticket, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the pick: inclusive scan of the row's 256 bin counts (`need` is read
  // before the barrier below, and written after it by one thread)
  const unsigned int need = shift == 24 ? (unsigned int)a.k : st->need;
  const unsigned int cnt = __ldcg(&a.hist[(size_t)r * 256 + tid]);
  unsigned int incl = cnt;
  const int lane = tid & 31, warp = tid >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned int o = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  unsigned int before = 0, total = 0;
  for (int x = 0; x < kSelThreads / 32; ++x) {
    before += x < warp ? wsum[x] : 0u;
    total += wsum[x];
  }
  incl += before;
  const unsigned int excl = incl - cnt;
  if (shift == 24 && total <= need) {
    if (tid == 0) {
      st->done = 2;
      st->take = total;
    }
  } else if (excl < need && incl >= need) {          // the bin of the k-th
    const unsigned int left = need - excl;
    st->prefix = prefix | ((uint32_t)tid << shift);
    st->cum += excl;
    st->need = left;
    st->take = a.k;
    st->shift = shift;
    if (cnt == left)
      st->done = 1;
    else if (shift == 0)
      st->done = 3;
  }
  a.hist[(size_t)r * 256 + tid] = 0;                 // for the next pass
  if (tid == 0) st->ticket = 0;
}

// The collect: grid (row, range), the ranges of the histogram passes.
__global__ void __launch_bounds__(kSelThreads)
select_collect_kernel(SelArgs a) {
  __shared__ unsigned int wsum[kSelThreads / 32];
  const int r = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  SelRow* st = a.rows + r;
  const unsigned int done = st->done, shift = st->shift;
  const uint32_t t = st->prefix;
  const unsigned int cum = st->cum, need = st->need;
  unsigned long long* cand = a.cand + (size_t)r * a.n2;
  const uint32_t* row = a.keys + (size_t)r * a.stride;
  const int p0 = c * a.span, p1 = min(a.m, p0 + a.span);
  const int lane = tid & 31, warp = tid >> 5;

  // keys equal to T in position order (done 3): how many lie before
  unsigned int before = 0, mine = 0;
  if (done == 3) {
    const size_t b0 = (size_t)r * a.c * 256 + (t & 0xffu);
    for (int x = 0; x < c; ++x) before += a.bhist[b0 + (size_t)x * 256];
    mine = a.bhist[b0 + (size_t)c * 256];
  }
  bool ordered = done == 3 && mine > 0 && before < need;   // uniform

  for (int b0 = p0; b0 < p1; b0 += kSelTile) {
    const int p = b0 + 4 * tid;
    const uint4 v = load_keys4(row, p, p1, a.aligned);
    const uint32_t ks[4] = {v.x, v.y, v.z, v.w};
    unsigned int eq = 0;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const uint32_t key = ks[x];
      if (key == kNoKey) continue;
      bool lt;
      if (done == 2)
        lt = true;
      else if (done == 1)
        lt = (key >> shift) <= (t >> shift);
      else
        lt = key < t;
      if (lt) {
        cand[atomicAdd(&st->lt, 1u)] =
            ((unsigned long long)key << 32) | (uint32_t)(p + x);
      } else if (done == 3 && key == t) {
        eq |= 1u << x;
      }
    }
    if (!ordered) continue;
    // rank this tile's equal keys: thread, then warp, then block order
    const unsigned int n = __popc(eq);
    unsigned int incl = n;
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned int o = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    unsigned int rank = before + incl - n, tile = 0;
    for (int x = 0; x < kSelThreads / 32; ++x) {
      rank += x < warp ? wsum[x] : 0u;
      tile += wsum[x];
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
      if ((eq >> x) & 1u) {
        if (rank < need)
          cand[cum + rank] = ((unsigned long long)t << 32) | (uint32_t)(p + x);
        ++rank;
      }
    before += tile;
    ordered = before < need;
    __syncthreads();                     // wsum is read before it is reused
  }
}

// The final sort, one block a row: the collected survivors as
// (key << 32 | position), in shared memory (`in_smem`) or in the row's
// scratch. emit(row, slot, valid, key, position) for the first k slots.
template <typename Emit>
__global__ void __launch_bounds__(1024)
select_sort_kernel(SelArgs a, bool in_smem, Emit emit) {
  extern __shared__ unsigned long long sv[];
  const int r = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int n2 = a.n2;
  unsigned long long* v = in_smem ? sv : a.cand + (size_t)r * n2;
  const unsigned int take = a.rows[r].take;
  const unsigned long long* src = a.cand + (size_t)r * n2;
  for (int i = tid; i < n2; i += nt)
    if ((unsigned int)i >= take)
      v[i] = ~0ull;
    else if (in_smem)
      v[i] = src[i];
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int x = tid; x < (n2 >> 1); x += nt) {
        const int lo = 2 * x - (x & (stride - 1)), hi = lo + stride;
        const unsigned long long p = v[lo], q = v[hi];
        if ((p > q) == ((lo & size) == 0)) {
          v[lo] = q;
          v[hi] = p;
        }
      }
      __syncthreads();
    }
  for (int j = tid; j < a.k; j += nt) {
    const unsigned long long x = j < n2 ? v[j] : ~0ull;
    const uint32_t key = (uint32_t)(x >> 32);
    emit(r, j, key != kNoKey, key, (int)(uint32_t)x);
  }
}

// The select of the k smallest keys of each of r rows of m keys (row i at
// keys + i * stride), into `emit`; ws holds plan_select(r, m, k).bytes.
template <typename Emit>
cudaError_t run_select(const uint32_t* keys, long long stride, int r, int m,
                       int k, void* ws, const Emit& emit,
                       cudaStream_t stream) {
  if (r < 1 || m < 1 || k < 1 || stride < m) return cudaErrorInvalidValue;
  const SelPlan p = plan_select(r, m, k);
  char* w = static_cast<char*>(ws);
  SelArgs a;
  a.keys = keys;
  a.stride = stride;
  a.r = r;
  a.m = m;
  a.k = k;
  a.c = p.c;
  a.span = p.span;
  a.n2 = p.n2;
  a.aligned = stride % 4 == 0 && (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  a.rows = reinterpret_cast<SelRow*>(w + p.rows_off);
  a.hist = reinterpret_cast<unsigned int*>(w + p.hist_off);
  a.bhist = reinterpret_cast<unsigned int*>(w + p.bhist_off);
  a.cand = reinterpret_cast<unsigned long long*>(w + p.cand_off);
  if (ws == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(ws, 0, p.zero_bytes, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(r, p.c);
  for (int shift = 24; shift >= 0; shift -= 8) {
    select_hist_kernel<<<grid, kSelThreads, 0, stream>>>(a, shift);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  select_collect_kernel<<<grid, kSelThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool in_smem = p.n2 <= kSortSmem;
  const size_t smem = in_smem ? (size_t)p.n2 * 8 : 0;
  auto kernel = select_sort_kernel<Emit>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int threads = p.n2 / 2;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  kernel<<<r, threads, smem, stream>>>(a, in_smem, emit);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch
