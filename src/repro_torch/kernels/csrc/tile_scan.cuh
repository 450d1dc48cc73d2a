// The tile scan that masked_topk.cu's split and key kernels and
// fused_live.cu's delta splits share: a block of kThreads threads holds
// kQG queries and walks a run of rows, evaluates every (query, row) pair
// on its packed label words, skips a tile no pair passes without reading
// its vectors, and scores each passing pair as ‖v‖² − 2·q·v with the dot
// in fp32 FMAs in ascending dimension order from 0 (no TF32, no tensor
// cores). One chain for all three kernels: a row's score is bit-identical
// whichever of them scans it, which the live read's fused and staged
// paths rely on.
//
// What bounds it: on unselective predicates the fp32 FMA units (2·D
// flops per passing pair); on selective ones the label words, the only
// bytes every row costs. The design, for Hopper:
//   * Label tiles of kLabelRows rows. Their words are copied with
//     cp.async into one of two buffers, the next tile's in flight while
//     this one is tested. Lane l of warp w tests row 32 w + l against the
//     block's kQG = 32 queries, word by word (the queries' words are
//     stored word-major, so a 16-byte load serves 4 queries to the whole
//     warp), and keeps a 32-bit mask of the queries that pass it. One
//     barrier pair a label tile, however few rows pass.
//   * Vector tiles of kTileRows rows inside a label tile. A vector tile
//     no pair passes is skipped (no vector read, no barrier). Otherwise
//     its rows are staged into shared memory in chunks of at most
//     kMaxChunk dimensions, so any D fits: cp.async, 16 bytes at a time
//     when D % 4 == 0 and the rows are 16-byte aligned, 4 bytes
//     otherwise; bf16 rows are loaded 16 bytes a lane and widened to fp32
//     (exact). With one chunk, the next passing vector tile's rows are
//     requested as soon as this tile's scores are out, so they load while
//     the owners take the scores.
//   * Register blocking. Thread (tq, tr) computes a kTQ x kTR micro-tile:
//     queries tq, tq + 8, tq + 16, tq + 24 and rows tr, tr + 32 of the
//     vector tile, 8 accumulators, from float4 loads of the queries and
//     rows (6 shared loads for 32 FMAs; the strides are 4 mod 8 floats, so
//     the loads of a warp hit distinct banks). A warp none of whose
//     micro-tiles holds a passing pair skips the FMAs.
//   * The scores go to a shared [kQG][kTileRows] tile; the kLanesPerQ = 8
//     lanes that own a query (qloc = tid / kLanesPerQ, rows sub, sub + 8,
//     ... of the tile) then take its passing pairs from there through the
//     kernel's own() callback, so the sinks (a key store, a top-k list in
//     shared memory) do not depend on the micro-tile mapping.
// What it leaves: the FMA loop runs near half of the card's fp32 rate,
// and a block waits on its rows where the next passing tile lies in the
// next label tile; see PERF.md.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kThreads = 256;
constexpr int kQG = 32;                           // queries per block
constexpr int kLanesPerQ = kThreads / kQG;        // threads per query's list
constexpr int kTileRows = 64;                     // rows per vector tile
constexpr int kLabelRows = 256;                   // rows per label tile
constexpr int kTQ = 4, kTR = 2;                   // a thread's micro-tile
constexpr int kQGroups = kQG / kTQ;               // 8 threads across queries
constexpr int kRGroups = kTileRows / kTR;         // 32 threads across rows
constexpr int kOwnRows = kTileRows / kLanesPerQ;  // rows an owner takes a tile
constexpr int kScoreStride = kTileRows + 8;       // owners read distinct banks
constexpr int kMaxChunk = 256;                    // dimensions staged at once
constexpr size_t kMaxSmem = 232448;               // 227 KB opt-in limit

static_assert(kQGroups * kRGroups == kThreads, "one micro-tile a thread");
static_assert(kLabelRows == kThreads, "one label row a thread");
static_assert(kQG == 32 && kLanesPerQ == 8, "one mask bit a query");
static_assert(kLabelRows == 8 * 32, "a warp tests 32 rows of a label tile");
static_assert(kTileRows == 64, "two warps' rows make a vector tile");

// How the dimensions are staged: nch chunks of dch (a multiple of 4)
// floats, each at a row stride cs = 4 mod 8 floats (16-byte aligned, and
// eight consecutive rows or queries start in distinct bank quads).
struct DimPlan {
  int nch, dch, cs;
};

__host__ __device__ inline DimPlan dim_plan(int d) {
  const int nch = (d + kMaxChunk - 1) / kMaxChunk;
  const int dch = ((d + nch - 1) / nch + 3) & ~3;
  return {nch, dch, dch % 8 == 0 ? dch + 4 : dch};
}

// Dynamic shared memory of a scanning block at (d, w): kQG queries and
// kTileRows rows of a dimension chunk, the rows' norms, the score tile,
// the queries' label words, two label tiles of words and source rows,
// and the label tile's pass masks.
__host__ __device__ inline size_t scan_smem_bytes(int d, int w) {
  const DimPlan p = dim_plan(d);
  return sizeof(float) *
         ((size_t)(kQG + kTileRows) * p.cs + kTileRows +
          (size_t)kQG * kScoreStride + (size_t)kQG * w +
          2 * (size_t)kLabelRows * w + kLabelRows + 8 + 2 * kLabelRows);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Row sources. Scan position p reads row p of the arrays.
struct DirectRows {
  static constexpr bool kGather = false;
};

// The tombstone bit of global row `id` in the packed little-endian words
// tomb [tw]: bit id & 31 of word id >> 5, the id clipped into range.
__device__ __forceinline__ bool tombstoned(const uint32_t* __restrict__ tomb,
                                           int tw, int id) {
  const long long last = (long long)tw * 32 - 1;
  const long long safe = id < 0 ? 0 : (id > last ? last : id);
  return (tomb[safe >> 5] >> (safe & 31)) & 1u;
}

// The live delta: scan position p reads row sel[p] (row p when sel is
// null); a -1 pad or a row whose global id base_n + row is tombstoned is
// no row, and passes no query.
struct LiveRows {
  static constexpr bool kGather = true;
  const int* sel;
  const uint32_t* tomb;
  int tw, base_n;
  __device__ __forceinline__ int operator()(int p) const {
    const int row = sel ? sel[p] : p;
    return (row < 0 || tombstoned(tomb, tw, base_n + row)) ? -1 : row;
  }
};

// Scan positions [p0, p1) of the rows base [., d], norms [.], bm [., w]
// (through `rows`) for the queries q0 = blockIdx.x * kQG .. of q [nq, d],
// qbm [nq, w]. After each vector tile every thread of the block calls
//   own(qloc, sub, live, t0, nr, tm, scq)
// for its list: query qloc = tid / kLanesPerQ (live when qloc is below
// the block's query count), the tile's rows sub, sub + kLanesPerQ, ...
// below nr (positions t0 + r), tm[r] bit qloc set where the pair passes
// (tm null: no pair of the tile passes) and scq[r] its score. Every
// thread of the block must call it (it holds barriers, and `own` may use
// warp-wide operations); `smem` is 16-byte aligned.
template <int PRED, typename T, typename Rows, typename Own>
__device__ __forceinline__ void scan_tiles(
    float* smem, const T* __restrict__ q, const uint32_t* __restrict__ qbm,
    int nq, const T* __restrict__ base, const float* __restrict__ norms,
    const uint32_t* __restrict__ bm, int d, int w, long long p0, int p1,
    const Rows& rows, Own own) {
  const DimPlan dp = dim_plan(d);
  const int cs = dp.cs;
  float* qs = smem;                                   // [kQG][cs]
  float* rs = qs + kQG * cs;                          // [kTileRows][cs]
  float* rn = rs + kTileRows * cs;                    // [kTileRows]
  float* sc = rn + kTileRows;                         // [kQG][kScoreStride]
  uint32_t* qb = reinterpret_cast<uint32_t*>(sc + kQG * kScoreStride);
  uint32_t* rb = qb + kQG * w;                        // [2][kLabelRows][w]
  uint32_t* rmask = rb + 2 * kLabelRows * w;          // [kLabelRows]
  uint32_t* wany = rmask + kLabelRows;                // [8]
  int* rrow = reinterpret_cast<int*>(wany + 8);       // [2][kLabelRows]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kQG;
  const int nqb = min(kQG, nq - q0);
  if (p0 >= p1) return;                               // uniform
  // the queries' label words, word-major: qb[i * kQG + query]
  for (int i = tid; i < kQG * w; i += kThreads) {
    const int c = i / kQG, r = i - c * kQG;
    qb[i] = r < nqb ? qbm[(size_t)(q0 + r) * w + c] : 0u;
  }
  const uint32_t live_q = nqb >= 32 ? kFullMask : (1u << nqb) - 1u;
  const int tq = tid % kQGroups, tr = tid / kQGroups;   // micro-tile
  const uint32_t my_q = 0x01010101u << tq;              // its query bits
  const int qloc = tid / kLanesPerQ, sub = tid % kLanesPerQ;   // owner
  const bool live = qloc < nqb;
  // 16-byte row copies: 4 floats or 8 bf16 values at a time
  const bool vec16 =
      d % (16 / (int)sizeof(T)) == 0 && dp.dch % (16 / (int)sizeof(T)) == 0 &&
      (reinterpret_cast<uintptr_t>(base) & 15) == 0;
  bool q_ready = false;

  // the label words of positions [s0, s0 + kLabelRows) into buffer buf
  auto stage_labels = [&](int s0, int buf) {
    const int ns = min(kLabelRows, p1 - s0);
    uint32_t* dst = rb + buf * kLabelRows * w;
    if constexpr (Rows::kGather) {
      const int row = tid < ns ? rows(s0 + tid) : -1;
      rrow[buf * kLabelRows + tid] = row;
      if (row >= 0)
        for (int c = 0; c < w; ++c)
          cp_async4(dst + tid * w + c, bm + (size_t)row * w + c);
    } else {
      const uint32_t* src = bm + (size_t)s0 * w;
      for (int i = tid; i < ns * w; i += kThreads) cp_async4(dst + i, src + i);
    }
    cp_async_commit();
  };

  // queries' dimensions [c0, c0 + len) (zero past len and for dead ones)
  auto stage_queries = [&](int c0, int len) {
    const int len4 = (len + 3) & ~3;
    for (int r = warp; r < kQG; r += kThreads / 32)
      for (int c = lane; c < len4; c += 32)
        qs[r * cs + c] = (r < nqb && c < len)
                             ? to_f32(q[(size_t)(q0 + r) * d + c0 + c])
                             : 0.f;
  };

  // rows t0 .. t0 + nr of a vector tile, dimensions [c0, c0 + len) (and
  // their norms with `with_norms`), a warp a row; lrow holds the tile's
  // source rows when gathering
  auto stage_rows = [&](int t0, int nr, int c0, int len, const int* lrow,
                        bool with_norms) {
    const int len4 = (len + 3) & ~3;
    if (with_norms)
      for (int i = tid; i < nr; i += kThreads) {
        int row = t0 + i;
        if constexpr (Rows::kGather) row = lrow[i];
        if (row >= 0)
          cp_async4(rn + i, norms + row);
        else
          rn[i] = kPadScore;
      }
    if constexpr (sizeof(T) == 2) {
      if (vec16) {        // bf16: 8 values a lane, every row's load first
        constexpr int kPer = kTileRows / (kThreads / 32);
        for (int c = 8 * lane; c < len; c += 256) {
          uint4 raw[kPer];
#pragma unroll
          for (int m = 0; m < kPer; ++m) {
            const int r = warp + m * (kThreads / 32);
            int row = t0 + r;
            if constexpr (Rows::kGather) row = r < nr ? lrow[r] : -1;
            raw[m] = (r < nr && row >= 0)
                         ? *reinterpret_cast<const uint4*>(
                               base + (size_t)row * d + c0 + c)
                         : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int m = 0; m < kPer; ++m) {
            const int r = warp + m * (kThreads / 32);
            if (r >= nr) continue;
            float4* dst = reinterpret_cast<float4*>(rs + r * cs + c);
            const uint4 x = raw[m];       // bf16 -> fp32 is exact: << 16
            dst[0] = make_float4(__uint_as_float(x.x << 16),
                                 __uint_as_float(x.x & 0xffff0000u),
                                 __uint_as_float(x.y << 16),
                                 __uint_as_float(x.y & 0xffff0000u));
            dst[1] = make_float4(__uint_as_float(x.z << 16),
                                 __uint_as_float(x.z & 0xffff0000u),
                                 __uint_as_float(x.w << 16),
                                 __uint_as_float(x.w & 0xffff0000u));
          }
        }
        cp_async_commit();
        return;
      }
    }
    for (int r = warp; r < nr; r += kThreads / 32) {
      int row = t0 + r;
      if constexpr (Rows::kGather) row = lrow[r];
      float* dst = rs + r * cs;
      if (sizeof(T) == 4 && vec16) {   // float rows, len % 4 == 0
        for (int c = 4 * lane; c < len; c += 128) {
          if (row >= 0)
            cp_async16(dst + c, reinterpret_cast<const float*>(base) +
                                    (size_t)row * d + c0 + c);
          else
            *reinterpret_cast<float4*>(dst + c) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int c = lane; c < len4; c += 32) {
          if (row >= 0 && c < len) {
            const T* src = base + (size_t)row * d + c0 + c;
            if constexpr (sizeof(T) == 4)
              cp_async4(dst + c, src);
            else
              dst[c] = to_f32(*src);
          } else {
            dst[c] = 0.f;
          }
        }
      }
    }
    cp_async_commit();
  };

  stage_labels((int)p0, 0);
  int buf = 0;
  for (int s0 = (int)p0; s0 < p1; s0 += kLabelRows, buf ^= 1) {
    const int ns = min(kLabelRows, p1 - s0);
    cp_async_wait_all();
    __syncthreads();      // this tile's words are in; the last one is done
    if (s0 + kLabelRows < p1) stage_labels(s0 + kLabelRows, buf ^ 1);
    const uint32_t* lw = rb + buf * kLabelRows * w;
    const int* lrow = rrow + buf * kLabelRows;

    // the label test: warp w, rows [32 w, 32 w + 32), a row a lane; its
    // mask gets bit j where query j passes, word by word over the queries
    {
      const int r = warp * 32 + lane;
      bool ok = r < ns;
      if constexpr (Rows::kGather) ok = ok && lrow[r] >= 0;
      uint32_t m = 0;
      if (ok) {
        const uint32_t* rw = lw + r * w;
        m = PRED == 2 ? 0u : live_q;
        for (int i = 0; i < w; ++i) {
          const uint32_t x = rw[i];
          const uint4* qw = reinterpret_cast<const uint4*>(qb + i * kQG);
          uint32_t bits = 0;
#pragma unroll
          for (int j = 0; j < kQG / 4; ++j) {
            const uint4 v = qw[j];
            if (PRED == 0) {
              bits |= (uint32_t)(x == v.x) << (4 * j) |
                      (uint32_t)(x == v.y) << (4 * j + 1) |
                      (uint32_t)(x == v.z) << (4 * j + 2) |
                      (uint32_t)(x == v.w) << (4 * j + 3);
            } else if (PRED == 1) {
              bits |= (uint32_t)((x & v.x) == v.x) << (4 * j) |
                      (uint32_t)((x & v.y) == v.y) << (4 * j + 1) |
                      (uint32_t)((x & v.z) == v.z) << (4 * j + 2) |
                      (uint32_t)((x & v.w) == v.w) << (4 * j + 3);
            } else {
              bits |= (uint32_t)((x & v.x) != 0) << (4 * j) |
                      (uint32_t)((x & v.y) != 0) << (4 * j + 1) |
                      (uint32_t)((x & v.z) != 0) << (4 * j + 2) |
                      (uint32_t)((x & v.w) != 0) << (4 * j + 3);
            }
          }
          if (PRED == 2) {
            m |= bits;
            if (m == live_q) break;
          } else {
            m &= bits;
            if (m == 0) break;
          }
        }
        m &= live_q;
      }
      rmask[r] = m;
      const uint32_t any = __reduce_or_sync(kFullMask, m);
      if (lane == 0) wany[warp] = any;
    }
    __syncthreads();      // the masks are in

    int pre = -1;         // the vector tile whose rows are already staged
    for (int v = 0; v < kLabelRows / kTileRows; ++v) {
      const int t0 = s0 + v * kTileRows;
      if (t0 >= p1) break;
      const int nr = min(kTileRows, p1 - t0);
      const uint32_t* tm = rmask + v * kTileRows;
      if ((wany[2 * v] | wany[2 * v + 1]) == 0) {    // no pair passes
        own(qloc, sub, live, t0, nr, nullptr, nullptr);
        continue;
      }
      const bool work =
          __any_sync(kFullMask, ((tm[tr] | tm[tr + kRGroups]) & my_q) != 0);
      float acc[kTQ][kTR];
#pragma unroll
      for (int i = 0; i < kTQ; ++i)
#pragma unroll
        for (int j = 0; j < kTR; ++j) acc[i][j] = 0.f;
      for (int ch = 0; ch < dp.nch; ++ch) {
        const int c0 = ch * dp.dch, len = min(dp.dch, d - c0);
        if (ch > 0) __syncthreads();           // the last chunk is consumed
        if (dp.nch > 1 || !q_ready) stage_queries(c0, len);
        if (ch > 0 || pre != v)
          stage_rows(t0, nr, c0, len, lrow + v * kTileRows, ch == 0);
        cp_async_wait_all();
        __syncthreads();                       // the chunk is in
        if (work) {
          const float4* qv = reinterpret_cast<const float4*>(qs);
          const float4* rv = reinterpret_cast<const float4*>(rs);
          const int cs4 = cs >> 2, n4 = (len + 3) >> 2;
#pragma unroll 2
          for (int c4 = 0; c4 < n4; ++c4) {
            float4 a[kTQ], b[kTR];
#pragma unroll
            for (int i = 0; i < kTQ; ++i)
              a[i] = qv[(tq + kQGroups * i) * cs4 + c4];
#pragma unroll
            for (int j = 0; j < kTR; ++j)
              b[j] = rv[(tr + kRGroups * j) * cs4 + c4];
#pragma unroll
            for (int i = 0; i < kTQ; ++i)
#pragma unroll
              for (int j = 0; j < kTR; ++j) {
                float s = acc[i][j];
                s = fmaf(a[i].x, b[j].x, s);
                s = fmaf(a[i].y, b[j].y, s);
                s = fmaf(a[i].z, b[j].z, s);
                s = fmaf(a[i].w, b[j].w, s);
                acc[i][j] = s;
              }
          }
        }
      }
      q_ready = true;
      if (work)
#pragma unroll
        for (int i = 0; i < kTQ; ++i)
#pragma unroll
          for (int j = 0; j < kTR; ++j) {
            const int r = tr + kRGroups * j;
            sc[(tq + kQGroups * i) * kScoreStride + r] =
                rn[r] - 2.0f * acc[i][j];
          }
      __syncthreads();                 // the scores are in; rs and rn free
      // the next vector tile of this label tile that some pair passes:
      // its rows load while the owners take this one's scores
      pre = -1;
      if (dp.nch == 1)
        for (int u = v + 1; u < kLabelRows / kTileRows; ++u) {
          const int u0 = s0 + u * kTileRows;
          if (u0 >= p1) break;
          if ((wany[2 * u] | wany[2 * u + 1]) != 0) {
            stage_rows(u0, min(kTileRows, p1 - u0), 0, d,
                       lrow + u * kTileRows, true);
            pre = u;
            break;
          }
        }
      own(qloc, sub, live, t0, nr, tm, sc + qloc * kScoreStride);
    }
  }
}

// Insert pairs into the top-k lists in shared memory (lk, lp [k] each,
// ascending in pair_less order) of the warp's queries, each list kept by
// its query's kLanesPerQ lanes, an aligned lane group. Lane bit j of cm
// offers (kv[j], pv[j]) to its group's list; `none` is a key after every
// real one. In each round every group inserts its smallest offered pair
// (an argmin over its lanes): all 8 lanes count the entries before it,
// the entries after its slot move up one, 8 at a time from the top, and
// the offers that no longer come before the list's last entry are
// dropped. So a tile costs at most k rounds, a group needs no lock and an
// insert no serial shift. Every lane of the warp must call it.
template <int N, typename K>
__device__ __forceinline__ void group_insert(K* lk, int* lp, int k, int sub,
                                             unsigned int cm, const K* kv,
                                             const int* pv, K none) {
  const int nblk = (k + kLanesPerQ - 1) / kLanesPerQ;
  while (__any_sync(kFullMask, cm != 0)) {
    K ck = none;
    int cp = kEmptyId;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (((cm >> j) & 1u) && pair_less(kv[j], pv[j], ck, cp)) {
        ck = kv[j];
        cp = pv[j];
      }
    const int mine = cp;
    lanes_argmin<kLanesPerQ>(ck, cp);           // the group's smallest
    const bool has = cp != kEmptyId;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (mine == cp && pv[j] == cp) cm &= ~(1u << j);
    int slot = 0;
    if (has)
      for (int e = sub; e < k; e += kLanesPerQ)
        slot += pair_less(lk[e], lp[e], ck, cp) ? 1 : 0;
    for (int off = kLanesPerQ / 2; off > 0; off >>= 1)
      slot += __shfl_xor_sync(kFullMask, slot, off);
    for (int b = nblk - 1; b >= 0; --b) {
      const int e = b * kLanesPerQ + sub;
      const bool mv = has && e >= slot && e < k - 1;
      K tk = ck;
      int tp = cp;
      if (mv) {
        tk = lk[e];
        tp = lp[e];
      }
      __syncwarp();
      if (mv) {
        lk[e + 1] = tk;
        lp[e + 1] = tp;
      }
    }
    if (has && slot < k && sub == slot % kLanesPerQ) {
      lk[slot] = ck;
      lp[slot] = cp;
    }
    __syncwarp();
    if (cm) {                                   // drop what no longer fits
      const K tk = lk[k - 1];
      const int tp = lp[k - 1];
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (!pair_less(kv[j], pv[j], tk, tp)) cm &= ~(1u << j);
    }
  }
}

// A lane's offer of its passing pairs of a vector tile (own()'s
// arguments) to its query's list: key(s, out) gives a score's key and
// whether it qualifies, pos(r) its position, `none` is a key after every
// real one; pairs that do not come
// before the list's last entry are dropped at once, the rest go to
// group_insert. Every lane of the warp must call it.
template <typename K, typename Key, typename Pos>
__device__ __forceinline__ void offer_tile(K* lk, int* lp, int k, int qloc,
                                           int sub, bool live, int nr,
                                           const uint32_t* tm,
                                           const float* scq, K none, Key key,
                                           Pos pos) {
  K kv[kOwnRows];
  int pv[kOwnRows];
  unsigned int cm = 0;
  if (live && tm) {
    const K tk = lk[k - 1];
    const int tp = lp[k - 1];
#pragma unroll
    for (int j = 0; j < kOwnRows; ++j) {
      const int r = sub + j * kLanesPerQ;
      bool ok = r < nr && ((tm[r] >> qloc) & 1u);
      kv[j] = tk;
      pv[j] = tp;
      if (ok) {
        ok = key(scq[r], kv[j]);
        pv[j] = pos(r);
        ok = ok && pair_less(kv[j], pv[j], tk, tp);
      }
      cm |= (unsigned int)ok << j;
    }
  }
  if (!__any_sync(kFullMask, cm != 0)) return;
  group_insert<kOwnRows>(lk, lp, k, sub, cm, kv, pv, none);
}

}  // namespace repro_torch
