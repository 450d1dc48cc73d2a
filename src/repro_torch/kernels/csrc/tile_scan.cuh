// The tile scan that masked_topk.cu's split and key kernels and
// fused_live.cu's delta splits share: a block of kThreads threads holds
// kQG queries and walks a run of rows in tiles of kTileRows, evaluates
// every (query, row) pair of a tile on its packed label words, skips a
// tile no pair passes without reading its vectors, and scores each
// passing pair as ‖v‖² − 2·q·v with the dot in fp32 FMAs in ascending
// dimension order from 0 (no TF32, no tensor cores). One chain for all
// three kernels: a row's score is bit-identical whichever of them scans
// it, which the live read's fused and staged paths rely on.
//
// Each thread owns one query (qloc = tid / kLanesPerQ) and the rows sub,
// sub + kLanesPerQ, ... of each tile. Row and query stride in shared
// memory is odd, so the kLanesPerQ threads of a query read distinct
// banks.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kThreads = 256;
constexpr int kQG = 16;                           // queries per block
constexpr int kLanesPerQ = kThreads / kQG;        // threads per query: 16
constexpr int kTileRows = 32;                     // rows per tile
constexpr int kRowsPerThread = kTileRows / kLanesPerQ;
constexpr size_t kMaxSmem = 232448;               // 227 KB opt-in limit

static_assert(kLanesPerQ == 16, "the per-query shuffle tree spans 16 lanes");

__host__ __device__ inline int padded_stride(int d) { return d | 1; }

// Dynamic shared memory of a scanning block at (d, w): kQG queries and
// kTileRows rows of d floats, the rows' norms, label words and source
// rows.
inline size_t scan_smem_bytes(int d, int w) {
  return sizeof(float) * ((size_t)(kQG + kTileRows) * padded_stride(d) +
                          kTileRows) +
         sizeof(uint32_t) * (size_t)(kQG + kTileRows) * w +
         sizeof(int) * kTileRows;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
// qbm [nq, w]. Calls take(qloc, p, s) for each passing pair of this
// thread with its score s, and drop(qloc, p) for each other pair of a
// live query (qloc < the block's query count) and a position in range.
// Every thread of the block must call it (it holds barriers).
template <int PRED, typename T, typename Rows, typename Take, typename Drop>
__device__ __forceinline__ void scan_tiles(
    float* smem, const T* __restrict__ q, const uint32_t* __restrict__ qbm,
    int nq, const T* __restrict__ base, const float* __restrict__ norms,
    const uint32_t* __restrict__ bm, int d, int w, long long p0, int p1,
    const Rows& rows, Take take, Drop drop) {
  const int ds = padded_stride(d);
  float* qs = smem;                               // [kQG][ds] queries
  float* rs = qs + kQG * ds;                      // [kTileRows][ds] rows
  float* rn = rs + kTileRows * ds;                // [kTileRows] norms
  uint32_t* qb = reinterpret_cast<uint32_t*>(rn + kTileRows);  // [kQG][w]
  uint32_t* rb = qb + kQG * w;                    // [kTileRows][w]
  int* rrow = reinterpret_cast<int*>(rb + kTileRows * w);  // [kTileRows]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kQG;
  const int nqb = min(kQG, nq - q0);
  for (int r = warp; r < kQG; r += kThreads / 32)
    for (int c = lane; c < d; c += 32)
      qs[r * ds + c] = r < nqb ? to_f32(q[(size_t)(q0 + r) * d + c]) : 0.f;
  for (int i = tid; i < kQG * w; i += kThreads)
    qb[i] = i < nqb * w ? qbm[(size_t)q0 * w + i] : 0u;

  const int qloc = tid / kLanesPerQ, sub = tid % kLanesPerQ;
  const bool live = qloc < nqb;
  for (int t0 = (int)p0; t0 < p1; t0 += kTileRows) {
    const int nr = min(kTileRows, p1 - t0);
    __syncthreads();                  // the previous tile is consumed
    if constexpr (Rows::kGather) {
      for (int i = tid; i < nr; i += kThreads) rrow[i] = rows(t0 + i);
      __syncthreads();
      for (int i = tid; i < nr * w; i += kThreads) {
        const int row = rrow[i / w];
        rb[i] = row >= 0 ? bm[(size_t)row * w + i % w] : 0u;
      }
    } else {
      for (int i = tid; i < nr * w; i += kThreads)
        rb[i] = bm[(size_t)t0 * w + i];
    }
    __syncthreads();
    bool pass[kRowsPerThread];
    bool any = false;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = sub + j * kLanesPerQ;
      bool ok = live && r < nr;
      if constexpr (Rows::kGather) ok = ok && rrow[r] >= 0;
      pass[j] = ok && row_passes<PRED>(rb + r * w, qb + qloc * w, w);
      any |= pass[j];
    }
    if (!__syncthreads_or(any)) {     // no pair passes: no row is read
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int r = sub + j * kLanesPerQ;
        if (live && r < nr) drop(qloc, t0 + r);
      }
      continue;
    }
    for (int r = warp; r < nr; r += kThreads / 32) {
      if constexpr (Rows::kGather) {
        const int row = rrow[r];
        for (int c = lane; c < d; c += 32)
          rs[r * ds + c] = row >= 0 ? to_f32(base[(size_t)row * d + c]) : 0.f;
      } else {
        for (int c = lane; c < d; c += 32)
          rs[r * ds + c] = to_f32(base[(size_t)(t0 + r) * d + c]);
      }
    }
    for (int i = tid; i < nr; i += kThreads) {
      if constexpr (Rows::kGather)
        rn[i] = rrow[i] >= 0 ? norms[rrow[i]] : kPadScore;
      else
        rn[i] = norms[t0 + i];
    }
    __syncthreads();
    bool mine = false;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) mine |= pass[j];
    float acc[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0.f;
    if (mine) {
      const float* qv = qs + qloc * ds;
      for (int c = 0; c < d; ++c) {
        const float qc = qv[c];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j)
          acc[j] = fmaf(qc, rs[(sub + j * kLanesPerQ) * ds + c], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = sub + j * kLanesPerQ;
      if (!live || r >= nr) continue;
      if (pass[j])
        take(qloc, t0 + r, rn[r] - 2.0f * acc[j]);
      else
        drop(qloc, t0 + r);
    }
  }
}

}  // namespace repro_torch
