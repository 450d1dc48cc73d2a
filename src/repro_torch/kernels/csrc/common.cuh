// Shared device helpers for the port's kernels: predicate evaluation on
// packed uint32 label words and a block-wide argmin over (score, id).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kEmptyId = 0x7fffffff;   // id of an empty top-k slot
constexpr float kPadScore = 3.0e38f;   // masked_topk's sentinel score

// (score, id) lexicographic order: ties go to the lower row id, the
// order `_fold_topk` of the TPU kernel produces.
__device__ __forceinline__ bool pair_less(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

// PRED 0 = EQUALITY, 1 = AND (containment), 2 = OR (overlap), evaluated
// word by word as in `_predicate_mask_block`.
template <int PRED>
__device__ __forceinline__ bool row_passes(const uint32_t* __restrict__ row,
                                           const uint32_t* qbm, int w) {
  if (PRED == 0) {
    for (int i = 0; i < w; ++i)
      if (row[i] != qbm[i]) return false;
    return true;
  } else if (PRED == 1) {
    for (int i = 0; i < w; ++i)
      if ((row[i] & qbm[i]) != qbm[i]) return false;
    return true;
  } else {
    for (int i = 0; i < w; ++i)
      if (row[i] & qbm[i]) return true;
    return false;
  }
}

// Block-wide argmin of one (s, id) pair per thread; every thread gets the
// winner back. `red_s`/`red_i` hold one slot per warp. blockDim.x must be
// a multiple of 32. The order is a total order on distinct ids, so the
// result does not depend on the reduction tree.
__device__ __forceinline__ void block_argmin(float& s, int& id, float* red_s,
                                             int* red_i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(kFullMask, s, off);
    const int oi = __shfl_xor_sync(kFullMask, id, off);
    if (pair_less(os, oi, s, id)) { s = os; id = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { red_s[warp] = s; red_i[warp] = id; }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    s = lane < nw ? red_s[lane] : INFINITY;
    id = lane < nw ? red_i[lane] : kEmptyId;
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(kFullMask, s, off);
      const int oi = __shfl_xor_sync(kFullMask, id, off);
      if (pair_less(os, oi, s, id)) { s = os; id = oi; }
    }
    if (lane == 0) { red_s[0] = s; red_i[0] = id; }
  }
  __syncthreads();
  s = red_s[0];
  id = red_i[0];
  __syncthreads();   // the slots are reused by the next call
}

}  // namespace repro_torch
