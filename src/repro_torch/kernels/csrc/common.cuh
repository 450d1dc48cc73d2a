// Shared device helpers for the port's kernels: predicate evaluation on
// packed uint32 label words, the (key, id) order of the top-k lists, and
// argmins over (score, id) pairs within a lane group or a block.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kEmptyId = 0x7fffffff;   // id of an empty top-k slot
constexpr float kPadScore = 3.0e38f;   // masked_topk's sentinel score

// Integer key whose order is the IEEE total order of the float (-0.0
// before +0.0), the order jax.lax.top_k ranks by, and its inverse.
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float key_float(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

// (score, id) lexicographic order: ties go to the lower row id, the
// order `_fold_topk` of the TPU kernel produces. Also used on (key,
// position) pairs with integer keys.
template <typename K>
__device__ __forceinline__ bool pair_less(K a, int ia, K b, int ib) {
  return a < b || (a == b && ia < ib);
}

// Argmin in `pair_less` order over WIDTH consecutive lanes (an aligned
// group of a warp: xor offsets below WIDTH stay inside it); every lane
// of the group gets the winner.
template <int WIDTH, typename K>
__device__ __forceinline__ void lanes_argmin(K& s, int& id) {
  for (int off = WIDTH / 2; off > 0; off >>= 1) {
    const K os = __shfl_xor_sync(kFullMask, s, off);
    const int oi = __shfl_xor_sync(kFullMask, id, off);
    if (pair_less(os, oi, s, id)) { s = os; id = oi; }
  }
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

// Block-wide argmin in `pair_less` order of one (s, id) pair per thread;
// every thread gets the winner back. `red_s`/`red_i` hold one slot per
// warp; `empty` is a key after every real one. blockDim.x must be a
// multiple of 32. The order is a total order on distinct ids, so the
// result does not depend on the reduction tree.
template <typename K>
__device__ __forceinline__ void block_argmin(K& s, int& id, K* red_s,
                                             int* red_i, K empty) {
  lanes_argmin<32>(s, id);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { red_s[warp] = s; red_i[warp] = id; }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    s = lane < nw ? red_s[lane] : empty;
    id = lane < nw ? red_i[lane] : kEmptyId;
    lanes_argmin<32>(s, id);
    if (lane == 0) { red_s[0] = s; red_i[0] = id; }
  }
  __syncthreads();
  s = red_s[0];
  id = red_i[0];
  __syncthreads();   // the slots are reused by the next call
}

}  // namespace repro_torch
