"""The kernels' entry points: sentinel cleanup around the wrappers.

The CUDA kernels take any Q, N and S·K (they mask the ragged edge
themselves, and the merge kernel pads k > K itself), so unlike the TPU
wrappers nothing is padded to block multiples here and `selectivity`
needs no padded-row correction. What stays is the reference's output
rule (`src/repro/kernels/ops.py`): `PAD_SCORE` scores and −1 ids come
back as id −1 with distance +inf. Each wrapper takes its CUDA kernel for
CUDA tensors and its plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import bitmap_filter as bf
from repro_torch.kernels import masked_topk as mk


def _clean(ids, dists):
    bad = (ids < 0) | (dists >= mk.PAD_SCORE)
    return ids.masked_fill(bad, -1), dists.masked_fill(bad, math.inf)


def masked_topk(qvecs, qbms, base, norms, bitmaps, *, pred: int, k: int):
    """Fused filtered brute-force top-k. Returns (ids [Q, k] i32 with −1
    pads, dists [Q, k] f32 ranking scores with +inf pads)."""
    dists, ids = mk.masked_topk_accum(qvecs, qbms, base, norms, bitmaps,
                                      pred=pred, k=k)
    return _clean(ids, dists)


def masked_topk_multiblock(qvecs, qbms, base, norms, bitmaps, *,
                           pred: int, k: int, bn: int = mk.DEFAULT_BN):
    """The same top-k through the per-block kernel: [NB, Q, k] block
    lists, reduced block-major by `merge_topk` (the reference's stable
    top-k over the block-major flatten, the same fold). Returns what
    `masked_topk` returns."""
    dists, ids = mk.masked_topk_blocks(qvecs, qbms, base, norms, bitmaps,
                                       pred=pred, k=k, bn=bn)
    return merge_topk(ids, dists, k=k)


def merge_topk(ids, dists, *, k: int | None = None):
    """Cross-shard top-k merge. Returns (ids [Q, k] i32, dists [Q, k] f32).

    ids [S, Q, K] per-shard candidate ids, already global, −1 at invalid
    slots; dists [S, Q, K] scores (cast to float32), where +inf, NaN or
    any value >= `PAD_SCORE` marks a slot invalid. k defaults to K and
    may exceed it: the surplus comes back as −1 ids with +inf dists, as
    do all invalid outputs. Candidates rank by the IEEE total order of
    their distances (−0.0 before +0.0, as `jax.lax.top_k` ranks), ties to
    the earlier shard, then the earlier slot."""
    if k is None:
        k = ids.shape[-1]
    dists, ids = mk.merge_topk_accum(
        dists.to(torch.float32).contiguous(),
        ids.to(torch.int32).contiguous(), k=k)
    return _clean(ids, dists)


def selectivity(qbms, bitmaps, *, pred: int):
    """Per-query predicate match counts [Q] i32."""
    return bf.selectivity_count(qbms, bitmaps, pred=pred)
