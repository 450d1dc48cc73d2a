"""The kernels' entry points: sentinel cleanup around the wrappers.

The CUDA kernels take any Q, N and S·K (they mask the ragged edge
themselves, and the merge kernel pads k > K itself), so unlike the TPU
wrappers nothing is padded to block multiples here and `selectivity`
needs no padded-row correction. What stays is the reference's output
rule (`src/repro/kernels/ops.py`): `PAD_SCORE` scores and −1 ids come
back as id −1 with distance +inf, and the fused live read's one dummy
base slot when there are no base candidates. Each wrapper takes its
CUDA kernel for CUDA tensors and its plain PyTorch version for CPU
tensors.
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


def _fused_live(qvecs, qbms, cand_ids, cand_dists, dvec, dnorms, dbm,
                base_n, tomb_words, sel, pred, k):
    """The reference wrapper's rules around `mk.fused_live_accum`: with no
    base candidates (KB = 0) the kernel gets one dummy slot; outputs map
    to −1 ids and +inf distances."""
    q = qvecs.shape[0]
    if cand_ids.shape[1] == 0:
        cand_ids = torch.full((q, 1), -1, dtype=torch.int32,
                              device=qvecs.device)
        cand_dists = torch.full((q, 1), mk.PAD_SCORE, dtype=torch.float32,
                                device=qvecs.device)
    dists, ids = mk.fused_live_accum(
        qvecs, qbms, cand_dists.to(torch.float32).contiguous(),
        cand_ids.to(torch.int32).contiguous(), dvec, dnorms, dbm,
        tomb_words, base_n=int(base_n), sel=sel, pred=pred, k=k)
    return _clean(ids, dists)


def fused_live_topk(qvecs, qbms, cand_ids, cand_dists, dvec, dnorms, dbm,
                    base_n, tomb_words, *, pred: int, k: int):
    """Fused live top-k: the routed base candidates folded with a full
    scan of the delta mirror, tombstones applied to both inside the
    kernel.

    cand_ids/cand_dists [Q, KB] routed base candidates (global ids, −1 /
    +inf at invalid slots; KB may be 0); dvec/dnorms/dbm the delta mirror
    (sentinel rows carry PAD_SCORE norms and never surface); delta row r
    has global id base_n + r; tomb_words [TW] int32 views of the packed
    little-endian tombstones over base and delta ids. A candidate with
    id < 0, a non-finite distance, a distance >= PAD_SCORE or a
    tombstoned id never surfaces. Returns (ids [Q, k] i32 with −1 pads,
    dists [Q, k] f32 with +inf pads); equal to the staged base →
    masked_topk → merge_topk path."""
    return _fused_live(qvecs, qbms, cand_ids, cand_dists, dvec, dnorms, dbm,
                       base_n, tomb_words, None, pred, k)


def fused_live_topk_select(qvecs, qbms, cand_ids, cand_dists, dvec, dnorms,
                           dbm, sel, base_n, tomb_words, *, pred: int,
                           k: int):
    """`fused_live_topk` over the delta rows `sel` [NS] int32 picks
    (delta-local rows in scan order, −1 pads: id −1, never surfaces), as
    the chunk pruner chooses them; the kernel gathers the rows itself.
    Equal to `fused_live_topk` whenever the pruner's bound holds."""
    return _fused_live(qvecs, qbms, cand_ids, cand_dists, dvec, dnorms, dbm,
                       base_n, tomb_words, sel.to(torch.int32).contiguous(),
                       pred, k)


def selectivity(qbms, bitmaps, *, pred: int):
    """Per-query predicate match counts [Q] i32."""
    return bf.selectivity_count(qbms, bitmaps, pred=pred)
