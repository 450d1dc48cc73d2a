"""Distance + top-k primitives shared by the filtered-ANN methods.

Distances are squared-L2 ranked via ``||v||² − 2·v·q`` (the query norm is
rank-invariant and omitted). Candidate top-k runs on fixed-shape padded
id tensors with −1 padding; duplicate candidates are suppressed with the
sort-adjacency trick (equal ids ⇒ equal distances ⇒ adjacent after a
stable sort by distance). Every top-k here ranks as `jax.lax.top_k`
does: by the IEEE total order of the scores (−0.0 before +0.0; see
`order_key`), ties to the lowest candidate position. `torch.topk` gives
no tie order, and a float sort treats −0.0 and +0.0 as equal.
"""

from __future__ import annotations

import math

import torch

INF = math.inf


def score_all(qvecs: torch.Tensor, base: torch.Tensor,
              base_norms: torch.Tensor) -> torch.Tensor:
    """Full [Q, N] ranking scores (squared-L2 up to a per-query constant)."""
    return base_norms[None, :] - 2.0 * (qvecs @ base.T)


def score_candidates(qvecs: torch.Tensor, cand_vecs: torch.Tensor,
                     cand_norms: torch.Tensor) -> torch.Tensor:
    """Per-candidate scores. qvecs [Q,d], cand_vecs [Q,C,d] -> [Q,C]."""
    dots = torch.einsum("qd,qcd->qc", qvecs, cand_vecs)
    return cand_norms - 2.0 * dots


def order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of float32 `x` whose integer order is the IEEE total
    order of the floats: −NaN < −inf < … < −0.0 < +0.0 < … < +inf < NaN.
    This is the order in which `jax.lax.top_k` ranks."""
    b = x.contiguous().view(torch.int32)
    return torch.where(b >= 0, b, b ^ 0x7FFFFFFF)


def smallest(scores: torch.Tensor, k: int):
    """(values, positions) of the k smallest float32 scores per row in
    `order_key` order, ties to the lowest position (k <= C)."""
    _, idx = torch.sort(order_key(scores), dim=-1, stable=True)
    idx = idx[..., :k]
    return torch.gather(scores, -1, idx), idx


def topk_ids(scores: torch.Tensor, ids: torch.Tensor, k: int, valid=None,
             dedup: bool = False):
    """Top-k smallest-score candidate ids.

    scores [Q, C] float32; ids [Q, C] int32 (−1 = padding); valid optional
    bool [Q, C]; `dedup` drops a repeated id that sits next to its first
    copy after a stable sort by score. Returns (ids [Q, k] int32 with −1
    fill, scores [Q, k]).
    """
    bad = ids < 0
    if valid is not None:
        bad = bad | ~valid
    scores = scores.masked_fill(bad, INF)
    if dedup:
        scores, order = torch.sort(scores, dim=-1, stable=True)
        ids = torch.gather(ids, -1, order)
        dup = torch.zeros_like(bad)
        dup[:, 1:] = (ids[:, 1:] == ids[:, :-1]) & (ids[:, 1:] >= 0)
        scores = scores.masked_fill(dup, INF)
    q, c = scores.shape
    if k > c:
        scores = torch.cat([scores, scores.new_full((q, k - c), INF)], 1)
        ids = torch.cat([ids, ids.new_full((q, k - c), -1)], 1)
    out_scores, idx = smallest(scores, k)
    out_ids = torch.gather(ids, 1, idx)
    out_ids = torch.where(torch.isinf(out_scores), -1, out_ids)
    return out_ids.to(torch.int32), out_scores


def merge_topk(ids_a, scores_a, ids_b, scores_b, k: int):
    """Merge two padded top-k sets, dropping duplicate ids."""
    ids = torch.cat([ids_a, ids_b], dim=-1)
    scores = torch.cat([scores_a, scores_b], dim=-1)
    return topk_ids(scores, ids, k, dedup=True)
