"""Distance + top-k primitives shared by the filtered-ANN methods.

Distances are squared-L2 ranked via ``||v||² − 2·v·q`` (the query norm is
rank-invariant and omitted). Candidate top-k runs on fixed-shape padded
id tensors with −1 padding. Every top-k here is stable — ties go to the
lowest candidate position, as `jax.lax.top_k` does — because
`torch.topk` gives no tie order.
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


def smallest(scores: torch.Tensor, k: int):
    """(values, positions) of the k smallest per row, ties to the lowest
    position (k <= C)."""
    vals, idx = torch.sort(scores, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_ids(scores: torch.Tensor, ids: torch.Tensor, k: int, valid=None):
    """Top-k smallest-score candidate ids.

    scores [Q, C] float32; ids [Q, C] int32 (−1 = padding); valid optional
    bool [Q, C]. Returns (ids [Q, k] int32 with −1 fill, scores [Q, k]).
    """
    bad = ids < 0
    if valid is not None:
        bad = bad | ~valid
    scores = scores.masked_fill(bad, INF)
    q, c = scores.shape
    if k > c:
        scores = torch.cat([scores, scores.new_full((q, k - c), INF)], 1)
        ids = torch.cat([ids, ids.new_full((q, k - c), -1)], 1)
    out_scores, idx = smallest(scores, k)
    out_ids = torch.gather(ids, 1, idx)
    out_ids = torch.where(torch.isinf(out_scores), -1, out_ids)
    return out_ids.to(torch.int32), out_scores
