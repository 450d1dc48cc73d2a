"""The least time an op needs on its inputs, counted from the call's
arguments alone, whatever kernel implements it.

The time is the larger of operations over the peak rate and bytes over
the peak bandwidth. Both ops are counted over the distinct label sets
of the rows (the paper's group table), not over rows: whether a row
passes depends only on its label set, so a kernel may decide over the
G groups and read no per-row bitmap. A count over rows would let such a
kernel read past 100%.

* `selectivity(qbms [Q, W], bitmaps [N, W])`: one 32-bit op per
  (query, label set, word); bytes: the group table (G × W words and G
  sizes), the query words, the [Q] counts written.
* `masked_topk(qvecs [Q, D], qbms, base [N, D], norms, bitmaps, k)`:
  2·D flops per passing (query, row) pair; bytes: the group table, the
  vector and norm of every row that passes for at least one query, the
  queries, and [Q, k] ids and distances written.
"""

from __future__ import annotations

import torch

from portbench.reference.exact import predicate_mask
from portbench.reference.groups import group_rows

PRED_NAMES = ("EQUALITY", "AND", "OR")


class GroupTables:
    """Group tables of the bitmaps tensors calls pass, worked out once a
    tensor."""

    def __init__(self):
        self._seen: dict = {}

    def of(self, bitmaps: torch.Tensor):
        key = (bitmaps.data_ptr(), tuple(bitmaps.shape))
        hit = self._seen.get(key)
        if hit is None:
            g = group_rows(bitmaps)
            hit = (g.bitmaps, torch.from_numpy(g.sizes).to(bitmaps.device))
            self._seen[key] = hit
        return hit


def selectivity_counts(q: int, w: int, groups: int) -> tuple[int, int]:
    """(32-bit ops, bytes) of one selectivity call."""
    return q * groups * w, groups * (w + 1) * 4 + q * w * 4 + q * 4


def masked_topk_counts(gbm: torch.Tensor, sizes: torch.Tensor,
                       qbms: torch.Tensor, pred: int, d: int,
                       k: int) -> tuple[int, int]:
    """(fp32 flops, bytes) of one masked_topk call, from the group table
    (gbm [G, W], sizes [G]) and the call's query words."""
    ok = predicate_mask(gbm, qbms, PRED_NAMES[pred])          # [Q, G]
    pairs = int((ok.to(torch.float64) @ sizes.to(torch.float64)).sum())
    rows = int(sizes[ok.any(0)].sum())
    q, w = qbms.shape
    g = gbm.shape[0]
    nbytes = (g * (w + 1) * 4 + rows * (d + 1) * 4 + q * (d + w) * 4
              + q * k * 8)
    return 2 * d * pairs, nbytes


def least_seconds(ops: float, nbytes: float, op_rate: float,
                  bytes_rate: float) -> float:
    return max(ops / op_rate, nbytes / bytes_rate)
