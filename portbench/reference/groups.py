"""Label-set groups, worked out again from the raw bitmaps.

The served dataset stores rows grouped by label set (the paper's
precomputed set-count table): group ids by first appearance of a
bitmap, rows stably sorted by group id. Answers come back as row ids of
that order, so the reference rebuilds the same order to map them to the
rows it drew.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Groups:
    order: np.ndarray        # [N] int64: served row i is drawn row order[i]
    sizes: np.ndarray        # [G] int64 rows a group, in group-id order
    bitmaps: torch.Tensor    # [G, W] int32 group label sets (group-id order)
    gid: torch.Tensor        # [N] int64 group id of each drawn row

    @property
    def n_groups(self) -> int:
        return int(self.sizes.shape[0])


def group_rows(bitmaps: torch.Tensor) -> Groups:
    """Groups of the [N, W] int32 bitmaps (on any device)."""
    n = bitmaps.shape[0]
    uniq, inv = torch.unique(bitmaps, dim=0, return_inverse=True)
    g = uniq.shape[0]
    first = torch.full((g,), n, dtype=torch.int64, device=bitmaps.device)
    first.scatter_reduce_(0, inv, torch.arange(n, device=bitmaps.device),
                          reduce="amin")
    by_first = torch.argsort(first)                   # group id -> uniq row
    rank = torch.empty_like(by_first)
    rank[by_first] = torch.arange(g, device=bitmaps.device)
    gid = rank[inv]
    order = torch.sort(gid, stable=True).indices
    sizes = torch.bincount(gid, minlength=g)
    return Groups(order=order.cpu().numpy(), sizes=sizes.cpu().numpy(),
                  bitmaps=uniq[by_first], gid=gid)
