"""Global-norm gradient clipping on the port's trees, in place."""

from __future__ import annotations

import torch

from repro_torch.models.common import tree_leaves
from repro_torch.optim.adam import leaf_rows, row_ranges


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of fp32 squares
    (the leaves added one after another, as the JAX package's Python
    `sum` does; a large leaf summed slice by slice)."""
    total = 0
    with torch.no_grad():
        for leaf in tree_leaves(tree):
            rows = leaf_rows(leaf.contiguous())
            sq = sum(torch.sum(torch.square(rows[r].float()))
                     for r in row_ranges(leaf.shape))
            total = total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """Scales every gradient by min(1, max_norm / (norm + 1e-9)) in fp32,
    in place. Returns (grads, norm), `grads` the same tree."""
    norm = global_norm(grads)
    limit = torch.full_like(norm, max_norm)
    scale = torch.clamp(limit / (norm + 1e-9), max=1.0)
    with torch.no_grad():
        for g in tree_leaves(grads):
            if g.dtype == torch.float32:
                g.mul_(scale)
            else:
                g.copy_(g.float() * scale)
    return grads, norm
