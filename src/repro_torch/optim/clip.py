"""Global-norm gradient clipping on the port's trees, in place. On a
mesh each gradient is a DTensor: a leaf's sum of squares is the sum of
its shards' local sums, all-reduced over the mesh dimensions that shard
it, and the scale multiplies each rank's shards."""

from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol

from repro_torch.models.common import is_dtensor, tree_leaves
from repro_torch.optim.adam import leaf_rows, row_ranges


def _sum_squares(t: torch.Tensor) -> torch.Tensor:
    rows = leaf_rows(t.contiguous())
    return sum(torch.sum(torch.square(rows[r].float()))
               for r in row_ranges(t.shape))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of fp32 squares
    (the leaves added one after another, as the JAX package's Python
    `sum` does; a large leaf summed slice by slice). On a mesh the result
    is a plain tensor, the same on every rank."""
    from torch.distributed.tensor import Shard

    total = 0
    with torch.no_grad():
        for leaf in tree_leaves(tree):
            if not is_dtensor(leaf):
                total = total + _sum_squares(leaf)
                continue
            sq = _sum_squares(leaf.to_local())
            for d, pl in enumerate(leaf.placements):
                if isinstance(pl, Shard):
                    sq = funcol.all_reduce(sq, "sum", (leaf.device_mesh, d))
                    if isinstance(sq, funcol.AsyncCollectiveTensor):
                        sq = sq.wait()
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
            g = g.to_local() if is_dtensor(g) else g
            if g.dtype == torch.float32:
                g.mul_(scale)
            else:
                g.copy_(g.float() * scale)
    return grads, norm
