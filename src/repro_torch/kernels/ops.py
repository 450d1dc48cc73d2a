"""The kernels' entry points: sentinel cleanup around the wrappers.

The CUDA kernels take any Q and N (they mask the ragged edge
themselves), so unlike the TPU wrappers nothing is padded to block
multiples here and `selectivity` needs no padded-row correction. What
stays is the reference's output rule (`src/repro/kernels/ops.py`):
`PAD_SCORE` scores and −1 ids come back as id −1 with distance +inf.
Each wrapper takes its CUDA kernel for CUDA tensors and its plain
PyTorch version for CPU tensors.
"""

from __future__ import annotations

import math

from repro_torch.kernels import bitmap_filter as bf
from repro_torch.kernels import masked_topk as mk


def masked_topk(qvecs, qbms, base, norms, bitmaps, *, pred: int, k: int):
    """Fused filtered brute-force top-k. Returns (ids [Q, k] i32 with −1
    pads, dists [Q, k] f32 ranking scores with +inf pads)."""
    dists, ids = mk.masked_topk_accum(qvecs, qbms, base, norms, bitmaps,
                                      pred=pred, k=k)
    bad = (ids < 0) | (dists >= mk.PAD_SCORE)
    return ids.masked_fill(bad, -1), dists.masked_fill(bad, math.inf)


def selectivity(qbms, bitmaps, *, pred: int):
    """Per-query predicate match counts [Q] i32."""
    return bf.selectivity_count(qbms, bitmaps, pred=pred)
