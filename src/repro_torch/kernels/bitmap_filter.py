"""Predicate selectivity counting over packed bitmaps: the CUDA kernel's
wrapper and its plain PyTorch version.

`selectivity_count` is the port of the TPU kernel of the same name
(`src/repro/kernels/bitmap_filter.py`): |{i : P(L_i, L_q)}| per query,
the router's `selectivity` feature. On a CUDA tensor it launches the
hand-written kernel in `csrc/selectivity.cu`; on a CPU tensor it runs
`selectivity_plain`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.masked_topk import _predicate_mask_block

QUERY_GROUP = 8          # queries per block (kGroup in csrc/selectivity.cu)
MAX_SPLITS = 64          # row splits (the kernel's grid.y)
MIN_SPLIT_ROWS = 4096    # fewest rows a split is given


def selectivity_plain(qbms: torch.Tensor, bitmaps: torch.Tensor, *,
                      pred: int) -> torch.Tensor:
    """Plain PyTorch version: the word-looped mask, summed -> [Q] int32."""
    return _predicate_mask_block(bitmaps, qbms, pred).sum(
        1, dtype=torch.int32)


def selectivity_count(qbms: torch.Tensor, bitmaps: torch.Tensor, *,
                      pred: int) -> torch.Tensor:
    """qbms [Q, W] int32, bitmaps [N, W] int32 -> counts [Q] int32, exact.

    CUDA tensors launch the kernel (counted in
    `selectivity_count.launches`); CPU tensors run `selectivity_plain`.
    Raises TypeError/ValueError on inputs the kernel does not take,
    RuntimeError if the launch fails."""
    pred = int(pred)
    if qbms.dtype != torch.int32 or bitmaps.dtype != torch.int32:
        raise TypeError(f"selectivity takes int32 views of uint32 bitmaps; "
                        f"got {qbms.dtype} / {bitmaps.dtype}")
    if pred not in (0, 1, 2):
        raise ValueError(f"pred must be 0, 1 or 2; got {pred}")
    q, w = qbms.shape
    n = bitmaps.shape[0]
    if bitmaps.shape[1] != w:
        raise ValueError(f"word widths differ: qbms {tuple(qbms.shape)}, "
                         f"bitmaps {tuple(bitmaps.shape)}")
    dev = qbms.device
    if dev.type == "cpu":
        return selectivity_plain(qbms, bitmaps, pred=pred)
    if dev.type != "cuda" or bitmaps.device != dev:
        raise ValueError(f"selectivity inputs must share one cuda or cpu "
                         f"device; got {dev} / {bitmaps.device}")
    if not (qbms.is_contiguous() and bitmaps.is_contiguous()):
        raise ValueError("selectivity inputs must be contiguous")
    if n >= 2 ** 31 - 2 ** 16:
        raise ValueError(f"selectivity takes fewer than 2^31 rows; got {n}")
    out = torch.empty((q,), dtype=torch.int32, device=dev)
    if q == 0:
        return out
    groups = -(-q // QUERY_GROUP)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(MAX_SPLITS, -(-4 * sms // groups),
                        n // MIN_SPLIT_ROWS))
    part = torch.empty((splits, q), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _build.library().selectivity_launch(
            qbms.data_ptr(), bitmaps.data_ptr(), part.data_ptr(),
            out.data_ptr(), q, n, w, pred, splits, stream)
    _build.check(code, "selectivity")
    _build.count_launch(selectivity_count)
    return out


selectivity_count.launches = 0
