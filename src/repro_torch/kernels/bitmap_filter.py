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

BLOCKS_PER_SM = 2        # blocks a launch aims for on each SM
MAX_WORDS = 800          # widest bitmap whose two tiles fit in shared memory


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
    if w > MAX_WORDS:
        raise ValueError(f"selectivity takes at most {MAX_WORDS} words a "
                         f"bitmap; got {w}")
    out = torch.empty((q,), dtype=torch.int32, device=dev)
    if q == 0:
        return out
    if bitmaps.data_ptr() % 16:          # the tiles move 16 bytes at a time
        bitmaps = bitmaps.clone()
    lib = _build.library()
    # query groups of the kernel's block, and row splits of whole tiles,
    # about BLOCKS_PER_SM blocks an SM in all
    groups = -(-q // lib.selectivity_query_group(w))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(-(-BLOCKS_PER_SM * sms // groups),
                        -(-n // lib.selectivity_tile_rows(w))))
    part = torch.empty((splits, q), dtype=torch.int32, device=dev)
    # the chunked kernel (w > 16) reads the query words as [W, Q]
    qbm_t = qbms.t().contiguous() if w > 16 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.selectivity_launch(
            qbms.data_ptr(), None if qbm_t is None else qbm_t.data_ptr(),
            bitmaps.data_ptr(), part.data_ptr(), out.data_ptr(), q, n, w,
            pred, splits, stream)
    _build.check(code, "selectivity")
    _build.count_launch(selectivity_count)
    return out


selectivity_count.launches = 0
