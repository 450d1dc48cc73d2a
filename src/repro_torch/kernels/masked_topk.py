"""Fused predicate mask + squared-L2 score + top-k: the CUDA kernel's
wrapper and its plain PyTorch version.

`masked_topk_accum` is the port of the TPU kernel of the same name
(`src/repro/kernels/masked_topk.py`). On a CUDA tensor it launches the
hand-written kernel in `csrc/masked_topk.cu`; on a CPU tensor it runs
`masked_topk_plain`, the same function in plain PyTorch. Both return the
raw kernel output: [Q, k] scores ‖v‖² − 2·q·v and row ids, ordered by
(score, id) with ties to the lowest id, and (PAD_SCORE, −1) in the slots
past the match count. `ops.masked_topk` turns those into −1 / +inf.
"""

from __future__ import annotations

import torch

from repro_torch.ann.predicates import eval_predicate
from repro_torch.kernels import _build

PAD_SCORE = 3.0e38      # sentinel of masked-out candidates (finite, as on TPU)
MAX_K = 128             # largest k the CUDA kernel keeps per thread
MAX_SPLITS = 1024       # row splits (the kernel's grid.y)
SPLIT_ROWS = 1024       # rows a split is given, up to MAX_SPLITS splits
SMEM_LIMIT = 232448     # shared memory a block can use on Hopper (227 KB)


def _predicate_mask_block(bitmaps: torch.Tensor, qbms: torch.Tensor,
                          pred: int) -> torch.Tensor:
    """bitmaps [N, W] int32, qbms [Q, W] int32 -> bool [Q, N]."""
    return eval_predicate(bitmaps, qbms[:, None, :], pred)


def stable_topk_raw(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """k smallest of [Q, C] scores in candidate order, ties to the lowest
    position; slots past C and scores >= PAD_SCORE come back as
    (score or PAD_SCORE, −1). Returns (dists [Q, k], ids [Q, k])."""
    q, c = scores.shape
    if k > c:
        scores = torch.cat([scores, scores.new_full((q, k - c), PAD_SCORE)], 1)
        ids = torch.cat([ids, ids.new_full((q, k - c), -1)], 1)
    d, order = torch.sort(scores, dim=1, stable=True)
    d, order = d[:, :k], order[:, :k]
    out_i = torch.gather(ids, 1, order)
    return d, torch.where(d >= PAD_SCORE, -1, out_i).to(torch.int32)


def masked_topk_plain(qvecs, qbms, base, norms, bitmaps, *, pred: int,
                      k: int):
    """Plain PyTorch version: the word-looped mask, fp32 scores
    ‖v‖² − 2·q·v, masked rows at PAD_SCORE, and a stable top-k."""
    scores = norms[None, :] - 2.0 * (qvecs @ base.T)
    s = torch.where(_predicate_mask_block(bitmaps, qbms, pred), scores,
                    PAD_SCORE)
    ids = torch.arange(base.shape[0], dtype=torch.int32,
                       device=base.device).expand(s.shape[0], -1)
    return stable_topk_raw(s, ids, k)


def _check(qvecs, qbms, base, norms, bitmaps, pred, k):
    for name, t in (("qvecs", qvecs), ("base", base), ("norms", norms)):
        if t.dtype != torch.float32:
            raise TypeError(f"masked_topk takes float32 {name}; got "
                            f"{t.dtype} (bf16 inputs are not supported yet)")
    for name, t in (("qbms", qbms), ("bitmaps", bitmaps)):
        if t.dtype != torch.int32:
            raise TypeError(f"masked_topk takes int32 views of the uint32 "
                            f"{name}; got {t.dtype}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"masked_topk supports 1 <= k <= {MAX_K}; got {k}")
    if pred not in (0, 1, 2):
        raise ValueError(f"pred must be 0, 1 or 2; got {pred}")
    q, d = qvecs.shape
    n, w = bitmaps.shape
    if (base.shape != (n, d) or norms.shape != (n,)
            or qbms.shape != (q, w)):
        raise ValueError(
            f"shape mismatch: qvecs {tuple(qvecs.shape)}, qbms "
            f"{tuple(qbms.shape)}, base {tuple(base.shape)}, norms "
            f"{tuple(norms.shape)}, bitmaps {tuple(bitmaps.shape)}")


def splits_for(n: int) -> int:
    """Row splits: short ones (SPLIT_ROWS rows), so that the blocks stay
    even when the passing rows bunch together, at most MAX_SPLITS."""
    return max(1, min(MAX_SPLITS, -(-n // SPLIT_ROWS)))


def masked_topk_accum(qvecs, qbms, base, norms, bitmaps, *, pred: int,
                      k: int):
    """Masked exact top-k: (dists [Q, k] f32, ids [Q, k] i32), raw.

    qvecs [Q, D] f32, qbms [Q, W] int32, base [N, D] f32, norms [N] f32,
    bitmaps [N, W] int32, all on one device. CUDA tensors launch the
    kernel (and count the launch in `masked_topk_accum.launches`); CPU
    tensors run `masked_topk_plain`. Raises TypeError/ValueError on
    inputs the kernel does not take, RuntimeError if the launch fails.
    """
    pred, k = int(pred), int(k)
    _check(qvecs, qbms, base, norms, bitmaps, pred, k)
    dev = qvecs.device
    if dev.type == "cpu":
        return masked_topk_plain(qvecs, qbms, base, norms, bitmaps,
                                 pred=pred, k=k)
    if dev.type != "cuda":
        raise ValueError(f"masked_topk runs on cuda or cpu; got {dev}")
    tensors = (qvecs, qbms, base, norms, bitmaps)
    if any(t.device != dev for t in tensors):
        raise ValueError("masked_topk inputs must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("masked_topk inputs must be contiguous")
    q, d = qvecs.shape
    n, w = bitmaps.shape
    lib = _build.library()
    smem = lib.masked_topk_smem_bytes(d, w)
    if smem > SMEM_LIMIT:
        raise ValueError(f"masked_topk keeps 48 rows of D + W words in shared "
                         f"memory: D = {d}, W = {w} needs {smem} bytes, more "
                         f"than {SMEM_LIMIT}")
    if n >= 2 ** 31 - 2 ** 16:
        raise ValueError(f"masked_topk takes fewer than 2^31 rows; got {n}")
    dists = torch.empty((q, k), dtype=torch.float32, device=dev)
    ids = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return dists, ids
    splits = splits_for(n)
    # scratch freed on return is reused only by work queued later on this
    # stream (the caching allocator is stream-ordered)
    part_d = torch.empty((q, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((q, splits, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.masked_topk_launch(
            qvecs.data_ptr(), qbms.data_ptr(), base.data_ptr(),
            norms.data_ptr(), bitmaps.data_ptr(), part_d.data_ptr(),
            part_i.data_ptr(), dists.data_ptr(), ids.data_ptr(),
            q, n, d, w, pred, k, splits, stream)
    _build.check(code, "masked_topk")
    masked_topk_accum.launches += 1
    return dists, ids


masked_topk_accum.launches = 0
