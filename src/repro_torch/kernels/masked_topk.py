"""Fused predicate mask + squared-L2 score + top-k, its per-block variant,
and the cross-shard top-k merge: the CUDA kernels' wrappers and their
plain PyTorch versions.

Each wrapper is the port of the TPU kernel of the same name
(`src/repro/kernels/masked_topk.py`). On a CUDA tensor it launches the
hand-written kernel (`csrc/masked_topk.cu`, `csrc/merge_topk.cu`); on a
CPU tensor it runs the `*_plain` function beside it, the same function
in plain PyTorch. All return the raw kernel output, with (PAD_SCORE, −1)
in the slots past the valid candidates; `ops` turns those into −1 /
+inf.

* `masked_topk_accum`: [Q, k] scores ‖v‖² − 2·q·v and row ids, ordered
  by (score, id) with ties to the lowest id.
* `masked_topk_blocks`: the same per block of `bn` rows, [NB, Q, k].
* `merge_topk_accum`: [S, Q, K] candidates -> [Q, k], in the IEEE total
  order of the distances (−0.0 before +0.0, as `jax.lax.top_k` ranks)
  with ties to the earlier shard, then the earlier slot.
"""

from __future__ import annotations

import torch

from repro_torch.ann.predicates import eval_predicate
from repro_torch.ann.topk import order_key
from repro_torch.kernels import _build

PAD_SCORE = 3.0e38      # sentinel of masked-out candidates (finite, as on TPU)
MAX_K = 128             # largest k the CUDA kernel keeps per thread
MAX_SPLITS = 1024       # row splits (the kernel's grid.y)
SPLIT_ROWS = 1024       # rows a split is given, up to MAX_SPLITS splits
SMEM_LIMIT = 232448     # shared memory a block can use on Hopper (227 KB)
DEFAULT_BN = 1024       # rows per block of `masked_topk_blocks`
MAX_BLOCKS = 65535      # blocks of `masked_topk_blocks` (the kernel's grid.y)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the kernel's `dtype`


def _predicate_mask_block(bitmaps: torch.Tensor, qbms: torch.Tensor,
                          pred: int) -> torch.Tensor:
    """bitmaps [N, W] int32, qbms [Q, W] int32 -> bool [Q, N]."""
    return eval_predicate(bitmaps, qbms[:, None, :], pred)


def stable_topk_raw(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """k smallest of [Q, C] scores in candidate order, ties to the lowest
    position; slots past C and scores not below PAD_SCORE (NaN too) come
    back as (PAD_SCORE, −1), as the kernel's merge returns them. Returns
    (dists [Q, k], ids [Q, k])."""
    q, c = scores.shape
    if k > c:
        scores = torch.cat([scores, scores.new_full((q, k - c), PAD_SCORE)], 1)
        ids = torch.cat([ids, ids.new_full((q, k - c), -1)], 1)
    d, order = torch.sort(scores, dim=1, stable=True)
    d, order = d[:, :k], order[:, :k]
    out_i = torch.gather(ids, 1, order)
    bad = ~(d < PAD_SCORE)
    return (d.masked_fill(bad, PAD_SCORE),
            torch.where(bad, -1, out_i).to(torch.int32))


def _masked_scores(qvecs, qbms, base, norms, bitmaps, pred: int):
    """[Q, N] fp32 scores ‖v‖² − 2·q·v, masked rows at PAD_SCORE. bf16
    inputs are upcast first, so the products are exact and the matmul is
    fp32, as the TPU kernel accumulates them."""
    scores = norms[None, :] - 2.0 * (qvecs.float() @ base.float().T)
    return torch.where(_predicate_mask_block(bitmaps, qbms, pred), scores,
                       PAD_SCORE)


def masked_topk_plain(qvecs, qbms, base, norms, bitmaps, *, pred: int,
                      k: int):
    """Plain PyTorch version: the word-looped mask, fp32 scores
    ‖v‖² − 2·q·v, masked rows at PAD_SCORE, and a stable top-k."""
    s = _masked_scores(qvecs, qbms, base, norms, bitmaps, pred)
    ids = torch.arange(base.shape[0], dtype=torch.int32,
                       device=base.device).expand(s.shape[0], -1)
    return stable_topk_raw(s, ids, k)


def masked_topk_blocks_plain(qvecs, qbms, base, norms, bitmaps, *,
                             pred: int, k: int, bn: int = DEFAULT_BN):
    """Plain PyTorch version of the per-block top-k: the masked scores cut
    into blocks of `bn` rows (the last one ragged), each block's k
    smallest by a stable sort (ties to the lowest row), (PAD_SCORE, −1)
    past its match count. Returns (dists [NB, Q, k], ids [NB, Q, k])."""
    s = _masked_scores(qvecs, qbms, base, norms, bitmaps, pred)
    q, n = s.shape
    nb = -(-n // bn)
    flat = s.new_full((q, nb * bn), PAD_SCORE)
    flat[:, :n] = s
    blk = flat.view(q, nb, bn)
    if k > bn:
        blk = torch.cat([blk, blk.new_full((q, nb, k - bn), PAD_SCORE)], 2)
    d, order = torch.sort(blk, dim=2, stable=True)
    d, order = d[:, :, :k], order[:, :, :k]
    rows = order + torch.arange(nb, device=s.device)[None, :, None] * bn
    ids = torch.where(d >= PAD_SCORE, -1, rows).to(torch.int32)
    return (d.transpose(0, 1).contiguous(),
            ids.transpose(0, 1).contiguous())


def _check(qvecs, qbms, base, norms, bitmaps, pred, k):
    for name, t in (("qvecs", qvecs), ("base", base)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"masked_topk takes float32 or bfloat16 {name}; "
                            f"got {t.dtype}")
    if qvecs.dtype != base.dtype:
        raise TypeError(f"masked_topk takes qvecs and base of one type; got "
                        f"{qvecs.dtype} and {base.dtype}")
    if norms.dtype != torch.float32:
        raise TypeError(f"masked_topk takes float32 norms; got {norms.dtype}")
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


def _scan_device(name, qvecs, qbms, base, norms, bitmaps):
    """The device of a scan's inputs, None for the CPU; for CUDA, checks
    what the split kernel takes and returns (device, library)."""
    dev = qvecs.device
    if dev.type == "cpu":
        return None, None
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu; got {dev}")
    tensors = (qvecs, qbms, base, norms, bitmaps)
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name} inputs must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} inputs must be contiguous")
    d = qvecs.shape[1]
    n, w = bitmaps.shape
    lib = _build.library()
    smem = lib.masked_topk_smem_bytes(d, w)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name} keeps 48 rows of D + W words in shared "
                         f"memory: D = {d}, W = {w} needs {smem} bytes, more "
                         f"than {SMEM_LIMIT}")
    if n >= 2 ** 31 - 2 ** 16:
        raise ValueError(f"{name} takes fewer than 2^31 rows; got {n}")
    return dev, lib


def _scan_lists(lib, dev, args, pred: int, k: int, rows: int):
    """Launch the split kernel on `dev` (its current stream) with splits
    of `rows` rows: the sorted top-k of each (split, query),
    (dists [NB, Q, k], ids [NB, Q, k]), NB = max(1, ceil(N / rows)).
    Returns (dists, ids, the launch's CUDA error code)."""
    qvecs, qbms, base, norms, bitmaps = args
    q, d = qvecs.shape
    n, w = bitmaps.shape
    nb = max(1, -(-n // rows))
    dists = torch.empty((nb, q, k), dtype=torch.float32, device=dev)
    ids = torch.empty((nb, q, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.masked_topk_blocks_launch(
            qvecs.data_ptr(), qbms.data_ptr(), base.data_ptr(),
            norms.data_ptr(), bitmaps.data_ptr(), dists.data_ptr(),
            ids.data_ptr(), q, n, d, w, pred, k, rows, _DTYPES[qvecs.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    return dists, ids, code


def masked_topk_accum(qvecs, qbms, base, norms, bitmaps, *, pred: int,
                      k: int):
    """Masked exact top-k: (dists [Q, k] f32, ids [Q, k] i32), raw.

    qvecs [Q, D] and base [N, D] both float32 or both bfloat16 (the dot
    accumulates in fp32), qbms [Q, W] int32, norms [N] f32, bitmaps
    [N, W] int32, all on one device. CUDA tensors launch the split kernel
    over `splits_for(N)` row splits and fold its per-split lists with the
    merge kernel (the pair counted once in `masked_topk_accum.launches`);
    CPU tensors run `masked_topk_plain`. Raises TypeError/ValueError on
    inputs the kernel does not take, RuntimeError if a launch fails.
    """
    pred, k = int(pred), int(k)
    args = (qvecs, qbms, base, norms, bitmaps)
    _check(*args, pred, k)
    dev, lib = _scan_device("masked_topk", *args)
    if dev is None:
        return masked_topk_plain(*args, pred=pred, k=k)
    q, n = qvecs.shape[0], bitmaps.shape[0]
    dists = torch.empty((q, k), dtype=torch.float32, device=dev)
    ids = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return dists, ids
    # the scratch lists, freed on return, are reused only by work queued
    # later on this stream (the caching allocator is stream-ordered)
    part_d, part_i, code = _scan_lists(lib, dev, args, pred, k,
                                       max(1, -(-n // splits_for(n))))
    _build.check(code, "masked_topk")
    with torch.cuda.device(dev):
        code = lib.merge_topk_launch(
            part_d.data_ptr(), part_i.data_ptr(), dists.data_ptr(),
            ids.data_ptr(), part_d.shape[0], q, k, k, 1,   # lists sorted
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "masked_topk")
    _build.count_launch(masked_topk_accum)
    return dists, ids


masked_topk_accum.launches = 0


def masked_topk_blocks(qvecs, qbms, base, norms, bitmaps, *, pred: int,
                       k: int, bn: int = DEFAULT_BN):
    """Per-block masked top-k: (dists [NB, Q, k] f32, ids [NB, Q, k] i32),
    raw, NB = ceil(N / bn); block b holds rows [b·bn, (b+1)·bn).

    Inputs as `masked_topk_accum`, N >= 1. CUDA tensors launch the split
    kernel with splits of exactly `bn` rows (counted in
    `masked_topk_blocks.launches`); CPU tensors run
    `masked_topk_blocks_plain`."""
    pred, k, bn = int(pred), int(k), int(bn)
    _check(qvecs, qbms, base, norms, bitmaps, pred, k)
    n = bitmaps.shape[0]
    if bn < 1 or n < 1 or -(-n // bn) > MAX_BLOCKS:
        raise ValueError(f"masked_topk_blocks takes N >= 1 rows in at most "
                         f"{MAX_BLOCKS} blocks; got N = {n}, bn = {bn}")
    args = (qvecs, qbms, base, norms, bitmaps)
    dev, lib = _scan_device("masked_topk_blocks", *args)
    if dev is None:
        return masked_topk_blocks_plain(*args, pred=pred, k=k, bn=bn)
    if qvecs.shape[0] == 0:
        empty = torch.empty((-(-n // bn), 0, k), device=dev)
        return empty, empty.to(torch.int32)
    dists, ids, code = _scan_lists(lib, dev, args, pred, k, bn)
    _build.check(code, "masked_topk_blocks")
    _build.count_launch(masked_topk_blocks)
    return dists, ids


masked_topk_blocks.launches = 0


# ---------------------------------------------------------------------------
# cross-shard top-k merge
# ---------------------------------------------------------------------------

def merge_topk_plain(dists, ids, *, k: int):
    """Plain PyTorch version of the merge: slots with id < 0, a NaN or a
    distance >= PAD_SCORE count as PAD_SCORE; the [S, Q, K] candidates
    are laid out shard-major and sorted stably by the IEEE total order of
    their distances (`order_key`), so ties go to the earlier shard, then
    the earlier slot. Returns (dists [Q, k], ids [Q, k]), raw: valid
    distances keep their bits; (PAD_SCORE, −1) elsewhere."""
    s, q, kk = dists.shape
    d = dists.masked_fill((ids < 0) | ~(dists < PAD_SCORE), PAD_SCORE)
    d = d.transpose(0, 1).reshape(q, s * kk)
    i = ids.transpose(0, 1).reshape(q, s * kk)
    if k > s * kk:
        d = torch.cat([d, d.new_full((q, k - s * kk), PAD_SCORE)], 1)
        i = torch.cat([i, i.new_full((q, k - s * kk), -1)], 1)
    _, order = torch.sort(order_key(d), dim=1, stable=True)
    out_d = torch.gather(d, 1, order[:, :k])
    out_i = torch.gather(i, 1, order[:, :k])
    return out_d, torch.where(out_d >= PAD_SCORE, -1, out_i).to(torch.int32)


def merge_topk_accum(dists, ids, *, k: int):
    """Cross-shard top-k merge, raw: dists [S, Q, K] float32, ids
    [S, Q, K] int32 (already global) -> (dists [Q, k], ids [Q, k]) with
    (PAD_SCORE, −1) at invalid outputs; k may exceed S·K.

    CUDA tensors launch the kernel (counted in
    `merge_topk_accum.launches`); CPU tensors run `merge_topk_plain`.
    Raises TypeError/ValueError on inputs the kernel does not take,
    RuntimeError if the launch fails."""
    k = int(k)
    if dists.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError(f"merge_topk takes float32 dists and int32 ids; got "
                        f"{dists.dtype} / {ids.dtype}")
    if dists.dim() != 3 or dists.shape != ids.shape:
        raise ValueError(f"merge_topk takes [S, Q, K] dists and ids; got "
                         f"{tuple(dists.shape)} / {tuple(ids.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"merge_topk supports 1 <= k <= {MAX_K}; got {k}")
    s, q, kk = dists.shape
    if s < 1 or kk < 1 or s * kk >= 2 ** 31 - 2 ** 16:
        raise ValueError(f"merge_topk takes 1 <= S, 1 <= K and S·K < 2^31; "
                         f"got S = {s}, K = {kk}")
    dev = dists.device
    if dev.type == "cpu" and ids.device.type == "cpu":
        return merge_topk_plain(dists, ids, k=k)
    if dev.type != "cuda" or ids.device != dev:
        raise ValueError(f"merge_topk inputs must share one cuda or cpu "
                         f"device; got {dev} / {ids.device}")
    if not (dists.is_contiguous() and ids.is_contiguous()):
        raise ValueError("merge_topk inputs must be contiguous")
    out_d = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_d, out_i
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _build.library().merge_topk_launch(
            dists.data_ptr(), ids.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), s, q, kk, k, 0, stream)
    _build.check(code, "merge_topk")
    _build.count_launch(merge_topk_accum)
    return out_d, out_i


merge_topk_accum.launches = 0
