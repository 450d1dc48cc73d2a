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
* `fused_live_accum`: the live read (`csrc/fused_live.cu`): tombstone-
  masked base candidates, then the delta rows' masked scores, in one
  [Q, k] top-k in that fold order.

Every wrapper takes any k >= 1, as the reference does. Up to `MAX_K`
the scanning kernels keep each query's top-k list in shared memory;
above it `masked_topk`,
`masked_topk_blocks` and `fused_live` write one sortable key per
(query, position) and reduce each row's keys with the select of
`csrc/topk_select.cuh`. The merge takes any k itself: its lists are
read once into shared memory and selected there; past that, the scans'
sorted lists are stepped through, and others go through that select
over keys in a workspace.
"""

from __future__ import annotations

import torch

from repro_torch.ann.predicates import eval_predicate
from repro_torch.ann.topk import order_key
from repro_torch.kernels import _build

PAD_SCORE = 3.0e38      # sentinel of masked-out candidates (finite, as on TPU)
MAX_K = 128             # largest k the scanning kernels' lists keep
LARGE_KEYS = 1 << 26    # (query, position) keys a k > MAX_K launch holds
                        # (256 MB)
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
    if k < 1:
        raise ValueError(f"masked_topk takes k >= 1; got {k}")
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


def _check_smem(name: str, lib, d: int, w: int, k: int) -> None:
    """Raise if a scanning block at (D, W) needs more shared memory than a
    block can have: the scan's, and for k <= MAX_K each query's k-entry
    list; the layout's numbers come from the library."""
    qg, rows, label_rows, chunk = (lib.tile_scan_layout(i) for i in range(4))
    lists = qg * k * 8 if k <= MAX_K else 0
    smem = lib.tile_scan_smem_bytes(d, w) + lists
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{name} keeps {qg} queries and {rows} rows of up to {chunk} "
            f"dimensions, two tiles of {label_rows} rows of W label words "
            f"and {lists} bytes of top-k lists in shared memory: D = {d}, "
            f"W = {w}, k = {k} needs {smem} bytes, more than {SMEM_LIMIT}")


def _select_workspace(lib, dev, rows: set, m: int, k: int) -> torch.Tensor:
    """The select's workspace (`csrc/topk_select.cuh`) for launches of
    each row count in `rows` over m positions, k kept."""
    nbytes = max(lib.topk_select_workspace_bytes(r, m, k) for r in rows)
    return torch.empty(max(nbytes, 1), dtype=torch.uint8, device=dev)


def _chunks(q: int, qc: int) -> set:
    """The row counts of the chunks of q rows, qc at a time."""
    return {qc, q - (q - 1) // qc * qc}


def _scan_device(name, qvecs, qbms, base, norms, bitmaps, k):
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
    n = bitmaps.shape[0]
    lib = _build.library()
    _check_smem(name, lib, qvecs.shape[1], bitmaps.shape[1], k)
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
    [N, W] int32, all on one device; any k >= 1. CUDA tensors with
    k <= MAX_K launch the split kernel over `splits_for(N)` row splits
    and fold its per-split lists with the merge kernel, the pair
    (counted once in `masked_topk_accum.launches`); with k > MAX_K they
    go to `masked_topk_large`. CPU tensors run `masked_topk_plain`.
    Raises TypeError/ValueError on inputs the kernel does not take,
    RuntimeError if a launch fails.
    """
    pred, k = int(pred), int(k)
    args = (qvecs, qbms, base, norms, bitmaps)
    if k > MAX_K:
        return masked_topk_large(*args, pred=pred, k=k)
    _check(*args, pred, k)
    dev, lib = _scan_device("masked_topk", *args, k)
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
    _build.check(_merge_launch(lib, dev, part_d, part_i, dists, ids, k, True),
                 "masked_topk")
    _build.count_launch(masked_topk_accum)
    return dists, ids


masked_topk_accum.launches = 0


def masked_topk_large(qvecs, qbms, base, norms, bitmaps, *, pred: int,
                      k: int):
    """Masked exact top-k for any k, through the kernels that keep no
    per-thread lists (`masked_topk_accum` sends k > MAX_K here): per
    query chunk (at most LARGE_KEYS keys at once) the key kernel writes
    [Qc, N] sortable score keys and the select of `csrc/topk_select.cuh`
    reduces each query's to its top-k. Counted once a call in
    `masked_topk_large.launches`. Inputs and output as
    `masked_topk_accum`; CPU tensors run `masked_topk_plain`."""
    pred, k = int(pred), int(k)
    args = (qvecs, qbms, base, norms, bitmaps)
    _check(*args, pred, k)
    dev, lib = _scan_device("masked_topk", *args, k)
    if dev is None:
        return masked_topk_plain(*args, pred=pred, k=k)
    q, d = qvecs.shape
    n, w = bitmaps.shape
    if q == 0 or n == 0:
        return (torch.full((q, k), PAD_SCORE, dtype=torch.float32,
                           device=dev),
                torch.full((q, k), -1, dtype=torch.int32, device=dev))
    dists = torch.empty((q, k), dtype=torch.float32, device=dev)
    ids = torch.empty((q, k), dtype=torch.int32, device=dev)
    stride = -(-n // 4) * 4
    qc = max(1, min(q, LARGE_KEYS // stride))
    keys = torch.empty((qc, stride), dtype=torch.int32, device=dev)
    ws = _select_workspace(lib, dev, _chunks(q, qc), n, k)
    rows = max(1, -(-n // splits_for(n)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s in range(0, q, qc):
            e = min(q, s + qc)
            code = lib.masked_topk_large_launch(
                qvecs[s:e].data_ptr(), qbms[s:e].data_ptr(), base.data_ptr(),
                norms.data_ptr(), bitmaps.data_ptr(), keys.data_ptr(),
                ws.data_ptr(), dists[s:e].data_ptr(), ids[s:e].data_ptr(),
                e - s, n, d, w, pred, k, rows, _DTYPES[qvecs.dtype], stream)
            _build.check(code, "masked_topk")
    _build.count_launch(masked_topk_large)
    return dists, ids


masked_topk_large.launches = 0


def masked_topk_blocks(qvecs, qbms, base, norms, bitmaps, *, pred: int,
                       k: int, bn: int = DEFAULT_BN):
    """Per-block masked top-k: (dists [NB, Q, k] f32, ids [NB, Q, k] i32),
    raw, NB = ceil(N / bn); block b holds rows [b·bn, (b+1)·bn).

    Inputs as `masked_topk_accum`, N >= 1, any k >= 1. CUDA tensors with
    k <= MAX_K launch the split kernel with splits of exactly `bn` rows;
    above it the key kernel and the select over each (query, block)
    segment (both counted in `masked_topk_blocks.launches`, once a call);
    CPU tensors run `masked_topk_blocks_plain`."""
    pred, k, bn = int(pred), int(k), int(bn)
    _check(qvecs, qbms, base, norms, bitmaps, pred, k)
    n = bitmaps.shape[0]
    if bn < 1 or n < 1 or -(-n // bn) > MAX_BLOCKS:
        raise ValueError(f"masked_topk_blocks takes N >= 1 rows in at most "
                         f"{MAX_BLOCKS} blocks; got N = {n}, bn = {bn}")
    args = (qvecs, qbms, base, norms, bitmaps)
    dev, lib = _scan_device("masked_topk_blocks", *args, k)
    if dev is None:
        return masked_topk_blocks_plain(*args, pred=pred, k=k, bn=bn)
    q = qvecs.shape[0]
    if q == 0:
        empty = torch.empty((-(-n // bn), 0, k), device=dev)
        return empty, empty.to(torch.int32)
    if k > MAX_K:
        dists, ids = _blocks_large(lib, dev, args, pred, k, bn)
    else:
        dists, ids, code = _scan_lists(lib, dev, args, pred, k, bn)
        _build.check(code, "masked_topk_blocks")
    _build.count_launch(masked_topk_blocks)
    return dists, ids


def _blocks_large(lib, dev, args, pred: int, k: int, bn: int):
    """`masked_topk_blocks` for k > MAX_K on `dev`: per query chunk the
    key kernel writes [Qc, NB·bn] keys (the ragged last block padded) and
    the select reduces each (query, block) segment of bn keys."""
    qvecs, qbms, base, norms, bitmaps = args
    q, d = qvecs.shape
    n, w = bitmaps.shape
    nb = -(-n // bn)
    stride = nb * bn
    qc = max(1, min(q, LARGE_KEYS // stride, (2 ** 31 - 1) // nb))
    keys = torch.empty((qc, stride), dtype=torch.int32, device=dev)
    ws = _select_workspace(lib, dev, {c * nb for c in _chunks(q, qc)}, bn, k)
    dists = torch.empty((nb, q, k), dtype=torch.float32, device=dev)
    ids = torch.empty((nb, q, k), dtype=torch.int32, device=dev)
    rows = max(1, -(-n // splits_for(n)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s in range(0, q, qc):
            e = min(q, s + qc)
            code = lib.masked_topk_blocks_large_launch(
                qvecs[s:e].data_ptr(), qbms[s:e].data_ptr(), base.data_ptr(),
                norms.data_ptr(), bitmaps.data_ptr(), keys.data_ptr(),
                ws.data_ptr(), dists.data_ptr(), ids.data_ptr(), e - s, s, q,
                n, d, w, pred, k, bn, rows, _DTYPES[qvecs.dtype], stream)
            _build.check(code, "masked_topk_blocks")
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


def _merge_launch(lib, dev, dists, ids, out_d, out_i, k: int,
                  sorted_lists: bool) -> int:
    """Launch `csrc/merge_topk.cu` on `dev`'s current stream: [S, Q, K]
    dists/ids (Q >= 1) into out_d/out_i [Q, k], with the workspace the
    kernel asks for (none unless the lists are too long for a block's
    shared memory and not `sorted_lists`). `sorted_lists` is the scans'
    promise that every [K] list is ascending under the rules of
    `merge_topk_plain`; the result is the same either way. Returns the
    CUDA error code."""
    s, q, kk = dists.shape
    nbytes = lib.merge_topk_workspace_bytes(s, q, kk, k, int(sorted_lists))
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
    with torch.cuda.device(dev):
        return lib.merge_topk_launch(
            dists.data_ptr(), ids.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), None if ws is None else ws.data_ptr(), s, q,
            kk, k, int(sorted_lists),
            torch.cuda.current_stream(dev).cuda_stream)


def merge_topk_accum(dists, ids, *, k: int):
    """Cross-shard top-k merge, raw: dists [S, Q, K] float32, ids
    [S, Q, K] int32 (already global) -> (dists [Q, k], ids [Q, k]) with
    (PAD_SCORE, −1) at invalid outputs; any k >= 1, which may exceed S·K.

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
    if k < 1:
        raise ValueError(f"merge_topk takes k >= 1; got {k}")
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
    _build.check(_merge_launch(_build.library(), dev, dists, ids, out_d,
                               out_i, k, False), "merge_topk")
    _build.count_launch(merge_topk_accum)
    return out_d, out_i


merge_topk_accum.launches = 0


# ---------------------------------------------------------------------------
# fused live read: base candidates + delta scan + tombstones
# ---------------------------------------------------------------------------

def tombstone_bits_plain(tomb_words: torch.Tensor,
                         ids: torch.Tensor) -> torch.Tensor:
    """Packed tombstone lookup: bool, True where global row `id` is dead.

    `tomb_words` [TW] int32 views of the uint32 words, bit `r & 31` of
    word `r >> 5` set for dead row r (numpy `packbits(bitorder="little")`
    layout). Ids are clipped into range first, as the reference does:
    out-of-range ids (−1 pads, sentinel rows) read an arbitrary bit,
    which is harmless because their score is already PAD_SCORE. The
    words are shifted as int32 (torch's uint32 `>>` does not run on the
    CPU) and masked after the shift, which gives the same bit."""
    safe = ids.long().clamp(0, tomb_words.shape[0] * 32 - 1)
    words = tomb_words[safe >> 5]
    return ((words >> (safe & 31).to(torch.int32)) & 1) != 0


def _fused_live_inputs(dvec, dnorms, dbm, sel, base_n: int):
    """The delta rows in scan order, with their global ids: all mirror
    rows (id base_n + r), or the rows `sel` picks (a −1 pad gets id −1
    and a PAD_SCORE norm)."""
    if sel is None:
        ids = torch.arange(dvec.shape[0], dtype=torch.int32,
                           device=dvec.device) + int(base_n)
        return dvec, dnorms, dbm, ids
    safe = sel.long().clamp(min=0)
    pad = sel < 0
    return (dvec[safe], dnorms[safe].masked_fill(pad, PAD_SCORE), dbm[safe],
            torch.where(pad, -1, sel + int(base_n)).to(torch.int32))


def fused_live_plain(qvecs, qbms, cand_dists, cand_ids, dvec, dnorms, dbm,
                     tomb_words, *, base_n: int, sel=None, pred: int,
                     k: int):
    """Plain PyTorch version of the fused live read, in the kernel's fold
    order: the base candidates (an id < 0, a non-finite distance, one at
    or above PAD_SCORE or a tombstoned id becomes PAD_SCORE), then the
    delta rows' scores ‖v‖² − 2·q·v (PAD_SCORE where the predicate fails
    or the row is dead), one stable top-k over both by the IEEE total
    order of the distances (`order_key`), ties to the earlier position.
    Returns (dists [Q, k], ids [Q, k]), raw: (PAD_SCORE, −1) at invalid
    outputs."""
    ci = cand_ids.to(torch.int32)
    cd = cand_dists.to(torch.float32)
    bad = ((ci < 0) | ~torch.isfinite(cd) | (cd >= PAD_SCORE)
           | tombstone_bits_plain(tomb_words, ci))
    cd = cd.masked_fill(bad, PAD_SCORE)
    ci = ci.masked_fill(bad, -1)
    dv, dn, db, di = _fused_live_inputs(dvec, dnorms, dbm, sel, base_n)
    dead = tombstone_bits_plain(tomb_words, di) | (di < 0)
    s = _masked_scores(qvecs, qbms, dv, dn, db, pred).masked_fill(
        dead[None, :], PAD_SCORE)
    d = torch.cat([cd, s], 1)
    i = torch.cat([ci, di.expand(s.shape[0], -1)], 1)
    q, c = d.shape
    if k > c:
        d = torch.cat([d, d.new_full((q, k - c), PAD_SCORE)], 1)
        i = torch.cat([i, i.new_full((q, k - c), -1)], 1)
    _, order = torch.sort(order_key(d), dim=1, stable=True)
    out_d = torch.gather(d, 1, order[:, :k])
    out_i = torch.gather(i, 1, order[:, :k])
    bad = ~(out_d < PAD_SCORE)
    return (out_d.masked_fill(bad, PAD_SCORE),
            torch.where(bad, -1, out_i).to(torch.int32))


def fused_live_accum(qvecs, qbms, cand_dists, cand_ids, dvec, dnorms, dbm,
                     tomb_words, *, base_n: int, sel=None, pred: int,
                     k: int):
    """Fused live top-k, raw: (dists [Q, k] f32, ids [Q, k] i32) with
    (PAD_SCORE, −1) at invalid outputs.

    qvecs [Q, D] f32, qbms [Q, W] int32, cand_dists/cand_ids [Q, KB]
    f32/int32 routed base candidates (global ids; KB may be 0), the delta
    mirror dvec [ND, D] f32, dnorms [ND] f32, dbm [ND, W] int32, whose row
    r has id base_n + r, tomb_words [TW] int32 views of the packed
    tombstones over base and delta ids (TW >= 1), optional sel [NS] int32
    mirror rows to scan instead of all of them (−1 pads), any k >= 1, all
    on one device. CUDA tensors with k <= MAX_K launch
    `csrc/fused_live.cu` and fold its lists with the merge kernel; above
    it the base candidates' and delta rows' keys go through the select
    of `csrc/topk_select.cuh` (either way counted once in
    `fused_live_accum.launches`); CPU tensors run `fused_live_plain`.
    Raises TypeError/ValueError on inputs the kernel does not take,
    RuntimeError if a launch fails."""
    pred, k, base_n = int(pred), int(k), int(base_n)
    tensors = [qvecs, qbms, cand_dists, cand_ids, dvec, dnorms, dbm,
               tomb_words] + ([] if sel is None else [sel])
    types = [torch.float32, torch.int32, torch.float32, torch.int32,
             torch.float32, torch.float32, torch.int32, torch.int32,
             torch.int32]
    for t, want in zip(tensors, types):
        if t.dtype != want:
            raise TypeError(f"fused_live takes float32 vectors, norms and "
                            f"candidate distances and int32 ids, bitmaps, "
                            f"tombstone words and sel; got {t.dtype} where "
                            f"{want} is due")
    if k < 1:
        raise ValueError(f"fused_live takes k >= 1; got {k}")
    if pred not in (0, 1, 2):
        raise ValueError(f"pred must be 0, 1 or 2; got {pred}")
    q, d = qvecs.shape
    nd, w = dbm.shape
    kb = cand_ids.shape[1]
    if (qbms.shape != (q, w) or cand_dists.shape != (q, kb)
            or cand_ids.shape[0] != q or dvec.shape != (nd, d)
            or dnorms.shape != (nd,) or tomb_words.dim() != 1
            or tomb_words.shape[0] < 1 or (sel is not None and sel.dim() != 1)
            or base_n < 0):
        raise ValueError(
            f"shape mismatch: qvecs {tuple(qvecs.shape)}, qbms "
            f"{tuple(qbms.shape)}, candidates {tuple(cand_dists.shape)} / "
            f"{tuple(cand_ids.shape)}, dvec {tuple(dvec.shape)}, dnorms "
            f"{tuple(dnorms.shape)}, dbm {tuple(dbm.shape)}, tomb_words "
            f"{tuple(tomb_words.shape)}, base_n {base_n}")
    dev = qvecs.device
    if all(t.device.type == "cpu" for t in tensors):
        return fused_live_plain(qvecs, qbms, cand_dists, cand_ids, dvec,
                                dnorms, dbm, tomb_words, base_n=base_n,
                                sel=sel, pred=pred, k=k)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"fused_live inputs must share one cuda or cpu "
                         f"device; got {sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_live inputs must be contiguous")
    ns = nd if sel is None else sel.shape[0]
    if (base_n + nd >= 2 ** 31 - 2 ** 16 or kb + ns >= 2 ** 31 - 2 ** 16
            or tomb_words.shape[0] >= 2 ** 26):
        raise ValueError(f"fused_live takes fewer than 2^31 ids and "
                         f"candidates; got base_n {base_n}, ND {nd}, KB {kb}")
    lib = _build.library()
    _check_smem("fused_live", lib, d, w, k)
    dists = torch.empty((q, k), dtype=torch.float32, device=dev)
    ids = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return dists, ids
    if k > MAX_K:
        _fused_live_large(lib, dev, tensors[:8], sel, base_n, pred, k,
                          dists, ids)
        _build.count_launch(fused_live_accum)
        return dists, ids
    splits = 0 if ns == 0 else splits_for(ns)
    rows = max(1, -(-ns // max(splits, 1)))
    splits = -(-ns // rows)
    part_d = torch.empty((1 + splits, q, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((1 + splits, q, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fused_live_launch(
            qvecs.data_ptr(), qbms.data_ptr(), cand_dists.data_ptr(),
            cand_ids.data_ptr(), kb, dvec.data_ptr(), dnorms.data_ptr(),
            dbm.data_ptr(), None if sel is None else sel.data_ptr(), ns,
            base_n, tomb_words.data_ptr(), tomb_words.shape[0],
            part_d.data_ptr(), part_i.data_ptr(), q, d, w, pred, k, rows,
            stream)
        _build.check(code, "fused_live")
    _build.check(_merge_launch(lib, dev, part_d, part_i, dists, ids, k, True),
                 "fused_live")
    _build.count_launch(fused_live_accum)
    return dists, ids


fused_live_accum.launches = 0


def _fused_live_large(lib, dev, tensors, sel, base_n: int, pred: int,
                      k: int, dists, ids) -> None:
    """`fused_live_accum` for k > MAX_K on `dev`, into dists/ids [Q, k]:
    per query chunk, keys over the KB base slots and the NS scanned delta
    rows, then the select (`csrc/fused_live.cu`'s
    `fused_live_large_launch`)."""
    qvecs, qbms, cand_dists, cand_ids, dvec, dnorms, dbm, tomb_words = tensors
    q, d = qvecs.shape
    w = dbm.shape[1]
    kb = cand_ids.shape[1]
    ns = dvec.shape[0] if sel is None else sel.shape[0]
    m = kb + ns
    if m == 0:
        dists.fill_(PAD_SCORE)
        ids.fill_(-1)
        return
    stride = -(-m // 4) * 4
    qc = max(1, min(q, LARGE_KEYS // stride, 65535))
    keys = torch.empty((qc, stride), dtype=torch.int32, device=dev)
    ws = _select_workspace(lib, dev, _chunks(q, qc), m, k)
    rows = max(1, -(-ns // splits_for(ns))) if ns else 1
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s in range(0, q, qc):
            e = min(q, s + qc)
            code = lib.fused_live_large_launch(
                qvecs[s:e].data_ptr(), qbms[s:e].data_ptr(),
                cand_dists[s:e].data_ptr(), cand_ids[s:e].data_ptr(), kb,
                dvec.data_ptr(), dnorms.data_ptr(), dbm.data_ptr(),
                None if sel is None else sel.data_ptr(), ns, base_n,
                tomb_words.data_ptr(), tomb_words.shape[0], keys.data_ptr(),
                ws.data_ptr(), dists[s:e].data_ptr(), ids[s:e].data_ptr(),
                e - s, d, w, pred, k, rows, stream)
            _build.check(code, "fused_live")
