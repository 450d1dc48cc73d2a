"""ANN dataset container: vectors + label sets + group structure (host).

Vectors are stored **reordered by label-set group** (all vectors sharing
an identical label set are contiguous), which makes Equality selectivity
an O(1) group lookup — the paper's "precomputed set-count table". The
arrays are numpy, byte-identical to the JAX package's for the same
inputs; `repro_torch.ann.index.FilteredIndex` uploads them to a device.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import numpy as np

from repro_torch.ann import labels as lb
from repro_torch.ann.predicates import Predicate, eval_predicate_np


def sha1_file(path: str, block: int = 1 << 22) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(block)
            if not chunk:
                return h.hexdigest()
            h.update(chunk)


@dataclasses.dataclass
class ANNDataset:
    name: str
    vectors: np.ndarray            # [N, d] float32, group-sorted order
    bitmaps: np.ndarray            # [N, W] uint32, group-sorted order
    universe: int                  # |U|
    group_of: np.ndarray           # [N] int32 group id per vector
    group_bitmaps: np.ndarray      # [G, W] uint32 (one per unique label set)
    group_start: np.ndarray        # [G] int32 start offset in sorted order
    group_size: np.ndarray         # [G] int32
    group_lookup: dict             # bitmap bytes -> group id (host-side hash)
    norms_sq: np.ndarray           # [N] float32 squared L2 norms

    @staticmethod
    def build(name: str, vectors: np.ndarray,
              label_sets: Sequence[Sequence[int]], universe: int) -> "ANNDataset":
        vectors = np.asarray(vectors, dtype=np.float32)
        if len(label_sets) != vectors.shape[0]:
            raise ValueError(f"{len(label_sets)} label sets for "
                             f"{vectors.shape[0]} vectors")
        bitmaps = lb.pack_label_sets(label_sets, universe)
        return ANNDataset.from_packed(name, vectors, bitmaps, universe)

    @staticmethod
    def from_packed(name: str, vectors: np.ndarray, bitmaps: np.ndarray,
                    universe: int, *, return_order: bool = False):
        """Group-sorted construction from already-packed bitmaps: group
        ids by first appearance of a bitmap, rows stably sorted by
        group. Rows that are already group-sorted keep their order, which
        `LiveFilteredIndex.compact` relies on.

        With `return_order=True` also returns the [N] permutation where
        `order[i]` is the input row of output row `i` (the id remap a
        live compaction translates tombstones through)."""
        vectors = np.asarray(vectors, dtype=np.float32)
        bitmaps = np.asarray(bitmaps, dtype=np.uint32)
        n = vectors.shape[0]
        if bitmaps.shape[0] != n:
            raise ValueError(f"{bitmaps.shape[0]} bitmaps for {n} vectors")
        lookup: dict[bytes, int] = {}
        gid = np.empty(n, dtype=np.int32)
        for i in range(n):
            k = lb.bitmap_key(bitmaps[i])
            if k not in lookup:
                lookup[k] = len(lookup)
            gid[i] = lookup[k]
        order = np.argsort(gid, kind="stable")
        vectors = vectors[order]
        bitmaps = bitmaps[order]
        gid = gid[order]
        g = len(lookup)
        group_bitmaps = np.zeros((g, bitmaps.shape[1]), dtype=np.uint32)
        starts = np.searchsorted(gid, np.arange(g), side="left").astype(np.int32)
        ends = np.searchsorted(gid, np.arange(g), side="right").astype(np.int32)
        for k, j in lookup.items():
            group_bitmaps[j] = np.frombuffer(k, dtype=np.uint32)
        ds = ANNDataset(
            name=name, vectors=vectors, bitmaps=bitmaps, universe=universe,
            group_of=gid, group_bitmaps=group_bitmaps,
            group_start=starts, group_size=(ends - starts).astype(np.int32),
            group_lookup=lookup,
            norms_sq=np.sum(vectors.astype(np.float64) ** 2, axis=1).astype(np.float32),
        )
        return (ds, order) if return_order else ds

    @property
    def n(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])

    @property
    def n_groups(self) -> int:
        return int(self.group_bitmaps.shape[0])

    def row_slice(self, start: int, stop: int,
                  name: str | None = None) -> "ANNDataset":
        """Contiguous row partition `[start, stop)` as its own dataset.

        Because rows are stored group-sorted, a contiguous slice is itself
        group-sorted, so the slice preserves row order exactly: local row
        `i` of the shard is global row `start + i` of the parent. This is
        what `ShardedFilteredIndex` relies on to globalise per-shard ids
        with a plain offset. Group tables (bitmaps/start/size/lookup) are
        rebuilt for the groups the slice intersects; a group cut by the
        boundary keeps only its in-slice rows. Vectors, bitmaps and norms
        are views of the parent's arrays.

        Raises ValueError on an empty/out-of-range slice or if the rows
        are not group-sorted (never the case for `build`/`synthesize`
        outputs).
        """
        start, stop = int(start), int(stop)
        if not (0 <= start < stop <= self.n):
            raise ValueError(
                f"row_slice [{start}, {stop}) out of range for n={self.n}")
        gids = self.group_of[start:stop]
        if np.any(np.diff(gids) < 0):
            raise ValueError("row_slice requires group-sorted row order")
        uniq = np.unique(gids)                     # sorted = slice order
        new_gid = np.searchsorted(uniq, gids).astype(np.int32)
        g = uniq.size
        starts = np.searchsorted(new_gid, np.arange(g),
                                 side="left").astype(np.int32)
        ends = np.searchsorted(new_gid, np.arange(g),
                               side="right").astype(np.int32)
        group_bitmaps = self.group_bitmaps[uniq].copy()
        lookup = {lb.bitmap_key(group_bitmaps[j]): j for j in range(g)}
        return ANNDataset(
            name=name or f"{self.name}[{start}:{stop}]",
            vectors=self.vectors[start:stop], bitmaps=self.bitmaps[start:stop],
            universe=self.universe, group_of=new_gid,
            group_bitmaps=group_bitmaps, group_start=starts,
            group_size=(ends - starts).astype(np.int32), group_lookup=lookup,
            norms_sq=self.norms_sq[start:stop])

    def group_id_of_bitmap(self, query_bm: np.ndarray) -> int:
        """Exact-match group id for a query label set; -1 if absent."""
        return self.group_lookup.get(lb.bitmap_key(query_bm), -1)

    def selectivity(self, query_bm: np.ndarray, pred: Predicate) -> float:
        """Fraction of base vectors satisfying the predicate, evaluated
        over groups weighted by group size."""
        pred = Predicate(pred)
        if pred == Predicate.EQUALITY:
            g = self.group_id_of_bitmap(query_bm)
            return 0.0 if g < 0 else float(self.group_size[g]) / self.n
        ok = eval_predicate_np(self.group_bitmaps, query_bm[None, :], pred)
        return float(self.group_size[ok].sum()) / self.n

    def matching_mask(self, query_bm: np.ndarray, pred: Predicate) -> np.ndarray:
        """Boolean [N] mask of predicate-passing vectors (host-side)."""
        ok = eval_predicate_np(self.group_bitmaps, query_bm[None, :], Predicate(pred))
        return ok[self.group_of]


@dataclasses.dataclass
class QuerySet:
    """A batch of filtered queries of a single predicate type."""
    dataset: str
    pred: Predicate
    vectors: np.ndarray        # [Q, d] float32
    bitmaps: np.ndarray        # [Q, W] uint32
    ground_truth: np.ndarray   # [Q, k] int32 ids into dataset order, -1 pad
    k: int

    @property
    def q(self) -> int:
        return int(self.vectors.shape[0])


def ground_truth_topk(ds: ANNDataset, qvecs: np.ndarray, qbms: np.ndarray,
                      pred: Predicate, k: int) -> np.ndarray:
    """Brute-force masked exact top-k on the host (recall = 1).

    Returns [Q, k] int32 ids, padded with -1 where fewer than k vectors
    satisfy the predicate.
    """
    qvecs = np.asarray(qvecs, dtype=np.float32)
    nq = qvecs.shape[0]
    out = np.full((nq, k), -1, dtype=np.int32)
    for qi in range(nq):
        mask = ds.matching_mask(qbms[qi], pred)
        idx = np.nonzero(mask)[0]
        if idx.size == 0:
            continue
        cand = ds.vectors[idx]
        d = ds.norms_sq[idx] - 2.0 * cand @ qvecs[qi]
        take = min(k, idx.size)
        part = np.argpartition(d, take - 1)[:take]
        part = part[np.argsort(d[part], kind="stable")]
        out[qi, :take] = idx[part]
    return out


def recall_at_k(result_ids: np.ndarray, gt_ids: np.ndarray) -> np.ndarray:
    """Per-query recall@k per paper Eq. (2): |R ∩ TopK| / min(k, |TopK|)."""
    nq, k = gt_ids.shape
    rec = np.zeros(nq, dtype=np.float64)
    for qi in range(nq):
        gt = set(int(i) for i in gt_ids[qi] if i >= 0)
        if not gt:
            rec[qi] = 1.0  # no valid candidates: vacuous query
            continue
        got = set(int(i) for i in result_ids[qi] if i >= 0)
        rec[qi] = len(got & gt) / min(k, len(gt))
    return rec
