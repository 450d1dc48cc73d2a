"""ANN dataset container: vectors + label sets + group structure (host).

Vectors are stored **reordered by label-set group** (all vectors sharing
an identical label set are contiguous), which makes Equality selectivity
an O(1) group lookup — the paper's "precomputed set-count table". The
arrays are numpy, byte-identical to the JAX package's for the same
inputs; `repro_torch.ann.index.FilteredIndex` uploads them to a device.

A sealed dataset persists as an on-disk segment (`save_segment` /
`load_segment`), in the JAX package's format: a segment written by
either package opens in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Sequence

import numpy as np

from repro_torch.ann import labels as lb
from repro_torch.ann.predicates import Predicate, eval_predicate_np

# On-disk segment format (one directory per sealed generation): .npy
# array files + a segment.json manifest with per-file sha1 checksums,
# readable zero-copy via np.memmap. Version 2 adds word-level RLE for the
# per-row label bitmaps (rows are group-sorted, so each bitmap column is
# about G runs); files record their "encoding" and v1 segments (all raw)
# load unchanged. The strings are the JAX package's, so either package
# reads the other's segments.
SEGMENT_FORMAT = "repro.ann-segment"
SEGMENT_VERSION = 2
SEGMENT_META = "segment.json"
_SEGMENT_ARRAYS = ("vectors", "bitmaps", "norms_sq", "group_of",
                   "group_bitmaps", "group_start", "group_size")
_RLE_FIELDS = ("bitmaps",)          # the [N, W] bitmaps dominate label bytes
_RLE_ENCODING = "rle-u32-colmajor"


def rle_encode_words(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Column-major word-level run-length encoding of a [N, W] uint32
    array. Returns (values u32, counts) with ``np.repeat(values, counts)``
    reproducing ``arr.T.ravel()``; counts take the smallest unsigned
    dtype that holds the longest run."""
    flat = np.ascontiguousarray(arr.T).ravel()
    if flat.size == 0:
        return (np.empty(0, np.uint32), np.empty(0, np.int64))
    edge = np.flatnonzero(np.diff(flat)) + 1
    starts = np.concatenate(([0], edge))
    counts = np.diff(np.concatenate((starts, [flat.size])))
    for dt in (np.uint16, np.uint32):
        if counts.max() <= np.iinfo(dt).max:
            counts = counts.astype(dt)
            break
    else:
        counts = counts.astype(np.int64)
    return flat[starts].astype(np.uint32), counts


def rle_decode_words(values: np.ndarray, counts: np.ndarray,
                     shape: tuple[int, int]) -> np.ndarray:
    """Inverse of `rle_encode_words`: exact [N, W] uint32 round-trip.
    Raises ValueError when the stream does not decode to `shape`."""
    n, w = int(shape[0]), int(shape[1])
    flat = np.repeat(values.astype(np.uint32), counts)
    if flat.size != n * w:
        raise ValueError(
            f"RLE stream decodes to {flat.size} words; shape "
            f"{(n, w)} needs {n * w} (torn or corrupt segment)")
    return np.ascontiguousarray(flat.reshape(w, n).T)


def sha1_file(path: str, block: int = 1 << 22) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(block)
            if not chunk:
                return h.hexdigest()
            h.update(chunk)


def fsync_path(path: str) -> None:
    """fsync a file or directory: durable before a manifest commit may
    reference it."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


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

    # ---- durable segment files (repro_torch.ann.store) -----------------
    def save_segment(self, dirpath: str) -> dict:
        """Write this dataset as an immutable on-disk segment: one
        ``.npy`` file per array plus a ``segment.json`` manifest with
        shapes and per-file sha1 checksums. The [N, W] label bitmaps are
        stored RLE-encoded (``.rle.npz``) when that is smaller than raw,
        else raw. Everything is fsynced before the call returns. Returns
        the manifest dict."""
        os.makedirs(dirpath, exist_ok=True)
        files = {}
        for field in _SEGMENT_ARRAYS:
            arr = np.ascontiguousarray(getattr(self, field))
            encoding = "raw"
            if field in _RLE_FIELDS and arr.ndim == 2:
                values, counts = rle_encode_words(arr)
                if values.nbytes + counts.nbytes < arr.nbytes:
                    encoding = _RLE_ENCODING
            if encoding == _RLE_ENCODING:
                fname = f"{field}.rle.npz"
                fpath = os.path.join(dirpath, fname)
                np.savez(fpath, values=values, counts=counts)
            else:
                fname = f"{field}.npy"
                fpath = os.path.join(dirpath, fname)
                np.save(fpath, arr)
            files[field] = {"file": fname, "sha1": sha1_file(fpath),
                            "bytes": os.path.getsize(fpath),
                            "shape": list(arr.shape),
                            "dtype": str(arr.dtype),
                            "encoding": encoding}
        meta = {
            "format": SEGMENT_FORMAT,
            "version": SEGMENT_VERSION,
            "name": self.name,
            "n": self.n,
            "dim": self.dim,
            "universe": self.universe,
            "width": int(self.bitmaps.shape[1]),
            "n_groups": self.n_groups,
            "files": files,
        }
        tmp = os.path.join(dirpath, SEGMENT_META + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(dirpath, SEGMENT_META))
        for field in _SEGMENT_ARRAYS:
            fsync_path(os.path.join(dirpath, files[field]["file"]))
        fsync_path(dirpath)
        return meta

    @staticmethod
    def load_segment(dirpath: str, *, mmap: bool = True,
                     verify: bool = False) -> "ANNDataset":
        """Open a segment written by `save_segment` (either package's).

        With ``mmap=True`` (default) every raw array is an ``np.memmap``
        view of its file (RLE-encoded bitmaps decode into memory);
        ``FilteredIndex`` uploads either to its device. ``verify=True``
        re-hashes every file against its recorded sha1. Raises ValueError
        for a directory that is not a segment, a newer version, a file
        whose size or checksum disagrees, or an unknown encoding."""
        meta_path = os.path.join(dirpath, SEGMENT_META)
        if not os.path.exists(meta_path):
            raise ValueError(f"{dirpath!r} is not a segment directory "
                             f"(no {SEGMENT_META})")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("format") != SEGMENT_FORMAT:
            raise ValueError(
                f"{dirpath!r} is not a {SEGMENT_FORMAT} segment "
                f"(format={meta.get('format')!r})")
        if int(meta.get("version", -1)) > SEGMENT_VERSION:
            raise ValueError(
                f"segment version {meta['version']} is newer than "
                f"supported version {SEGMENT_VERSION}")
        arrays = {}
        for field in _SEGMENT_ARRAYS:
            info = meta["files"][field]
            fpath = os.path.join(dirpath, info["file"])
            size = os.path.getsize(fpath)
            if size != info["bytes"]:
                raise ValueError(
                    f"segment file {fpath!r} is {size} bytes; manifest "
                    f"records {info['bytes']} (torn or corrupt segment)")
            if verify and sha1_file(fpath) != info["sha1"]:
                raise ValueError(
                    f"segment file {fpath!r} fails its sha1 checksum")
            encoding = info.get("encoding", "raw")
            if encoding == _RLE_ENCODING:
                with np.load(fpath) as z:
                    arrays[field] = rle_decode_words(
                        z["values"], z["counts"], info["shape"])
            elif encoding == "raw":
                arrays[field] = np.load(fpath,
                                        mmap_mode="r" if mmap else None)
            else:
                raise ValueError(
                    f"segment file {fpath!r} uses unknown encoding "
                    f"{encoding!r} (newer writer?)")
        lookup = {lb.bitmap_key(np.ascontiguousarray(bm)): j
                  for j, bm in enumerate(arrays["group_bitmaps"])}
        return ANNDataset(name=meta["name"], universe=int(meta["universe"]),
                          group_lookup=lookup, **arrays)

    @property
    def n(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])

    @property
    def n_groups(self) -> int:
        return int(self.group_bitmaps.shape[0])

    def cache_key(self) -> tuple:
        """Stable content-identity key for cross-module caches (the
        JAX package's key: the same arrays give the same key in both).

        Metadata alone (name/shape/universe) aliases distinct datasets, and
        id() keys can be recycled after GC — so fold in a fingerprint of
        strided vector/bitmap/group samples. Computed once and memoised on
        the instance.
        """
        key = getattr(self, "_cache_key", None)
        if key is None:
            h = hashlib.sha1()
            for a in (self.vectors[:: max(1, self.n // 64)],
                      self.bitmaps[:: max(1, self.n // 64)],
                      self.group_size):
                h.update(np.ascontiguousarray(a).tobytes())
            key = (self.name, self.n, self.dim, self.universe,
                   self.n_groups, h.hexdigest())
            object.__setattr__(self, "_cache_key", key)
        return key

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
