"""Live index — streaming upserts and deletes over a sealed base, on one
torch device.

`LiveFilteredIndex` turns the frozen `FilteredIndex` serving handle into
a mutable one without giving up the batched read path:

* **delta segment** (`DeltaSegment`) — an append-only, host-growable
  store of upserted vectors and bitmaps, mirrored to the device in fixed
  `chunk`-row blocks (sealed chunks upload once; the partial tail chunk
  is padded with sentinel rows and re-uploaded when the watermark moves);
* **tombstone bitmap** — one bool per id over base + delta; `delete()`
  marks ids dead and bumps a version so snapshots stay consistent;
* **snapshot epochs** (`LiveSnapshot`) — a consistent read view: the
  delta high-watermark plus a tombstone copy, pinned to its base
  *generation* so an in-flight batch keeps its base alive across a
  concurrent `compact()`;
* **background compaction** — `compact()` folds the surviving base and
  delta rows into a fresh group-sorted `ANNDataset` (the construction
  `ANNDataset.build` uses, so upsert-everything-then-compact equals
  building the index directly), grafts or rebuilds the old base's method
  indexes in a worker thread, and swaps the base under the generation
  counter while old-epoch readers drain.

The read path runs the routed method on the base, overfetched by the
base tombstone count (`_bucket(k + dead)`, so deleted rows cannot crowd
live ones out of the top-k), then folds the base candidates and the
delta rows through **one fused kernel** (`ops.fused_live_topk`, the
hand-written CUDA `fused_live` kernel on a card): it scans the delta
mirror, applies the packed tombstone words to both candidate sets and
keeps one running top-k. Once the delta outgrows `delta_prune_min_rows`,
sealed chunks' mini-IVF indexes (`ChunkIndex`) drop clusters whose exact
ball or label bounds prove they cannot reach any query's top-k
(`ops.fused_live_topk_select`); the partial tail chunk is always
scanned. The three-stage path (`masked_topk` overfetch, host tombstone
mask, `merge_topk`) stays as `_run_staged`, the parity reference, equal
to the fused path bit for bit on the card. Ids are per-generation row
ids: base rows keep their dataset row id, delta rows take
`base_n + insertion_order`; compaction remaps both (`last_remap()`).

Compaction **grafts** where it can: each built method index of the old
base is spliced onto the compacted dataset through `Method.graft_index`
(IVF lists carry surviving rows through the id remap with frozen
centroids), with a full build for methods that do not graft.

`ShardedLiveIndex` scales the same surface across row shards: upserts
round-robin over per-shard live handles, a read pins one cross-shard
epoch (`ShardedLiveSnapshot`), fans out to the shards' fused reads and
folds their globalised candidates through `ops.merge_topk`, and
compaction rebuilds globally and re-shards.

`RouterService` and `AsyncBatchQueue` serve these handles as they serve a
sealed one (`ShardedRouterService` the sharded one); routing features
stay fresh through `live_stats()`, which `repro_torch.core.features`
reads (live per-label counts and exact live selectivity corrections).

Both handles take a write-ahead log (`attach_wal`): every write is
logged before the state mutates and made durable off the write lock, and
each compaction logs a barrier at its snapshot point, so
`repro_torch.ann.store.IndexStore` replays a handle exactly.

Both report to the serving-ops layer as the JAX package's do. A
`LiveFilteredIndex` registers pull gauges on the process resource ledger
(`repro_torch.ann.ledger`: generation, delta rows and bytes on the host
and on the device, tombstones, pinned readers, retired generations),
holds a `snapshot_pin` lease for every snapshot until its release and a
`retired_generation` lease for every superseded base that readers still
pin. Under an active trace (`repro_torch.ann.trace`) a read opens
`live.base` (annotated with the base overfetch), `live.delta` and, on
the staged path, `live.merge`; `ShardedLiveIndex` opens one `shard` span
a shard. These spans keep the JAX package's boundaries and read the
host's clock: on a card a span around a launch measures the enqueue plus
any device-to-host copy inside it (the read's results come back to the
host within `live.base` and `live.delta`), not the device's own time.
No span adds a synchronisation of its own.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.ann import engine as engine_mod
from repro_torch.ann import labels as lb
from repro_torch.ann import ledger as ledger_mod
from repro_torch.ann import registry as registry_mod
from repro_torch.ann import trace
from repro_torch.ann.dataset import ANNDataset
from repro_torch.ann.distributed import shard_bounds, shard_devices
from repro_torch.ann.engine import ParamSetting, resolve_setting, to_device
from repro_torch.ann.index import (FilteredIndex, QueryBatch, SearchResult,
                                   exact_distances, resolve_device)
from repro_torch.ann.ivf import assign_to_centroids, kmeans
from repro_torch.ann.predicates import Predicate
from repro_torch.ann.sharded import merge_candidates, stack_candidates
from repro_torch.kernels import masked_topk as mk
from repro_torch.kernels import ops

DEFAULT_DELTA_CHUNK = 512


def _bucket(k: int, mult: int = 8) -> int:
    """Round up to a multiple of `mult`: the overfetch width follows the
    tombstone count, bucketed as the JAX package buckets it."""
    return ((int(k) + mult - 1) // mult) * mult


def _label_counts(bitmaps: np.ndarray, universe: int,
                  weights: np.ndarray | None = None) -> np.ndarray:
    """[U] per-label carrier counts from packed [N, W] bitmaps."""
    if bitmaps.shape[0] == 0:
        return np.zeros(universe, dtype=np.int64)
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((bitmaps[:, :, None] >> shifts) & np.uint32(1)).astype(np.int64)
    bits = bits.reshape(bitmaps.shape[0], -1)[:, :universe]
    if weights is not None:
        bits = weights[:, None] * bits
    return bits.sum(0)


class KeyTable:
    """Vectorised open-addressing map: int64 external key -> int64 row.

    Lookups and inserts run as numpy linear-probe loops over whole
    batches, so `rows_of`/`delete_keys` stay flat for multi-million-row
    deltas. Power-of-two table kept at <= 0.5 load; re-inserting an
    existing key overwrites its row (a re-used key maps to its newest
    row).
    """

    __slots__ = ("_keys", "_rows", "_used", "_mask", "_count")

    def __init__(self, capacity_hint: int = 64):
        size = 1 << max(4, int(2 * max(capacity_hint, 1) - 1).bit_length())
        self._keys = np.zeros(size, np.int64)
        self._rows = np.zeros(size, np.int64)
        self._used = np.zeros(size, bool)
        self._mask = size - 1
        self._count = 0

    def __len__(self) -> int:
        return self._count

    @staticmethod
    def _hash(keys: np.ndarray, mask: int) -> np.ndarray:
        """splitmix64 finalizer — avalanche for sequential key ranges."""
        h = keys.astype(np.uint64)
        h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        h = h ^ (h >> np.uint64(31))
        return (h & np.uint64(mask)).astype(np.int64)

    def _grow_to(self, need: int) -> None:
        if 2 * need <= self._mask + 1:
            return
        old_keys = self._keys[self._used]
        old_rows = self._rows[self._used]
        size = 1 << int(2 * need - 1).bit_length()
        self._keys = np.zeros(size, np.int64)
        self._rows = np.zeros(size, np.int64)
        self._used = np.zeros(size, bool)
        self._mask = size - 1
        self._count = 0
        if old_keys.size:
            self.insert(old_keys, old_rows)

    def insert(self, keys, rows) -> None:
        """Batch upsert. Duplicate keys *within* one batch resolve
        last-wins (callers pass unique keys; upsert validates)."""
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        rows = np.ascontiguousarray(rows, dtype=np.int64)
        if keys.size == 0:
            return
        self._grow_to(self._count + keys.size)
        idx = self._hash(keys, self._mask)
        pending = np.arange(keys.size)
        guard = 0
        while pending.size:
            cur = idx[pending]
            used = self._used[cur]
            ours = used & (self._keys[cur] == keys[pending])
            attempt = ~used | ours
            if attempt.any():
                a = pending[attempt]
                c = cur[attempt]
                was_free = ~used[attempt]
                self._keys[c] = keys[a]
                self._rows[c] = rows[a]
                self._used[c] = True
                # entries that lost a same-slot race re-probe; numpy
                # duplicate-index assignment leaves the last writer's key
                won = self._keys[c] == keys[a]
                self._rows[c[won]] = rows[a[won]]
                self._count += int((was_free & won).sum())
                done = np.zeros(pending.size, bool)
                done[np.nonzero(attempt)[0][won]] = True
                pending = pending[~done]
            idx[pending] = (idx[pending] + 1) & self._mask
            guard += 1
            if guard > self._mask + 2:       # load <= 0.5 makes this unreachable
                raise RuntimeError("KeyTable probe loop did not terminate")

    def lookup(self, keys) -> np.ndarray:
        """[R] rows for keys; −1 where the key was never inserted."""
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        out = np.full(keys.shape, -1, np.int64)
        if keys.size == 0 or self._count == 0:
            return out
        idx = self._hash(keys, self._mask)
        pending = np.arange(keys.size)
        guard = 0
        while pending.size:
            cur = idx[pending]
            used = self._used[cur]
            hit = used & (self._keys[cur] == keys[pending])
            out[pending[hit]] = self._rows[cur[hit]]
            pending = pending[used & ~hit]    # empty slot => key absent
            idx[pending] = (idx[pending] + 1) & self._mask
            guard += 1
            if guard > self._mask + 2:
                raise RuntimeError("KeyTable probe loop did not terminate")
        return out


@dataclasses.dataclass(frozen=True)
class ChunkIndex:
    """Mini-IVF over one sealed delta chunk: coarse k-means centroids
    plus chunk-local posting lists, built once at chunk-seal time.

    `radius[c]` upper-bounds (in f64, rounded up) the L2 distance from
    `centroids[c]` to every member, so `max(0, ‖q−c‖ − radius)²` is an
    exact lower bound on any member's squared distance to q — the
    pruning test of the fused read path. `label_union[c]` /
    `label_inter[c]` are the bitwise OR / AND of the members' label
    bitmaps — exact label bounds, so a cluster that cannot hold a
    predicate-matching row is pruned even where the distance bound
    cannot fire. Both are None on an index built without bitmaps; such
    chunks skip label pruning."""

    centroids: np.ndarray   # [C, d] f32
    cnorms: np.ndarray      # [C] f64 squared centroid norms
    radius: np.ndarray      # [C] f64 cover radii (rounded up)
    members: np.ndarray     # [chunk] i32 chunk-local rows, cluster-grouped
    starts: np.ndarray      # [C+1] i32 posting-list offsets into members
    label_union: np.ndarray | None = None   # [C, W] u32 OR of member labels
    label_inter: np.ndarray | None = None   # [C, W] u32 AND of member labels

    def arrays(self) -> dict:
        out = {"centroids": self.centroids, "cnorms": self.cnorms,
               "radius": self.radius, "members": self.members,
               "starts": self.starts}
        if self.label_union is not None:
            out["label_union"] = self.label_union
            out["label_inter"] = self.label_inter
        return out

    @classmethod
    def from_arrays(cls, arrays: dict) -> "ChunkIndex":
        out = {f: np.asarray(arrays[f])
               for f in ("centroids", "cnorms", "radius",
                         "members", "starts")}
        for f in ("label_union", "label_inter"):
            if f in arrays:
                out[f] = np.asarray(arrays[f])
        return cls(**out)


def build_chunk_index(vectors: np.ndarray, *, bitmaps: np.ndarray = None,
                      n_clusters: int = 8, seed: int = 0) -> ChunkIndex:
    """Build the mini-IVF for one sealed chunk (deterministic per seed, the
    JAX package's arrays for the same rows). With `bitmaps` ([n, W] u32
    member label bitmaps) the index also carries exact per-cluster label
    union/intersection bounds for predicate pruning."""
    n = vectors.shape[0]
    c = max(1, min(int(n_clusters), n))
    cent = kmeans(vectors, c, iters=4, seed=seed)
    assign = assign_to_centroids(vectors, cent)
    order = np.argsort(assign, kind="stable").astype(np.int32)
    lens = np.bincount(assign, minlength=cent.shape[0])
    starts = np.zeros(cent.shape[0] + 1, np.int32)
    starts[1:] = np.cumsum(lens)
    centf = cent.astype(np.float64)
    diff = vectors.astype(np.float64) - centf[assign]
    dist = np.sqrt((diff ** 2).sum(axis=1))
    radius = np.zeros(cent.shape[0], np.float64)
    np.maximum.at(radius, assign, dist)
    radius = radius * (1.0 + 1e-9) + 1e-9    # round up: bound must hold
    union = inter = None
    if bitmaps is not None:
        nc = cent.shape[0]
        w = bitmaps.shape[1]
        union = np.zeros((nc, w), np.uint32)
        # empty clusters read as union=0 / inter=~0: every label test
        # then prunes them, which is safe (their posting list is empty)
        inter = np.full((nc, w), np.uint32(0xFFFFFFFF))
        np.bitwise_or.at(union, assign, bitmaps.astype(np.uint32))
        np.bitwise_and.at(inter, assign, bitmaps.astype(np.uint32))
    return ChunkIndex(cent.astype(np.float32), (centf ** 2).sum(axis=1),
                      radius, order, starts, union, inter)


@dataclasses.dataclass(frozen=True)
class LiveStats:
    """Live-set summary the routing features read (see
    `repro_torch.core.features`): exact live size, per-label carrier
    fractions, and the bitmap rows that correct base selectivity counts
    (subtract tombstoned base rows, add live delta rows). `base_ds` is the
    sealed base the tombstone rows refer to, so a compaction racing the
    feature pass cannot pair generation-g corrections with a
    generation-g+1 base."""
    n_live: int
    label_freq: np.ndarray          # [U] live per-label carrier fractions
    base_tomb_bitmaps: np.ndarray   # [Tb, W] bitmaps of dead base rows
    delta_bitmaps: np.ndarray       # [Dl, W] bitmaps of live delta rows
    base_ds: object = None          # ANNDataset of this snapshot's base


class DeltaSegment:
    """Append-only host store with a chunked device mirror.

    Host arrays grow by doubling; rows never mutate once appended, so
    concurrent readers can slice up to their snapshot watermark without
    locking. The device mirror covers whole `chunk`-row blocks of
    appended data and is extended (one upload per new block) under a
    private lock; `device_view` pads the partial tail chunk with
    sentinel rows (zero vector + `PAD_SCORE` norm, never selected) so the
    kernels see shapes that change only at chunk boundaries.
    """

    def __init__(self, dim: int, width: int, *,
                 chunk: int = DEFAULT_DELTA_CHUNK, device="cuda"):
        self.dim = int(dim)
        self.width = int(width)
        self.chunk = max(1, int(chunk))
        self.device = torch.device(device)     # where the mirror lives
        self._vec = np.empty((0, self.dim), np.float32)
        self._bm = np.empty((0, self.width), np.uint32)
        self._norms = np.empty((0,), np.float32)
        self._rows = 0
        self._dev = None            # (vectors, norms, bitmaps) tensors
        self._dev_rows = 0          # rows covered by the mirror
        self._dev_lock = threading.Lock()
        self._view_cache = None     # (rows, assembled triple)
        self._chunk_idx: list[ChunkIndex] = []   # mini-IVF per sealed chunk

    @property
    def rows(self) -> int:
        return self._rows

    def _grow(self, need: int) -> None:
        cap = self._vec.shape[0]
        if need <= cap:
            return
        new_cap = max(need, max(self.chunk, 2 * cap))
        for name, fill_shape in (("_vec", (new_cap, self.dim)),
                                 ("_bm", (new_cap, self.width)),
                                 ("_norms", (new_cap,))):
            old = getattr(self, name)
            new = np.zeros(fill_shape, old.dtype)
            new[: self._rows] = old[: self._rows]
            setattr(self, name, new)

    def append(self, vectors: np.ndarray,
               bitmaps: np.ndarray) -> tuple[int, int]:
        """Append rows; returns the local id range [start, stop)."""
        n = vectors.shape[0]
        start = self._rows
        self._grow(start + n)
        self._vec[start: start + n] = vectors
        self._bm[start: start + n] = bitmaps
        self._norms[start: start + n] = np.sum(
            vectors.astype(np.float64) ** 2, axis=1).astype(np.float32)
        self._rows = start + n
        return start, start + n

    def host_view(self, rows: int):
        """(vectors, bitmaps, norms) for the first `rows` rows (views —
        valid for any watermark that was reached before the call)."""
        return self._vec[:rows], self._bm[:rows], self._norms[:rows]

    def device_view(self, rows: int):
        """(vectors [R, d] f32, norms [R] f32, bitmaps [R, W] int32) on the
        segment's device covering the first `rows` rows, R = `rows`
        rounded up to a chunk multiple with never-selected sentinel rows.
        Sealed chunks are uploaded once; the view is cached until the
        watermark moves."""
        device = self.device
        full = (rows // self.chunk) * self.chunk
        with self._dev_lock:
            # read-mostly fast path: the assembled triple (including the
            # padded tail) only depends on the watermark
            if self._view_cache is not None and self._view_cache[0] == rows:
                return self._view_cache[1]
            if full > self._dev_rows:
                vec = to_device(self._vec[self._dev_rows: full], device)
                nm = to_device(self._norms[self._dev_rows: full], device)
                bm = to_device(self._bm[self._dev_rows: full], device)
                if self._dev is None:
                    self._dev = (vec, nm, bm)
                else:
                    self._dev = tuple(torch.cat([a, b]) for a, b in
                                      zip(self._dev, (vec, nm, bm)))
                self._dev_rows = full
            dev = self._dev
        parts = [tuple(t[:full] for t in dev)] if full else []
        tail = rows - full
        if tail:
            tv = np.zeros((self.chunk, self.dim), np.float32)
            tb = np.zeros((self.chunk, self.width), np.uint32)
            tn = np.full((self.chunk,), mk.PAD_SCORE, np.float32)
            tv[:tail] = self._vec[full:rows]
            tb[:tail] = self._bm[full:rows]
            tn[:tail] = self._norms[full:rows]
            parts.append((to_device(tv, device), to_device(tn, device),
                          to_device(tb, device)))
        if not parts:
            view = (torch.zeros((0, self.dim), device=device),
                    torch.zeros((0,), device=device),
                    torch.zeros((0, self.width), dtype=torch.int32,
                                device=device))
        elif len(parts) == 1:
            view = parts[0]
        else:
            view = tuple(torch.cat(ts) for ts in zip(*parts))
        with self._dev_lock:
            # the row prefix below `rows` is immutable, so the view only
            # depends on the watermark — safe to reuse until it moves
            self._view_cache = (rows, view)
        return view

    def device_rows(self) -> int:
        return self._dev_rows

    def host_bytes(self) -> int:
        """Allocated host backing (includes growth headroom)."""
        return self._vec.nbytes + self._bm.nbytes + self._norms.nbytes

    def device_bytes(self) -> int:
        """Mirror footprint: vectors + norms + bitmaps per covered row
        (the segment's own tensors, not the process's device total)."""
        return self._dev_rows * (self.dim * 4 + 4 + self.width * 4)

    def drop_device(self) -> None:
        with self._dev_lock:
            self._dev = None
            self._dev_rows = 0
            self._view_cache = None

    # ---- per-chunk mini-IVF ---------------------------------------------
    def chunk_indexes(self, rows: int) -> list[ChunkIndex]:
        """ChunkIndex list covering the sealed chunks below `rows`, built
        lazily on first request after a chunk seals and cached forever
        (sealed chunks are immutable)."""
        want = int(rows) // self.chunk
        if want <= 0:
            return []
        with self._dev_lock:
            vec = self._vec        # row prefix is immutable; see host_view
            bm = self._bm
            while len(self._chunk_idx) < want:
                i = len(self._chunk_idx)
                lo = i * self.chunk
                self._chunk_idx.append(build_chunk_index(
                    vec[lo: lo + self.chunk],
                    bitmaps=bm[lo: lo + self.chunk], seed=i))
            return self._chunk_idx[:want]

    def adopt_chunk_indexes(self, indexes: dict[int, ChunkIndex]) -> None:
        """Install persisted chunk indexes (the store's restore path).
        Only a contiguous prefix extension of the chunks built so far,
        over sealed chunks, is taken; the rest build lazily."""
        with self._dev_lock:
            sealed = self._rows // self.chunk
            for i in sorted(indexes):
                if i == len(self._chunk_idx) and i < sealed:
                    self._chunk_idx.append(indexes[i])

    def built_chunk_indexes(self) -> list[ChunkIndex]:
        """The chunk indexes built so far (no building)."""
        with self._dev_lock:
            return list(self._chunk_idx)


class _StageTimings:
    """Instance facade over the engine's thread-local stage-timing
    accumulator: `run_method` adds `base_s`/`delta_s`/`merge_s`, the
    service layer drains them with `pop_stage_timings` (per thread, so
    pipelined queue workers don't cross-contaminate)."""

    def _stage_add(self, d: dict) -> None:
        for key, val in d.items():
            engine_mod.stage_add(key, val)

    def pop_stage_timings(self) -> dict:
        """Return and clear this thread's accumulated stage timings."""
        return engine_mod.pop_stage_timings()


class _LabelClockMixin:
    """Monotone per-label write clock: every `upsert`/`delete` bumps a
    global write counter and stamps the labels present in the written
    rows with it, so an answer recorded at clock `c` for query labels `L`
    is unaffected by later writes iff `label_clock(L) <= c` (any row that
    can match a predicate over a non-empty label set carries one of
    them). An empty query bitmap compares against the global clock
    (`label_clock(None)`).

    Concrete classes provide `_lock` and `_universe` and call
    `_clock_init()` in `__init__` and `_clock_touch(counts)` under the
    lock on every write. Compaction does not touch the clock: it remaps
    ids but never changes the live row set."""

    def _clock_init(self) -> None:
        self._label_stamps = np.zeros(self._universe, dtype=np.int64)
        self._write_clock = 0

    def _clock_touch(self, counts: np.ndarray) -> None:
        """Stamp the labels with nonzero `counts` ([U] per-label row
        counts of the written rows); caller holds the lock."""
        self._write_clock += 1
        touched = np.nonzero(counts)[0]
        if touched.size:
            self._label_stamps[touched] = self._write_clock

    def label_clock(self, labels=None) -> int:
        """The latest write clock that touched any of `labels` (int
        indices), or the global write clock when `labels` is None/empty.
        Monotone; 0 means "never written"."""
        with self._lock:
            if labels is None:
                return self._write_clock
            labels = np.asarray(labels, dtype=np.int64)
            if labels.size == 0:
                return self._write_clock
            return int(self._label_stamps[labels].max())


class _StableKeyMixin:
    """Stable external keys.

    Concrete classes provide `_lock`, `_keys`, `_next_key`, `n_total`,
    `delete(rows)`, and `_row_live(rows) -> bool[R]`; the mixin owns the
    `KeyTable` lifecycle (`_key_rows`, built lazily by `_key_index`,
    extended on upsert by `_note_new_keys`, dropped to None at the
    compaction swap) and the public key API."""

    def _key_index(self) -> KeyTable:
        """key -> current-generation row table (caller holds the lock).
        Re-used keys map to their newest row."""
        if self._key_rows is None:
            n_tot = self.n_total
            table = KeyTable(max(n_tot, 64))
            if n_tot:
                table.insert(self._keys[:n_tot],
                             np.arange(n_tot, dtype=np.int64))
            self._key_rows = table
        return self._key_rows

    def _note_new_keys(self, ks: np.ndarray, start_row: int) -> None:
        """Extend the key table for freshly appended rows (lock held;
        no-op while the table hasn't been built)."""
        if self._key_rows is not None and ks.size:
            self._key_rows.insert(
                ks, np.arange(start_row, start_row + ks.size,
                              dtype=np.int64))

    def _claim_keys(self, keys, n: int) -> np.ndarray:
        """Validate/assign [n] external keys (caller holds the lock)."""
        if keys is None:
            ks = np.arange(self._next_key, self._next_key + n,
                           dtype=np.int64)
        else:
            ks = np.atleast_1d(np.asarray(keys, dtype=np.int64))
            if ks.shape != (n,):
                raise ValueError(
                    f"upsert keys must be [{n}]; got shape {ks.shape}")
            if np.unique(ks).size != n:
                raise ValueError("upsert keys must be unique per batch")
            rows = self._key_index().lookup(ks)
            known = rows >= 0
            if known.any():
                live = self._row_live(rows[known])
                if live.any():
                    bad_key = int(ks[known][live][0])
                    bad_row = int(rows[known][live][0])
                    raise ValueError(
                        f"key {bad_key} already names a live row (id "
                        f"{bad_row}); delete it first to re-point the key")
        if n:
            self._next_key = max(self._next_key, int(ks.max()) + 1)
        return ks

    def keys_of(self, ids, snapshot=None) -> np.ndarray:
        """Stable external keys for (current-generation or snapshot)
        ids: int64 array of `ids`' shape, −1 where the id is −1. Keys
        survive `compact()`; per-generation ids do not."""
        ids = np.asarray(ids, dtype=np.int64)
        if snapshot is not None:
            keys = snapshot.keys
        else:
            with self._lock:
                keys = self._keys[: self.n_total]
        out = np.full(ids.shape, -1, dtype=np.int64)
        valid = ids >= 0
        if valid.any():
            out[valid] = keys[ids[valid]]
        return out

    def rows_of(self, keys) -> np.ndarray:
        """Current-generation ids for external keys (−1 for a key that
        has never been assigned). A re-used key maps to its newest
        row."""
        keys = np.atleast_1d(np.asarray(keys, dtype=np.int64))
        with self._lock:
            return self._key_index().lookup(keys)

    def delete_keys(self, keys) -> int:
        """Tombstone rows by stable external key; unknown keys raise
        KeyError. Returns the number of newly deleted rows."""
        keys = np.atleast_1d(np.asarray(keys, dtype=np.int64))
        with self._lock:
            rows = self.rows_of(keys)
            if (rows < 0).any():
                missing = keys[rows < 0].tolist()
                raise KeyError(f"unknown external keys: {missing}")
            return self.delete(rows)


class LiveSnapshot:
    """Consistent read epoch over a `LiveFilteredIndex`.

    Captures the delta high-watermark, a tombstone copy, the external-key
    prefix, and the base generation — and *pins* that generation (the
    sealed base handle stays open) until `release()` / the context
    manager exits. Searches handed a snapshot see exactly this state
    whatever `upsert`/`delete`/`compact` calls run meanwhile.
    """

    __slots__ = ("generation", "base_n", "delta_rows", "tombstones",
                 "tombstone_version", "delta", "keys", "next_key",
                 "_owner", "_released", "_lease")

    def __init__(self, owner, generation, base_n, delta_rows, tombstones,
                 tombstone_version, delta, keys, next_key):
        self.generation = generation
        self.base_n = base_n
        self.delta_rows = delta_rows
        self.tombstones = tombstones
        self.tombstone_version = tombstone_version
        self.delta = delta
        self.keys = keys
        self.next_key = next_key
        self._owner = owner
        self._released = False
        self._lease = None          # ledger pin, set by snapshot()

    @property
    def n_total(self) -> int:
        return self.base_n + self.delta_rows

    @property
    def n_live(self) -> int:
        return self.n_total - int(self.tombstones.sum())

    def release(self) -> None:
        """Unpin the snapshot's generation (idempotent, thread-safe). A
        drained, superseded generation frees its base handle here."""
        with self._owner._lock:        # flag flip atomic wrt double release
            if self._released:
                return
            self._released = True
        if self._lease is not None:
            self._lease.release()
        self._owner._release_reader(self.generation)

    def __enter__(self) -> "LiveSnapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return (f"LiveSnapshot(gen={self.generation}, base_n={self.base_n}, "
                f"delta_rows={self.delta_rows}, "
                f"tombstones={int(self.tombstones.sum())})")


class LiveFilteredIndex(_StableKeyMixin, _LabelClockMixin, _StageTimings):
    """Mutable serving handle: sealed base + delta segment + tombstones,
    on one torch device.

    Args:
        ds: the sealed base dataset, or None for an empty live index
            (then `name`/`dim`/`universe` are required — e.g. via the
            `empty` constructor). Routed serving (`RouterService`) needs
            a non-empty base for its dataset-level features; direct
            method search works from empty.
        registry: optional `MethodRegistry` for method-name resolution.
        device: "cuda" (default) or "cpu", for the base handle and the
            delta mirror. With "cuda" and no card, construction raises
            RuntimeError.
        delta_chunk: delta device-mirror block size in rows.
        base_keys: optional [N] int64 stable external keys for the base
            rows (defaults to the row ids 0..N-1).
        next_key: first key `upsert` auto-assigns (defaults past the
            largest base key).
        generation: starting generation counter.
        fused: serve reads through the fused kernel (default); False
            takes the three-stage parity path (`_run_staged`).
        graft: let `compact()` splice built method indexes through
            `Method.graft_index` instead of rebuilding (default).
        delta_prune_min_rows: delta size above which the sealed-chunk
            mini-IVF pruner engages (default `4 * delta_chunk`).
    """

    def __init__(self, ds: ANNDataset | None = None, *, name: str | None = None,
                 dim: int | None = None, universe: int | None = None,
                 registry=None, device="cuda",
                 delta_chunk: int = DEFAULT_DELTA_CHUNK,
                 base_keys: np.ndarray | None = None,
                 next_key: int | None = None, generation: int = 0,
                 fused: bool = True, graft: bool = True,
                 delta_prune_min_rows: int | None = None):
        self.torch_device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if ds is None:
            if name is None or dim is None or universe is None:
                raise ValueError(
                    "an empty LiveFilteredIndex needs name=, dim= and "
                    "universe= (or pass a base ANNDataset)")
            self._name, self._dim = str(name), int(dim)
            self._universe = int(universe)
            self._width = lb.n_words(self._universe)
            self._base_fx: FilteredIndex | None = None
            self._base_n = 0
            base_counts = np.zeros(self._universe, dtype=np.int64)
        else:
            self._name, self._dim = ds.name, ds.dim
            self._universe = ds.universe
            self._width = ds.bitmaps.shape[1]
            self._base_fx = FilteredIndex(ds, registry=registry,
                                          device=self.torch_device)
            self._base_n = ds.n
            base_counts = _label_counts(
                ds.group_bitmaps, ds.universe,
                weights=ds.group_size.astype(np.int64))
        self._registry = registry
        self._delta_chunk = int(delta_chunk)
        self._delta = DeltaSegment(self._dim, self._width, chunk=delta_chunk,
                                   device=self.torch_device)
        self._tomb = np.zeros(self._base_n, bool)
        self._tomb_version = 0
        self._live_label_counts = base_counts
        self._clock_init()
        self._generation = int(generation)
        if base_keys is None:
            self._keys = np.arange(self._base_n, dtype=np.int64)
        else:
            self._keys = np.asarray(base_keys, dtype=np.int64).copy()
            if self._keys.shape != (self._base_n,):
                raise ValueError(
                    f"base_keys must be [{self._base_n}]; got shape "
                    f"{self._keys.shape}")
        self._next_key = int(next_key) if next_key is not None else \
            (int(self._keys.max()) + 1 if self._base_n else 0)
        self._key_rows: KeyTable | None = None   # built lazily
        self._wal = None                          # attached write-ahead log
        self._lock = threading.RLock()
        self._readers: dict[int, int] = {}      # generation -> pin count
        self._retired: dict[int, FilteredIndex | None] = {}
        self._retired_leases: dict[int, object] = {}   # gen -> ledger lease
        self._compact_pool: ThreadPoolExecutor | None = None
        self._compacting: Future | None = None
        self._last_remap: np.ndarray | None = None
        self._features = None       # repro_torch.core.features cache slot
        self.fused = bool(fused)
        self._graft = bool(graft)
        self._delta_prune_min_rows = (4 * self._delta_chunk
                                      if delta_prune_min_rows is None
                                      else int(delta_prune_min_rows))
        self._tomb_words_cache = None   # ((gen, version, n_pad), tensor)
        self._prune_stats = {"calls": 0, "clusters": 0, "pruned": 0,
                             "label_pruned": 0}
        self._closed = False
        # delta/device bytes + reader pins as pull gauges on the process
        # ledger (collected only at scrape/snapshot time)
        self._ledger_key = f"live:{self._name}:{id(self):x}"
        ledger_mod.get_ledger().register_collector(
            self._ledger_key, self._ledger_gauges)

    def _ledger_gauges(self) -> dict:
        with self._lock:
            if self._closed:
                return {"closed": 1}
            d = self._delta
            return {"generation": self._generation,
                    "delta_rows": d.rows,
                    "delta_host_bytes": d.host_bytes(),
                    "delta_device_rows": d.device_rows(),
                    "delta_device_bytes": d.device_bytes(),
                    "tombstones": int(self._tomb.sum()),
                    "pinned_readers": sum(self._readers.values()),
                    "retired_generations": len(self._retired)}

    @classmethod
    def empty(cls, name: str, dim: int, universe: int,
              **kw) -> "LiveFilteredIndex":
        """A live index with no sealed base — everything starts as delta."""
        return cls(None, name=name, dim=dim, universe=universe, **kw)

    @classmethod
    def from_state(cls, state: dict, **kw) -> "LiveFilteredIndex":
        """Open the logical state `export_state` gives — the JAX
        package's `export_state` dict with its `base_ds` given as packed
        arrays: `name`, `universe`, `base_vectors` [N, d] and
        `base_bitmaps` [N, W] (the base's group-sorted rows; N may be 0),
        `base_keys`, `delta_vectors`, `delta_bitmaps`, `delta_keys`,
        `dead_ids`, `next_key` and `generation`. The index answers as the
        one that exported it: the same ids, keys and tombstones. `kw`
        goes to the constructor (`device=`, `registry=`, ...)."""
        bv = np.asarray(state["base_vectors"], np.float32)
        bb = np.asarray(state["base_bitmaps"], np.uint32)
        name, universe = str(state["name"]), int(state["universe"])
        common = dict(next_key=int(state["next_key"]),
                      generation=int(state["generation"]), **kw)
        if bv.shape[0]:
            live = cls(ANNDataset.from_packed(name, bv, bb, universe),
                       base_keys=state["base_keys"], **common)
        else:
            live = cls(None, name=name, dim=bv.shape[1], universe=universe,
                       **common)
        dv = np.asarray(state["delta_vectors"], np.float32)
        dbm = np.asarray(state["delta_bitmaps"], np.uint32)
        dead = np.asarray(state["dead_ids"], np.int64)
        with live._lock:
            live._delta.append(dv, dbm)
            live._tomb = np.zeros(live._base_n + dv.shape[0], bool)
            live._tomb[dead] = True
            live._tomb_version = int(dead.size > 0)
            live._keys = np.concatenate(
                [live._keys, np.asarray(state["delta_keys"], np.int64)])
            live._live_label_counts = (
                live._live_label_counts + _label_counts(dbm, universe)
                - _label_counts(live._bitmaps_of(dead), universe))
        return live

    # ---- lifecycle ------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def ds(self) -> ANNDataset | None:
        """The current generation's sealed base dataset (None when the
        index started empty and has not compacted yet)."""
        fx = self._base_fx
        return None if fx is None else fx.ds

    @property
    def generation(self) -> int:
        return self._generation

    @property
    def base_n(self) -> int:
        return self._base_n

    @property
    def n_total(self) -> int:
        return self._base_n + self._delta.rows

    @property
    def n_live(self) -> int:
        with self._lock:
            return self.n_total - int(self._tomb.sum())

    @property
    def device(self):
        """Base device tensors (the routing features' `selectivity`
        kernel reads their bitmaps). Requires a non-empty base."""
        if self._base_fx is None:
            raise RuntimeError(
                f"LiveFilteredIndex({self._name!r}) has no sealed base yet "
                f"(compact() first, or serve it unrouted)")
        return self._base_fx.device

    def close(self) -> None:
        """Stop the handle: wait out a running compaction (its swap is
        skipped once closed), close the base of every generation, drop
        the delta device mirror. Idempotent."""
        ledger_mod.get_ledger().deregister_collector(self._ledger_key)
        with self._lock:
            if self._closed:
                return
            self._closed = True
            comp = self._compacting
        if comp is not None:
            try:
                comp.result(timeout=300)
            except Exception:       # its failure belongs to its own caller
                pass
        with self._lock:
            if self._base_fx is not None:
                self._base_fx.close()
            for fx in self._retired.values():
                if fx is not None:
                    fx.close()
            self._retired.clear()
            for lease in self._retired_leases.values():
                lease.release()
            self._retired_leases.clear()
            self._delta.drop_device()
            self._tomb_words_cache = None
            self._features = None
        if self._compact_pool is not None:
            self._compact_pool.shutdown(wait=True)
            self._compact_pool = None

    def __enter__(self) -> "LiveFilteredIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                f"LiveFilteredIndex({self._name!r}) is closed")

    # ---- write path -----------------------------------------------------
    def upsert(self, vectors, bitmaps, *, keys=None) -> np.ndarray:
        """Append rows to the delta segment.

        Args:
            vectors: [R, d] (or [d]) float embeddings.
            bitmaps: [R, W] (or [W]) packed uint32 label sets.
            keys: optional [R] int64 stable external keys for the rows
                (auto-assigned sequentially when omitted). A key that
                already names a *live* row is rejected — delete the old
                row first to re-point a key.
        Returns: [R] int64 assigned ids (valid for this generation;
            `compact()` remaps them — `keys_of` gives the stable keys).
        Raises: RuntimeError if closed; ValueError on shape mismatch or
            a duplicate live key.
        """
        vectors = np.asarray(vectors, dtype=np.float32)
        bitmaps = np.asarray(bitmaps, dtype=np.uint32)
        if vectors.ndim == 1:
            vectors = vectors[None]
        if bitmaps.ndim == 1:
            bitmaps = bitmaps[None]
        if vectors.ndim != 2 or vectors.shape[1] != self._dim:
            raise ValueError(
                f"upsert vectors must be [R, {self._dim}]; got "
                f"{vectors.shape}")
        if bitmaps.shape != (vectors.shape[0], self._width):
            raise ValueError(
                f"upsert bitmaps must be [{vectors.shape[0]}, "
                f"{self._width}]; got {bitmaps.shape}")
        # the bit expansion only depends on the arguments — keep it out
        # of the lock so big ingest batches don't stall readers
        counts = _label_counts(bitmaps, self._universe)
        with self._lock:
            self._check_open()
            ks = self._claim_keys(keys, vectors.shape[0])
            wal = self._wal
            if wal is not None:              # logged before applied
                seq = wal.log_upsert(self._generation, ks, vectors, bitmaps)
            start, stop = self._delta.append(vectors, bitmaps)
            self._tomb = np.concatenate(
                [self._tomb, np.zeros(stop - start, bool)])
            self._keys = np.concatenate([self._keys, ks])
            self._note_new_keys(ks, self._base_n + start)
            self._live_label_counts = self._live_label_counts + counts
            self._clock_touch(counts)
            out = np.arange(self._base_n + start, self._base_n + stop,
                            dtype=np.int64)
        if wal is not None:
            wal.commit(seq)                  # durable before acked, off-lock
        return out

    def _row_live(self, rows: np.ndarray) -> np.ndarray:
        """bool[R]: which current-generation rows are not tombstoned
        (mixin hook; caller holds the lock)."""
        return ~self._tomb[rows]

    def delete(self, ids) -> int:
        """Tombstone ids (base or delta rows of the current generation).
        Returns the number of *newly* deleted rows; already-dead ids are
        no-ops. Raises IndexError on out-of-range ids."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        with self._lock:
            self._check_open()
            n_tot = self.n_total
            if ids.size and (ids.min() < 0 or ids.max() >= n_tot):
                raise IndexError(
                    f"delete ids must be in [0, {n_tot}); got range "
                    f"[{ids.min()}, {ids.max()}]")
            wal = self._wal
            if wal is not None:              # replay is idempotent
                seq = wal.log_delete(self._generation, ids)
            fresh = np.unique(ids[~self._tomb[ids]])
            if fresh.size:
                self._tomb[fresh] = True
                self._tomb_version += 1
                dcounts = _label_counts(self._bitmaps_of(fresh),
                                        self._universe)
                self._live_label_counts = self._live_label_counts - dcounts
                self._clock_touch(dcounts)
            out = int(fresh.size)
        if wal is not None:
            wal.commit(seq)                  # durable before acked, off-lock
        return out

    # ---- durability hook (repro_torch.ann.store) ------------------------
    def attach_wal(self, wal) -> None:
        """Attach a write-ahead log: every later `upsert`/`delete`
        appends a record *before* the state mutates (and commits it off
        the lock before returning), and `compact_async` logs a
        compaction barrier at its snapshot point. Pass None to detach.
        The store owns the log (rotation, fsync, close); the handle only
        appends."""
        with self._lock:
            self._wal = wal

    def _bitmaps_of(self, gids: np.ndarray) -> np.ndarray:
        """[R, W] packed bitmaps for current-generation global ids."""
        out = np.zeros((gids.size, self._width), np.uint32)
        base = gids < self._base_n
        if base.any():
            out[base] = self._base_fx.ds.bitmaps[gids[base]]
        if (~base).any():
            out[~base] = self._delta._bm[gids[~base] - self._base_n]
        return out

    def fetch(self, ids, snapshot: LiveSnapshot | None = None) -> np.ndarray:
        """[R, d] vectors for result ids (−1 rows come back as NaN).
        With a snapshot, ids are interpreted in that epoch's id space."""
        snap = snapshot or self.snapshot()
        try:
            ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
            out = np.full((ids.size, self._dim), np.nan, np.float32)
            fx = self._base_for(snap)
            base = (ids >= 0) & (ids < snap.base_n)
            if base.any():
                out[base] = fx.ds.vectors[ids[base]]
            delta = ids >= snap.base_n
            if delta.any():
                dvec, _, _ = snap.delta.host_view(snap.delta_rows)
                out[delta] = dvec[ids[delta] - snap.base_n]
            return out
        finally:
            if snapshot is None:
                snap.release()

    # ---- snapshots / epochs ---------------------------------------------
    def snapshot(self) -> LiveSnapshot:
        """Pin a consistent read epoch (see `LiveSnapshot`). Callers that
        hold one across writes must `release()` it (context manager
        supported); searches without an explicit snapshot take and
        release one internally."""
        with self._lock:
            self._check_open()
            rows = self._delta.rows
            gen = self._generation
            self._readers[gen] = self._readers.get(gen, 0) + 1
            # keys: a view is enough — _keys is only ever *reassigned*
            # (concatenate on upsert, fresh array at the compaction
            # swap), never written in place; tombstones mutate in place
            # and must copy
            snap = LiveSnapshot(self, gen, self._base_n, rows,
                                self._tomb[: self._base_n + rows].copy(),
                                self._tomb_version, self._delta,
                                self._keys[: self._base_n + rows],
                                self._next_key)
        # the pin lease carries the acquiring trace id + caller stack —
        # a snapshot held past the ledger's leak age names its taker
        snap._lease = ledger_mod.get_ledger().acquire(
            "snapshot_pin", self._name, meta={"generation": int(gen)})
        return snap

    def _release_reader(self, gen: int) -> None:
        with self._lock:
            left = self._readers.get(gen, 0) - 1
            if left > 0:
                self._readers[gen] = left
                return
            self._readers.pop(gen, None)
            had_retired = gen in self._retired
            fx = self._retired.pop(gen, None)
            lease = (self._retired_leases.pop(gen, None)
                     if had_retired else None)
        if lease is not None:
            lease.release()
        if fx is not None:
            fx.close()

    def _base_for(self, snap: LiveSnapshot) -> FilteredIndex | None:
        with self._lock:
            if snap.generation == self._generation:
                return self._base_fx
            if snap.generation in self._retired:
                return self._retired[snap.generation]
        raise RuntimeError(
            f"snapshot generation {snap.generation} has been released "
            f"(current generation {self._generation})")

    # ---- read path -------------------------------------------------------
    def _resolve(self, method):
        if isinstance(method, str):
            reg = self._registry or registry_mod.default_registry()
            return reg.get(method)
        return method

    def run_method(self, method, setting: ParamSetting, batch: QueryBatch,
                   *, snapshot: LiveSnapshot | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Raw live execution of one (method, setting): the routed method
        on the base, the delta rows and the tombstones through the fused
        kernel (or the staged path).

        Returns the `FilteredIndex.run_method` contract: ([Q, k] int32
        ids with −1 pad, [Q, k] float32 ranking scores with +inf at −1).
        Stage timings (`base_s`/`delta_s`/`merge_s`) accumulate on a
        thread-local, drained by `pop_stage_timings()`.
        """
        self._check_open()
        snap = snapshot
        if snap is None:
            snap = self.snapshot()
        try:
            if self.fused and snap.delta_rows:
                return self._run_fused(method, setting, batch, snap)
            return self._run_staged(method, setting, batch, snap)
        finally:
            if snapshot is None:
                snap.release()

    def _run_base(self, method, setting, batch: QueryBatch,
                  snap: LiveSnapshot, base_dead: int
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Routed base candidates [Q, KB] (numpy), overfetched by the
        full base tombstone count (bucketed, clamped to the base size) so
        deletions can't crowd out live rows: among the top-(k + dead)
        ranked matches at most `dead` are tombstoned, leaving >= k live
        ones. [Q, 0] for an empty base."""
        fx = self._base_for(snap) if snap.base_n else None
        if fx is None:
            return (np.zeros((batch.q, 0), np.int32),
                    np.zeros((batch.q, 0), np.float32))
        k = batch.k
        kb = (max(k, min(_bucket(k + base_dead), snap.base_n))
              if base_dead else k)
        trace.annotate(overfetch=int(kb))
        b_ids, b_raw = fx.run_method(
            self._resolve(method), setting,
            QueryBatch(batch.vectors, batch.bitmaps, batch.pred, kb))
        return (np.asarray(b_ids, dtype=np.int32),
                np.asarray(b_raw, dtype=np.float32))

    def _run_fused(self, method, setting, batch: QueryBatch,
                   snap: LiveSnapshot):
        """The live read through one `ops.fused_live_topk(_select)` call:
        routed base candidates and the delta scan fold in the kernel,
        tombstones applied to both there, so there is no host mask, no
        delta overfetch and no separate merge. Equal to `_run_staged`."""
        dev = self.torch_device
        base_dead = int(snap.tombstones[: snap.base_n].sum())
        t0 = time.perf_counter()
        with trace.span("live.base", base_n=int(snap.base_n),
                        dead=base_dead):
            b_ids, b_raw = self._run_base(method, setting, batch, snap,
                                          base_dead)
        t1 = time.perf_counter()
        with trace.span("live.delta", rows=int(snap.delta_rows),
                        fused=True):
            dvec, dnorm, dbm = snap.delta.device_view(snap.delta_rows)
            tomb_words = self._tomb_words(snap)
            sel = self._delta_select(snap, batch, b_ids, b_raw)
            if sel is not None and sel.size == 0:
                # every sealed cluster was pruned and there is no tail
                # row; one pruned row keeps the operand non-empty (it
                # provably cannot displace any query's top-k)
                sel = np.zeros(1, np.int32)
            args = (to_device(batch.vectors, dev),
                    to_device(batch.bitmaps, dev), to_device(b_ids, dev),
                    to_device(b_raw, dev), dvec, dnorm, dbm)
            if sel is None:
                ids, raw = ops.fused_live_topk(
                    *args, snap.base_n, tomb_words, pred=int(batch.pred),
                    k=batch.k)
            else:
                ids, raw = ops.fused_live_topk_select(
                    *args, to_device(sel, dev), snap.base_n, tomb_words,
                    pred=int(batch.pred), k=batch.k)
            ids = ids.cpu().numpy()
            raw = raw.cpu().numpy()
        t2 = time.perf_counter()
        self._stage_add({"base_s": t1 - t0, "delta_s": t2 - t1,
                         "merge_s": 0.0})    # the merge happens in-kernel
        return ids, raw

    def _run_staged(self, method, setting, batch: QueryBatch,
                    snap: LiveSnapshot):
        """The three-stage live read (base run → delta `masked_topk` →
        host tombstone mask → `merge_topk`): the parity reference for
        the fused path, and the path of an empty delta."""
        k = batch.k
        tomb = snap.tombstones
        base_dead = int(tomb[: snap.base_n].sum())
        delta_dead = int(tomb[snap.base_n:].sum())
        parts = []
        t0 = time.perf_counter()
        if snap.base_n:
            with trace.span("live.base", base_n=int(snap.base_n),
                            dead=base_dead):
                b_ids, b_raw = self._run_base(method, setting, batch,
                                              snap, base_dead)
            if base_dead:
                valid = b_ids >= 0
                dead = np.zeros_like(valid)
                dead[valid] = tomb[b_ids[valid]]
                b_ids = np.where(dead, np.int32(-1), b_ids)
                b_raw = np.where(dead, np.float32(np.inf), b_raw)
            parts.append((b_ids, b_raw))
        t1 = time.perf_counter()
        if snap.delta_rows:
            dev = self.torch_device
            # exact overfetch: top-(k + dead) over the delta always
            # contains the live top-k
            kd = _bucket(k + min(delta_dead, snap.delta_rows))
            with trace.span("live.delta", rows=int(snap.delta_rows),
                            overfetch=int(kd), fused=False):
                dvec, dnorm, dbm = snap.delta.device_view(snap.delta_rows)
                d_ids, d_raw = ops.masked_topk(
                    to_device(batch.vectors, dev),
                    to_device(batch.bitmaps, dev),
                    dvec, dnorm, dbm, pred=int(batch.pred), k=kd)
                d_ids = d_ids.cpu().numpy()
                d_raw = d_raw.cpu().numpy()
            # sentinel/pad rows are already −1; rows past the watermark
            # (appended since the snapshot) and tombstoned rows drop here
            valid = (d_ids >= 0) & (d_ids < snap.delta_rows)
            dead = ~valid
            dead[valid] |= tomb[snap.base_n + d_ids[valid]]
            d_ids = np.where(dead, np.int32(-1),
                             d_ids + np.int32(snap.base_n))
            d_raw = np.where(dead, np.float32(np.inf), d_raw)
            parts.append((d_ids, d_raw))
        t2 = time.perf_counter()
        if not parts:
            ids = np.full((batch.q, k), -1, np.int32)
            raw = np.full((batch.q, k), np.inf, np.float32)
        else:
            with trace.span("live.merge"):
                ids, raw = merge_candidates(*stack_candidates(parts), k=k,
                                            device=self.torch_device)
        t3 = time.perf_counter()
        self._stage_add({"base_s": t1 - t0, "delta_s": t2 - t1,
                         "merge_s": t3 - t2})
        return ids, raw

    def _tomb_words(self, snap: LiveSnapshot) -> torch.Tensor:
        """[TW] int32 views of the packed little-endian device tombstones
        for the fused kernel. Cached by (generation, tombstone version,
        padded length): rows appended after the pack only add zero bits,
        so the cached words stay valid until a delete bumps the version
        or the padded length grows past the next 4096-row bucket."""
        n_pad = _bucket(max(snap.n_total, 1), 4096)
        key = (snap.generation, snap.tombstone_version, n_pad)
        cached = self._tomb_words_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        words = np.zeros(n_pad // 8, np.uint8)
        packed = np.packbits(snap.tombstones, bitorder="little")
        words[: packed.size] = packed
        dev = to_device(words.view(np.uint32), self.torch_device)
        self._tomb_words_cache = (key, dev)
        return dev

    @staticmethod
    def _label_drop(chunk_idx: list[ChunkIndex],
                    batch: QueryBatch) -> np.ndarray:
        """[Q, C] True where a cluster's exact label bounds prove no
        member can satisfy the query's predicate. Chunks without label
        bounds contribute all-False columns."""
        qb = batch.bitmaps.astype(np.uint32)
        nq = qb.shape[0]
        qx = qb[:, None, :]                       # [Q, 1, W]
        pred = Predicate(batch.pred)
        cols = []
        for c in chunk_idx:
            ncl = c.radius.size
            if c.label_union is None:
                cols.append(np.zeros((nq, ncl), bool))
                continue
            uq = c.label_union[None, :, :] & qx   # [Q, C, W]
            if pred == Predicate.OR:
                # OR needs a shared bit; the union has none of q's bits
                drop = (uq == 0).all(axis=2)
            elif pred == Predicate.AND:
                # AND needs q ⊆ row; a q-bit missing from the union is
                # missing from every member
                drop = (uq != qx).any(axis=2)
            else:                                 # EQUALITY: row == q
                # a q-bit missing from the union, or a bit carried by
                # every member (intersection) that q lacks
                drop = ((uq != qx).any(axis=2)
                        | ((c.label_inter[None, :, :] & ~qx) != 0)
                        .any(axis=2))
            cols.append(drop)
        return np.concatenate(cols, axis=1)

    def _delta_select(self, snap: LiveSnapshot, batch: QueryBatch,
                      b_ids: np.ndarray, b_raw: np.ndarray
                      ) -> np.ndarray | None:
        """Exact ball-bound + label-bound pruning over the sealed chunks'
        mini-IVFs.

        Returns None to scan the whole delta mirror, or a sorted [NS]
        i32 array of delta-local rows that provably contains every
        query's live top-k among the delta. A cluster is dropped only
        when, for *every* query, it cannot contribute: its exact distance
        lower bound exceeds the query's k-th best live base candidate
        (plus a rounding margin), or its label union/intersection is
        incompatible with the query's predicate. Either way the result
        equals the full scan's. The partial tail chunk is always
        scanned."""
        rows = snap.delta_rows
        if rows < self._delta_prune_min_rows:
            return None
        chunk_idx = snap.delta.chunk_indexes(rows)
        if not chunk_idx:
            return None
        # per-query threshold: k-th smallest live base candidate (raw
        # score scale ‖v‖² − 2·q·v); +inf disables distance pruning for
        # queries with fewer than k live base candidates
        if b_ids.shape[1] >= batch.k:
            live = b_ids >= 0
            live[live] = ~snap.tombstones[b_ids[live]]
            cand = np.where(live, b_raw, np.inf).astype(np.float64)
            cand.sort(axis=1)
            bound = cand[:, batch.k - 1]                   # [Q]
        else:
            bound = np.full(batch.q, np.inf)
        qv = batch.vectors.astype(np.float64)
        qn = (qv ** 2).sum(axis=1)
        cent = np.concatenate([c.centroids for c in chunk_idx]
                              ).astype(np.float64)
        cn = np.concatenate([c.cnorms for c in chunk_idx])
        rad = np.concatenate([c.radius for c in chunk_idx])
        d2 = np.maximum(cn[None, :] - 2.0 * (qv @ cent.T) + qn[:, None],
                        0.0)
        lbound = np.maximum(np.sqrt(d2) - rad[None, :], 0.0) ** 2  # [Q, C]
        # margin absorbs the kernel's f32 rounding of candidate scores;
        # an infinite bound yields an infinite margin and never drops
        margin = 1e-3 * (1.0 + np.abs(bound))
        dist_drop = (lbound - qn[:, None]) > (bound + margin)[:, None]
        label_drop = self._label_drop(chunk_idx, batch)         # [Q, C]
        drop = (dist_drop | label_drop).all(axis=0)
        with self._lock:
            self._prune_stats["calls"] += 1
            self._prune_stats["clusters"] += int(drop.size)
            self._prune_stats["pruned"] += int(drop.sum())
            self._prune_stats["label_pruned"] += int(
                label_drop.all(axis=0).sum())
        if not drop.any():
            return None
        chunk = snap.delta.chunk
        keep_rows = []
        ci = 0
        for i, c in enumerate(chunk_idx):
            ncl = c.radius.size
            kept = ~drop[ci: ci + ncl]
            off = i * chunk
            if kept.all():
                keep_rows.append(off + np.arange(chunk, dtype=np.int64))
            elif kept.any():
                parts = [c.members[c.starts[j]: c.starts[j + 1]]
                         for j in np.nonzero(kept)[0]]
                keep_rows.append(off + np.concatenate(parts
                                                      ).astype(np.int64))
            ci += ncl
        covered = len(chunk_idx) * chunk
        keep_rows.append(np.arange(covered, rows, dtype=np.int64))
        sel = np.concatenate(keep_rows)
        sel.sort()                 # scan order matches the full scan
        return sel.astype(np.int32)

    def search(self, batch: QueryBatch, method,
               setting: ParamSetting | str | None = None, *,
               snapshot: LiveSnapshot | None = None) -> SearchResult:
        """Direct single-method live search (no routing). Args/semantics
        match `FilteredIndex.search`, plus `snapshot=` to read a pinned
        epoch; timings gain `base_s`/`delta_s`/`merge_s`."""
        self._check_open()
        method = self._resolve(method)
        if not isinstance(setting, ParamSetting):
            setting = resolve_setting(method, setting)
        self.pop_stage_timings()
        t0 = time.perf_counter()
        snap = snapshot if snapshot is not None else self.snapshot()
        try:
            ids, raw = self.run_method(method, setting, batch,
                                       snapshot=snap)
            keys = self.keys_of(ids, snapshot=snap)
        finally:
            if snapshot is None:
                snap.release()
        dt = time.perf_counter() - t0
        timings = {"search_s": dt, "total_s": dt}
        timings.update(self.pop_stage_timings())
        return SearchResult(
            ids=ids, distances=exact_distances(raw, ids, batch.vectors),
            decisions=None, timings=timings, keys=keys)

    # ---- routing-feature freshness ---------------------------------------
    def live_stats(self) -> LiveStats:
        """Current live-set summary for the routing features (exact live
        size, live per-label fractions, correction bitmaps)."""
        with self._lock:
            rows = self._delta.rows
            tomb = self._tomb
            n_live = self._base_n + rows - int(tomb.sum())
            base_dead = np.nonzero(tomb[: self._base_n])[0]
            base_bm = (self._base_fx.ds.bitmaps[base_dead]
                       if base_dead.size else
                       np.zeros((0, self._width), np.uint32))
            delta_live = ~tomb[self._base_n: self._base_n + rows]
            delta_bm = self._delta._bm[:rows][delta_live]
            return LiveStats(
                n_live=n_live,
                label_freq=(self._live_label_counts.astype(np.float64)
                            / max(n_live, 1)),
                base_tomb_bitmaps=base_bm,
                delta_bitmaps=delta_bm.copy(),
                base_ds=self.ds)

    # ---- compaction ------------------------------------------------------
    def compact(self, timeout: float | None = None) -> int:
        """Merge base + delta (minus tombstones) into a fresh sealed base
        and swap it in. Blocks until done; returns the new generation.
        See `compact_async` for the non-blocking form."""
        return self.compact_async().result(timeout=timeout)

    def compact_async(self) -> Future:
        """Start (or join) a background compaction.

        The worker thread gathers the surviving rows under a snapshot,
        builds the new group-sorted `ANNDataset` + `FilteredIndex`,
        grafts or rebuilds the old base's built method indexes, then
        swaps under the write lock: rows upserted and tombstones set
        *during* the rebuild are carried over (tail rows become the new
        delta; late deletes are translated through the id remap).
        Old-generation readers keep their base until their snapshots
        release. Returns a Future of the new generation; a second call
        while one runs returns the same Future.
        """
        with self._lock:
            self._check_open()
            if self._compacting is not None and not self._compacting.done():
                return self._compacting
            if self._compact_pool is None:
                self._compact_pool = ThreadPoolExecutor(
                    max_workers=1,
                    thread_name_prefix=f"compact-{self._name}")
            snap = self.snapshot()
            wal = self._wal
            if wal is not None:
                # barrier record: replay compacts synchronously at this
                # point, reproducing the snapshot's fold exactly
                seq = wal.log_compact(self._generation)
            fut = self._compact_pool.submit(self._compact_job, snap)
            self._compacting = fut
        if wal is not None:
            wal.commit(seq)
        return fut

    def _compact_job(self, snap: LiveSnapshot) -> int:
        try:
            keep_base = ~snap.tombstones[: snap.base_n]
            keep_delta = ~snap.tombstones[snap.base_n:]
            dvec, dbm, _ = snap.delta.host_view(snap.delta_rows)
            base_ds = None if snap.base_n == 0 else self._base_for(snap).ds
            vec_parts, bm_parts = [], []
            if base_ds is not None:
                vec_parts.append(base_ds.vectors[keep_base])
                bm_parts.append(base_ds.bitmaps[keep_base])
            vec_parts.append(dvec[keep_delta])
            bm_parts.append(dbm[keep_delta])
            vectors = np.concatenate(vec_parts)
            bitmaps = np.concatenate(bm_parts)
            kept = np.concatenate([
                np.nonzero(keep_base)[0],
                snap.base_n + np.nonzero(keep_delta)[0]])
            new_ds, order = ANNDataset.from_packed(
                self._name, vectors, bitmaps, self._universe,
                return_order=True)
            inv = np.empty(order.size, np.int64)
            inv[order] = np.arange(order.size)
            remap = np.full(snap.n_total, -1, np.int64)
            remap[kept] = inv
            # stable keys follow their rows through the remap
            new_keys = np.empty(new_ds.n, np.int64)
            new_keys[remap[kept]] = snap.keys[kept]
            new_fx = FilteredIndex(new_ds, registry=self._registry,
                                   device=self.torch_device)
            old_fx = self._base_for(snap) if snap.base_n else None
            if old_fx is not None:
                # graft where the method supports it: splice the old
                # built index through the id remap instead of rebuilding
                base_remap = remap[: snap.base_n]
                new_from_delta = remap[snap.base_n:]
                new_from_delta = np.sort(
                    new_from_delta[new_from_delta >= 0])
                for m_name, build in old_fx.built_keys():
                    try:
                        m = self._resolve(m_name)
                    except KeyError:
                        continue        # method no longer registered
                    grafted = None
                    old_index = old_fx._indexes.get((m_name, build))
                    if self._graft and old_index is not None:
                        kw = ({"device": self.torch_device}
                              if m.builds_on_device else {})
                        grafted = m.graft_index(
                            new_ds, old_index, old_fx.ds, base_remap,
                            new_from_delta, dict(build), **kw)
                    if grafted is not None:
                        new_fx.adopt_index(m, build, grafted)
                    else:
                        new_fx.get_index(m, build)
            with self._lock:
                if self._closed:
                    new_fx.close()
                    return self._generation
                rows_now = self._delta.rows
                tvec, tbm, _ = self._delta.host_view(rows_now)
                tail = slice(snap.delta_rows, rows_now)
                new_delta = DeltaSegment(self._dim, self._width,
                                         chunk=self._delta_chunk,
                                         device=self.torch_device)
                n_tail = rows_now - snap.delta_rows
                if n_tail:
                    new_delta.append(tvec[tail], tbm[tail])
                new_tomb = np.zeros(new_ds.n + n_tail, bool)
                # deletes that landed after the compaction snapshot
                newly = self._tomb[: snap.n_total] & ~snap.tombstones
                ng = remap[np.nonzero(newly)[0]]
                new_tomb[ng[ng >= 0]] = True
                new_tomb[new_ds.n:] = self._tomb[snap.n_total:
                                                 snap.n_total + n_tail]
                old_gen = self._generation
                old_base = self._base_fx
                self._base_fx = new_fx
                self._base_n = new_ds.n
                self._delta = new_delta
                self._tomb = new_tomb
                self._keys = np.concatenate(
                    [new_keys, self._keys[snap.n_total:
                                          snap.n_total + n_tail]])
                self._key_rows = None
                self._tomb_version += 1
                self._generation = old_gen + 1
                self._features = None       # dataset features went stale
                self._tomb_words_cache = None
                self._last_remap = remap
                if self._readers.get(old_gen):
                    # record the retirement even for an empty base (None)
                    # so pinned snapshots of generation 0 stay resolvable
                    self._retired[old_gen] = old_base
                    old_ds = (old_base.ds if old_base is not None
                              else None)
                    self._retired_leases[old_gen] = \
                        ledger_mod.get_ledger().acquire(
                            "retired_generation", self._name,
                            bytes=(old_ds.vectors.nbytes
                                   + old_ds.bitmaps.nbytes
                                   if old_ds is not None else 0),
                            meta={"generation": int(old_gen)})
                elif old_base is not None:
                    old_base.close()
                return self._generation
        finally:
            snap.release()
            with self._lock:
                self._compacting = None

    # ---- maintenance -----------------------------------------------------
    def export_state(self, snap: LiveSnapshot) -> dict:
        """Full logical state of a pinned snapshot, all numpy: the JAX
        package's `export_state` dict with its `base_ds` given as packed
        arrays (`name`, `universe`, `base_vectors`, `base_bitmaps`), as
        `from_state` takes it: per-row stable keys, the delta rows in
        insertion order (with keys), and the tombstoned ids of the
        epoch."""
        base_fx = self._base_for(snap) if snap.base_n else None
        dvec, dbm, _ = snap.delta.host_view(snap.delta_rows)
        return {
            "generation": snap.generation,
            "name": self._name,
            "universe": self._universe,
            "base_vectors": (np.zeros((0, self._dim), np.float32)
                             if base_fx is None else base_fx.ds.vectors),
            "base_bitmaps": (np.zeros((0, self._width), np.uint32)
                             if base_fx is None else base_fx.ds.bitmaps),
            "base_keys": snap.keys[: snap.base_n],
            "delta_vectors": dvec,
            "delta_bitmaps": dbm,
            "delta_keys": snap.keys[snap.base_n:],
            "dead_ids": np.nonzero(snap.tombstones)[0].astype(np.int64),
            "next_key": snap.next_key,
        }

    def last_remap(self) -> np.ndarray | None:
        """Id translation of the most recent `compact()`: `remap[old_id]`
        is the row's id in the new generation, −1 if it was deleted.
        None before the first compaction."""
        return self._last_remap

    def built_keys(self) -> list[tuple]:
        return [] if self._base_fx is None else self._base_fx.built_keys()

    def stats(self) -> dict:
        """State snapshot: generation, live/total row counts, delta and
        tombstone sizes, mirror coverage, compaction status."""
        with self._lock:
            rows = self._delta.rows
            return {
                "dataset": self._name,
                "device": str(self.torch_device),
                "generation": self._generation,
                "base_n": self._base_n,
                "delta_rows": rows,
                "delta_device_rows": self._delta.device_rows(),
                "tombstones": int(self._tomb.sum()),
                "n_live": self._base_n + rows - int(self._tomb.sum()),
                "tombstone_version": self._tomb_version,
                "next_key": self._next_key,
                "compacting": (self._compacting is not None
                               and not self._compacting.done()),
                "retired_generations": sorted(self._retired),
                "fused": self.fused,
                "graft": self._graft,
                "delta_chunk_indexes": len(self._delta._chunk_idx),
                "delta_prune": dict(self._prune_stats),
                "wal_attached": self._wal is not None,
                "closed": self._closed,
            }


# ---------------------------------------------------------------------------
# sharded live index — round-robin upserts over per-shard delta segments
# ---------------------------------------------------------------------------

class ShardedLiveSnapshot:
    """Consistent cross-shard read epoch: one pinned `LiveSnapshot` per
    shard plus the shard list, bounds, gid maps, global key prefix and
    delta locations of the epoch, all captured under the sharded index's
    write lock. Pins the epoch (an old shard list survives a compaction
    swap) until `release()`, which is idempotent; a context manager."""

    __slots__ = ("epoch", "shards", "bounds", "snaps", "gmaps", "keys",
                 "next_key", "locs", "base_ds", "_owner", "_released")

    def __init__(self, owner, epoch, shards, bounds, snaps, gmaps,
                 keys, next_key, locs, base_ds):
        self.epoch = epoch
        self.shards = shards
        self.bounds = bounds
        self.snaps = snaps
        self.gmaps = gmaps
        self.keys = keys
        self.next_key = next_key
        self.locs = locs
        self.base_ds = base_ds
        self._owner = owner
        self._released = False

    def release(self) -> None:
        """Unpin this epoch (idempotent, thread-safe)."""
        with self._owner._lock:
            if self._released:
                return
            self._released = True
        for snap in self.snaps:
            snap.release()
        self._owner._release_epoch(self.epoch)

    def __enter__(self) -> "ShardedLiveSnapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class ShardedLiveIndex(_StableKeyMixin, _LabelClockMixin, _StageTimings):
    """Row-sharded live handle: one `LiveFilteredIndex` per shard.

    Upserts round-robin row by row across shards; global delta ids are
    assigned in insertion order (`total_base_n + j`) and mapped to
    (shard, local row), so `delete()` and result globalisation agree.
    `run_method` snapshots every shard under one lock (a consistent
    cross-shard epoch), fans out, globalises the per-shard ids and
    reduces through `ops.merge_topk` (the `merge_topk` kernel on a card).
    Each shard serves its own read through the fused kernel (`fused` and
    `delta_prune_min_rows` forward to the per-shard handles). `compact()`
    rebuilds **globally**: every surviving row merges into one fresh
    dataset that is re-sharded contiguously, so the result is exactly a
    `ShardedFilteredIndex` over the compacted data (rows migrate across
    shard boundaries, so per-shard method indexes are rebuilt, not
    grafted).

    Args mirror `ShardedFilteredIndex` (`device="cuda"` round-robins the
    shards over the host's cards, all on the one card of a one-card host;
    "cpu" puts them on the host), plus the empty-base form of
    `LiveFilteredIndex` through `name`/`dim`/`universe` and its
    `delta_chunk`, `base_keys`, `next_key`, `generation`, `fused` and
    `delta_prune_min_rows`. Raises ValueError for `n_shards < 1`.

    Writes and compactions log to an attached write-ahead log
    (`attach_wal`) at the sharded level: global ids and keys, the epoch
    as the generation. Each shard run opens a `shard` trace span, as the
    JAX package's handle does, beside the stage timings.
    """

    def __init__(self, ds: ANNDataset | None = None, n_shards: int = 1, *,
                 name: str | None = None, dim: int | None = None,
                 universe: int | None = None, device="cuda", registry=None,
                 parallel: bool = True,
                 delta_chunk: int = DEFAULT_DELTA_CHUNK,
                 base_keys: np.ndarray | None = None,
                 next_key: int | None = None, generation: int = 0,
                 fused: bool = True,
                 delta_prune_min_rows: int | None = None):
        n_shards = int(n_shards)
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1; got {n_shards}")
        devices = shard_devices(n_shards, device)
        self._registry = registry
        self._delta_chunk = int(delta_chunk)
        self._devices = devices
        self._fused = bool(fused)
        self._delta_prune_min_rows = delta_prune_min_rows
        if ds is None:
            if name is None or dim is None or universe is None:
                raise ValueError(
                    "an empty ShardedLiveIndex needs name=, dim= and "
                    "universe= (or pass a base ANNDataset)")
            self._name, self._dim = str(name), int(dim)
            self._universe = int(universe)
            self._base_ds: ANNDataset | None = None
            self.bounds = np.zeros(n_shards + 1, dtype=np.int64)
            self.shards = self._empty_shards()
        else:
            self._name, self._dim = ds.name, ds.dim
            self._universe = ds.universe
            self._base_ds = ds
            self.bounds = shard_bounds(ds.n, n_shards)
            self.shards = self._base_shards(ds, self.bounds)
        self._total_base = 0 if ds is None else ds.n
        self._delta_loc: list[tuple[int, int]] = []  # gid-j -> (shard, row)
        self._shard_gids: list[list[int]] = [[] for _ in self.shards]
        self._gid_arrays: list[np.ndarray] | None = None   # search cache
        self._last_remap: np.ndarray | None = None
        self._next_shard = 0
        if base_keys is None:
            self._keys = np.arange(self._total_base, dtype=np.int64)
        else:
            self._keys = np.asarray(base_keys, dtype=np.int64).copy()
            if self._keys.shape != (self._total_base,):
                raise ValueError(
                    f"base_keys must be [{self._total_base}]; got shape "
                    f"{self._keys.shape}")
        self._next_key = int(next_key) if next_key is not None else \
            (int(self._keys.max()) + 1 if self._total_base else 0)
        self._key_rows: KeyTable | None = None   # key -> gid, built lazily
        self._wal = None
        self._wal_quiet = False               # compaction's internal replay
        self._pool = (ThreadPoolExecutor(
            max_workers=n_shards,
            thread_name_prefix=f"live-shard-{self._name}")
            if parallel and n_shards > 1 else None)
        self._lock = threading.RLock()
        self._clock_init()
        self._epoch = int(generation)
        self._epoch_readers: dict[int, int] = {}
        self._old_shards: dict[int, list] = {}
        self._feature_fx: FilteredIndex | None = None
        self._compact_pool: ThreadPoolExecutor | None = None
        self._compacting: Future | None = None
        self._features = None       # repro_torch.core.features cache slot
        self._closed = False

    def _shard_kw(self) -> dict:
        return dict(registry=self._registry, delta_chunk=self._delta_chunk,
                    fused=self._fused,
                    delta_prune_min_rows=self._delta_prune_min_rows)

    def _base_shards(self, ds: ANNDataset, bounds) -> list:
        return [LiveFilteredIndex(
                    ds.row_slice(int(s), int(e), name=f"{ds.name}/shard{i}"),
                    device=self._devices[i], **self._shard_kw())
                for i, (s, e) in enumerate(zip(bounds[:-1], bounds[1:]))]

    def _empty_shards(self) -> list:
        return [LiveFilteredIndex.empty(
                    f"{self._name}/shard{i}", self._dim, self._universe,
                    device=self._devices[i], **self._shard_kw())
                for i in range(len(self._devices))]

    # ---- lifecycle ------------------------------------------------------
    @property
    def fused(self) -> bool:
        """Whether shards serve reads through the fused kernel; setting
        it propagates to every current shard (and to shards created by
        later compactions)."""
        return self._fused

    @fused.setter
    def fused(self, value: bool) -> None:
        self._fused = bool(value)
        for s in self.shards:
            s.fused = self._fused

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def ds(self) -> ANNDataset | None:
        """The current generation's full base dataset (None before the
        first compaction of an empty-started index)."""
        return self._base_ds

    @property
    def generation(self) -> int:
        return self._epoch

    @property
    def n_live(self) -> int:
        with self._lock:
            return sum(s.n_live for s in self.shards)

    @property
    def base_n(self) -> int:
        return self._total_base

    @property
    def n_total(self) -> int:
        with self._lock:
            return self._total_base + len(self._delta_loc)

    @property
    def torch_device(self) -> torch.device:
        """Shard 0's device: where the routing features and the
        cross-shard merge run."""
        return self._devices[0]

    @property
    def feature_index(self) -> FilteredIndex:
        """Full-base `FilteredIndex` on shard 0's device, built at first
        use: the `selectivity` kernel of the routing features reads its
        bitmaps (per-shard bitmaps would under-count)."""
        with self._lock:
            self._check_open()
            if self._base_ds is None:
                raise RuntimeError(f"ShardedLiveIndex({self._name!r}) has "
                                   f"no sealed base yet")
            if self._feature_fx is None:
                self._feature_fx = FilteredIndex(
                    self._base_ds, registry=self._registry,
                    device=self.torch_device)
            return self._feature_fx

    @property
    def device(self):
        """Full-base device tensors (routing-feature path only)."""
        return self.feature_index.device

    def close(self) -> None:
        """Wait out a running compaction (its swap is skipped once
        closed), close every shard of every epoch and the feature handle,
        shut the pools down. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            comp = self._compacting
        if comp is not None:
            try:
                comp.result(timeout=300)
            except Exception:       # its failure belongs to its own caller
                pass
        with self._lock:
            for s in self.shards:
                s.close()
            for old in self._old_shards.values():
                for s in old:
                    s.close()
            self._old_shards.clear()
            if self._feature_fx is not None:
                self._feature_fx.close()
                self._feature_fx = None
            self._features = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._compact_pool is not None:
            self._compact_pool.shutdown(wait=True)
            self._compact_pool = None

    def __enter__(self) -> "ShardedLiveIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                f"ShardedLiveIndex({self._name!r}) is closed")

    # ---- write path -----------------------------------------------------
    def upsert(self, vectors, bitmaps, *, keys=None) -> np.ndarray:
        """Append rows, round-robin across shards. Returns [R] global ids
        (current generation); `keys=` as in `LiveFilteredIndex.upsert`
        (stable global keys, auto-assigned when omitted)."""
        vectors = np.asarray(vectors, dtype=np.float32)
        bitmaps = np.asarray(bitmaps, dtype=np.uint32)
        if vectors.ndim == 1:
            vectors = vectors[None]
        if bitmaps.ndim == 1:
            bitmaps = bitmaps[None]
        if vectors.ndim != 2 or vectors.shape[1] != self._dim:
            raise ValueError(
                f"upsert vectors must be [R, {self._dim}]; got "
                f"{vectors.shape}")
        width = lb.n_words(self._universe)
        if bitmaps.shape != (vectors.shape[0], width):
            raise ValueError(
                f"upsert bitmaps must be [{vectors.shape[0]}, {width}]; "
                f"got {bitmaps.shape}")
        counts = _label_counts(bitmaps, self._universe)
        with self._lock:
            self._check_open()
            n = vectors.shape[0]
            ks = self._claim_keys(keys, n)
            wal = self._wal if not self._wal_quiet else None
            if wal is not None:
                seq = wal.log_upsert(self._epoch, ks, vectors, bitmaps)
            nsh = self.n_shards
            shard_of = (self._next_shard + np.arange(n)) % nsh
            gid0 = self._total_base + len(self._delta_loc)
            d0 = len(self._delta_loc)
            self._delta_loc.extend([None] * n)
            for s in range(nsh):
                rows = np.nonzero(shard_of == s)[0]
                if rows.size == 0:
                    continue
                start_local = self.shards[s]._delta.rows
                self.shards[s].upsert(vectors[rows], bitmaps[rows])
                for off, j in enumerate(rows.tolist()):
                    self._delta_loc[d0 + j] = (s, start_local + off)
                self._shard_gids[s].extend((gid0 + rows).tolist())
            self._keys = np.concatenate([self._keys, ks])
            self._note_new_keys(ks, gid0)
            self._clock_touch(counts)
            self._gid_arrays = None           # snapshots rebuild lazily
            self._next_shard = (self._next_shard + n) % nsh
            out = np.arange(gid0, gid0 + n, dtype=np.int64)
        if wal is not None:
            wal.commit(seq)                  # durable before acked, off-lock
        return out

    def _row_live(self, rows: np.ndarray) -> np.ndarray:
        """bool[R]: which current-generation global ids are live (mixin
        hook; caller holds the lock)."""
        return np.array([self._gid_live(int(g)) for g in rows], bool)

    def _shard_local(self, gid: int) -> tuple[int, int]:
        """(shard, shard-local id) for a current-generation global id."""
        if gid < self._total_base:
            s = int(np.searchsorted(self.bounds, gid, side="right")) - 1
            return s, gid - int(self.bounds[s])
        s, row = self._delta_loc[gid - self._total_base]
        return s, self.shards[s].base_n + row

    def _gid_live(self, gid: int) -> bool:
        s, lid = self._shard_local(int(gid))
        return not self.shards[s]._tomb[lid]

    def delete(self, ids) -> int:
        """Tombstone global ids; returns the number newly deleted. Raises
        IndexError on out-of-range ids."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        with self._lock:
            self._check_open()
            n_tot = self._total_base + len(self._delta_loc)
            if ids.size and (ids.min() < 0 or ids.max() >= n_tot):
                raise IndexError(
                    f"delete ids must be in [0, {n_tot}); got range "
                    f"[{ids.min()}, {ids.max()}]")
            wal = self._wal if not self._wal_quiet else None
            if wal is not None:
                seq = wal.log_delete(self._epoch, ids)
            per: dict[int, list] = {}
            for gid in ids.tolist():
                s, lid = self._shard_local(gid)
                per.setdefault(s, []).append(lid)
            # stamp before delegating: labels of every named id (a
            # conservative superset — already-dead ids stamp too)
            if ids.size:
                bms = np.concatenate(
                    [self.shards[s]._bitmaps_of(np.asarray(lids, np.int64))
                     for s, lids in per.items()])
                self._clock_touch(_label_counts(bms, self._universe))
            out = sum(self.shards[s].delete(lids)
                      for s, lids in per.items())
        if wal is not None:
            wal.commit(seq)                  # durable before acked, off-lock
        return out

    # stable external keys (`keys_of`/`rows_of`/`delete_keys`/`_claim_keys`)
    # come from _StableKeyMixin (global ids / global keys).

    # ---- durability hook (repro_torch.ann.store) ------------------------
    def attach_wal(self, wal) -> None:
        """Attach a write-ahead log at the sharded level (global ids and
        keys; the per-shard handles stay without one). See
        `LiveFilteredIndex.attach_wal`."""
        with self._lock:
            self._wal = wal

    # ---- read path -------------------------------------------------------
    def snapshot(self) -> ShardedLiveSnapshot:
        """Pin a consistent cross-shard read epoch (see
        `ShardedLiveSnapshot`); callers must `release()` it."""
        with self._lock:
            self._check_open()
            epoch = self._epoch
            shards = list(self.shards)
            bounds = self.bounds.copy()
            snaps = [s.snapshot() for s in shards]
            if self._gid_arrays is None:      # invalidated by upsert
                self._gid_arrays = [np.asarray(g, dtype=np.int64)
                                    for g in self._shard_gids]
            n_tot = self._total_base + len(self._delta_loc)
            self._epoch_readers[epoch] = \
                self._epoch_readers.get(epoch, 0) + 1
            # keys slice is a view: _keys is reassigned, never mutated in
            # place (see LiveFilteredIndex.snapshot)
            return ShardedLiveSnapshot(self, epoch, shards, bounds, snaps,
                                       self._gid_arrays, self._keys[:n_tot],
                                       self._next_key, list(self._delta_loc),
                                       self._base_ds)

    def shard_candidates(self, method, setting: ParamSetting,
                         batch: QueryBatch, snap: ShardedLiveSnapshot
                         ) -> list:
        """Every shard's live read of the pinned epoch `snap` (in
        parallel on the pool), with ids globalised: a base id plus its
        shard's offset, a delta id through the insertion-order map. One
        ([Q, k] int32 ids, [Q, k] float32 scores) pair per shard, on the
        host. Stage timings accumulate on the calling thread: `base_s`
        and `delta_s` of the slowest shard, `shard{j}_s` and
        `shard_max_s`."""
        inline = self._pool is None
        parent = trace.current()
        times = [0.0] * len(snap.shards)

        def shard_run(jsv):
            # drain the shard's stage timings in the thread that ran it
            # (they live on a thread-local); run inline, keep the
            # caller's own slate apart
            j, (shard, ssnap) = jsv
            saved = engine_mod.pop_stage_timings() if inline else {}
            s0 = time.perf_counter()
            with trace.attach(parent):
                with trace.span("shard", shard=j):
                    out = shard.run_method(method, setting, batch,
                                           snapshot=ssnap)
            times[j] = time.perf_counter() - s0
            got = shard.pop_stage_timings()
            self._stage_add(saved)
            return out, got

        items = list(enumerate(zip(snap.shards, snap.snaps)))
        ran = ([shard_run(it) for it in items] if inline
               else list(self._pool.map(shard_run, items)))
        # shards overlap in wall-clock: report the slowest stage
        for key in ("base_s", "delta_s"):
            vals = [t.get(key, 0.0) for _, t in ran]
            if any(vals):
                self._stage_add({key: max(vals)})
        # per-shard wall seconds + the straggler (the latency the fan-out
        # waits for — a sum would hide it)
        self._stage_add({f"shard{j}_s": s for j, s in enumerate(times)})
        self._stage_add({"shard_max_s": max(times)})
        parts = []
        for s, (((ids, raw), _), ssnap) in enumerate(zip(ran, snap.snaps)):
            ids = np.asarray(ids, dtype=np.int64)
            out = np.full(ids.shape, -1, np.int64)
            is_base = (ids >= 0) & (ids < ssnap.base_n)
            out[is_base] = ids[is_base] + int(snap.bounds[s])
            is_delta = ids >= ssnap.base_n
            if is_delta.any():
                out[is_delta] = snap.gmaps[s][ids[is_delta] - ssnap.base_n]
            parts.append((out.astype(np.int32),
                          np.asarray(raw, dtype=np.float32)))
        return parts

    def run_method(self, method, setting: ParamSetting, batch: QueryBatch,
                   *, snapshot: ShardedLiveSnapshot | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Raw sharded live execution: `shard_candidates` over one
        consistent cross-shard epoch, then the `merge_topk` reduction of
        the [S, Q, k] candidates. Pass `snapshot=` to pin several calls to
        one epoch.

        Returns the `FilteredIndex.run_method` contract ([Q, k] int32
        global ids with −1 pad, [Q, k] float32 scores with +inf at −1).
        Stage timings accumulate on the calling thread (those of
        `shard_candidates`, and `merge_s`)."""
        self._check_open()
        snap = snapshot if snapshot is not None else self.snapshot()
        try:
            parts = self.shard_candidates(method, setting, batch, snap)
            t0 = time.perf_counter()
            gids, graw = merge_candidates(*stack_candidates(parts),
                                          k=batch.k, device=self.torch_device)
            self._stage_add({"merge_s": time.perf_counter() - t0})
            return gids, graw
        finally:
            if snapshot is None:
                snap.release()

    def _release_epoch(self, epoch: int) -> None:
        with self._lock:
            left = self._epoch_readers.get(epoch, 0) - 1
            if left > 0:
                self._epoch_readers[epoch] = left
                return
            self._epoch_readers.pop(epoch, None)
            old = (self._old_shards.pop(epoch, None)
                   if epoch != self._epoch else None)
        if old:
            for s in old:
                s.close()

    def search(self, batch: QueryBatch, method,
               setting: ParamSetting | str | None = None, *,
               snapshot: ShardedLiveSnapshot | None = None) -> SearchResult:
        """Direct single-method sharded live search (no routing); the
        result carries the rows' stable `keys`. `snapshot=` reads a
        pinned epoch, as on `LiveFilteredIndex.search` (the recall
        auditor pins one for all of a pass's groups)."""
        self._check_open()
        if isinstance(method, str):
            reg = self._registry or registry_mod.default_registry()
            method = reg.get(method)
        if not isinstance(setting, ParamSetting):
            setting = resolve_setting(method, setting)
        self.pop_stage_timings()
        t0 = time.perf_counter()
        snap = snapshot if snapshot is not None else self.snapshot()
        try:
            ids, raw = self.run_method(method, setting, batch, snapshot=snap)
            keys = self.keys_of(ids, snapshot=snap)
        finally:
            if snapshot is None:
                snap.release()
        dt = time.perf_counter() - t0
        timings = {"search_s": dt, "total_s": dt}
        timings.update(self.pop_stage_timings())
        return SearchResult(
            ids=ids, distances=exact_distances(raw, ids, batch.vectors),
            decisions=None, timings=timings, keys=keys)

    def _delta_rows(self, snaps: list, locs):
        """Host (vectors, bitmaps, tombstone flags) of the delta rows at
        `locs` ((shard, row) pairs), read through the per-shard snapshots
        `snaps` of one epoch."""
        width = lb.n_words(self._universe)
        vec = np.zeros((len(locs), self._dim), np.float32)
        bm = np.zeros((len(locs), width), np.uint32)
        dead = np.zeros(len(locs), bool)
        if locs:
            loc_shard = np.array([l[0] for l in locs], np.int64)
            loc_row = np.array([l[1] for l in locs], np.int64)
            for s, ssnap in enumerate(snaps):
                mine = loc_shard == s
                if not mine.any():
                    continue
                sv, sb, _ = ssnap.delta.host_view(ssnap.delta_rows)
                rows = loc_row[mine]
                vec[mine] = sv[rows]
                bm[mine] = sb[rows]
                dead[mine] = ssnap.tombstones[ssnap.base_n + rows]
        return vec, bm, dead

    def fetch(self, ids, snapshot: ShardedLiveSnapshot | None = None
              ) -> np.ndarray:
        """[R, d] vectors for global result ids (−1 rows come back as
        NaN), the sharded mirror of `LiveFilteredIndex.fetch`. With a
        snapshot, ids are read in that epoch's global id space."""
        snap = snapshot or self.snapshot()
        try:
            ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
            out = np.full((ids.size, self._dim), np.nan, np.float32)
            base_n = int(snap.bounds[-1])
            base = (ids >= 0) & (ids < base_n)
            if base.any():
                out[base] = snap.base_ds.vectors[ids[base]]
            delta = ids >= base_n
            if delta.any():
                vec, _, _ = self._delta_rows(
                    snap.snaps,
                    [snap.locs[int(g) - base_n] for g in ids[delta]])
                out[delta] = vec
            return out
        finally:
            if snapshot is None:
                snap.release()

    # ---- routing-feature freshness ---------------------------------------
    def live_stats(self) -> LiveStats:
        """Aggregate live-set summary across shards (one consistent epoch:
        shard stats and the base dataset are read under the lock a
        compaction swap takes)."""
        with self._lock:
            per = [s.live_stats() for s in self.shards]
            base_ds = self._base_ds
        n_live = sum(p.n_live for p in per)
        counts = sum((p.label_freq * p.n_live for p in per),
                     np.zeros(self._universe))
        return LiveStats(
            n_live=n_live,
            label_freq=counts / max(n_live, 1),
            base_tomb_bitmaps=np.concatenate(
                [p.base_tomb_bitmaps for p in per]),
            delta_bitmaps=np.concatenate([p.delta_bitmaps for p in per]),
            base_ds=base_ds)

    # ---- compaction ------------------------------------------------------
    def compact(self, timeout: float | None = None) -> int:
        """Global rebuild + re-shard; blocks, returns the new epoch."""
        return self.compact_async().result(timeout=timeout)

    def compact_async(self) -> Future:
        """Background global compaction: merge every shard's surviving
        base and delta rows (in global id order) into one fresh dataset,
        re-shard it contiguously, swap the shard list atomically, and
        close the old shards once their epoch's readers drain. Writes made
        during the rebuild carry over exactly as in
        `LiveFilteredIndex.compact_async`. A second call while one runs
        returns the same Future."""
        with self._lock:
            self._check_open()
            if self._compacting is not None and not self._compacting.done():
                return self._compacting
            if self._compact_pool is None:
                self._compact_pool = ThreadPoolExecutor(
                    max_workers=1,
                    thread_name_prefix=f"compact-{self._name}")
            fut = self._compact_pool.submit(self._compact_job)
            self._compacting = fut
            return fut

    def _gather(self, snaps, locs):
        """Surviving rows in global id order + the kept-gid list."""
        vec_parts, bm_parts, kept = [], [], []
        for s, snap in enumerate(snaps):
            if snap.base_n == 0:
                continue
            keep = ~snap.tombstones[: snap.base_n]
            ds = self.shards[s]._base_for(snap).ds
            vec_parts.append(ds.vectors[keep])
            bm_parts.append(ds.bitmaps[keep])
            kept.append(int(self.bounds[s]) + np.nonzero(keep)[0])
        if locs:
            dvec, dbm, dead = self._delta_rows(snaps, locs)
            vec_parts.append(dvec[~dead])
            bm_parts.append(dbm[~dead])
            kept.append(self._total_base + np.nonzero(~dead)[0])
        if vec_parts:
            return (np.concatenate(vec_parts), np.concatenate(bm_parts),
                    np.concatenate(kept))
        width = lb.n_words(self._universe)
        return (np.zeros((0, self._dim), np.float32),
                np.zeros((0, width), np.uint32), np.zeros(0, np.int64))

    def _compact_job(self) -> int:
        snaps = None
        try:
            with self._lock:
                snaps = [s.snapshot() for s in self.shards]
                locs = list(self._delta_loc)
                old_total = self._total_base + len(locs)
                old_keys = self._keys[:old_total].copy()
                wal = self._wal
                if wal is not None:
                    seq = wal.log_compact(self._epoch)
            if wal is not None:
                wal.commit(seq)
            vectors, bitmaps, kept = self._gather(snaps, locs)
            new_ds, order = ANNDataset.from_packed(
                self._name, vectors, bitmaps, self._universe,
                return_order=True)
            inv = np.empty(order.size, np.int64)
            inv[order] = np.arange(order.size)
            remap = np.full(old_total, -1, np.int64)
            remap[kept] = inv
            new_keys = np.empty(new_ds.n, np.int64)
            new_keys[remap[kept]] = old_keys[kept]
            nsh = self.n_shards
            built = []
            for s in self.shards:
                built.extend(k for k in s.built_keys() if k not in built)
            if new_ds.n >= nsh:
                new_bounds = shard_bounds(new_ds.n, nsh)
                new_shards = self._base_shards(new_ds, new_bounds)
                new_base: ANNDataset | None = new_ds
            else:
                # fewer surviving rows than shards: restart from empty
                # shards and replay the rows as delta below
                new_bounds = np.zeros(nsh + 1, dtype=np.int64)
                new_shards = self._empty_shards()
                new_base = None
            for shard in new_shards:
                if shard._base_fx is None:
                    continue
                for m_name, build in built:
                    try:
                        shard._base_fx.get_index(m_name, build)
                    except KeyError:
                        pass            # method no longer registered
            with self._lock:
                if self._closed:
                    for s in new_shards:
                        s.close()
                    return self._epoch
                old_shards = self.shards
                tail = self._delta_loc[len(locs):]
                late_tomb: list[int] = []       # old gids deleted late
                for s, snap in enumerate(snaps):
                    cur = old_shards[s]._tomb
                    newly = cur[: snap.n_total] & ~snap.tombstones
                    for lid in np.nonzero(newly)[0].tolist():
                        if lid < snap.base_n:
                            late_tomb.append(int(self.bounds[s]) + lid)
                        else:
                            late_tomb.append(
                                int(self._shard_gids[s][lid - snap.base_n]))
                # tail rows (upserted during the rebuild) in global
                # insertion order, with their current tombstones
                tail_rows = []
                for s, row in tail:
                    shard = old_shards[s]
                    tail_rows.append((shard._delta._vec[row],
                                      shard._delta._bm[row],
                                      bool(shard._tomb[shard.base_n + row])))
                tail_keys = self._keys[old_total: old_total + len(tail)]
                old_epoch = self._epoch
                self.shards = new_shards
                self.bounds = new_bounds
                self._base_ds = new_base
                self._total_base = new_ds.n if new_base is not None else 0
                self._delta_loc = []
                self._shard_gids = [[] for _ in new_shards]
                self._gid_arrays = None
                self._next_shard = 0
                self._keys = (new_keys if new_base is not None
                              else np.zeros(0, np.int64))
                self._key_rows = None
                self._epoch = old_epoch + 1
                self._last_remap = remap
                self._features = None       # dataset features went stale
                if self._feature_fx is not None:
                    self._feature_fx.close()
                    self._feature_fx = None
                # replay: rows that missed the snapshot (and every row
                # when the base fell below the shard count), with their
                # stable keys; the log stays quiet — these rows' own
                # upsert and delete records already cover them
                replay = []
                if new_base is None and new_ds.n:
                    replay.append((new_ds.vectors, new_ds.bitmaps, None,
                                   new_keys))
                if tail_rows:
                    replay.append((
                        np.stack([t[0] for t in tail_rows]),
                        np.stack([t[1] for t in tail_rows]),
                        np.array([t[2] for t in tail_rows], bool),
                        tail_keys))
                self._wal_quiet = True
                try:
                    for vecs, bms, dead, ks in replay:
                        gids = self.upsert(vecs, bms, keys=ks)
                        if dead is not None and dead.any():
                            self.delete(gids[dead])
                    if late_tomb:
                        ng = remap[np.asarray(late_tomb, np.int64)]
                        ng = ng[(ng >= 0) & (ng < self._total_base
                                             + len(self._delta_loc))]
                        if ng.size:
                            self.delete(ng)
                finally:
                    self._wal_quiet = False
                if self._epoch_readers.get(old_epoch):
                    self._old_shards[old_epoch] = old_shards
                else:
                    for s in old_shards:
                        s.close()
                return self._epoch
        finally:
            if snaps is not None:
                for snap in snaps:
                    snap.release()
            with self._lock:
                self._compacting = None

    # ---- maintenance -----------------------------------------------------
    def export_state(self, snap: ShardedLiveSnapshot) -> dict:
        """Full logical state of a pinned cross-shard epoch in *global* id
        order, all numpy: `LiveFilteredIndex.export_state`'s dict (the
        JAX package's, with its `base_ds` as packed arrays)."""
        base_n = int(snap.bounds[-1])
        width = lb.n_words(self._universe)
        dvec, dbm, delta_dead = self._delta_rows(snap.snaps, snap.locs)
        dead = [base_n + np.nonzero(delta_dead)[0]]
        for s, ssnap in enumerate(snap.snaps):
            lids = np.nonzero(ssnap.tombstones[: ssnap.base_n])[0]
            if lids.size:
                dead.append(int(snap.bounds[s]) + lids)
        base = snap.base_ds
        return {
            "generation": snap.epoch,
            "name": self._name,
            "universe": self._universe,
            "base_vectors": (np.zeros((0, self._dim), np.float32)
                             if base is None else base.vectors),
            "base_bitmaps": (np.zeros((0, width), np.uint32)
                             if base is None else base.bitmaps),
            "base_keys": snap.keys[:base_n],
            "delta_vectors": dvec,
            "delta_bitmaps": dbm,
            "delta_keys": snap.keys[base_n:],
            "dead_ids": np.sort(np.concatenate(dead)).astype(np.int64),
            "next_key": snap.next_key,
        }

    def last_remap(self) -> np.ndarray | None:
        """Global-id translation of the most recent `compact()` (see
        `LiveFilteredIndex.last_remap`)."""
        return self._last_remap

    def stats(self) -> dict:
        """Aggregate + per-shard state snapshot."""
        with self._lock:
            return {
                "dataset": self._name,
                "devices": [str(d) for d in self._devices],
                "generation": self._epoch,
                "n_shards": self.n_shards,
                "base_n": self._total_base,
                "delta_rows": len(self._delta_loc),
                "n_live": sum(s.n_live for s in self.shards),
                "next_key": self._next_key,
                "compacting": (self._compacting is not None
                               and not self._compacting.done()),
                "wal_attached": self._wal is not None,
                "closed": self._closed,
                "shards": [s.stats() for s in self.shards],
            }
