"""`repro_torch.ann.store` — the durable storage subsystem for live indexes.

An `IndexStore` is a directory that makes the whole serving state of a
`LiveFilteredIndex` / `ShardedLiveIndex` survive process restarts and
crashes:

* **segment files** — the sealed base dataset of each generation,
  written once (`ANNDataset.save_segment`) and opened zero-copy via
  `np.memmap`, together with the per-row stable-key map (`keys.npy`)
  and the persistable built method indexes (``indexes/*.npz`` through
  `Method.index_arrays`) and sealed delta-chunk indexes
  (``delta_chunks/*.npz``);
* **manifest** — one version-stamped JSON (`MANIFEST.json`) committed
  by atomic rename. The manifest is the *only* commit point: whatever
  it references is a complete, consistent state, and `open()` deletes
  any segment/WAL files it does not reference (the debris of a crash
  mid-checkpoint or mid-compaction);
* **write-ahead log** — every `upsert`/`delete` appends a CRC-framed
  record *before* the in-memory state mutates (fsync batched by the
  ``sync_every`` knob, group commit off the handle's lock), and
  `compact_async` logs a barrier record at its snapshot point, so replay
  reproduces compactions exactly. A torn tail (crash mid-write) is
  detected by length/CRC and truncated on recovery; a damaged record
  followed by a valid one (mid-log corruption) is refused;
* **stable external keys** — the per-generation key map rides in the
  segment, WAL upsert records carry their keys, and compaction barriers
  replay deterministically, so the keys a client saw before a crash
  resolve to the same vectors after `open()`.

The directory layout, the manifest, the segment files and the WAL's
byte layout are the JAX package's (`repro.ann.store`): a store written
by either package opens in the other and answers the same. The handle
lives on the device the caller names (`device=`, the card by default);
`open()` adopts every persisted method index onto it and rebuilds only
those without a file.

`IndexStore.open()` recovers base + WAL into a serving-ready live
handle (`store.index`); `checkpoint()` folds the current WAL into a new
segment generation; `compact()` runs a live compaction and commits the
new generation through the manifest before retiring the old segment.
`link_router()` records the router artifact + benchmark-table version
stamps, and `open()` refuses to serve when the artifact on disk no
longer matches. The WAL reports its fsync backlog to the process ledger
(`repro_torch.ann.ledger`) and the store opens `wal.append`,
`wal.fsync`, `store.checkpoint` and `store.commit_manifest` spans under
an ambient trace (`repro_torch.ann.trace`).
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import time
import zlib

import numpy as np

from repro_torch.ann import labels as lb
from repro_torch.ann import ledger as ledger_mod
from repro_torch.ann import registry as registry_mod
from repro_torch.ann import trace
from repro_torch.ann.dataset import ANNDataset, fsync_path
from repro_torch.ann.live import (DEFAULT_DELTA_CHUNK, ChunkIndex,
                                  LiveFilteredIndex, ShardedLiveIndex)

STORE_FORMAT = "repro.index-store"
STORE_VERSION = 1
MANIFEST = "MANIFEST.json"
_SEGMENTS_DIR = "segments"
_WAL_DIR = "wal"
_KEYS_FILE = "keys.npy"
_INDEX_DIR = "indexes"
_CHUNK_DIR = "delta_chunks"

# ---------------------------------------------------------------------------
# write-ahead log
# ---------------------------------------------------------------------------

_WAL_MAGIC = b"RPWAL001"
_WAL_HEADER = struct.Struct("<IIQ")          # dim, width, generation
_REC_HEADER = struct.Struct("<IBQII")        # magic, type, gen, len, crc
_REC_MAGIC = 0x52574C52
REC_UPSERT, REC_DELETE, REC_COMPACT = 1, 2, 3


class WalRecord:
    """One replayed WAL operation (`kind` ∈ upsert/delete/compact)."""

    __slots__ = ("kind", "gen", "keys", "vectors", "bitmaps", "ids")

    def __init__(self, kind, gen, keys=None, vectors=None, bitmaps=None,
                 ids=None):
        self.kind = kind
        self.gen = gen
        self.keys = keys
        self.vectors = vectors
        self.bitmaps = bitmaps
        self.ids = ids


class WriteAheadLog:
    """Append-only CRC-framed operation log with group-commit fsync.

    Record frame: ``<IBQII`` header (magic, type, generation,
    payload_len, crc32(payload)) + payload. The file starts with a
    24-byte header (magic, dim, width, creation generation).

    Durability is split from appending so callers log under their own
    write lock but fsync *off* it: `log_*` writes the record to the OS
    (`flush`) and returns its sequence number; `commit(seq)` makes it
    durable before the operation is acknowledged. With ``sync_every ==
    1`` every commit waits for an fsync, but concurrent committers share
    one: the first caller into `wait_durable` becomes the fsync leader
    and its single fsync covers every record appended so far, so
    followers return without touching the disk (group commit). Larger
    ``sync_every`` values skip the wait until that many records
    accumulate.
    """

    def __init__(self, path: str, file, *, dim: int, width: int,
                 sync_every: int = 1):
        self.path = path
        self.dim = int(dim)
        self.width = int(width)
        self.sync_every = max(1, int(sync_every))
        self._f = file
        self._mu = threading.Lock()        # serializes appends
        self._fsync_mu = threading.Lock()  # serializes fsync leaders
        self._seq = 0                      # records appended (and flushed)
        self._durable_seq = 0              # records covered by an fsync
        self._bytes = 0                    # payload+frame bytes appended
        self._durable_bytes = 0            # bytes covered by an fsync
        self._closed = False
        # fsync backlog (unsynced records + bytes) as a pull gauge on the
        # process ledger
        self._ledger_key = f"wal:{os.path.basename(path)}:{id(self):x}"
        ledger_mod.get_ledger().register_collector(
            self._ledger_key, self.backlog)

    # ---- lifecycle ------------------------------------------------------
    @classmethod
    def create(cls, path: str, *, dim: int, width: int, generation: int,
               sync_every: int = 1) -> "WriteAheadLog":
        """Start a fresh WAL file (truncates an existing one)."""
        f = open(path, "wb")
        f.write(_WAL_MAGIC + _WAL_HEADER.pack(dim, width, int(generation)))
        f.flush()
        os.fsync(f.fileno())
        return cls(path, f, dim=dim, width=width, sync_every=sync_every)

    @classmethod
    def open_append(cls, path: str, *, dim: int, width: int,
                    sync_every: int = 1) -> "WriteAheadLog":
        """Append to an existing (already replayed/truncated) WAL."""
        f = open(path, "ab")
        return cls(path, f, dim=dim, width=width, sync_every=sync_every)

    def sync(self) -> None:
        """Force every appended record to durable storage."""
        self.wait_durable(self._seq)

    def wait_durable(self, seq: int) -> None:
        """Block until record `seq` is fsynced. One concurrent caller
        becomes the leader whose single fsync covers every record
        flushed so far; the rest find `_durable_seq` already past their
        seq and return without an fsync of their own."""
        if self._durable_seq >= seq:
            return
        with self._fsync_mu:
            if self._durable_seq >= seq or self._closed:
                return
            with self._mu:
                target = self._seq        # all appended records are flushed
                target_bytes = self._bytes
            with trace.span("wal.fsync", covered=target):
                os.fsync(self._f.fileno())
            self._durable_seq = max(self._durable_seq, target)
            self._durable_bytes = max(self._durable_bytes, target_bytes)

    def commit(self, seq: int) -> None:
        """The ack point for record `seq`: durable before returning when
        ``sync_every == 1``, otherwise fsync only once a batch of
        ``sync_every`` records has accumulated. Call it *outside* any
        lock readers contend on."""
        if self.sync_every == 1 or seq - self._durable_seq >= self.sync_every:
            self.wait_durable(seq)

    def backlog(self) -> dict:
        """Fsync backlog: records flushed to the OS but not yet durable,
        and the bytes they cover (the crash-loss window)."""
        with self._mu:
            return {"records": self._seq - self._durable_seq,
                    "bytes": self._bytes - self._durable_bytes}

    def close(self) -> None:
        ledger_mod.get_ledger().deregister_collector(self._ledger_key)
        if not self._closed:
            self.sync()
            with self._fsync_mu, self._mu:
                self._f.close()
                self._closed = True

    # ---- append ---------------------------------------------------------
    def _append(self, rtype: int, gen: int, payload: bytes) -> int:
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        with trace.span("wal.append", rtype=rtype,
                        payload_bytes=len(payload)):
            with self._mu:
                if self._closed:
                    raise RuntimeError(f"WAL {self.path!r} is closed")
                self._f.write(_REC_HEADER.pack(_REC_MAGIC, rtype,
                                               int(gen),
                                               len(payload), crc))
                self._f.write(payload)
                self._f.flush()
                self._seq += 1
                self._bytes += _REC_HEADER.size + len(payload)
                return self._seq

    def log_upsert(self, gen: int, keys: np.ndarray, vectors: np.ndarray,
                   bitmaps: np.ndarray) -> int:
        n = int(vectors.shape[0])
        payload = (struct.pack("<I", n)
                   + np.ascontiguousarray(keys, np.int64).tobytes()
                   + np.ascontiguousarray(vectors, np.float32).tobytes()
                   + np.ascontiguousarray(bitmaps, np.uint32).tobytes())
        return self._append(REC_UPSERT, gen, payload)

    def log_delete(self, gen: int, ids: np.ndarray) -> int:
        ids = np.ascontiguousarray(ids, np.int64)
        payload = struct.pack("<I", ids.size) + ids.tobytes()
        return self._append(REC_DELETE, gen, payload)

    def log_compact(self, gen: int) -> int:
        return self._append(REC_COMPACT, gen, b"")

    # ---- replay ---------------------------------------------------------
    @staticmethod
    def replay(path: str, *, dim: int, width: int,
               truncate: bool = True) -> list[WalRecord]:
        """Parse every complete record; detect a torn tail (short or
        CRC-failing trailing bytes, the signature of a crash mid-write)
        and, with ``truncate=True``, cut the file back to the last good
        record so later appends extend a clean log.

        A bad record *followed by another valid one* is not a torn tail
        but mid-log corruption, and truncating there would discard
        fsync-acknowledged operations: that case raises ValueError."""
        with open(path, "rb") as f:
            data = f.read()
        head = len(_WAL_MAGIC) + _WAL_HEADER.size
        if len(data) < head or data[: len(_WAL_MAGIC)] != _WAL_MAGIC:
            raise ValueError(f"{path!r} is not a write-ahead log")
        fdim, fwidth, _ = _WAL_HEADER.unpack(
            data[len(_WAL_MAGIC): head])
        if (fdim, fwidth) != (dim, width):
            raise ValueError(
                f"WAL {path!r} was written for dim={fdim}/width={fwidth}; "
                f"store expects dim={dim}/width={width}")
        records: list[WalRecord] = []
        off = head
        good = off
        while True:
            if off + _REC_HEADER.size > len(data):
                break                          # torn or clean end
            magic, rtype, gen, plen, crc = _REC_HEADER.unpack(
                data[off: off + _REC_HEADER.size])
            body_at = off + _REC_HEADER.size
            if magic != _REC_MAGIC or body_at + plen > len(data):
                break
            payload = data[body_at: body_at + plen]
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                break
            rec = WriteAheadLog._parse(rtype, gen, payload, dim, width)
            if rec is None:
                break
            records.append(rec)
            off = body_at + plen
            good = off
        if good < len(data):
            if WriteAheadLog._valid_record_after(data, good, dim, width):
                raise ValueError(
                    f"WAL {path!r} is corrupt at byte {good}: a valid "
                    f"record follows the damaged one, so this is mid-log "
                    f"corruption, not a torn tail — truncating would "
                    f"silently discard acknowledged operations. Restore "
                    f"the log from a replica or recover the tail "
                    f"manually.")
            if truncate:
                with open(path, "r+b") as f:
                    f.truncate(good)
                    f.flush()
                    os.fsync(f.fileno())
        return records

    @staticmethod
    def _valid_record_after(data: bytes, off: int, dim: int,
                            width: int) -> bool:
        """True if a complete, CRC-valid record starts anywhere after
        `off`: a torn tail has nothing valid after it, mid-log
        corruption has acknowledged records."""
        magic = struct.pack("<I", _REC_MAGIC)
        pos = data.find(magic, off + 1)
        while pos != -1:
            if pos + _REC_HEADER.size <= len(data):
                _, rtype, gen, plen, crc = _REC_HEADER.unpack(
                    data[pos: pos + _REC_HEADER.size])
                body = pos + _REC_HEADER.size
                if body + plen <= len(data):
                    payload = data[body: body + plen]
                    if ((zlib.crc32(payload) & 0xFFFFFFFF) == crc
                            and WriteAheadLog._parse(
                                rtype, gen, payload, dim, width)
                            is not None):
                        return True
            pos = data.find(magic, pos + 1)
        return False

    @staticmethod
    def _parse(rtype, gen, payload, dim, width):
        try:
            if rtype == REC_COMPACT:
                return WalRecord("compact", gen)
            (n,) = struct.unpack_from("<I", payload, 0)
            body = payload[4:]
            if rtype == REC_DELETE:
                if len(body) != 8 * n:
                    return None
                return WalRecord("delete", gen,
                                 ids=np.frombuffer(body, np.int64).copy())
            if rtype == REC_UPSERT:
                kb, vb = 8 * n, 4 * n * dim
                if len(body) != kb + vb + 4 * n * width:
                    return None
                return WalRecord(
                    "upsert", gen,
                    keys=np.frombuffer(body[:kb], np.int64).copy(),
                    vectors=np.frombuffer(
                        body[kb: kb + vb], np.float32
                    ).reshape(n, dim).copy(),
                    bitmaps=np.frombuffer(
                        body[kb + vb:], np.uint32
                    ).reshape(n, width).copy())
        except struct.error:
            return None
        return None                            # unknown record type


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _snapshot_base(index, snap) -> ANNDataset | None:
    """The sealed base dataset a pinned snapshot reads (None when the
    epoch has no base)."""
    if isinstance(index, ShardedLiveIndex):
        return snap.base_ds
    return index._base_for(snap).ds if snap.base_n else None


class IndexStore:
    """Directory-backed durable home of one live index.

    Use the classmethod constructors — `create` for a fresh directory,
    `open` to recover an existing one — and serve through
    ``store.index`` (a WAL-attached `LiveFilteredIndex` or
    `ShardedLiveIndex`). The store owns the handle and the WAL;
    `close()` releases both.
    """

    def __init__(self, path: str, index, manifest: dict,
                 wal: WriteAheadLog | None, *, registry=None,
                 sync_every: int = 1):
        self.path = os.path.abspath(path)
        self._index = index
        self._manifest = manifest
        self._wal = wal
        self._registry = registry
        self._sync_every = int(sync_every)
        self._store_generation = -1
        self._replayed_records = 0
        self._closed = False

    # ---- constructors ---------------------------------------------------
    @classmethod
    def create(cls, path: str, source=None, *, name: str | None = None,
               dim: int | None = None, universe: int | None = None,
               n_shards: int = 1, router_dir: str | None = None,
               registry=None, device="cuda", sync_every: int = 1,
               delta_chunk: int = DEFAULT_DELTA_CHUNK,
               parallel: bool = True) -> "IndexStore":
        """Initialise a store directory and write generation 0.

        Args:
            path: target directory (created if missing; must not already
                be a store).
            source: what to persist — an `ANNDataset` (wrapped in a live
                handle on `device`), an existing `LiveFilteredIndex` /
                `ShardedLiveIndex` (its current state captured, delta,
                tombstones and keys included; its built indexes
                persisted), or None for an empty index (then
                `name`/`dim`/`universe` are required).
            n_shards: shard count when `source` is a dataset or None
                (live handles keep their own layout).
            router_dir: optional router artifact directory to link and
                version-stamp (see `link_router`).
            device: where a handle made here lives: "cuda" (the
                default; a sharded handle spreads its shards over the
                host's cards as `ShardedLiveIndex` does) or "cpu".
                Without a card the default raises RuntimeError.
        Returns: the open store; `store.index` is the WAL-attached
            serving handle (the store owns `source` from here on).
        Raises: ValueError if `path` already holds a store or the
            source/naming arguments are inconsistent.
        """
        path = os.path.abspath(path)
        if os.path.exists(os.path.join(path, MANIFEST)):
            raise ValueError(
                f"{path!r} is already an index store; use IndexStore.open")
        os.makedirs(os.path.join(path, _SEGMENTS_DIR), exist_ok=True)
        os.makedirs(os.path.join(path, _WAL_DIR), exist_ok=True)
        index = cls._coerce_source(source, name=name, dim=dim,
                                   universe=universe, n_shards=n_shards,
                                   registry=registry, device=device,
                                   delta_chunk=delta_chunk,
                                   parallel=parallel)
        store = cls(path, index, {}, None, registry=registry,
                    sync_every=sync_every)
        store.checkpoint()
        if router_dir is not None:
            store.link_router(router_dir)
        return store

    @staticmethod
    def _coerce_source(source, *, name, dim, universe, n_shards, registry,
                       device, delta_chunk, parallel):
        if isinstance(source, (LiveFilteredIndex, ShardedLiveIndex)):
            return source
        if isinstance(source, ANNDataset):
            if n_shards > 1:
                return ShardedLiveIndex(source, n_shards,
                                        registry=registry, device=device,
                                        delta_chunk=delta_chunk,
                                        parallel=parallel)
            return LiveFilteredIndex(source, registry=registry,
                                     device=device, delta_chunk=delta_chunk)
        if source is None:
            if name is None or dim is None or universe is None:
                raise ValueError(
                    "an empty IndexStore needs name=, dim= and universe= "
                    "(or pass a dataset / live handle as source)")
            if n_shards > 1:
                return ShardedLiveIndex(
                    None, n_shards, name=name, dim=dim, universe=universe,
                    registry=registry, device=device,
                    delta_chunk=delta_chunk, parallel=parallel)
            return LiveFilteredIndex.empty(
                name, dim, universe, registry=registry, device=device,
                delta_chunk=delta_chunk)
        raise TypeError(
            f"source must be an ANNDataset, LiveFilteredIndex, "
            f"ShardedLiveIndex or None; got {type(source).__name__}")

    @classmethod
    def open(cls, path: str, *, registry=None, device="cuda",
             sync_every: int = 1, delta_chunk: int = DEFAULT_DELTA_CHUNK,
             parallel: bool = True, mmap: bool = True,
             verify: bool = False,
             router_dir: str | None = None) -> "IndexStore":
        """Recover a store (written by either package) into a
        serving-ready live handle on `device` (as in `create`).

        Recovery = read the manifest (the commit point), delete
        unreferenced segment/WAL debris, memmap the base segment, restore
        the stable-key map and adopt the persisted built indexes, then
        replay the WAL (truncating a torn tail; compaction barriers
        re-run the compaction so ids and keys come back exactly), and
        adopt the persisted delta-chunk indexes.

        Args:
            mmap: memmap the segment arrays (default) instead of
                loading them into RAM.
            verify: re-hash the segment files against their recorded
                sha1 checksums (full read; default checks sizes only).
            router_dir: re-link the router artifact at this path
                (records its current version stamps) instead of
                validating the previously linked one — the migration
                override for a moved or re-saved artifact.
        Raises:
            ValueError: not a store, a newer store version, a corrupt
                segment or WAL, or a linked router/table whose version
                stamps no longer match the manifest (the error names
                both version pairs and the migration options).
        """
        path = os.path.abspath(path)
        mpath = os.path.join(path, MANIFEST)
        if not os.path.exists(mpath):
            raise ValueError(f"{path!r} is not an index store (no "
                             f"{MANIFEST})")
        with open(mpath) as f:
            manifest = json.load(f)
        if manifest.get("format") != STORE_FORMAT:
            raise ValueError(
                f"{path!r} is not a {STORE_FORMAT} directory "
                f"(format={manifest.get('format')!r})")
        if int(manifest.get("version", -1)) > STORE_VERSION:
            raise ValueError(
                f"store version {manifest['version']} is newer than "
                f"supported version {STORE_VERSION}")

        store = cls(path, None, manifest, None, registry=registry,
                    sync_every=sync_every)
        store._store_generation = int(manifest["store_generation"])
        if router_dir is not None:
            store.link_router(router_dir)
        elif manifest.get("router"):
            store._validate_router(manifest["router"])
        store._clean_stale()

        seg_dir = os.path.join(path, manifest["segment"])
        ds = ANNDataset.load_segment(seg_dir, mmap=mmap, verify=verify)
        base_keys = np.load(os.path.join(seg_dir, _KEYS_FILE))
        live_gen = int(manifest["live_generation"])
        next_key = int(manifest["next_key"])
        common = dict(name=manifest["name"], dim=int(manifest["dim"]),
                      universe=int(manifest["universe"]), registry=registry,
                      delta_chunk=delta_chunk,
                      base_keys=base_keys if ds.n else None,
                      next_key=next_key, generation=live_gen)
        if manifest["kind"] == "sharded":
            index = ShardedLiveIndex(
                ds if ds.n else None, int(manifest["n_shards"]),
                device=device, parallel=parallel, **common)
        else:
            index = LiveFilteredIndex(ds if ds.n else None, device=device,
                                      **common)
        store._index = index
        store._restore_built(index, seg_dir, manifest.get("built", []))

        wal_path = os.path.join(path, manifest["wal"])
        width = int(manifest["width"])
        records = WriteAheadLog.replay(wal_path, dim=int(manifest["dim"]),
                                       width=width, truncate=True)
        store._apply_records(index, records)
        store._adopt_chunk_indexes(index, seg_dir, manifest, records)
        store._wal = WriteAheadLog.open_append(
            wal_path, dim=int(manifest["dim"]), width=width,
            sync_every=sync_every)
        index.attach_wal(store._wal)
        store._replayed_records = len(records)
        return store

    # ---- recovery internals ---------------------------------------------
    def _clean_stale(self) -> None:
        """Delete segment dirs / WAL files the manifest does not
        reference — the debris of a crash between writing a new
        generation and committing the manifest rename."""
        keep_seg = os.path.basename(self._manifest["segment"])
        seg_root = os.path.join(self.path, _SEGMENTS_DIR)
        if os.path.isdir(seg_root):
            for entry in os.listdir(seg_root):
                if entry != keep_seg:
                    shutil.rmtree(os.path.join(seg_root, entry),
                                  ignore_errors=True)
        keep_wal = os.path.basename(self._manifest["wal"])
        wal_root = os.path.join(self.path, _WAL_DIR)
        if os.path.isdir(wal_root):
            for entry in os.listdir(wal_root):
                if entry != keep_wal:
                    try:
                        os.remove(os.path.join(wal_root, entry))
                    except OSError:
                        pass

    def _restore_built(self, index, seg_dir: str, built: list) -> None:
        """Restore `built_keys()` on load: adopt every persisted index
        file onto its handle's device (single, or one file per shard),
        and run the offline build only for an entry without a file."""
        reg = self._registry or registry_mod.default_registry()
        if isinstance(index, ShardedLiveIndex):
            all_fx = [s._base_fx for s in index.shards]
        else:
            all_fx = [index._base_fx]
        adopt = self._adopt_index_file
        for m_name, bp, fname in built:
            bp_t = tuple((k, v) for k, v in bp)
            try:
                method = reg.get(m_name)
            except KeyError:
                continue                      # method no longer registered
            if isinstance(fname, list):       # per-shard persisted files
                files = (fname if len(fname) == len(all_fx)
                         else [None] * len(all_fx))
                for fx, fn in zip(all_fx, files):
                    if fx is None:
                        continue
                    if fn is not None:
                        adopt(fx, seg_dir, fn, method, bp_t)
                    else:
                        fx.get_index(method, bp_t)
                continue
            for fx in all_fx:
                if fx is None:
                    continue
                if fname is not None and len(all_fx) == 1:
                    adopt(fx, seg_dir, fname, method, bp_t)
                else:
                    fx.get_index(method, bp_t)

    @staticmethod
    def _adopt_index_file(fx, seg_dir: str, fname: str, method,
                          bp_t: tuple) -> None:
        """Read one persisted index file and install it on `fx`."""
        with np.load(os.path.join(seg_dir, fname)) as z:
            arrays = {k: z[k] for k in z.files}
        fx.adopt_index(method, bp_t, registry_mod.deserialize_index(
            method, fx.ds, dict(bp_t), arrays))

    def _adopt_chunk_indexes(self, index, seg_dir: str, manifest: dict,
                             records: list[WalRecord]) -> None:
        """Install the checkpointed sealed-chunk mini-IVF structures on
        the recovered handle. WAL replay reproduces the delta rows in
        their original insertion order, so chunk i covers the same rows
        it did at checkpoint time — unless a compact barrier replayed
        (the delta was rebuilt) or the handle was opened with another
        `delta_chunk` (the boundaries moved); both cases skip adoption
        and leave the chunks to the lazy build."""
        entry = manifest.get("delta_chunks")
        if (not entry or not isinstance(index, LiveFilteredIndex)
                or int(entry.get("chunk", -1)) != index._delta_chunk
                or any(r.kind == "compact" for r in records)):
            return
        adopt: dict[int, ChunkIndex] = {}
        for i, fn in enumerate(entry["files"]):
            with np.load(os.path.join(seg_dir, fn)) as z:
                adopt[i] = ChunkIndex.from_arrays({k: z[k] for k in z.files})
        index._delta.adopt_chunk_indexes(adopt)

    def _apply_records(self, index, records: list[WalRecord]) -> None:
        """Replay WAL operations onto the freshly loaded handle.

        Generations in the records are absolute; the handle was
        constructed at the manifest's generation, a ``compact`` barrier
        re-runs the compaction synchronously (the same rows, remap and
        new ids as the original fold), and a record tagged one
        generation behind (an op that raced the original compaction) is
        translated the way the live handle translated it at swap time:
        snapshot-covered ids through `last_remap`, tail ids (rows
        upserted after the compaction snapshot) by their insertion order
        in the new delta.
        """
        # (n_total before the replayed compact, remap, n_total after it)
        ctx: tuple | None = None
        for rec in records:
            cur = index.generation
            if rec.kind == "upsert":
                if rec.gen not in (cur, cur - 1):
                    raise ValueError(
                        f"WAL upsert for generation {rec.gen} cannot apply "
                        f"at generation {cur} (corrupt log)")
                index.upsert(rec.vectors, rec.bitmaps, keys=rec.keys)
            elif rec.kind == "delete":
                ids = rec.ids
                if rec.gen == cur - 1:
                    if ctx is None:
                        raise ValueError(
                            "WAL delete predates a compaction the handle "
                            "has no remap for (corrupt log)")
                    prev_total, remap, post_total = ctx
                    tail = ids >= prev_total
                    out = np.empty_like(ids)
                    out[~tail] = remap[ids[~tail]]
                    # tail rows re-enter the delta in their insertion
                    # order right after the compaction's survivors, so
                    # id prev_total + j became post_total + j (post_total,
                    # not base_n: a sharded compaction whose survivors
                    # fall below the shard count replays them as delta
                    # with base_n = 0)
                    out[tail] = post_total + (ids[tail] - prev_total)
                    ids = out[out >= 0]
                elif rec.gen != cur:
                    raise ValueError(
                        f"WAL delete for generation {rec.gen} cannot apply "
                        f"at generation {cur} (corrupt log)")
                if ids.size:
                    index.delete(ids)
            elif rec.kind == "compact":
                if rec.gen == cur:
                    prev_total = index.n_total
                    index.compact()
                    ctx = (prev_total, index.last_remap(), index.n_total)
                elif rec.gen != cur - 1:
                    raise ValueError(
                        f"WAL compact barrier for generation {rec.gen} "
                        f"cannot apply at generation {cur} (corrupt log)")

    # ---- serving surface -------------------------------------------------
    @property
    def index(self):
        """The WAL-attached live handle (serve through this)."""
        self._check_open()
        return self._index

    @property
    def manifest(self) -> dict:
        """The committed manifest (a copy)."""
        return dict(self._manifest)

    @property
    def store_generation(self) -> int:
        return self._store_generation

    def load_dataset(self, *, mmap: bool = True) -> ANNDataset:
        """The current generation's base dataset straight from its
        segment (independent of the live handle)."""
        self._check_open()
        return ANNDataset.load_segment(
            os.path.join(self.path, self._manifest["segment"]), mmap=mmap)

    # ---- router linkage --------------------------------------------------
    def link_router(self, router_dir: str) -> dict:
        """Record (and version-stamp) the router artifact this store
        serves with. `open()` re-validates the stamps every time, so a
        re-trained or swapped artifact fails loudly instead of routing
        with a stale benchmark table. Returns the recorded entry."""
        from repro_torch.core.router import artifact_versions

        self._check_open()
        router_dir = os.path.abspath(router_dir)
        versions = artifact_versions(router_dir)
        rel = os.path.relpath(router_dir, self.path)
        entry = {"path": rel if not rel.startswith("..") else router_dir,
                 **versions}
        manifest = dict(self._manifest)
        manifest["router"] = entry
        self._commit_manifest(manifest)
        return entry

    def _router_path(self, entry: dict) -> str:
        p = entry["path"]
        return p if os.path.isabs(p) else os.path.join(self.path, p)

    def _validate_router(self, entry: dict) -> None:
        from repro_torch.core.router import artifact_versions

        rpath = self._router_path(entry)
        try:
            cur = artifact_versions(rpath)
        except ValueError as e:
            raise ValueError(
                f"store-linked router artifact is unreadable: {e}; "
                f"re-save the router with MLRouter.save() and re-link it "
                f"(IndexStore.link_router, or router_dir= on open)"
            ) from None
        hint = ("the artifact was re-saved or swapped under the store. "
                "Migrate by re-linking the intended artifact — "
                "IndexStore.link_router(dir) or IndexStore.open(..., "
                "router_dir=dir) — or restore the original artifact "
                "directory.")
        if (cur["router_version"] != int(entry["router_version"])
                or cur["table_version"] != int(entry["table_version"])):
            raise ValueError(
                f"router artifact at {rpath!r} carries (router "
                f"v{cur['router_version']}, table "
                f"v{cur['table_version']}) but this store was linked "
                f"against (router v{entry['router_version']}, table "
                f"v{entry['table_version']}); {hint}")
        want_sha = entry.get("content_sha1")
        if want_sha and cur["content_sha1"] != want_sha:
            raise ValueError(
                f"router artifact at {rpath!r} matches the linked format "
                f"versions (router v{cur['router_version']}, table "
                f"v{cur['table_version']}) but its content changed "
                f"(sha1 {want_sha[:12]} -> "
                f"{cur['content_sha1'][:12]}) — a re-trained router or a "
                f"swapped benchmark table; {hint}")

    def load_router(self):
        """Load the linked (and just-validated) `MLRouter`."""
        from repro_torch.core.router import MLRouter

        self._check_open()
        entry = self._manifest.get("router")
        if not entry:
            raise ValueError(
                f"store {self.path!r} has no linked router artifact "
                f"(IndexStore.link_router first)")
        self._validate_router(entry)
        return MLRouter.load(self._router_path(entry))

    # ---- durability ------------------------------------------------------
    def sync(self) -> None:
        """fsync any WAL records still in the batching window."""
        self._check_open()
        if self._wal is not None:
            self._wal.sync()

    def checkpoint(self) -> int:
        """Fold the current state into a fresh segment generation.

        Writes the base segment (+ keys + persistable built indexes and
        sealed delta-chunk indexes) outside the write lock, then — under
        the lock, so no operation can fall between the two — starts a
        new WAL seeded with the residual delta/tombstone state, commits
        the manifest by atomic rename, and swaps the live handle onto
        the new WAL. Only after the commit are the old segment and WAL
        deleted; a crash at any earlier point leaves the previous
        generation intact. Returns the new store generation.
        """
        self._check_open()
        with trace.span("store.checkpoint"):
            return self._checkpoint_impl()

    def _checkpoint_impl(self) -> int:
        index = self._index
        dim = int(index._dim)
        width = lb.n_words(index._universe)
        for _ in range(5):          # retry if a compaction swaps mid-write
            old_seg_rel = self._manifest.get("segment")
            store_gen = self._store_generation + 1
            seg_rel = os.path.join(_SEGMENTS_DIR, f"gen-{store_gen:06d}")
            wal_rel = os.path.join(_WAL_DIR, f"wal-{store_gen:06d}.log")
            seg_dir = os.path.join(self.path, seg_rel)
            committed = False
            wal = old_wal = None
            snap = index.snapshot()
            try:
                state = index.export_state(snap)
                gen = state["generation"]
                base_ds = _snapshot_base(index, snap)
                if base_ds is None:
                    base_ds = ANNDataset.from_packed(
                        index._name, np.zeros((0, dim), np.float32),
                        np.zeros((0, width), np.uint32), index._universe)
                base_ds.save_segment(seg_dir)
                np.save(os.path.join(seg_dir, _KEYS_FILE),
                        np.ascontiguousarray(state["base_keys"], np.int64))
                built = self._persist_indexes(index, seg_dir)
                chunk_files = self._persist_chunk_indexes(index, seg_dir)
                extras = [_KEYS_FILE] + list(chunk_files)
                for b in built:
                    fs = b[2] if isinstance(b[2], list) else [b[2]]
                    extras.extend(f for f in fs if f)
                for extra in extras:
                    fsync_path(os.path.join(seg_dir, extra))
                fsync_path(seg_dir)
                with index._lock:
                    if index.generation != gen:
                        continue          # raced: finally drops the files
                    snap2 = index.snapshot()
                    try:
                        state2 = index.export_state(snap2)
                        wal = WriteAheadLog.create(
                            os.path.join(self.path, wal_rel), dim=dim,
                            width=width, generation=gen,
                            sync_every=self._sync_every)
                        self._seed_wal(wal, gen, state2)
                        wal.sync()
                        manifest = self._manifest_dict(
                            index, store_gen, seg_rel, wal_rel, gen,
                            state2["next_key"], base_ds.n, built,
                            chunk_files)
                        self._commit_manifest(manifest)
                        old_wal, self._wal = self._wal, wal
                        index.attach_wal(wal)
                        self._store_generation = store_gen
                        committed = True
                    finally:
                        snap2.release()
            finally:
                snap.release()
                if not committed:
                    # failed (or raced) attempt: the old generation is
                    # still the committed state — drop the half-written
                    # files instead of leaking them
                    if wal is not None:
                        wal.close()
                        try:
                            os.remove(wal.path)
                        except OSError:
                            pass
                    shutil.rmtree(seg_dir, ignore_errors=True)
            if old_wal is not None:
                old_path = old_wal.path
                old_wal.close()
                try:
                    os.remove(old_path)
                except OSError:
                    pass
            if old_seg_rel and old_seg_rel != seg_rel:
                shutil.rmtree(os.path.join(self.path, old_seg_rel),
                              ignore_errors=True)
            return store_gen
        raise RuntimeError(
            "checkpoint kept losing the generation race against "
            "concurrent compactions; quiesce compact() and retry")

    @staticmethod
    def _seed_wal(wal: WriteAheadLog, gen: int, state: dict,
                  chunk: int = 1024) -> None:
        """Write the residual (non-segment) state as ordinary records:
        the delta rows in insertion order, then one delete record for
        every tombstone. Replaying them onto the freshly loaded base
        reproduces the checkpointed state exactly."""
        dvec, dbm = state["delta_vectors"], state["delta_bitmaps"]
        dkeys = state["delta_keys"]
        for s in range(0, dvec.shape[0], chunk):
            e = min(s + chunk, dvec.shape[0])
            wal.log_upsert(gen, dkeys[s:e], dvec[s:e], dbm[s:e])
        if state["dead_ids"].size:
            wal.log_delete(gen, state["dead_ids"])

    def _persist_indexes(self, index, seg_dir: str) -> list:
        """Serialize the built method indexes that support it. Returns
        the manifest's `built` list: [method, build_params, file-spec]
        where file-spec is a filename (single index), a per-shard list
        of filenames/nulls (sharded), or null (rebuild on open)."""
        built: list = []
        reg = self._registry or registry_mod.default_registry()
        idx_dir = os.path.join(seg_dir, _INDEX_DIR)
        if isinstance(index, ShardedLiveIndex):
            shards = list(index.shards)
            seen: list = []
            for s in shards:
                for key in s.built_keys():
                    if key not in seen:
                        seen.append(key)
            for i, (m_name, bp) in enumerate(seen):
                try:
                    method = reg.get(m_name)
                except KeyError:
                    continue
                files: list = []
                for j, s in enumerate(shards):
                    fx = s._base_fx
                    arrays = None
                    if fx is not None and (m_name, bp) in fx._indexes:
                        arrays = registry_mod.serialize_index(
                            method, fx._indexes[(m_name, bp)])
                    if arrays is None:
                        files.append(None)
                        continue
                    os.makedirs(idx_dir, exist_ok=True)
                    fname = os.path.join(_INDEX_DIR,
                                         f"{m_name}-{i}-s{j}.npz")
                    np.savez(os.path.join(seg_dir, fname), **arrays)
                    files.append(fname)
                built.append([m_name, [list(kv) for kv in bp],
                              files if any(files) else None])
            return built
        fx = index._base_fx
        if fx is None:
            return built
        for i, (m_name, bp) in enumerate(fx.built_keys()):
            fname = None
            try:
                method = reg.get(m_name)
                arrays = registry_mod.serialize_index(
                    method, fx._indexes[(m_name, bp)])
            except KeyError:
                continue
            if arrays is not None:
                os.makedirs(idx_dir, exist_ok=True)
                fname = os.path.join(_INDEX_DIR, f"{m_name}-{i}.npz")
                np.savez(os.path.join(seg_dir, fname), **arrays)
            built.append([m_name, [list(kv) for kv in bp], fname])
        return built

    def _persist_chunk_indexes(self, index, seg_dir: str) -> list:
        """Write the already-built sealed-chunk mini-IVF structures
        (`live.ChunkIndex`) next to the segment so `open()` adopts them
        instead of re-clustering the replayed delta. Single handles
        only — a sharded delta re-derives per shard lazily."""
        if not isinstance(index, LiveFilteredIndex):
            return []
        chunks = index._delta.built_chunk_indexes()
        if not chunks:
            return []
        cdir = os.path.join(seg_dir, _CHUNK_DIR)
        os.makedirs(cdir, exist_ok=True)
        files = []
        for i, ci in enumerate(chunks):
            fname = os.path.join(_CHUNK_DIR, f"chunk-{i:04d}.npz")
            np.savez(os.path.join(seg_dir, fname), **ci.arrays())
            files.append(fname)
        return files

    def _manifest_dict(self, index, store_gen, seg_rel, wal_rel, live_gen,
                       next_key, n_base, built, chunk_files=()) -> dict:
        return {
            "format": STORE_FORMAT,
            "version": STORE_VERSION,
            "name": index._name,
            "dim": int(index._dim),
            "universe": int(index._universe),
            "width": lb.n_words(index._universe),
            "kind": ("sharded" if isinstance(index, ShardedLiveIndex)
                     else "live"),
            "n_shards": (index.n_shards
                         if isinstance(index, ShardedLiveIndex) else 1),
            "store_generation": int(store_gen),
            "live_generation": int(live_gen),
            "segment": seg_rel,
            "wal": wal_rel,
            "next_key": int(next_key),
            "n_base": int(n_base),
            "router": self._manifest.get("router"),
            "built": built,
            "delta_chunks": ({"chunk": int(index._delta_chunk),
                              "files": list(chunk_files)}
                             if chunk_files else None),
            "updated": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }

    def _commit_manifest(self, manifest: dict) -> None:
        """Atomic manifest replace — the store's only commit point."""
        with trace.span("store.commit_manifest",
                        store_generation=manifest.get("store_generation")):
            tmp = os.path.join(self.path, MANIFEST + ".tmp")
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.path, MANIFEST))
            fsync_path(self.path)                  # durable rename
            self._manifest = manifest

    def compact(self, timeout: float | None = None) -> int:
        """Live compaction + checkpoint: fold base+delta−tombstones into
        a fresh sealed generation, then commit it through the manifest
        before the old segment is retired. Returns the new live
        generation."""
        self._check_open()
        gen = self._index.compact(timeout=timeout)
        self.checkpoint()
        return gen

    # ---- lifecycle -------------------------------------------------------
    def stats(self) -> dict:
        """Store + handle state snapshot."""
        self._check_open()
        return {
            "path": self.path,
            "store_generation": self._store_generation,
            "segment": self._manifest.get("segment"),
            "wal": self._manifest.get("wal"),
            "router": self._manifest.get("router"),
            "replayed_records": self._replayed_records,
            "index": self._index.stats(),
        }

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(f"IndexStore({self.path!r}) is closed")

    def close(self) -> None:
        """fsync + detach the WAL and close the owned handle.
        Idempotent; everything `open()` needs is already on disk."""
        if self._closed:
            return
        self._closed = True
        if self._index is not None:
            self._index.attach_wal(None)
        if self._wal is not None:
            self._wal.close()
        if self._index is not None:
            self._index.close()

    def __enter__(self) -> "IndexStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
