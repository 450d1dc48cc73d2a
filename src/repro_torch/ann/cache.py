"""`SemanticResultCache` — a query-result cache + admission layer in
front of the serving facade.

At millions-of-users traffic the query stream is heavily repetitive and
near-duplicate, so the fastest search is the one that never runs. The
cache fronts a `RouterService`/`ShardedRouterService` (or, with
`method=`, any bare handle exposing `search(batch, method, setting)`)
and serves two kinds of hits:

* **exact** — byte-identical (query vector, query bitmap, predicate, k).
  The hit path is a dict lookup plus a freshness check: it bypasses
  routing *and* search entirely and returns the cached `SearchResult`
  slice verbatim (ids, exact distances, stable keys) — bit-identical to
  a fresh search at the entry's pinned snapshot.
* **semantic** — a cached query under the *same* (bitmap, predicate, k)
  whose cosine similarity to the incoming vector clears `threshold`.
  The neighbour's (staleness-checked) result rows are re-scored against
  the incoming vector — exact squared-L2 recomputed from the row
  vectors, re-sorted — so distances are exact for the returned rows,
  but the row *set* is the neighbour's top-k: an approximation that is
  only as good as the threshold. `threshold=None` disables this path.
* **transfer** — when no same-bitmap neighbour clears the threshold, a
  cached query under a provably *looser* filter may still serve: OR
  with cached labels ⊇ the query's, AND with cached labels ⊆ the
  query's.  Served only if every valid cached row also satisfies the
  tighter query filter (packed-bitmap re-check per row), which makes
  the cached top-k exactly the query's top-k over its admissible rows.

The semantic lookup reuses our own `FilteredIndex` as the cache's
lookup structure: cached query vectors + bitmaps form a tiny
`ANNDataset` (rebuilt every `rebuild_every` insertions, linear-scan
tail in between) and the hit test is an EQUALITY-predicate `prefilter`
search over it — identical-bitmap nearest neighbours only, which is
exactly the set a same-predicate result can transfer to.

Staleness is not TTL-guesswork: live handles stamp every label they
write with a monotone clock (`_LabelClockMixin` in `repro_torch.ann.live`),
and an entry recorded at clock `c` is served only while
`label_clock(entry labels) <= c` — upserts/deletes touching the
predicate's label set evict exactly the affected entries, writes to
disjoint labels don't. Compactions remap ids but never change the live
row set, so entries *survive* them: on a generation mismatch the hit
path re-resolves current ids through the stable keys (`rows_of`) and
re-sorts. Sealed handles report a constant clock and never go stale.
A TTL (`ttl_s`) caps entry age on top; `capacity` bounds the cache with
LRU eviction; `admit_after` is the admission doorkeeper (a key must
miss that many times before it is cached — keeps one-off queries from
churning the LRU).

Counters (hits/misses/evictions/insertions) surface through `stats()`
and, when a `TelemetrySink` is attached, through `sink.stats()
["counters"]` via `note()`. `AsyncBatchQueue` probes the cache before
batching (`probe_one`) and fills per-group on miss through the wrapped
`route`/`execute` pipeline.

This is the JAX package's module on this package's handles. The
similarity index of cached queries lives on the wrapped handle's device
(`torch_device`), so on a card each semantic probe is one `masked_topk`
launch over a few hundred rows. The hit paths' rescoring and bitmap
re-checks run on the host in float64: row vectors and bitmaps a live
handle hands back (`fetch`, `_bitmaps_of`) are brought to the host
first, whatever device they come from.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.ann import ledger as ledger_mod
from repro_torch.ann import trace
from repro_torch.ann.dataset import ANNDataset
from repro_torch.ann.index import FilteredIndex, QueryBatch, SearchResult
from repro_torch.ann.predicates import Predicate

__all__ = ["SemanticResultCache"]


def _host(x, dtype) -> np.ndarray:
    """`x` as a numpy array of `dtype` on the host (a tensor on any
    device is copied down first)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _labels_of(bitmap: np.ndarray) -> np.ndarray:
    """int64 label indices set in one packed [W] uint32 bitmap."""
    bits = np.unpackbits(
        np.ascontiguousarray(bitmap, dtype=np.uint32).view(np.uint8),
        bitorder="little")
    return np.nonzero(bits)[0].astype(np.int64)


class _Entry:
    """One cached (query, predicate, k) -> result mapping."""

    __slots__ = ("vector", "vnorm", "bitmap", "labels", "pred", "k",
                 "clock", "generation", "ids", "distances", "keys",
                 "expires_at", "alive", "ekey")

    @property
    def nbytes(self) -> int:
        return (self.vector.nbytes + self.bitmap.nbytes
                + self.labels.nbytes + self.ids.nbytes
                + self.distances.nbytes + self.keys.nbytes)

    def __init__(self, vector, bitmap, pred, k, *, clock, generation,
                 ids, distances, keys, expires_at, ekey):
        self.vector = np.array(vector, dtype=np.float32, copy=True)
        self.vnorm = float(np.sqrt((self.vector.astype(np.float64)
                                    ** 2).sum()))
        self.bitmap = np.array(bitmap, dtype=np.uint32, copy=True)
        self.labels = _labels_of(self.bitmap)
        self.pred = Predicate(pred)
        self.k = int(k)
        self.clock = int(clock)
        self.generation = int(generation)
        self.ids = np.array(ids, dtype=np.int32, copy=True)
        self.distances = np.array(distances, dtype=np.float32, copy=True)
        self.keys = np.array(keys, dtype=np.int64, copy=True)
        self.expires_at = expires_at
        self.alive = True
        self.ekey = ekey


class _SimPart:
    """Per-(predicate, k) similarity lookup over the partition's cached
    query vectors: a `FilteredIndex` over the queries-so-far (rebuilt
    every `rebuild_every` insertions) plus a linear-scan tail for
    entries newer than the last rebuild. The index lives on `device`,
    the wrapped handle's."""

    def __init__(self, universe: int, name: str, device):
        self.universe = universe
        self.name = name
        self.device = device
        self.fx: FilteredIndex | None = None
        self.built: list[_Entry] = []     # row i of fx.ds -> entry
        self.tail: list[_Entry] = []
        self.seq = 0

    def add(self, entry: _Entry, rebuild_every: int) -> None:
        self.tail.append(entry)
        if len(self.tail) >= max(int(rebuild_every), 1):
            self.rebuild()

    def rebuild(self) -> None:
        alive = [e for e in self.built + self.tail if e.alive]
        self.tail = []
        if self.fx is not None:
            self.fx.close()
            self.fx = None
        self.built = []
        if not alive:
            return
        vecs = np.stack([e.vector for e in alive])
        bms = np.stack([e.bitmap for e in alive])
        self.seq += 1
        ds, order = ANNDataset.from_packed(
            f"{self.name}/g{self.seq}", vecs, bms, self.universe,
            return_order=True)
        self.built = [alive[int(i)] for i in order]
        self.fx = FilteredIndex(ds, device=self.device)

    def candidates(self, vector: np.ndarray, bitmap: np.ndarray,
                   probe: int) -> list[_Entry]:
        """Cached entries with `bitmap` exactly equal to the query's,
        nearest-first from the built index, plus the whole tail."""
        out: list[_Entry] = []
        if self.fx is not None:
            kk = min(max(int(probe), 1), self.fx.ds.n)
            res = self.fx.search(
                QueryBatch(vector[None], bitmap[None],
                           Predicate.EQUALITY, kk), "prefilter")
            for rid in res.ids[0]:
                if rid >= 0:
                    out.append(self.built[int(rid)])
        bkey = bitmap.tobytes()
        out.extend(e for e in self.tail if e.bitmap.tobytes() == bkey)
        return out

    def entries(self) -> list[_Entry]:
        """Every alive entry in the partition (bitmap-agnostic scan —
        the subset/superset transfer probe's candidate pool)."""
        return ([e for e in self.built if e.alive]
                + [e for e in self.tail if e.alive])

    def close(self) -> None:
        if self.fx is not None:
            self.fx.close()
            self.fx = None
        self.built = []
        self.tail = []


class SemanticResultCache:
    """Result cache + admission layer over a routed service or a bare
    index handle.

    Args:
        service: a `RouterService`/`ShardedRouterService` (routed
            fill-on-miss; the cache then also exposes `route`/`execute`
            so `AsyncBatchQueue` keeps its two-stage pipeline), or any
            handle with `search(batch, method, setting)` when `method=`
            is given (router-less serving).
        threshold: cosine similarity a cached same-bitmap query must
            clear for a semantic hit. None disables semantic hits
            (exact-key only — every hit bit-identical).
        ttl_s: optional max entry age in seconds (None: no TTL; the
            label write clock still evicts on relevant writes).
        capacity: max cached entries; least-recently-used beyond that.
        admit_after: misses a key must accumulate before it is inserted
            (1 = cache on first miss).
        rebuild_every: tail length that triggers a similarity-index
            rebuild per (predicate, k) partition.
        sim_probe: nearest cached queries fetched from the built
            similarity index per probe (cosine is re-checked on each).
        method / setting: fixed method for router-less fill-on-miss.
        telemetry: optional `TelemetrySink` to mirror counters into
            (defaults to the wrapped service's sink, if any).
    """

    def __init__(self, service, *, threshold: float | None = 0.98,
                 ttl_s: float | None = None, capacity: int = 1024,
                 admit_after: int = 1, rebuild_every: int = 32,
                 sim_probe: int = 8, method=None, setting=None,
                 telemetry=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        if threshold is not None and not (-1.0 <= float(threshold) <= 1.0):
            raise ValueError(
                f"threshold must be in [-1, 1] or None; got {threshold}")
        if admit_after < 1:
            raise ValueError(
                f"admit_after must be >= 1; got {admit_after}")
        self.service = service
        self.threshold = None if threshold is None else float(threshold)
        self.ttl_s = None if ttl_s is None else float(ttl_s)
        self.capacity = int(capacity)
        self.admit_after = int(admit_after)
        self.rebuild_every = int(rebuild_every)
        self.sim_probe = int(sim_probe)
        self._index = getattr(service, "index", service)
        self._sink = (telemetry if telemetry is not None
                      else getattr(service, "telemetry", None))
        if method is None:
            if not callable(getattr(service, "route", None)):
                raise ValueError(
                    "service has no route/execute surface — pass "
                    "method= for router-less serving")
            self._fill = service.search
            # expose the split pipeline only when the inner service has
            # it, so AsyncBatchQueue's feature detection stays truthful
            self.route = service.route
            self.execute = self._execute
        else:
            self._fill = (lambda batch, t=None:
                          service.search(batch, method, setting))
        self._lock = threading.RLock()
        self._entries: OrderedDict[tuple, _Entry] = OrderedDict()
        self._parts: dict[tuple, _SimPart] = {}
        self._seen: dict[tuple, int] = {}        # admission doorkeeper
        self._counters = {
            "hits_exact": 0, "hits_semantic": 0, "hits_transfer": 0,
            "misses": 0, "insertions": 0, "evictions_ttl": 0,
            "evictions_stale": 0, "evictions_capacity": 0}
        # entries/bytes as pull gauges on the process ledger: collected
        # only at scrape/snapshot time, zero cost on the serve path
        self._ledger_key = f"cache:{id(self):x}"
        ledger_mod.get_ledger().register_collector(
            self._ledger_key, self._ledger_gauges)

    def _ledger_gauges(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "capacity": self.capacity,
                    "bytes": sum(e.nbytes
                                 for e in self._entries.values())}

    # ---- facade ----------------------------------------------------------
    @property
    def ds(self):
        return getattr(self.service, "ds", None)

    @property
    def index(self):
        return self._index

    @property
    def telemetry(self):
        return self._sink

    @property
    def tracer(self):
        """The wrapped service's tracer (the queue discovers it here)."""
        return getattr(self.service, "tracer", None)

    @property
    def slo(self):
        """The wrapped service's SLO engine (hit-path observations)."""
        return getattr(self.service, "slo", None)

    @property
    def obslog(self):
        """The wrapped service's wide-event log (hit-path events)."""
        return getattr(self.service, "obslog", None)

    def close(self) -> None:
        """Drop every entry and the built similarity indexes. The
        wrapped service is not closed — the cache doesn't own it."""
        ledger_mod.get_ledger().deregister_collector(self._ledger_key)
        with self._lock:
            self._entries.clear()
            self._seen.clear()
            for part in self._parts.values():
                part.close()
            self._parts.clear()

    clear = close

    def __enter__(self) -> "SemanticResultCache":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        with self._lock:
            c = dict(self._counters)
            c["entries"] = len(self._entries)
            c["capacity"] = self.capacity
            c["partitions"] = len(self._parts)
        hits = c["hits_exact"] + c["hits_semantic"] + c["hits_transfer"]
        seen = hits + c["misses"]
        c["hit_rate"] = round(hits / seen, 4) if seen else None
        return c

    def _note(self, counter: str, evicted: _Entry | None = None) -> None:
        """Bump a counter (cache lock held) and mirror it to the sink."""
        self._counters[counter] += 1
        if evicted is not None:
            evicted.alive = False
            self._entries.pop(evicted.ekey, None)
        if self._sink is not None:
            self._sink.note(f"cache_{counter}")

    # ---- probe (the hit path: no routing, no search) ---------------------
    @staticmethod
    def _ekey(vector: np.ndarray, bitmap: np.ndarray, pred, k) -> tuple:
        return (int(pred), int(k), vector.tobytes(), bitmap.tobytes())

    def _clock(self, labels=None) -> int:
        lc = getattr(self._index, "label_clock", None)
        return int(lc(labels)) if callable(lc) else 0

    def _fresh(self, entry: _Entry, now: float) -> bool:
        """TTL + label-write-clock staleness check; evicts on failure
        (cache lock held)."""
        if not entry.alive:
            return False
        if entry.expires_at is not None and now >= entry.expires_at:
            self._note("evictions_ttl", entry)
            return False
        if self._clock(entry.labels) > entry.clock:
            self._note("evictions_stale", entry)
            return False
        return True

    def _current_rows(self, entry: _Entry) -> tuple:
        """(ids, distances, keys) in the current generation's id space.
        Same generation: the cached arrays verbatim (bit-identical to
        the search that filled them). After a compaction: ids re-resolve
        through the stable keys and rows re-sort by (distance, id) —
        compaction never changes the live row set, so a fresh entry's
        keys are all still live."""
        gen = int(getattr(self._index, "generation", 0))
        if entry.generation != gen:
            ids = np.full_like(entry.ids, -1)
            valid = entry.keys >= 0
            if valid.any():
                rows = self._index.rows_of(entry.keys[valid])
                ids[valid] = rows.astype(np.int32)
            dist_key = np.where(ids >= 0, entry.distances, np.inf)
            order = np.lexsort((ids, dist_key))
            entry.ids = ids[order]
            entry.distances = entry.distances[order]
            entry.keys = entry.keys[order]
            entry.generation = gen
        return (entry.ids.copy(), entry.distances.copy(),
                entry.keys.copy())

    def _rescore(self, vector: np.ndarray, ids: np.ndarray,
                 keys: np.ndarray) -> tuple:
        """Exact squared-L2 of the given rows against `vector`,
        re-sorted ascending — the semantic-hit serving path."""
        fetch = getattr(self._index, "fetch", None)
        if callable(fetch):
            vecs = _host(fetch(ids), np.float32)
        else:
            vecs = np.full((ids.size, vector.size), np.nan, np.float32)
            valid = ids >= 0
            if valid.any():
                vecs[valid] = self._index.ds.vectors[ids[valid]]
        diff = vecs.astype(np.float64) - vector.astype(np.float64)
        d = (diff ** 2).sum(axis=1).astype(np.float32)
        dist_key = np.where(ids >= 0, d, np.inf)
        order = np.lexsort((ids, dist_key))
        d = np.where(ids >= 0, d, np.float32(np.nan)).astype(np.float32)
        return ids[order], d[order], keys[order]

    def _probe_query(self, vector: np.ndarray, bitmap: np.ndarray,
                     pred, k: int):
        """One query against the cache: (ids, distances, keys, kind)
        or None on miss. Never routes, never searches the corpus."""
        vector = np.ascontiguousarray(vector, dtype=np.float32)
        bitmap = np.ascontiguousarray(bitmap, dtype=np.uint32)
        ekey = self._ekey(vector, bitmap, pred, k)
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(ekey)
            if entry is not None:
                if self._fresh(entry, now):
                    self._entries.move_to_end(ekey)
                    self._note("hits_exact")
                    return (*self._current_rows(entry), "exact")
            if self.threshold is not None:
                hit = self._probe_semantic(vector, bitmap, pred, k, now)
                if hit is not None:
                    return hit
            self._note("misses")
            return None

    def _probe_semantic(self, vector, bitmap, pred, k, now):
        part = self._parts.get((int(pred), int(k)))
        if part is None:
            return None
        vnorm = float(np.sqrt((vector.astype(np.float64) ** 2).sum()))
        if vnorm == 0.0:
            return None
        best, best_cos = None, float(self.threshold)
        for cand in part.candidates(vector, bitmap, self.sim_probe):
            if not cand.alive or cand.vnorm == 0.0:
                continue
            cos = float(vector.astype(np.float64)
                        @ cand.vector.astype(np.float64)) \
                / (vnorm * cand.vnorm)
            if cos >= best_cos:
                best, best_cos = cand, cos
        if best is not None and self._fresh(best, now):
            self._entries.move_to_end(best.ekey)
            self._note("hits_semantic")
            ids, _, keys = self._current_rows(best)
            return (*self._rescore(vector, ids, keys), "semantic")
        if Predicate(pred) in (Predicate.AND, Predicate.OR):
            return self._probe_transfer(part, vector, vnorm, bitmap,
                                        Predicate(pred), k, now)
        return None

    def _row_bitmaps(self, ids: np.ndarray) -> np.ndarray | None:
        """[R, W] packed bitmaps of current-generation row ids, or None
        when they can't be resolved (conservative: no transfer)."""
        bm_of = getattr(self._index, "_bitmaps_of", None)
        if callable(bm_of):
            try:
                return _host(bm_of(np.asarray(ids, np.int64)), np.uint32)
            except Exception:
                return None
        ds = getattr(self._index, "ds", None)
        if ds is None:
            return None
        ids = np.asarray(ids)
        if ids.size and int(ids.max()) >= ds.n:
            return None   # rows beyond the sealed dataset (sharded delta)
        return np.asarray(ds.bitmaps[ids], dtype=np.uint32)

    def _probe_transfer(self, part, vector, vnorm, bitmap,
                        pred: Predicate, k, now):
        """Subset/superset bitmap transfer: serve from a cached entry
        whose filter is provably *looser* than the query's — OR with
        cached labels ⊇ query labels, AND with cached labels ⊆ query
        labels — when every valid cached row also passes the tighter
        query filter.  The query's admissible rows are then a subset of
        the cached search's, and a top-k that lies entirely inside the
        subset is that subset's top-k too, so the transfer is exact for
        the served row set.  Any valid row failing the re-check means
        rows outside the query's filter may have crowded out admissible
        ones — that's a miss, never a guess."""
        qb = bitmap
        qkey = bitmap.tobytes()
        best, best_cos = None, float(self.threshold)
        for cand in part.entries():
            if cand.vnorm == 0.0 or cand.bitmap.tobytes() == qkey:
                continue
            cb = cand.bitmap
            if pred == Predicate.OR:
                looser = bool(((cb & qb) == qb).all())   # qb ⊆ cb
            else:                                        # AND
                # a label-less cached filter is invisible to the write
                # clock — new rows matching the query would go unseen
                looser = (cand.labels.size > 0
                          and bool(((cb & qb) == cb).all()))  # cb ⊆ qb
            if not looser:
                continue
            cos = float(vector.astype(np.float64)
                        @ cand.vector.astype(np.float64)) \
                / (vnorm * cand.vnorm)
            if cos >= best_cos:
                best, best_cos = cand, cos
        if best is None or not self._fresh(best, now):
            return None
        ids, _, keys = self._current_rows(best)
        valid = ids >= 0
        if valid.any():
            rbms = self._row_bitmaps(ids[valid])
            if rbms is None:
                return None
            if pred == Predicate.OR:
                ok = ((rbms & qb) != 0).any(axis=1)
            else:
                ok = ((rbms & qb) == qb).all(axis=1)
            if not bool(ok.all()):
                return None
        self._entries.move_to_end(best.ekey)
        self._note("hits_transfer")
        return (*self._rescore(vector, ids, keys), "transfer")

    def probe_one(self, vector, bitmap, pred, k: int = 10):
        """Single-query probe for `AsyncBatchQueue.submit`: a
        `repro_torch.ann.service.QueryResult` on hit, None on miss. The hit
        path bypasses routing and search entirely."""
        from repro_torch.ann.service import QueryResult

        t0 = time.monotonic()
        hit = self._probe_query(np.asarray(vector, dtype=np.float32),
                                np.asarray(bitmap, dtype=np.uint32),
                                Predicate(pred), int(k))
        if hit is None:
            return None
        ids, dists, keys, kind = hit
        lat_us = (time.monotonic() - t0) * 1e6
        tracer = self.tracer
        tid = None
        if tracer is not None:
            # hits never reach the batch pipeline, so they get their own
            # (tiny, retroactive) trace — cache provenance + latency
            root = tracer.start("cache_probe", pred=int(pred), k=int(k),
                                cache=kind)
            root.t0 = t0
            tracer.finish(root)
            tid = root.trace_id
        slo = self.slo
        if slo is not None:
            slo.observe_request(lat_us, pred=int(pred))
        olog = self.obslog
        if olog is not None:
            olog.emit({"ts": round(time.time(), 6), "trace": tid,
                       "pred": int(pred), "k": int(k), "batch_q": 1,
                       "qi": 0, "lat_us": round(lat_us, 1),
                       "cache": kind,
                       "slo": slo.state() if slo is not None else None})
        return QueryResult(ids=ids, distances=dists, decision=None,
                           keys=keys, cache=kind)

    # ---- serve (probe + per-group fill-on-miss) --------------------------
    def search(self, batch: QueryBatch, *, t: float | None = None
               ) -> SearchResult:
        """Probe every query; the misses — and only the misses — flow
        through the wrapped service as one sub-batch, and their results
        are admitted. `res.cache[i]` says how query i was served."""
        with trace.maybe_trace(self.tracer, "cache_search", q=batch.q):
            t0 = time.perf_counter()
            with trace.span("cache.probe", q=batch.q):
                hits = [self._probe_query(batch.vectors[i],
                                          batch.bitmaps[i],
                                          batch.pred, batch.k)
                        for i in range(batch.q)]
                miss = [i for i, h in enumerate(hits) if h is None]
                trace.annotate(misses=len(miss))
            ids = np.full((batch.q, batch.k), -1, np.int32)
            dists = np.full((batch.q, batch.k), np.nan, np.float32)
            keys = np.full((batch.q, batch.k), -1, np.int64)
            tags: list = [None] * batch.q
            decisions = None
            timings: dict = {}
            for i, h in enumerate(hits):
                if h is not None:
                    ids[i], dists[i], keys[i], tags[i] = h
            t1 = time.perf_counter()
            if miss:
                sub = batch.take(np.asarray(miss))
                clock0, gen0 = self._stamp()
                res = self._fill(sub, t=t)
                with trace.span("cache.admit", q=sub.q):
                    self._admit(sub, res, clock0, gen0)
                midx = np.asarray(miss)
                ids[midx] = res.ids
                dists[midx] = res.distances
                if res.keys is not None:
                    keys[midx] = res.keys
                if res.decisions is not None:
                    decisions = [None] * batch.q
                    for j, i in enumerate(miss):
                        decisions[i] = res.decisions[j]
                timings.update(res.timings)
            total = time.perf_counter() - t0
            timings["cache_s"] = timings.get("cache_s", 0.0) + (t1 - t0)
            timings["total_s"] = total
            kinds: dict[str, int] = {}
            for tag in tags:
                kinds[tag or "miss"] = kinds.get(tag or "miss", 0) + 1
            trace.annotate(cache=kinds)
            return SearchResult(ids=ids, distances=dists,
                                decisions=decisions, timings=timings,
                                keys=keys, cache=tags)

    def _execute(self, batch: QueryBatch, decisions) -> SearchResult:
        """`execute` facade for the pipelined queue: run the inner
        execute, admit the results. Probing already happened in
        `submit`, so everything reaching here is a miss."""
        clock0, gen0 = self._stamp()
        res = self.service.execute(batch, decisions)
        with trace.span("cache.admit", q=batch.q):
            self._admit(batch, res, clock0, gen0)
        return res

    # ---- admission -------------------------------------------------------
    def _stamp(self) -> tuple:
        """(write clock, generation) read *before* the backing search:
        a write or compaction racing the fill then makes the entry
        conservatively stale/remapped rather than silently fresh."""
        return (self._clock(None),
                int(getattr(self._index, "generation", 0)))

    def _admit(self, batch: QueryBatch, res: SearchResult,
               clock: int, generation: int) -> None:
        expires = (None if self.ttl_s is None
                   else time.monotonic() + self.ttl_s)
        keys = (res.keys if res.keys is not None
                else res.ids.astype(np.int64))
        with self._lock:
            for i in range(batch.q):
                vec = batch.vectors[i]
                bm = batch.bitmaps[i]
                ekey = self._ekey(np.ascontiguousarray(vec),
                                  np.ascontiguousarray(bm),
                                  batch.pred, batch.k)
                if self.admit_after > 1:
                    n = self._seen.get(ekey, 0) + 1
                    if n < self.admit_after:
                        # doorkeeper: bounded — reset rather than grow
                        if len(self._seen) > max(4 * self.capacity, 1024):
                            self._seen.clear()
                        self._seen[ekey] = n
                        continue
                    self._seen.pop(ekey, None)
                old = self._entries.pop(ekey, None)
                if old is not None:
                    old.alive = False
                entry = _Entry(vec, bm, batch.pred, batch.k,
                               clock=clock, generation=generation,
                               ids=res.ids[i], distances=res.distances[i],
                               keys=keys[i], expires_at=expires,
                               ekey=ekey)
                self._entries[ekey] = entry
                self._counters["insertions"] += 1
                if self._sink is not None:
                    self._sink.note("cache_insertions")
                pk = (int(batch.pred), int(batch.k))
                part = self._parts.get(pk)
                if part is None:
                    universe = getattr(self._index, "_universe", None)
                    if universe is None:
                        universe = self._index.ds.universe
                    part = _SimPart(int(universe),
                                    f"cacheq/{pk[0]}/{pk[1]}",
                                    self._index.torch_device)
                    self._parts[pk] = part
                part.add(entry, self.rebuild_every)
                while len(self._entries) > self.capacity:
                    _, lru = self._entries.popitem(last=False)
                    lru.alive = False
                    self._counters["evictions_capacity"] += 1
                    if self._sink is not None:
                        self._sink.note("cache_evictions_capacity")
