"""`RouterService` — the query-aware serving facade: binds an `MLRouter`
and a method registry to a `FilteredIndex` and serves typed `QueryBatch`
→ `SearchResult` traffic.

* `search()` — route the whole batch with one fused forward (vectorised
  features + stacked MLP + array-op Algorithm 2), then execute each
  chosen (method, ps) group as one batched search on the owned index.
* `search_chunked()` — the same pipeline micro-batched over fixed-size
  query chunks via `engine.run_chunked`.
* `explain()` — per-query routing transparency: predicted recall r̂ per
  candidate, the threshold-passing set, the chosen (method, ps), and the
  offline benchmark-table row that justified it.

Scaling layers on top of the facade:

* `ShardedRouterService` — the same routed pipeline over a
  `repro_torch.ann.sharded.ShardedFilteredIndex`: the batch is routed
  once (full-dataset features), each chosen (method, ps) group executes
  on every shard in parallel, and the per-shard candidates reduce
  through the `ops.merge_topk` kernel.
* `AsyncBatchQueue` — serves *concurrent single-query callers*: callers
  `submit()` one query each and get a `Future`; a background worker
  coalesces pending requests into micro-batches (flushing on `max_batch`
  or `max_wait_ms`, whichever trips first) so the device sees batched
  traffic without callers coordinating.

Both serve the live handles of `repro_torch.ann.live` as they serve a
sealed one: a routed batch reads one snapshot of a `LiveFilteredIndex`,
or one cross-shard snapshot of a `ShardedLiveIndex`.

The serving-ops hooks are the JAX package's: a service takes
`telemetry=` (`repro_torch.ann.telemetry.TelemetrySink`), `tracer=`
(`repro_torch.ann.trace.Tracer`), `slo=` (`repro_torch.ann.slo.SLOEngine`)
and `obslog=` (`repro_torch.ann.obslog.WideEventLog`); the queue probes a
`repro_torch.ann.cache.SemanticResultCache` backend before batching,
reports its depth to the resource ledger and opens one `request` trace
root per group. Each hook is None by default and then costs nothing.
`search_s` is the host clock around work whose result has reached the
host; no hook adds a device synchronisation.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import NamedTuple

import numpy as np

from repro_torch.ann import engine
from repro_torch.ann import ledger as ledger_mod
from repro_torch.ann import registry as registry_mod
from repro_torch.ann import trace
from repro_torch.ann.index import (FilteredIndex, QueryBatch, RoutingDecision,
                                   SearchResult, exact_distances)
from repro_torch.ann.live import ShardedLiveIndex
from repro_torch.ann.obslog import request_events
from repro_torch.ann.predicates import Predicate
from repro_torch.ann.sharded import ShardedFilteredIndex


@dataclasses.dataclass
class QueryExplanation:
    """Why one query was routed where it was."""
    query: int
    method: str
    ps_id: str | None
    r_hat: dict                 # candidate method -> predicted recall@10
    passing: list               # methods with r̂ ≥ T and a T-feasible setting
    table_row: dict | None      # offline B row for the chosen (method, ps)
    threshold: float


class RouterService:
    """Serving facade over (FilteredIndex, MLRouter, method registry).

    Args:
        index: the owned serving handle the service executes on — a
            `FilteredIndex`, a `LiveFilteredIndex`, or anything exposing
            their `ds`/`run_method` surface (`ShardedRouterService`
            passes a sharded handle).
        router: a `repro_torch.core.router.MLRouter`.
        t: default recall threshold T for Algorithm 2 (per-call
            overridable via the `t=` kwarg on search/route/explain).
        methods: optional Mapping name -> Method overriding the default
            candidate-registry view.
        telemetry: optional `repro_torch.ann.telemetry.TelemetrySink`;
            when set, every executed batch records per-query events
            (method, ps, predicate, k, latency share, live generation)
            and offers queries to the audit reservoir.
        tracer: optional `repro_torch.ann.trace.Tracer`; when set,
            `search` opens a request-scoped span tree (route → execute →
            per-group / live-stage spans) with tail-based sampling and
            the flight recorder. None keeps the span calls no-ops.
        slo: optional `repro_torch.ann.slo.SLOEngine`; every executed
            batch folds latency/error observations into its windows and
            stamps the router's table version as alert provenance.
        obslog: optional `repro_torch.ann.obslog.WideEventLog`; every
            served query emits one wide event (trace id, route decision,
            timings, generation, table version, SLO state).
    """

    def __init__(self, index: FilteredIndex, router, *, t: float = 0.9,
                 methods=None, telemetry=None, tracer=None, slo=None,
                 obslog=None):
        self.index = index
        self.router = router
        self.t = float(t)
        self.methods = (methods if methods is not None
                        else registry_mod.candidate_methods())
        self.telemetry = telemetry
        self.tracer = tracer
        self.slo = slo
        self.obslog = obslog

    @property
    def ds(self):
        return self.index.ds

    def _table_version(self):
        """The routing table's version (an `OnlineBenchmarkTable`'s), or
        None for a plain table — or no router, for a service that only
        executes given decisions."""
        return getattr(getattr(self.router, "table", None), "version", None)

    # ---- routing ---------------------------------------------------------
    def predict(self, batch: QueryBatch) -> np.ndarray:
        """[Q, M] predicted recall per candidate method."""
        return self.router.predict_recalls(self.ds, batch.bitmaps,
                                           batch.pred, fx=self.index)

    def route(self, batch: QueryBatch, *,
              t: float | None = None) -> list[RoutingDecision]:
        """Per-query `RoutingDecision`s without executing the searches
        (Algorithm 2 at threshold `t`, default the service's)."""
        with trace.span("route", q=batch.q):
            r_hat = self.predict(batch)
            decisions = self._decide(r_hat, batch, t)
            trace.annotate(table_version=self._table_version())
            return decisions

    def _decide(self, r_hat, batch, t):
        t = self.t if t is None else t
        dec = self.router.route_from_predictions(
            r_hat, self.ds.name, batch.pred, t)
        return [RoutingDecision(m, ps) for m, ps in dec]

    # ---- serving ---------------------------------------------------------
    def execute(self, batch: QueryBatch,
                decisions: list[RoutingDecision]) -> SearchResult:
        """Run already-routed decisions: each (method, ps) group executes
        as one batched search on the owned index. This is the second
        stage of the pipeline — `search` is `route` + `execute`, and the
        `AsyncBatchQueue` worker calls the stages separately so batch t+1
        routes while batch t executes.

        An index that reports per-call stage timings through
        `pop_stage_timings()` (the sharded handle: `shard{j}_s`,
        `shard_max_s`, `merge_s`; the live handle: `base_s`, `delta_s`,
        `merge_s`) has them folded into the result's timings. An index
        that exposes `snapshot()` (the live handle) is read under one
        batch-wide snapshot: every group and the key lookup see the same
        epoch, whatever writes or compactions run meanwhile. A failed
        batch still reaches the SLO engine and the wide-event log before
        its exception propagates."""
        with trace.span("execute", q=batch.q):
            try:
                return self._execute_impl(batch, decisions)
            except BaseException as e:
                # failed batches still count: availability SLOs and the
                # wide-event log see the error before it propagates
                if self.slo is not None:
                    self.slo.observe_batch(batch.q, errors=batch.q,
                                           pred=int(batch.pred))
                olog = self.obslog
                if olog is not None:
                    for ev in request_events(
                            batch, decisions, per_query_us=0.0,
                            trace_id=trace.trace_id(),
                            error=f"{type(e).__name__}: {e}"):
                        olog.emit(ev)
                raise

    def _execute_impl(self, batch: QueryBatch,
                      decisions: list[RoutingDecision]) -> SearchResult:
        t1 = time.perf_counter()
        ids = np.full((batch.q, batch.k), -1, dtype=np.int32)
        raw = np.full((batch.q, batch.k), np.inf, dtype=np.float32)
        pop = getattr(self.index, "pop_stage_timings", None)
        if callable(pop):
            pop()                        # clear this thread's stale slate
        snap_fn = getattr(self.index, "snapshot", None)
        if callable(snap_fn):
            with trace.span("snapshot_pin"):
                snap = snap_fn()
                trace.annotate(generation=int(getattr(
                    snap, "generation", 0)))
        else:
            snap = None
        pin = {} if snap is None else {"snapshot": snap}
        groups: dict = {}
        for qi, d in enumerate(decisions):
            groups.setdefault(d, []).append(qi)
        try:
            for (m_name, ps_id), idxs in groups.items():
                method = self.methods[m_name]
                # B may not cover a brand-new deployment dataset yet: fall
                # back to the method's max-budget setting until
                # benchmarked.
                setting = engine.resolve_setting(method, ps_id)
                idxs = np.asarray(idxs)
                with trace.span("group", method=m_name, ps=ps_id,
                                q=int(idxs.size)):
                    g_ids, g_raw = self.index.run_method(
                        method, setting, batch.take(idxs), **pin)
                ids[idxs] = g_ids
                raw[idxs] = g_raw
            # stable keys resolve inside the batch snapshot, so a
            # compaction can't remap rows between search and key lookup
            with trace.span("resolve_keys"):
                keys = self.index.keys_of(ids, **pin)
        finally:
            if snap is not None:
                snap.release()
        t2 = time.perf_counter()
        timings = {"search_s": t2 - t1, "total_s": t2 - t1}
        if callable(pop):
            timings.update(pop())
        generation = getattr(self.index, "generation", 0)
        trace.annotate(
            decisions=sorted({f"{m}/{ps}" for (m, ps) in groups}),
            generation=int(generation),
            table_version=self._table_version())
        sink = self.telemetry
        if sink is not None:
            sink.record_batch(batch, decisions, search_s=t2 - t1,
                              generation=generation, keys=keys)
            for stage in ("base_s", "delta_s", "merge_s", "shard_max_s"):
                if stage in timings:
                    sink.note(stage, timings[stage])
            # per-shard stage seconds (sharded handles emit shard{j}_s)
            # fold into the sink's (shard, stage) skew cells
            for stage, val in timings.items():
                if (stage.startswith("shard") and stage.endswith("_s")
                        and stage != "shard_max_s"):
                    try:
                        sh = int(stage[5:-2])
                    except ValueError:
                        continue
                    sink.note_shard(sh, "exec", val, batch.q)
        per_q_us = (t2 - t1) * 1e6 / max(batch.q, 1)
        slo_eng = self.slo
        if slo_eng is not None:
            slo_eng.observe_batch(batch.q, per_query_us=per_q_us,
                                  pred=int(batch.pred))
            tv = self._table_version()
            if tv is not None:
                slo_eng.note_provenance(table_version=tv)
        olog = self.obslog
        if olog is not None:
            for ev in request_events(
                    batch, decisions, per_query_us=per_q_us,
                    trace_id=trace.trace_id(), timings=timings,
                    generation=int(generation),
                    table_version=self._table_version(),
                    slo_state=(slo_eng.state() if slo_eng is not None
                               else None)):
                olog.emit(ev)
        return SearchResult(
            ids=ids,
            distances=exact_distances(raw, ids, batch.vectors),
            decisions=list(decisions), timings=timings, keys=keys)

    def search(self, batch: QueryBatch, *,
               t: float | None = None) -> SearchResult:
        """Route the batch, then run each (method, ps) group as one
        batched search. Returns a `SearchResult` with [Q, k] ids, exact
        squared-L2 distances, per-query `RoutingDecision`s and stage
        timings (`route_s`, `search_s`, `total_s`). Raises ValueError on
        batch/dataset shape mismatch; RuntimeError if the index is
        closed. With a tracer, the call is one traced request."""
        with trace.maybe_trace(self.tracer, "search", q=batch.q,
                               k=batch.k, pred=int(batch.pred)):
            t0 = time.perf_counter()
            decisions = self.route(batch, t=t)
            t1 = time.perf_counter()
            res = self.execute(batch, decisions)
            res.timings["route_s"] = t1 - t0
            res.timings["total_s"] = res.timings["search_s"] + (t1 - t0)
            if self.telemetry is not None:
                self.telemetry.note("route_s", t1 - t0)
            return res

    def search_chunked(self, batch: QueryBatch, *,
                       chunk: int = engine.DEFAULT_QCHUNK,
                       t: float | None = None) -> SearchResult:
        """`search` micro-batched over fixed-size query chunks via
        `engine.run_chunked` (bounded per-chunk memory and latency)."""
        timings = {"route_s": 0.0, "search_s": 0.0, "total_s": 0.0}

        def fn(qv, qb):
            res = self.search(
                QueryBatch(qv, qb, batch.pred, batch.k), t=t)
            for key, val in res.timings.items():
                timings[key] = timings.get(key, 0.0) + val
            dec = np.empty(len(res.decisions), dtype=object)
            dec[:] = res.decisions
            return res.ids, res.distances, dec, res.keys

        ids, dists, dec, keys = engine.run_chunked(
            fn, batch.q, batch.vectors, batch.bitmaps, chunk=chunk)
        return SearchResult(ids=ids, distances=dists,
                            decisions=list(dec), timings=timings,
                            keys=keys)

    # ---- transparency -----------------------------------------------------
    def explain(self, batch: QueryBatch, *,
                t: float | None = None) -> list[QueryExplanation]:
        """Per-query routing explanation (r̂ per method, passing set,
        chosen method/ps, backing table row)."""
        t = self.t if t is None else t
        r_hat = self.predict(batch)
        decisions = self._decide(r_hat, batch, t)
        methods = self.router.methods
        pt = int(batch.pred)
        has_pass, _, _, _ = self.router.table.routing_arrays(
            self.ds.name, pt, methods, t)
        out = []
        for qi, (m, ps) in enumerate(decisions):
            row = self.router.table.entries.get(
                (self.ds.name, pt, m, ps)) if ps is not None else None
            out.append(QueryExplanation(
                query=qi, method=m, ps_id=ps,
                r_hat={name: float(r_hat[qi, j])
                       for j, name in enumerate(methods)},
                passing=[name for j, name in enumerate(methods)
                         if has_pass[j] and r_hat[qi, j] >= t],
                table_row=dict(row) if row else None,
                threshold=t))
        return out


class ShardedRouterService(RouterService):
    """`RouterService` over a `repro_torch.ann.sharded.ShardedFilteredIndex`
    or a `repro_torch.ann.live.ShardedLiveIndex`.

    The routed pipeline is unchanged — and that is the point: the batch
    is routed **once** (one fused MLP forward over full-dataset features;
    on a card the `selectivity` kernel reads the sharded handle's
    `feature_index` tensors on shard 0's device), and only the execution
    of each chosen (method, ps) group fans out: every shard searches its
    own row partition in parallel and the per-shard candidates reduce
    through the `ops.merge_topk` kernel inside the handle's `run_method`.

    A sharded live handle is read under one cross-shard snapshot a batch
    (`RouterService.execute`).

    Args:
        index: a `ShardedFilteredIndex` or `ShardedLiveIndex` (TypeError
            otherwise — a plain `FilteredIndex`/`LiveFilteredIndex`
            belongs in `RouterService`).
        router / t / methods / telemetry / tracer / slo / obslog: as in
            `RouterService`.
    """

    def __init__(self, index, router, *, t: float = 0.9, methods=None,
                 telemetry=None, tracer=None, slo=None, obslog=None):
        if not isinstance(index, (ShardedFilteredIndex, ShardedLiveIndex)):
            raise TypeError(
                f"ShardedRouterService needs a ShardedFilteredIndex or "
                f"ShardedLiveIndex; got {type(index).__name__} (use "
                f"RouterService for single-index handles)")
        super().__init__(index, router, t=t, methods=methods,
                         telemetry=telemetry, tracer=tracer, slo=slo,
                         obslog=obslog)


# ---------------------------------------------------------------------------
# async micro-batch queue — concurrent single-query callers
# ---------------------------------------------------------------------------

class QueryResult(NamedTuple):
    """One caller's slice of a batched `SearchResult`.

    * `ids` — [k] int32 base ids, −1 padded;
    * `distances` — [k] float32 exact squared-L2 (NaN at −1 pad);
    * `decision` — the query's `RoutingDecision` (None when the queue
      serves a fixed method instead of a routed service);
    * `keys` — [k] int64 stable external keys (−1 pad; None when the
      backend has no key layer).
    * `cache` — how the query was served when the backend is a
      `repro_torch.ann.cache.SemanticResultCache`: ``"exact"``
      (bit-identical cached result), ``"semantic"`` (near-duplicate
      cached result, re-scored), ``"transfer"`` (served from a
      looser-filter cached entry whose rows all pass this query's
      filter), or None (full routed search).
    """
    ids: np.ndarray
    distances: np.ndarray
    decision: RoutingDecision | None
    keys: np.ndarray | None = None
    cache: str | None = None


@dataclasses.dataclass
class _PendingQuery:
    vector: np.ndarray
    bitmap: np.ndarray
    pred: Predicate
    k: int
    t_submit: float
    future: Future


class _DaemonExecutor:
    """Single daemon worker running submitted calls in order — the
    execution stage of the queue's two-stage pipeline. Unlike a
    `ThreadPoolExecutor` (non-daemon threads since 3.9) its thread is a
    daemon, so a hung backend search can neither block interpreter exit
    nor make `AsyncBatchQueue.close(timeout=...)` wait forever."""

    def __init__(self, name: str):
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def submit(self, fn, *args) -> Future:
        fut: Future = Future()
        self._q.put((fut, fn, args))
        return fut

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn, args = item
            try:
                fut.set_result(fn(*args))
            except BaseException as e:   # delivered to the future's reader
                fut.set_exception(e)

    def shutdown(self, timeout: float | None = None) -> None:
        self._q.put(None)
        self._thread.join(timeout=timeout)


class AsyncBatchQueue:
    """Coalesces concurrent single-query `submit()` calls into
    micro-batches.

    A background worker drains the queue into one batched call per
    (predicate, k) group whenever either knob trips:

    * `max_batch` — this many requests are pending (flush immediately;
      latency-optimal under load);
    * `max_wait_ms` — the oldest pending request has waited this long
      (bounds tail latency when traffic is sparse).

    The worker is a **two-stage pipeline** (double-buffered): when the
    backend separates routing from execution (`RouterService.route` /
    `.execute`), the worker thread routes batch *t+1* while a dedicated
    single-thread executor is still executing batch *t* — the routing
    forward and the searches overlap instead of serialising. Backends
    without the split (a bare `FilteredIndex` with `method=`) run both
    stages on the executor.

    Callers get a `concurrent.futures.Future` resolving to a
    `QueryResult`; a failed batch propagates its exception to exactly
    the futures in that batch.

    When the backend is a `repro_torch.ann.cache.SemanticResultCache` (it
    exposes `probe_one`), every `submit()` probes the cache *before*
    batching: a hit resolves the Future immediately — no queueing, no
    routing, no search — and only the misses flow through the pipeline,
    whose execute stage admits their results back into the cache.

    Args:
        service: the batched backend — a `RouterService` /
            `ShardedRouterService` (routed), or, with `method=`, any
            handle exposing `search(batch, method, setting)` such as
            `FilteredIndex` / `ShardedFilteredIndex` (direct
            single-method serving, no router needed).
        max_batch: flush threshold and per-batch size cap (>= 1).
        max_wait_ms: max age of the oldest pending request before a
            flush (>= 0; 0 means flush on every submit).
        method / setting: optional fixed method (+ optional setting)
            for router-less serving.

    Raises:
        ValueError: on non-positive `max_batch` or negative
            `max_wait_ms`.
    """

    def __init__(self, service, *, max_batch: int = 64,
                 max_wait_ms: float = 5.0, method=None, setting=None):
        if int(max_batch) < 1:
            raise ValueError(f"max_batch must be >= 1; got {max_batch}")
        if float(max_wait_ms) < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0; got {max_wait_ms}")
        self.service = service
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        # request-scoped tracing: roots are created at batch assembly in
        # the worker thread and re-attached (explicit contextvar
        # propagation) on the execution stage's thread
        self._tracer = getattr(service, "tracer", None)
        if method is None:
            self._search = service.search
        else:
            self._search = lambda b: service.search(b, method, setting)
        # routed services expose route()/execute() separately — that is
        # what lets the worker route batch t+1 while t executes
        self._pipelined = (method is None
                           and callable(getattr(service, "route", None))
                           and callable(getattr(service, "execute", None)))
        self._cv = threading.Condition()
        self._pending: list[_PendingQuery] = []
        self._inflight: list[Future] = []
        self._flush_req = False
        self._closed = False
        self._stats = {"queries": 0, "batches": 0, "cache_hits": 0,
                       "max_batch_seen": 0, "max_queue_depth": 0,
                       "flush_reasons": {}}
        # queue depth is a pull gauge on the process ledger — the
        # /statusz + backpressure-health surface reads it from there
        self._ledger_key = f"queue:{id(self):x}"
        ledger_mod.get_ledger().register_collector(
            self._ledger_key, self._ledger_gauges)
        self._exec = _DaemonExecutor("async-batch-exec")
        self._exec_fut: Future | None = None
        self._worker = threading.Thread(
            target=self._run, name="async-batch-queue", daemon=True)
        self._worker.start()

    # ---- caller surface --------------------------------------------------
    def submit(self, vector, bitmap, pred, k: int = 10) -> Future:
        """Enqueue one query; returns a Future of `QueryResult`.

        Args:
            vector: [d] float query embedding.
            bitmap: [W] uint32 packed query label set.
            pred: the query's `Predicate` (or its int value).
            k: result width.
        Raises: RuntimeError if the queue is closed; ValueError on
            non-1-D vector/bitmap or a width the dataset does not have.
        """
        vector = np.asarray(vector, dtype=np.float32)
        bitmap = np.asarray(bitmap, dtype=np.uint32)
        if vector.ndim != 1 or bitmap.ndim != 1:
            raise ValueError(
                f"submit takes one query: vector [d] and bitmap [W]; got "
                f"shapes {vector.shape} / {bitmap.shape}")
        # reject dim mismatches here, per caller — inside the worker they
        # would fail the whole co-batched (pred, k) group's futures
        ds = getattr(self.service, "ds", None)
        if ds is not None:
            if vector.shape[0] != ds.dim:
                raise ValueError(
                    f"query vector dim {vector.shape[0]} does not match "
                    f"dataset dim {ds.dim}")
            if bitmap.shape[0] != ds.bitmaps.shape[1]:
                raise ValueError(
                    f"query bitmap width {bitmap.shape[0]} does not match "
                    f"dataset width {ds.bitmaps.shape[1]}")
        # cache probe before batching: a semantic-cache backend answers
        # hits here, synchronously — the pipeline only ever sees misses
        probe = getattr(self.service, "probe_one", None)
        if callable(probe):
            hit = probe(vector, bitmap, Predicate(pred), int(k))
            if hit is not None:
                with self._cv:
                    if self._closed:
                        raise RuntimeError("AsyncBatchQueue is closed")
                    self._stats["queries"] += 1
                    self._stats["cache_hits"] += 1
                fut: Future = Future()
                fut.set_result(hit)
                return fut
        req = _PendingQuery(vector, bitmap, Predicate(pred), int(k),
                            time.monotonic(), Future())
        with self._cv:
            if self._closed:
                raise RuntimeError("AsyncBatchQueue is closed")
            self._pending.append(req)
            self._stats["max_queue_depth"] = max(
                self._stats["max_queue_depth"], len(self._pending))
            self._cv.notify_all()
        return req.future

    def flush(self, timeout: float | None = 30.0) -> None:
        """Force-drain everything currently pending and block until those
        requests complete (their futures resolve; failures stay on the
        futures, flush itself doesn't raise them)."""
        import concurrent.futures as cf

        with self._cv:
            # pending + whatever the worker already took for execution —
            # snapshotting _pending alone would miss an in-flight batch
            futs = [p.future for p in self._pending] + list(self._inflight)
            self._flush_req = True
            self._cv.notify_all()
        cf.wait(futs, timeout=timeout)

    def close(self, timeout: float | None = 30.0) -> None:
        """Stop accepting work, drain what's pending (both pipeline
        stages), join the worker and the execution stage. The timeout
        bounds the whole call; both stage threads are daemons, so a
        hung backend search is abandoned rather than waited on.
        Idempotent."""
        t0 = time.monotonic()
        ledger_mod.get_ledger().deregister_collector(self._ledger_key)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=timeout)
        left = (None if timeout is None
                else max(0.0, timeout - (time.monotonic() - t0)))
        self._exec.shutdown(timeout=left)

    def __enter__(self) -> "AsyncBatchQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _ledger_gauges(self) -> dict:
        with self._cv:
            return {"pending": len(self._pending),
                    "inflight": len(self._inflight),
                    "max_queue_depth": self._stats["max_queue_depth"]}

    def stats(self) -> dict:
        """Counters: queries/batches served, cache hits answered at
        submit time (`cache_hits`, nonzero only over a semantic-cache
        backend), largest batch, the queue-depth high-water mark
        (`max_queue_depth` — how far submissions ran ahead of the
        pipeline), a flush-reason histogram (max_batch / max_wait /
        flush / close), and the backend's telemetry sink's stats under
        `telemetry` when it has one."""
        with self._cv:
            s = dict(self._stats)
            s["flush_reasons"] = dict(self._stats["flush_reasons"])
            s["pending"] = len(self._pending)
        sink = getattr(self.service, "telemetry", None)
        if sink is not None:
            s["telemetry"] = sink.stats()
        return s

    # ---- worker: stage 1 (collect + route), stage 2 (execute) ------------
    def _run(self) -> None:
        while True:
            with self._cv:
                reason = None
                while reason is None:
                    if self._pending:
                        if len(self._pending) >= self.max_batch:
                            reason = "max_batch"
                        elif self._closed:
                            reason = "close"
                        elif self._flush_req:
                            reason = "flush"
                        else:
                            left = (self._pending[0].t_submit
                                    + self.max_wait_s - time.monotonic())
                            if left <= 0:
                                reason = "max_wait"
                            else:
                                self._cv.wait(timeout=left)
                    else:
                        self._flush_req = False
                        if self._closed:
                            return
                        self._cv.wait()
                take = self._pending[: self.max_batch]
                del self._pending[: len(take)]
                self._inflight.extend(p.future for p in take)
                if not self._pending:
                    self._flush_req = False
            # stage 1 in this thread: batch assembly + routing. This
            # overlaps with the executor still running the previous
            # batch — the double buffer.
            staged = self._route_stage(take)
            prev = self._exec_fut
            if prev is not None:
                try:               # depth-1 pipeline: wait out batch t-1
                    prev.result()
                except BaseException:
                    pass           # its failures already reached callers
            self._exec_fut = self._exec.submit(
                self._exec_stage, staged, reason,
                [p.future for p in take])

    def _route_stage(self, take: list[_PendingQuery]) -> list:
        """Group requests into per-(pred, k) batches and, when the
        backend supports it, route them. Routing failures reject exactly
        their group's futures here, before the execute stage.

        With a tracer on the backend, each group gets a trace root
        spanning submit → result: an `enqueue_wait` child reconstructed
        from the oldest submit time, `batch_assembly`, the backend's
        `route` span, and (on the executor thread, via `trace.attach`)
        the whole execute subtree."""
        groups: dict = {}
        for req in take:
            groups.setdefault((req.pred, req.k), []).append(req)
        staged = []
        tracer = self._tracer
        for (pred, k), reqs in groups.items():
            root = None
            try:
                if tracer is not None:
                    t0 = min(r.t_submit for r in reqs)
                    now = time.monotonic()
                    root = tracer.start("request", q=len(reqs),
                                        pred=int(pred), k=int(k))
                    root.t0 = t0
                    root.child(
                        "enqueue_wait", t0=t0, t1=now,
                        max_wait_ms=round((now - t0) * 1e3, 3),
                        mean_wait_ms=round(sum(
                            now - r.t_submit for r in reqs)
                            / len(reqs) * 1e3, 3))
                with trace.attach(root):
                    with trace.span("batch_assembly", q=len(reqs)):
                        batch = QueryBatch(
                            np.stack([r.vector for r in reqs]),
                            np.stack([r.bitmap for r in reqs]),
                            pred, k)
                    decisions = (self.service.route(batch)
                                 if self._pipelined else None)
                staged.append((reqs, batch, decisions, root))
            except BaseException as e:   # delivered to this group's callers
                if root is not None:
                    tracer.finish(root, error=repr(e))
                for req in reqs:
                    if not req.future.done():
                        req.future.set_exception(e)
        return staged

    def _exec_stage(self, staged: list, reason: str,
                    futs: list[Future]) -> None:
        try:
            with self._cv:
                self._stats["queries"] += sum(len(r) for r, *_ in staged)
                self._stats["batches"] += 1
                self._stats["max_batch_seen"] = max(
                    self._stats["max_batch_seen"], len(futs))
                rs = self._stats["flush_reasons"]
                rs[reason] = rs.get(reason, 0) + 1
            sink = getattr(self.service, "telemetry", None)
            tracer = self._tracer
            for reqs, batch, decisions, root in staged:
                try:
                    # re-enter the group's trace on this thread — the
                    # contextvar does not cross the executor hop itself
                    with trace.attach(root):
                        res = (self.service.execute(batch, decisions)
                               if decisions is not None
                               else self._search(batch))
                        trace.annotate(flush_reason=reason)
                    if sink is not None:
                        # queue wait = submit -> result, folded as a
                        # counter pair (sum + count) per drain window
                        now = time.monotonic()
                        wait = sum(now - r.t_submit for r in reqs)
                        sink.note("queue_wait_s", wait)
                        sink.note("queue_waits", len(reqs))
                    if root is not None:
                        tracer.finish(root)
                    for j, req in enumerate(reqs):
                        dec = (res.decisions[j]
                               if res.decisions is not None else None)
                        if not req.future.done():   # caller may have cancelled
                            req.future.set_result(QueryResult(
                                ids=res.ids[j], distances=res.distances[j],
                                decision=dec,
                                keys=(res.keys[j] if res.keys is not None
                                      else None)))
                except BaseException as e:   # propagate to exactly this group
                    if root is not None and root.t1 is None:
                        tracer.finish(root, error=repr(e))
                    for req in reqs:
                        if not req.future.done():
                            req.future.set_exception(e)
        finally:
            with self._cv:
                for f in futs:
                    try:
                        self._inflight.remove(f)
                    except ValueError:
                        pass
