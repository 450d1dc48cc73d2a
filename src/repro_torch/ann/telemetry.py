"""Serving telemetry + online router adaptation.

The paper's router consults a *frozen* offline benchmark table; under
production traffic and a live index the measured (recall, QPS) of every
(method, parameter-setting) cell drifts away from it.  This module keeps
routing honest against the *measured* system:

* `TelemetrySink` — a low-overhead per-query event sink.  The serving
  layer (`RouterService.execute`) calls `record_batch` once per executed
  batch; events land in a lock-free ring buffer (slot index from an
  atomic `itertools.count`), per-cell counters fold under one short
  per-batch lock, and a reservoir (algorithm R) keeps an unbiased sample
  of served queries for auditing.  `stats()` exposes counters plus
  latency percentiles computed from the ring.

* `RecallAuditor` — replays reservoir-sampled queries against the
  brute-force oracle (the registered "prefilter" method, i.e.
  `ops.masked_topk`) on a *pinned snapshot*, so audits never race
  compaction, and compares stable external keys so results survive row
  remaps.  Exact per-(method, ps) recall folds into the online table.

* `OnlineBenchmarkTable` — a `BenchmarkTable` whose cells are
  EWMA-updated from audited recall and measured QPS.  Routing reads
  (`routing_arrays`) are served from a per-version cache and republished
  atomically under a version counter; `drift()` scores each audited
  cell's divergence from the offline table.

* `OnlineRouterAdapter` — the adaptation loop.  Attaches the online
  table to a live `RouterService` (cell updates re-route immediately —
  Algorithm 2's passing set is table-driven), and when drift crosses a
  threshold retrains the MLP router off the serving path on
  audit-derived labels, shadow-evaluates the candidate against the
  incumbent on held-out audited queries, and promotes only on
  improvement through the versioned-artifact / `link_router` /
  content-sha machinery (rollback = keep serving the old artifact).

This is the JAX package's module on this package's handles: the same
reservoir draws (`np.random.default_rng(seed)`), the same reports and
the same table arithmetic. Device work stays where the reference has
it: the auditor's oracle is the registered `prefilter` method, so on a
card it runs the `masked_topk` kernel (`masked_topk_large` and
`fused_live` on a live handle, `merge_topk` across shards). The
adapter's default retrain needs the training slice
(`train_models_from_xy`), which this package does not have yet; until
it lands `_default_retrain` raises NotImplementedError, so pass
`retrain_fn=` to retrain.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.ann.index import QueryBatch
from repro_torch.ann.predicates import Predicate

__all__ = [
    "QueryEvent", "AuditSample", "TelemetrySink", "RecallAuditor",
    "OnlineBenchmarkTable", "OnlineRouterAdapter", "DegradedMethod",
    "constant_router",
]

# oracle used for exact-recall audits: the registered brute-force
# method (masked_topk over every live row — exact by construction)
ORACLE_METHOD = "prefilter"


class QueryEvent(NamedTuple):
    """One served query, as recorded on the hot path."""
    method: str          # routed method name
    ps_id: str | None    # parameter-setting id ("" when direct search)
    pred: int            # Predicate value
    k: int
    search_us: float     # per-query share of the batch's execute time
    generation: int      # live-index generation at execute time (0 sealed)
    t_wall: float        # wall-clock seconds (time.time()) — display only
    # trailing defaulted fields keep positional construction compatible
    t_mono: float = 0.0  # time.monotonic() — ordering / duration clock
    shard: int = -1      # shard the query executed on (-1: unsharded)


class AuditSample(NamedTuple):
    """A reservoir-sampled query retained for exact-recall auditing."""
    vector: np.ndarray       # [d] float32 copy
    bitmap: np.ndarray       # [W] uint32 copy
    pred: int
    k: int
    method: str
    ps_id: str | None
    served_keys: np.ndarray  # [k] int64 stable keys the service returned
    generation: int


def _percentile(sorted_vals: np.ndarray, q: float) -> float:
    if sorted_vals.size == 0:
        return 0.0
    return float(np.percentile(sorted_vals, q))


class TelemetrySink:
    """Lock-free per-query event ring + per-cell counters + reservoir.

    Hot-path cost is one `record_batch` call per executed batch: O(Q)
    tuple constructions into ring slots claimed from an atomic counter
    (no lock), one short lock to fold per-cell aggregates, and an
    RNG draw per query for reservoir admission (vector/bitmap copies
    happen only on acceptance, so steady-state admission is nearly
    free once the reservoir has seen many queries).
    """

    def __init__(self, capacity: int = 4096, reservoir: int = 256,
                 seed: int = 0):
        if capacity <= 0 or reservoir < 0:
            raise ValueError("capacity must be > 0 and reservoir >= 0")
        self.capacity = int(capacity)
        self._ring: list[QueryEvent | None] = [None] * self.capacity
        self._seq = itertools.count()        # atomic in CPython
        # per-cell aggregates: (method, ps_id, pred) -> [queries, lat_us]
        self._cells: dict[tuple, list] = {}    # cumulative (stats)
        self._fresh: dict[tuple, list] = {}    # since last drain_cells
        # per-shard stage cells: (shard, stage) -> [calls, seconds]
        self._shards: dict[tuple[int, str], list] = {}
        self._shards_fresh: dict[tuple[int, str], list] = {}
        self._agg_lock = threading.Lock()
        self._batches = 0
        self._queries = 0
        self._counters: dict[str, float] = {}
        # reservoir (algorithm R) of AuditSamples
        self._res_size = int(reservoir)
        self._res: list[AuditSample] = []
        self._res_seen = 0
        self._res_lock = threading.Lock()
        self._rng = np.random.default_rng(seed)

    # ---------------------------------------------------------- hot path

    def record_batch(self, batch: QueryBatch, decisions, *,
                     search_s: float, generation: int = 0,
                     keys: np.ndarray | None = None,
                     shard: int = -1) -> None:
        """Record one executed batch.  `decisions` is the [Q] list of
        `RoutingDecision` (or a single (method, ps_id) applied to all
        queries); `keys` are the served [Q, k] stable keys (row ids are
        an acceptable stand-in for sealed indexes); `shard` stamps the
        events when a shard-local service records its own traffic."""
        q = batch.q
        if q == 0:
            return
        per_q_us = search_s * 1e6 / q
        now = time.time()
        now_m = time.monotonic()
        shard = int(shard)
        one = not isinstance(decisions, (list, tuple)) or (
            len(decisions) != q)
        ring, cap, seq = self._ring, self.capacity, self._seq
        local_cells: dict[tuple, list] = {}
        for i in range(q):
            d = decisions if one else decisions[i]
            ev = QueryEvent(d[0], d[1], int(batch.pred), batch.k,
                            per_q_us, generation, now, now_m, shard)
            ring[next(seq) % cap] = ev
            cell = local_cells.setdefault((d[0], d[1], int(batch.pred)),
                                          [0, 0.0])
            cell[0] += 1
            cell[1] += per_q_us
        with self._agg_lock:
            self._batches += 1
            self._queries += q
            for key, (n, us) in local_cells.items():
                for store in (self._cells, self._fresh):
                    agg = store.setdefault(key, [0, 0.0])
                    agg[0] += n
                    agg[1] += us
        if self._res_size:
            self._offer_samples(batch, decisions, one, keys, generation)

    def note(self, name: str, value: float = 1.0) -> None:
        """Fold a named scalar counter (queue waits, stage timings...)."""
        with self._agg_lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def note_shard(self, shard: int, stage: str, seconds: float,
                   n: int = 1) -> None:
        """Fold per-shard stage time into the (shard, stage) cell —
        shard skew shows up in `stats()['shards']` and `/metrics`."""
        with self._agg_lock:
            for store in (self._shards, self._shards_fresh):
                agg = store.setdefault((int(shard), stage), [0, 0.0])
                agg[0] += n
                agg[1] += seconds

    # ------------------------------------------------------- reservoir

    def _offer_samples(self, batch, decisions, one, keys, generation):
        with self._res_lock:
            for i in range(batch.q):
                self._res_seen += 1
                if len(self._res) < self._res_size:
                    slot = len(self._res)
                    self._res.append(None)  # type: ignore[arg-type]
                else:
                    slot = int(self._rng.integers(0, self._res_seen))
                    if slot >= self._res_size:
                        continue
                d = decisions if one else decisions[i]
                served = (np.asarray(keys[i], dtype=np.int64).copy()
                          if keys is not None
                          else np.empty(0, dtype=np.int64))
                self._res[slot] = AuditSample(
                    batch.vectors[i].copy(), batch.bitmaps[i].copy(),
                    int(batch.pred), batch.k, d[0], d[1], served,
                    generation)

    def take_samples(self, clear: bool = True) -> list[AuditSample]:
        """Drain the reservoir (auditor entry point)."""
        with self._res_lock:
            out = [s for s in self._res if s is not None]
            if clear:
                self._res = []
                self._res_seen = 0
            return out

    def drain_cells(self) -> dict:
        """Per-cell {(method, ps_id, pred): (queries, mean_latency_us)}
        accumulated since the last drain — the adapter's measured-QPS
        feed.  Resets the accumulators."""
        with self._agg_lock:
            out = {k: (n, us / n) for k, (n, us) in self._fresh.items()
                   if n > 0}
            self._fresh = {}
            return out

    def drain_shards(self) -> dict:
        """Per-shard {(shard, stage): (queries, total_seconds)} since the
        last drain — the adapter's per-shard QPS feed.  Resets the fresh
        accumulators (cumulative `shard_aggregates` is untouched)."""
        with self._agg_lock:
            out = {k: (n, s) for k, (n, s) in self._shards_fresh.items()
                   if n > 0}
            self._shards_fresh = {}
            return out

    # ----------------------------------------------------------- stats

    def stats(self) -> dict:
        """Counters, per-method/cell aggregates, and latency percentiles
        computed from the event ring."""
        events = [e for e in self._ring if e is not None]
        lat = np.sort(np.array([e.search_us for e in events],
                               dtype=np.float64))
        with self._agg_lock:
            cells = {f"{m}/{ps}/{Predicate(p).name}":
                     {"queries": n, "mean_us": round(us / n, 2)}
                     for (m, ps, p), (n, us) in self._cells.items()
                     if n > 0}
            by_method: dict[str, int] = {}
            for (m, _ps, _p), (n, _us) in self._cells.items():
                by_method[m] = by_method.get(m, 0) + n
            shards = {f"shard{sh}/{stage}":
                      {"calls": n, "total_s": round(s, 6),
                       "mean_us": round(s / n * 1e6, 2)}
                      for (sh, stage), (n, s) in sorted(
                          self._shards.items()) if n > 0}
            counters = dict(self._counters)
            batches = self._batches
            queries = self._queries
        with self._res_lock:
            res = {"size": len(self._res), "seen": self._res_seen,
                   "capacity": self._res_size}
        return {
            "queries": queries,
            "batches": batches,
            "ring_events": len(events),
            "latency_us": {"p50": round(_percentile(lat, 50), 2),
                           "p90": round(_percentile(lat, 90), 2),
                           "p99": round(_percentile(lat, 99), 2)},
            "by_method": by_method,
            "cells": cells,
            "shards": shards,
            "counters": counters,
            "reservoir": res,
        }

    # raw (unformatted) aggregate accessors for exporters -----------------

    def cell_aggregates(self) -> dict:
        """{(method, ps_id, pred): (queries, total_latency_us)} copy."""
        with self._agg_lock:
            return {k: (n, us) for k, (n, us) in self._cells.items()}

    def shard_aggregates(self) -> dict:
        """{(shard, stage): (calls, total_seconds)} copy."""
        with self._agg_lock:
            return {k: (n, s) for k, (n, s) in self._shards.items()}

    def counter_values(self) -> dict:
        with self._agg_lock:
            return dict(self._counters)

    def seen_events(self) -> int:
        """Total queries recorded (monotone)."""
        with self._agg_lock:
            return self._queries

    def recent(self, n: int = 64) -> list[QueryEvent]:
        """Up to `n` most recently written events (best-effort order).
        Ordered by the monotonic stamp — wall clock can step backwards
        (NTP) and must never drive ordering or durations."""
        events = [e for e in self._ring if e is not None]
        events.sort(key=lambda e: (e.t_mono, e.t_wall))
        return events[-n:]


# --------------------------------------------------------------- auditor


def _audit_recall(served: np.ndarray, exact: np.ndarray, k: int) -> float:
    """|served ∩ exact| / min(k, |exact|); vacuous (no matching rows)
    counts as 1.0 — mirrors `dataset.recall_at_k` but over stable keys."""
    ex = set(int(x) for x in exact if x >= 0)
    if not ex:
        return 1.0
    got = set(int(x) for x in served if x >= 0)
    return len(got & ex) / min(k, len(ex))


class RecallAuditor:
    """Replays sampled queries against the brute-force oracle on a
    pinned snapshot and folds exact recall into the online table.

    The per-pass sampling budget adapts to traffic: with `sample_frac`
    set, each pass audits at most
    `clip(ceil(traffic_since_last_pass * sample_frac), min_budget,
    max_budget)` of the drained reservoir (uniform subsample), so audit
    cost tracks sink throughput instead of reservoir size — quiet
    periods still audit `min_budget` for signal, floods are capped at
    `max_budget`. The default (`sample_frac=None`) audits every drained
    sample, the pre-adaptive behaviour.

    Args:
        index: the serving handle audits replay on.
        sink: the `TelemetrySink` whose reservoir is drained.
        table: optional `OnlineBenchmarkTable` audited recall folds into.
        ds_name: table dataset key (defaults to `index.ds.name`).
        sample_frac: target audited fraction of recorded traffic per
            pass, in (0, 1]; None audits everything.
        min_budget / max_budget: hard floor / cap on the per-pass budget
            when `sample_frac` is set.
        seed: RNG seed for the uniform subsample.
        slo: optional `repro_torch.ann.slo.SLOEngine` — every audit pass
            pushes its per-sample exact recalls into the engine's
            recall objectives (and stamps the table version as alert
            provenance), so quality regressions page.
    """

    def __init__(self, index, sink: TelemetrySink, *,
                 table: "OnlineBenchmarkTable | None" = None,
                 ds_name: str | None = None,
                 sample_frac: float | None = None,
                 min_budget: int = 8, max_budget: int = 256,
                 seed: int = 0, slo=None):
        if sample_frac is not None and not (0.0 < sample_frac <= 1.0):
            raise ValueError(
                f"sample_frac must be in (0, 1] or None; got {sample_frac}")
        if min_budget < 1 or max_budget < min_budget:
            raise ValueError(
                f"need 1 <= min_budget <= max_budget; got "
                f"{min_budget}/{max_budget}")
        self.index = index
        self.sink = sink
        self.table = table
        ds = getattr(index, "ds", None)
        self.ds_name = ds_name or (ds.name if ds is not None else "live")
        self.slo = slo
        self.sample_frac = (None if sample_frac is None
                            else float(sample_frac))
        self.min_budget = int(min_budget)
        self.max_budget = int(max_budget)
        self._budget_rng = np.random.default_rng(seed)
        self._last_seen = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.last_error: BaseException | None = None
        self.audits = 0          # samples audited so far
        self.skipped = 0         # samples dropped by the budget
        self.runs = 0

    def budget_for(self, throughput: int) -> int | None:
        """Per-pass audit budget for `throughput` queries recorded since
        the last pass: `clip(ceil(throughput * sample_frac), min_budget,
        max_budget)`; None (unlimited) when `sample_frac` is unset."""
        if self.sample_frac is None:
            return None
        want = int(np.ceil(max(0, int(throughput)) * self.sample_frac))
        return int(np.clip(want, self.min_budget, self.max_budget))

    # one audit pass -----------------------------------------------------

    def run_once(self) -> dict:
        """Drain the reservoir, replay the oracle per (pred, k) group on
        one pinned snapshot, fold per-cell recall into the table.
        Returns the audit report, including per-sample results for the
        adapter's shadow-eval holdout."""
        samples = self.sink.take_samples()
        self.runs += 1
        if not samples:
            return {"samples": 0, "cells": {}, "results": [],
                    "budget": None}
        seen = self.sink.seen_events()
        budget = self.budget_for(seen - self._last_seen)
        self._last_seen = seen
        if budget is not None and len(samples) > budget:
            # uniform subsample of the drained reservoir (which is
            # itself an unbiased sample of traffic) — order-preserving
            idx = np.sort(self._budget_rng.choice(
                len(samples), size=budget, replace=False))
            self.skipped += len(samples) - budget
            samples = [samples[int(i)] for i in idx]
        groups: dict[tuple, list[AuditSample]] = {}
        for s in samples:
            groups.setdefault((s.pred, s.k), []).append(s)

        results: list[tuple[AuditSample, float, np.ndarray]] = []
        snap_fn = getattr(self.index, "snapshot", None)
        snap = snap_fn() if callable(snap_fn) else None
        try:
            for (pred, k), group in groups.items():
                batch = QueryBatch(
                    np.stack([s.vector for s in group]),
                    np.stack([s.bitmap for s in group]),
                    Predicate(pred), k)
                if snap is not None:
                    res = self.index.search(batch, ORACLE_METHOD,
                                            snapshot=snap)
                else:
                    res = self.index.search(batch, ORACLE_METHOD)
                exact = (res.keys if res.keys is not None else res.ids)
                for j, s in enumerate(group):
                    r = _audit_recall(s.served_keys, exact[j], k)
                    results.append((s, r, np.asarray(exact[j])))
        finally:
            if snap is not None:
                snap.release()

        # fold per-(method, ps, pred) mean recall into the online table
        cells: dict[tuple, list] = {}
        for s, r, _ex in results:
            c = cells.setdefault((s.method, s.ps_id, s.pred), [0, 0.0])
            c[0] += 1
            c[1] += r
        if self.table is not None:
            for (m, ps, pred), (n, tot) in cells.items():
                self.table.observe(self.ds_name, pred, m, ps,
                                   recall=tot / n, n=n)
        self.audits += len(results)
        report_cells = {f"{m}/{ps}/{Predicate(p).name}":
                        {"n": n, "recall": round(tot / n, 4)}
                        for (m, ps, p), (n, tot) in cells.items()}
        report = {"samples": len(results), "cells": report_cells,
                  "results": results, "budget": budget}
        if self.slo is not None:
            self.slo.ingest_audit(report)
            if self.table is not None:
                self.slo.note_provenance(table_version=self.table.version)
        return report

    # background loop ----------------------------------------------------

    def start(self, interval_s: float = 1.0) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.run_once()
                except Exception as e:        # keep auditing on errors
                    self.last_error = e

        self._stop.clear()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="recall-auditor")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=30)
        self._thread = None


# ---------------------------------------------------------- online table


from repro_torch.core.table import BenchmarkTable  # noqa: E402  (cycle-free)


class OnlineBenchmarkTable(BenchmarkTable):
    """`BenchmarkTable` with EWMA-updated cells and versioned,
    atomically-republished routing arrays.

    Writers call `observe(...)` (auditor: recall, adapter: measured
    QPS); each observation advances the version counter and invalidates
    the routing-array cache, so `routing_arrays` always reflects a
    consistent published version — Algorithm 2 consumers re-route the
    moment a cell's EWMA recall crosses the threshold `t`.
    """

    def __init__(self, base: BenchmarkTable, *, alpha: float = 0.25):
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha must be in (0, 1]")
        super().__init__(entries=base.copy().entries)
        self._offline = base.copy().entries
        self._alpha = float(alpha)
        self._lock = threading.RLock()
        self._version = 0
        self._ra_cache: dict = {}
        # audited-EWMA per cell (drift is audited-vs-offline, tracked
        # separately so QPS-only observations don't register as drift)
        self._audited: dict[tuple, dict] = {}
        # per-shard EWMA QPS cells (ds, shard) — shard-divergent
        # throughput visible to routing and exported per shard
        self._shard_cells: dict[tuple, dict] = {}

    # properties ---------------------------------------------------------

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def alpha(self) -> float:
        return self._alpha

    # writes -------------------------------------------------------------

    def observe(self, ds: str, pt, method: str, ps_id, *,
                recall: float | None = None, qps: float | None = None,
                n: int = 1) -> None:
        """Fold one audited measurement into cell (ds, pt, method, ps).

        EWMA per field: new = (1-a)*old + a*measured; a cell missing
        from the offline table is seeded directly with the measurement.
        The entry dict is *replaced*, never mutated, so concurrent
        readers of `entries` see either the old or the new cell.
        """
        if recall is None and qps is None:
            return
        key = (ds, int(pt), method, ps_id)
        a = self._alpha
        with self._lock:
            cur = self.entries.get(key)
            if cur is None:
                new = {"recall": float(recall if recall is not None
                                       else 0.0),
                       "qps": float(qps if qps is not None else 0.0)}
            else:
                new = dict(cur)
                if recall is not None:
                    new["recall"] = (1 - a) * cur["recall"] + a * recall
                if qps is not None:
                    new["qps"] = (1 - a) * cur["qps"] + a * qps
            self.entries[key] = new
            if recall is not None:
                st = self._audited.setdefault(
                    key, {"recall": float(recall), "n": 0})
                st["recall"] = (1 - a) * st["recall"] + a * float(recall)
                st["n"] += int(n)
            self._version += 1
            self._ra_cache.clear()

    def observe_shard(self, ds: str, shard: int, *, qps: float,
                      stage: str = "exec", n: int = 1) -> None:
        """Fold one measured per-shard QPS sample into the (ds, shard)
        EWMA cell.  Same versioning discipline as `observe`: the entry
        dict is replaced, the version advances, so exporters see a
        consistent published view."""
        key = (str(ds), int(shard), str(stage))
        a = self._alpha
        with self._lock:
            cur = self._shard_cells.get(key)
            if cur is None:
                new = {"qps": float(qps), "n": int(n)}
            else:
                new = {"qps": (1 - a) * cur["qps"] + a * float(qps),
                       "n": cur["n"] + int(n)}
            self._shard_cells[key] = new
            self._version += 1

    # reads --------------------------------------------------------------

    def shard_cells(self, ds: str | None = None) -> dict:
        """{(ds, shard, stage): {qps, n}} copy, optionally filtered."""
        with self._lock:
            return {k: dict(v) for k, v in self._shard_cells.items()
                    if ds is None or k[0] == ds}

    def shard_divergence(self, ds: str | None = None,
                         stage: str = "exec") -> float:
        """max/min EWMA QPS ratio across shards (1.0 = perfectly even;
        0.0 when fewer than two shards have cells)."""
        qps = [v["qps"] for k, v in self.shard_cells(ds).items()
               if k[2] == stage and v["qps"] > 0]
        if len(qps) < 2:
            return 0.0
        return max(qps) / min(qps)

    def routing_arrays(self, ds: str, pt, methods, t: float):
        key = (ds, int(pt), tuple(methods), float(t))
        with self._lock:
            hit = self._ra_cache.get(key)
            if hit is not None:
                return hit
            out = super().routing_arrays(ds, pt, methods, t)
            self._ra_cache[key] = out
            return out

    def drift(self) -> dict:
        """Per-cell |audited EWMA recall − offline recall| for every
        audited cell that exists in the offline table."""
        with self._lock:
            out = {}
            for key, st in self._audited.items():
                off = self._offline.get(key)
                if off is not None:
                    out[key] = abs(st["recall"] - off["recall"])
            return out

    def max_drift(self) -> float:
        d = self.drift()
        return max(d.values()) if d else 0.0

    def audited_cells(self) -> dict:
        with self._lock:
            return {k: dict(v) for k, v in self._audited.items()}

    def snapshot(self) -> BenchmarkTable:
        """Plain frozen copy of the current published entries (what a
        retrained artifact persists)."""
        with self._lock:
            return BenchmarkTable.copy(self)


# --------------------------------------------------------------- adapter


class OnlineRouterAdapter:
    """Drift-triggered background retrain with shadow-eval promotion.

    `attach` swaps the service's table for an `OnlineBenchmarkTable`
    (re-routing is then immediate and table-driven).  Each `step()`:

    1. runs one audit pass (exact recall folds into the table) and
       accumulates audited queries into disjoint train / holdout pools;
    2. folds measured QPS from the sink's per-cell latency aggregates;
    3. if `max_drift()` >= `drift_threshold` and enough samples have
       accumulated, retrains the MLP off the serving path on
       audit-derived per-method recall labels, shadow-evaluates the
       candidate vs the incumbent on the held-out pool, and promotes
       only on improvement — saving a *new* versioned artifact dir,
       validating `artifact_versions`, linking it into the `IndexStore`
       manifest (atomic rename), and swapping `service.router` in one
       reference assignment.  On no improvement, the candidate is
       discarded and the old artifact keeps serving (rollback).
    """

    def __init__(self, service, sink: TelemetrySink, *,
                 store=None, artifact_root: str | None = None,
                 alpha: float = 0.25, drift_threshold: float = 0.05,
                 min_samples: int = 16, holdout_frac: float = 0.5,
                 retrain_epochs: int = 60, retrain_hidden=(32, 16),
                 seed: int = 0, retrain_fn=None, ds_name=None, slo=None):
        self.service = service
        self.sink = sink
        self.store = store
        self.drift_threshold = float(drift_threshold)
        self.min_samples = int(min_samples)
        self.holdout_frac = float(holdout_frac)
        self.retrain_epochs = int(retrain_epochs)
        self.retrain_hidden = tuple(retrain_hidden)
        self.retrain_fn = retrain_fn
        self._seed = int(seed)
        self._rng = np.random.default_rng(seed)
        if artifact_root is None and store is not None:
            artifact_root = os.path.join(str(store.path), "routers")
        self.artifact_root = artifact_root
        self.table = OnlineBenchmarkTable(service.router.table,
                                          alpha=alpha)
        # atomic table swap: MLRouter is a plain mutable dataclass and
        # routing reads go through router.table per call
        service.router.table = self.table
        self.auditor = RecallAuditor(service.index, sink,
                                     table=self.table, ds_name=ds_name,
                                     slo=slo)
        self.ds_name = self.auditor.ds_name
        self._train: list = []      # (sample, recall, exact_keys)
        self._holdout: list = []
        self._pool_cap = 512
        self.promotions = 0
        self.history: list[dict] = []
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.last_error: BaseException | None = None

    # ------------------------------------------------------------- step

    def step(self) -> dict:
        """One adaptation round; returns a report dict."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> dict:
        audit = self.auditor.run_once()
        for rec in audit["results"]:
            pool = (self._holdout if self._rng.random() <
                    self.holdout_frac else self._train)
            pool.append(rec)
            if len(pool) > self._pool_cap:
                pool.pop(0)
        # measured QPS from the hot-path aggregates (pt comes from the
        # cell key — one table cell per (method, ps, predicate type))
        for (m, ps, pred), (_n, mean_us) in self.sink.drain_cells().items():
            if mean_us > 0:
                self.table.observe(self.ds_name, pred, m, ps,
                                   qps=1e6 / mean_us)
        # per-shard telemetry aggregates -> shard-keyed EWMA table cells
        # (shard-divergent QPS becomes visible to routing + /metrics)
        for (sh, stage), (n, sec) in self.sink.drain_shards().items():
            if sec > 0:
                self.table.observe_shard(self.ds_name, sh, qps=n / sec,
                                         stage=stage, n=n)
        drift = self.table.max_drift()
        report = {"samples": audit["samples"],
                  "audited": self.auditor.audits,
                  "max_drift": round(drift, 4),
                  "table_version": self.table.version,
                  "retrained": False, "promoted": False}
        if (drift >= self.drift_threshold
                and len(self._train) >= self.min_samples
                and len(self._holdout) >= max(4, self.min_samples // 4)):
            report.update(self._retrain_and_maybe_promote())
        self.history.append(report)
        return report

    # ---------------------------------------------------------- retrain

    def _retrain_and_maybe_promote(self) -> dict:
        fn = self.retrain_fn or self._default_retrain
        candidate = fn(self)
        out: dict = {"retrained": True, "promoted": False}
        if candidate is None:
            return out
        old_r, new_r = self._shadow_eval(candidate)
        out["shadow"] = {"incumbent_recall": round(old_r, 4),
                         "candidate_recall": round(new_r, 4)}
        if new_r > old_r + 1e-9:
            out.update(self._promote(candidate))
            out["promoted"] = True
        else:
            out["action"] = "rollback"   # old artifact keeps serving
        return out

    def _default_retrain(self, _self=None):
        """Retrain the per-method MLPs on audit-derived labels (the JAX
        package replays each training query through every candidate at
        its max-recall setting and fits `train_models_from_xy`). This
        package has no training code yet — ROADMAP queue 1, item 2 (the
        training slice) brings it — so this raises rather than return
        None, which `_retrain_and_maybe_promote` would read as "no
        candidate" and quietly skip every retrain. Pass `retrain_fn=`
        to retrain meanwhile."""
        raise NotImplementedError(
            "OnlineRouterAdapter's default retrain needs "
            "train_models_from_xy, which comes with the training slice "
            "(ROADMAP queue 1, item 2); pass retrain_fn= until then")

    # ------------------------------------------------------ shadow eval

    def _shadow_eval(self, candidate) -> tuple[float, float]:
        """Mean exact recall of incumbent vs candidate on the held-out
        audited pool (both routed through throwaway services with no
        telemetry, so shadow traffic never pollutes the sink)."""
        from repro_torch.ann.service import RouterService

        svc = self.service
        old = RouterService(svc.index, svc.router, t=svc.t,
                            methods=svc.methods)
        new = RouterService(svc.index, candidate, t=svc.t,
                            methods=svc.methods)
        groups: dict[tuple, list] = {}
        for rec in self._holdout:
            groups.setdefault((rec[0].pred, rec[0].k), []).append(rec)
        tot = [0.0, 0.0]
        n = 0
        for (pred, k), group in groups.items():
            qb = QueryBatch(np.stack([r[0].vector for r in group]),
                            np.stack([r[0].bitmap for r in group]),
                            Predicate(pred), k)
            for slot, s in enumerate((old, new)):
                res = s.search(qb)
                got = res.keys if res.keys is not None else res.ids
                for qi, rec in enumerate(group):
                    tot[slot] += _audit_recall(got[qi], rec[2], k)
            n += len(group)
        return tot[0] / n, tot[1] / n

    # --------------------------------------------------------- promote

    def _promote(self, candidate) -> dict:
        """Persist the candidate as a *new* versioned artifact dir,
        validate `artifact_versions`, atomically link it into the store
        manifest, then swap the serving reference."""
        out: dict = {}
        if self.artifact_root is not None:
            os.makedirs(self.artifact_root, exist_ok=True)
            v = self.promotions + 1
            path = os.path.join(self.artifact_root, f"router-v{v:03d}")
            while os.path.exists(path):
                v += 1
                path = os.path.join(self.artifact_root,
                                    f"router-v{v:03d}")
            # persist with a frozen table snapshot, then re-attach the
            # live online table for serving
            from repro_torch.core.router import artifact_versions

            candidate.table = self.table.snapshot()
            try:
                candidate.save(path)
            finally:
                candidate.table = self.table
            versions = artifact_versions(path)
            out["artifact"] = path
            out["versions"] = versions
            if self.store is not None:
                self.store.link_router(path)
        candidate.table = self.table
        self.service.router = candidate      # atomic reference swap
        self.promotions += 1
        return out

    # ------------------------------------------------- background loop

    def start(self, interval_s: float = 2.0) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.step()
                except Exception as e:
                    self.last_error = e

        self._stop.clear()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="router-adapter")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=60)
        self._thread = None


# ------------------------------------------------- drift fault injection


class DegradedMethod:
    """Wraps a registered `Method` and truncates its results to the
    first `keep` of k — an injected recall regression that only the
    audit loop can see (the method still *returns* k-shaped arrays, so
    nothing crashes; recall just drops). Used by the adaptation tests
    and `chip_smoke.py` to measure time-to-reroute.

    The truncation copies whatever the wrapped method returns: numpy
    arrays on the host (the `Method.search` contract), or tensors, which
    are cloned and filled on their own device."""

    def __init__(self, inner, keep: int = 3):
        self._inner = inner
        self._keep = int(keep)
        self.name = inner.name

    @property
    def builds_on_device(self) -> bool:
        return bool(getattr(self._inner, "builds_on_device", False))

    def param_settings(self):
        return self._inner.param_settings()

    def build(self, ds, build_params, **kw):
        return self._inner.build(ds, build_params, **kw)

    def index_arrays(self, index):
        return self._inner.index_arrays(index)

    def index_from_arrays(self, ds, build_params, arrays):
        return self._inner.index_from_arrays(ds, build_params, arrays)

    def search(self, fx, index, qvecs, qbms, pred, k, search_params):
        ids, raw = self._inner.search(fx, index, qvecs, qbms, pred, k,
                                      search_params)
        if isinstance(ids, torch.Tensor):
            ids, raw = ids.clone(), raw.clone()
        else:
            ids = np.array(ids, copy=True)
            raw = np.array(raw, copy=True)
        if ids.shape[1] > self._keep:
            ids[:, self._keep:] = -1
            raw[:, self._keep:] = float("inf")
        return ids, raw


def constant_router(feature_names, methods: list, table,
                    value: float = 0.95):
    """An `MLRouter` whose every prediction is exactly `value` (one
    zero-weight linear layer, identity scaler). With `value >= t` every
    method is in Algorithm 2's candidate set, so routing is decided
    purely by the benchmark table — the deterministic harness the
    adaptation tests and benches use to make re-routing table-driven."""
    from repro_torch.core import mlp
    from repro_torch.core.router import MLRouter

    nf = 0
    for name in feature_names:
        nf += 3 if name == "pred" else 1
    models = {m: [{"w": np.zeros((nf, 1), np.float32),
                   "b": np.full((1,), value, np.float32)}]
              for m in methods}
    scaler = mlp.Scaler(np.zeros(nf), np.ones(nf))
    return MLRouter(feature_names=list(feature_names), methods=methods,
                    models=models, scaler=scaler, table=table)
