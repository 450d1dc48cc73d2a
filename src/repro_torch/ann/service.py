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
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.ann import engine
from repro_torch.ann import registry as registry_mod
from repro_torch.ann.index import (FilteredIndex, QueryBatch, RoutingDecision,
                                   SearchResult, exact_distances)


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
        index: the owned serving handle the service executes on.
        router: a `repro_torch.core.router.MLRouter`.
        t: default recall threshold T for Algorithm 2 (per-call
            overridable via the `t=` kwarg on search/route/explain).
        methods: optional Mapping name -> Method overriding the default
            candidate-registry view.
    """

    def __init__(self, index: FilteredIndex, router, *, t: float = 0.9,
                 methods=None):
        self.index = index
        self.router = router
        self.t = float(t)
        self.methods = (methods if methods is not None
                        else registry_mod.candidate_methods())

    @property
    def ds(self):
        return self.index.ds

    # ---- routing ---------------------------------------------------------
    def predict(self, batch: QueryBatch) -> np.ndarray:
        """[Q, M] predicted recall per candidate method."""
        return self.router.predict_recalls(self.ds, batch.bitmaps,
                                           batch.pred, fx=self.index)

    def route(self, batch: QueryBatch, *,
              t: float | None = None) -> list[RoutingDecision]:
        """Per-query `RoutingDecision`s without executing the searches
        (Algorithm 2 at threshold `t`, default the service's)."""
        return self._decide(self.predict(batch), batch, t)

    def _decide(self, r_hat, batch, t):
        t = self.t if t is None else t
        dec = self.router.route_from_predictions(
            r_hat, self.ds.name, batch.pred, t)
        return [RoutingDecision(m, ps) for m, ps in dec]

    # ---- serving ---------------------------------------------------------
    def execute(self, batch: QueryBatch,
                decisions: list[RoutingDecision]) -> SearchResult:
        """Run already-routed decisions: each (method, ps) group executes
        as one batched search on the owned index."""
        t1 = time.perf_counter()
        ids = np.full((batch.q, batch.k), -1, dtype=np.int32)
        raw = np.full((batch.q, batch.k), np.inf, dtype=np.float32)
        groups: dict = {}
        for qi, d in enumerate(decisions):
            groups.setdefault(d, []).append(qi)
        for (m_name, ps_id), idxs in groups.items():
            method = self.methods[m_name]
            # B may not cover a brand-new deployment dataset yet: fall
            # back to the method's max-budget setting until benchmarked.
            setting = engine.resolve_setting(method, ps_id)
            idxs = np.asarray(idxs)
            g_ids, g_raw = self.index.run_method(method, setting,
                                                 batch.take(idxs))
            ids[idxs] = g_ids
            raw[idxs] = g_raw
        t2 = time.perf_counter()
        return SearchResult(
            ids=ids,
            distances=exact_distances(raw, ids, batch.vectors),
            decisions=list(decisions),
            timings={"search_s": t2 - t1, "total_s": t2 - t1},
            keys=self.index.keys_of(ids))

    def search(self, batch: QueryBatch, *,
               t: float | None = None) -> SearchResult:
        """Route the batch, then run each (method, ps) group as one
        batched search. Returns a `SearchResult` with [Q, k] ids, exact
        squared-L2 distances, per-query `RoutingDecision`s and stage
        timings (`route_s`, `search_s`, `total_s`). Raises ValueError on
        batch/dataset shape mismatch; RuntimeError if the index is
        closed."""
        t0 = time.perf_counter()
        decisions = self.route(batch, t=t)
        t1 = time.perf_counter()
        res = self.execute(batch, decisions)
        res.timings["route_s"] = t1 - t0
        res.timings["total_s"] = res.timings["search_s"] + (t1 - t0)
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
