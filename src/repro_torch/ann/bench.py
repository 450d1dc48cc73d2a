"""Measurement harness: run (dataset × predicate × method × param-setting),
recording per-query recall@k and wall-clock QPS — the raw material for
the offline benchmark table B and the router training set. Methods
return host arrays, so each timed call ends after the device has
finished.

Runs against a handle (`FilteredIndex` or any other); a bare
`ANNDataset` opens the shared default pool's handle on `device`."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.ann import engine
from repro_torch.ann.dataset import QuerySet, recall_at_k
from repro_torch.ann.index import QueryBatch, as_index


@dataclasses.dataclass
class RunResult:
    dataset: str
    pred: int
    method: str
    ps_id: str
    recall_per_query: np.ndarray   # [Q]
    mean_recall: float
    qps: float
    latency_s: float
    ids: np.ndarray                # [Q, k]
    dists: np.ndarray              # [Q, k] ranking scores (+inf at −1 pad)


def run_method(fx, method: engine.Method, setting, qs: QuerySet, *,
               warmup: bool = True, device="cuda") -> RunResult:
    """One (method, setting) over the query set `qs` on the handle `fx`
    (a bare dataset opens its pooled handle on `device`, "cuda" by
    default)."""
    fx = as_index(fx, device)
    batch = QueryBatch.from_queryset(qs)
    if warmup:  # exclude index build and first-call set-up from the timing
        fx.run_method(method, setting, batch.take(np.arange(min(8, qs.q))))
    t0 = time.perf_counter()
    ids, dists = fx.run_method(method, setting, batch)
    dt = time.perf_counter() - t0
    rec = recall_at_k(ids, qs.ground_truth)
    return RunResult(
        dataset=fx.ds.name, pred=int(qs.pred), method=method.name,
        ps_id=setting.ps_id, recall_per_query=rec,
        mean_recall=float(rec.mean()), qps=qs.q / max(dt, 1e-9),
        latency_s=dt, ids=ids, dists=dists)



def sweep(fx, methods: dict, qs: QuerySet, *,
          device="cuda") -> list[RunResult]:
    """Every parameter setting of every method in `methods` over `qs`."""
    fx = as_index(fx, device)
    out = []
    for m in methods.values():
        for setting in m.param_settings():
            out.append(run_method(fx, m, setting, qs))
    return out
