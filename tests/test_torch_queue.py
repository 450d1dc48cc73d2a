"""`AsyncBatchQueue` on the CPU: the cases of the JAX package's queue
tests (flush on `max_batch` and on `max_wait_ms`, per-(pred, k) grouping,
routed decisions, `flush`/`close`, validation, errors reaching exactly
their batch), each answer held against the JAX package's answer for the
same query; then the queue over the sharded service from many threads."""

import os
import sys
import threading

import numpy as np
import pytest

from repro.ann.index import QueryBatch as JQB
from repro.ann.service import RouterService as JService
from repro.core.router import MLRouter as JRouter
from repro_torch.ann.index import FilteredIndex
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.predicates import Predicate
from repro_torch.ann.service import (AsyncBatchQueue, RouterService,
                                     ShardedRouterService)
from repro_torch.ann.sharded import ShardedFilteredIndex
from repro_torch.core.router import MLRouter as TRouter
from repro_torch.data.ann_synth import DatasetSpec, synthesize

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's
ALL_PREDS = (Predicate.EQUALITY, Predicate.AND, Predicate.OR)
ROUTER = os.path.join(os.path.dirname(__file__), os.pardir, "src",
                      "repro_torch", "assets", "router_ivf")
# Exact distances from fp32 scores that the two packages sum in
# different orders: a few ulps of ‖v‖² + 2‖q‖‖v‖ (≲ 300 here).
ATOL = 1e-3
TIMEOUT = 60


@pytest.fixture(scope="module")
def tds():
    return synthesize(DatasetSpec(*TINY))


@pytest.fixture(scope="module")
def tfx(tds):
    fx = FilteredIndex(tds, device="cpu")
    yield fx
    fx.close()


@pytest.fixture(scope="module")
def routers(tiny_ds):
    """The committed router, loaded by each package, with the same
    benchmark-table rows for the tiny dataset."""
    jr, tr = JRouter.load(ROUTER), TRouter.load(ROUTER)
    rand = np.random.default_rng(11)
    for pt in range(3):
        for name, ps_ids in (("postfilter", ("ef200", "ef800", "ef2000")),
                             ("ivf_gamma", ("g1", "g4", "g8"))):
            for ps in ps_ids:
                rec, qps = rand.uniform(0.6, 1.0), rand.uniform(100, 2000)
                for r in (jr, tr):
                    r.table.add(tiny_ds.name, pt, name, ps, float(rec),
                                float(qps))
    return jr, tr


def _jax_exact(tiny_index, v, b, pred, k):
    return tiny_index.search(JQB(v, b, pred, k), "prefilter")


def _same_row(r, want_ids, want_d):
    np.testing.assert_array_equal(r.ids, want_ids)
    np.testing.assert_allclose(r.distances, want_d, rtol=0, atol=ATOL,
                               equal_nan=True)


def test_queue_flush_on_max_batch(tiny_index, tfx, tiny_queries):
    """With an effectively infinite wait, only the max_batch knob can
    trigger the flush."""
    qs = tiny_queries[Predicate.AND]
    want = _jax_exact(tiny_index, qs.vectors[:8], qs.bitmaps[:8],
                      Predicate.AND, 10)
    with AsyncBatchQueue(tfx, max_batch=8, max_wait_ms=60_000,
                         method="prefilter") as q:
        futs = [q.submit(qs.vectors[i], qs.bitmaps[i], Predicate.AND)
                for i in range(8)]
        results = [f.result(timeout=TIMEOUT) for f in futs]
        stats = q.stats()
    assert stats["flush_reasons"] == {"max_batch": 1}
    assert stats["queries"] == 8 and stats["max_batch_seen"] == 8
    assert stats["batches"] == 1 and stats["pending"] == 0
    for i, r in enumerate(results):
        _same_row(r, want.ids[i], want.distances[i])
        np.testing.assert_array_equal(r.keys, want.ids[i])
        assert r.decision is None                  # direct method, no router


def test_queue_flush_on_max_wait(tiny_index, tfx, tiny_queries):
    """Fewer requests than max_batch: the age knob must flush them."""
    qs = tiny_queries[Predicate.OR]
    want = _jax_exact(tiny_index, qs.vectors[:3], qs.bitmaps[:3],
                      Predicate.OR, 10)
    with AsyncBatchQueue(tfx, max_batch=64, max_wait_ms=40,
                         method="prefilter") as q:
        futs = [q.submit(qs.vectors[i], qs.bitmaps[i], Predicate.OR)
                for i in range(3)]
        results = [f.result(timeout=TIMEOUT) for f in futs]
        stats = q.stats()
    for i, r in enumerate(results):
        _same_row(r, want.ids[i], want.distances[i])
    assert stats["flush_reasons"].get("max_wait", 0) >= 1
    assert "max_batch" not in stats["flush_reasons"]
    assert stats["queries"] == 3


def test_queue_groups_mixed_predicates(tiny_index, tfx, tiny_queries):
    """One flush serves mixed-predicate traffic correctly (grouped into
    per-(pred, k) sub-batches)."""
    subs = []
    for pred in ALL_PREDS:
        qs = tiny_queries[pred]
        subs += [(pred, qs.vectors[i], qs.bitmaps[i]) for i in range(4)]
    with AsyncBatchQueue(tfx, max_batch=len(subs), max_wait_ms=60_000,
                         method="prefilter") as q:
        futs = [q.submit(v, b, pred, k=7) for pred, v, b in subs]
        results = [f.result(timeout=TIMEOUT) for f in futs]
        assert q.stats()["batches"] == 1
    for (pred, v, b), r in zip(subs, results):
        want = _jax_exact(tiny_index, v[None], b[None], pred, 7)
        _same_row(r, want.ids[0], want.distances[0])


def test_queue_routed_service_carries_decisions(tiny_index, tfx,
                                                tiny_queries, routers):
    jr, tr = routers
    qs = tiny_queries[Predicate.AND]
    want = JService(tiny_index, jr, t=0.9).search(
        JQB(qs.vectors[:4], qs.bitmaps[:4], Predicate.AND, 10))
    with AsyncBatchQueue(RouterService(tfx, tr, t=0.9), max_batch=4,
                         max_wait_ms=60_000) as q:
        futs = [q.submit(qs.vectors[i], qs.bitmaps[i], Predicate.AND)
                for i in range(4)]
        results = [f.result(timeout=TIMEOUT) for f in futs]
    assert [tuple(r.decision) for r in results] == \
        [tuple(d) for d in want.decisions]
    for i, r in enumerate(results):
        _same_row(r, want.ids[i], want.distances[i])


def test_queue_flush_waits_for_inflight(tfx, tiny_queries):
    """flush() must cover the batch the worker already dequeued, not just
    what is still pending."""
    qs = tiny_queries[Predicate.AND]
    with AsyncBatchQueue(tfx, max_batch=1, max_wait_ms=0,
                         method="prefilter") as q:
        futs = [q.submit(qs.vectors[i], qs.bitmaps[i], Predicate.AND)
                for i in range(3)]
        q.flush(timeout=120)
        assert all(f.done() for f in futs)


def test_queue_close_drains_and_rejects(tfx, tiny_queries):
    qs = tiny_queries[Predicate.AND]
    q = AsyncBatchQueue(tfx, max_batch=64, max_wait_ms=60_000,
                        method="prefilter")
    fut = q.submit(qs.vectors[0], qs.bitmaps[0], Predicate.AND)
    q.close()                                  # drains the pending query
    assert fut.result(timeout=TIMEOUT).ids.shape == (10,)
    assert q.stats()["flush_reasons"] == {"close": 1}
    with pytest.raises(RuntimeError, match="closed"):
        q.submit(qs.vectors[0], qs.bitmaps[0], Predicate.AND)
    q.close()                                  # idempotent


def test_queue_validates(tfx, tds):
    with pytest.raises(ValueError, match="max_batch"):
        AsyncBatchQueue(tfx, max_batch=0, method="prefilter")
    with pytest.raises(ValueError, match="max_wait_ms"):
        AsyncBatchQueue(tfx, max_wait_ms=-1, method="prefilter")
    with AsyncBatchQueue(tfx, method="prefilter") as q:
        with pytest.raises(ValueError, match="one query"):
            q.submit(tds.vectors[:2], tds.bitmaps[:2], Predicate.AND)
        # dim mismatches are rejected per caller at submit() — inside the
        # worker they would fail the whole co-batched group
        with pytest.raises(ValueError, match="vector dim"):
            q.submit(tds.vectors[0, :-2], tds.bitmaps[0], Predicate.AND)
        with pytest.raises(ValueError, match="bitmap width"):
            q.submit(tds.vectors[0],
                     np.concatenate([tds.bitmaps[0]] * 2), Predicate.AND)


def test_queue_propagates_backend_errors(tfx, tds, tiny_queries):
    """A failing batch rejects exactly its own futures; the next batch is
    served."""
    with AsyncBatchQueue(tfx, max_batch=2, max_wait_ms=60_000,
                         method="no_such_method") as q:
        futs = [q.submit(tds.vectors[i], tds.bitmaps[i], Predicate.AND)
                for i in range(2)]
        for f in futs:
            with pytest.raises(KeyError, match="unknown method"):
                f.result(timeout=TIMEOUT)

    class FailsOnEquality:
        ds = tds

        def search(self, batch, method, setting):
            if batch.pred == Predicate.EQUALITY:
                raise RuntimeError("boom")
            return tfx.search(batch, method, setting)

    qs = tiny_queries[Predicate.OR]
    with AsyncBatchQueue(FailsOnEquality(), max_batch=4, max_wait_ms=60_000,
                         method="prefilter") as q:
        bad = [q.submit(tds.vectors[i], tds.bitmaps[i], Predicate.EQUALITY)
               for i in range(2)]
        good = [q.submit(qs.vectors[i], qs.bitmaps[i], Predicate.OR)
                for i in range(2)]
        for f in bad:
            with pytest.raises(RuntimeError, match="boom"):
                f.result(timeout=TIMEOUT)
        assert all(f.result(timeout=TIMEOUT).ids.shape == (10,)
                   for f in good)


# ---------------------------------------------------------------------------
# the queue over the sharded service, from many threads
# ---------------------------------------------------------------------------

def _submit_from_threads(q, subs, n_threads):
    """Submit `subs` [(pred, vector, bitmap)] from `n_threads` threads,
    each taking every n-th; returns the futures in `subs` order."""
    futs = [None] * len(subs)

    def work(t):
        for i in range(t, len(subs), n_threads):
            pred, v, b = subs[i]
            futs[i] = q.submit(v, b, pred)

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=TIMEOUT)
    assert not any(th.is_alive() for th in threads)
    return futs


def test_queue_over_sharded_service_matches_batched(tds, tiny_queries,
                                                    routers):
    """Single-query submits from 8 threads (mixed predicates) get the
    batched routed search's decision for their query, and with
    `method="prefilter"` the batched exact search's ids."""
    _, tr = routers
    subs, want_dec, want_ids = [], [], []
    with ShardedFilteredIndex(tds, 3, device="cpu") as sfx:
        svc = ShardedRouterService(sfx, tr, t=0.9)
        for pred in ALL_PREDS:
            qs = tiny_queries[pred]
            batch = TQB(qs.vectors, qs.bitmaps, pred, 10)
            want_dec += svc.route(batch)
            want_ids += list(sfx.search(batch, "prefilter").ids)
            subs += [(pred, qs.vectors[i], qs.bitmaps[i])
                     for i in range(qs.q)]
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            with AsyncBatchQueue(svc, max_batch=16, max_wait_ms=2) as q:
                routed = [f.result(timeout=TIMEOUT)
                          for f in _submit_from_threads(q, subs, 8)]
                stats = q.stats()
            with AsyncBatchQueue(sfx, max_batch=16, max_wait_ms=2,
                                 method="prefilter") as q:
                exact = [f.result(timeout=TIMEOUT)
                         for f in _submit_from_threads(q, subs, 8)]
        finally:
            sys.setswitchinterval(old)
    assert [r.decision for r in routed] == want_dec
    for r, ids in zip(exact, want_ids):
        np.testing.assert_array_equal(r.ids, ids)
    assert stats["queries"] == len(subs)
    assert sum(stats["flush_reasons"].values()) == stats["batches"]
    assert stats["max_batch_seen"] <= 16
