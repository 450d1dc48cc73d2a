"""Serving over the live layer on the CPU against the JAX package: the
live routing features (exact live selectivity, label frequencies, the
`size` feature), `RouterService` over a live handle before and after
writes, and `AsyncBatchQueue` answering single queries while a writer
upserts. The serving patterns of `tests/test_live.py`; the helpers are
`test_torch_live.py`'s.

Every test draws its randomness from its own seeded generator."""

import threading
import time

import jax
import numpy as np
import pytest

from repro.ann.live import LiveFilteredIndex as JLive
from repro.ann.service import RouterService as JService
from repro.core import features as jF
from repro.core import mlp as jmlp
from repro.core.router import MLRouter as JRouter
from repro.core.table import BenchmarkTable as JTable
from repro_torch.ann.predicates import Predicate, eval_predicate_np
from repro_torch.ann.service import AsyncBatchQueue, RouterService
from repro_torch.core import features as tF
from repro_torch.core.router import MLRouter as TRouter
from test_torch_live import (ALL_PREDS, _batches, _live, _state,  # noqa: F401
                             tds)

METHODS = ["postfilter", "ivf_gamma"]


def test_live_features_match_reference(tiny_ds, tds, tiny_queries):
    """Live selectivity (exact, against the oracle), label frequencies and
    the `size` feature: the JAX package's numbers, bit for bit."""
    with _live(tds) as tl, JLive(tiny_ds) as jl:
        for live, ds in ((tl, tds), (jl, tiny_ds)):
            ids = live.upsert(ds.vectors[:70] + np.float32(0.04),
                              ds.bitmaps[200:270])
            live.delete(np.concatenate([np.arange(40, 90), ids[:15]]))
        _, all_b, tomb = _state(tl)
        n_live = int((~tomb).sum())
        assert tl.live_stats().n_live == jl.live_stats().n_live == n_live
        np.testing.assert_array_equal(tl.live_stats().label_freq,
                                      jl.live_stats().label_freq)
        for pred in ALL_PREDS:
            qb = tiny_queries[pred].bitmaps
            got = tF.batch_selectivity(tds, qb, pred, fx=tl)
            np.testing.assert_array_equal(
                got, jF.batch_selectivity(tiny_ds, qb, pred, fx=jl))
            want = np.array([
                float((eval_predicate_np(all_b, qb[i][None], pred)
                       & ~tomb).sum()) / n_live for i in range(qb.shape[0])])
            np.testing.assert_allclose(got, want, atol=1e-12)
            names = tF.MINIMAL_FEATURES + ["size", "mean_label_freq"]
            x = tF.feature_matrix(tds, qb, pred, names, fx=tl)
            assert x.tobytes() == jF.feature_matrix(
                tiny_ds, qb, pred, names, fx=jl).tobytes()
            assert (x[:, names.index("size") + 2] == n_live).all()


@pytest.fixture(scope="module")
def router_path(tiny_ds, tiny_queries, tmp_path_factory):
    """One router (random MLP weights, both methods on both sides of the
    thresholds), saved by the JAX package, loaded by each."""
    rand = np.random.default_rng(11)
    table = JTable.new()
    for pt in range(3):
        for name, ps_ids in (("postfilter", ("ef200", "ef800", "ef2000")),
                             ("ivf_gamma", ("g1", "g4", "g8"))):
            for ps in ps_ids:
                table.add(tiny_ds.name, pt, name, ps,
                          recall=float(rand.uniform(0.75, 1.0)),
                          qps=float(rand.uniform(100, 2000)))
    models = {m: jmlp.params_to_numpy(
        jmlp.init_mlp((5, 16, 8, 1), jax.random.PRNGKey(7 + j)))
        for j, m in enumerate(METHODS)}
    x = np.concatenate([jF.feature_matrix(tiny_ds, qs.bitmaps, p,
                                          jF.MINIMAL_FEATURES)
                        for p, qs in tiny_queries.items()])
    path = str(tmp_path_factory.mktemp("router") / "r")
    JRouter(feature_names=jF.MINIMAL_FEATURES, methods=METHODS,
            models=models, scaler=jmlp.Scaler.fit(x), table=table).save(path)
    return path


def test_router_service_serves_live_as_reference(tiny_ds, tds, tiny_queries,
                                                 router_path):
    """RouterService over the live handle, before and after writes: the
    JAX package's decisions, ids and keys; live stage timings; one
    batch-wide snapshot (the handle's pin count returns to 0)."""
    with _live(tds) as tl, JLive(tiny_ds) as jl:
        ts = RouterService(tl, TRouter.load(router_path), t=0.9)
        js = JService(jl, JRouter.load(router_path), t=0.9)
        for write in (False, True):
            if write:
                for live, ds in ((tl, tds), (jl, tiny_ds)):
                    ids = live.upsert(ds.vectors[:30] + np.float32(0.01),
                                      ds.bitmaps[:30])
                    live.delete(np.concatenate([ids[:5], [1, 2, 3]]))
            for pred in ALL_PREDS:
                jb, tb = _batches(tiny_queries[pred], pred)
                tr, jr = ts.search(tb), js.search(jb)
                assert [tuple(d) for d in tr.decisions] == \
                    [tuple(d) for d in jr.decisions]
                np.testing.assert_array_equal(tr.ids, jr.ids)
                np.testing.assert_array_equal(tr.keys, jr.keys)
                assert {"route_s", "base_s", "delta_s", "merge_s"} <= \
                    tr.timings.keys()
                assert not tl._readers
        tb = _batches(tiny_queries[Predicate.AND], Predicate.AND)[1]
        chunked = ts.search_chunked(tb, chunk=8)
        np.testing.assert_array_equal(chunked.ids, ts.search(tb).ids)
        assert chunked.timings["delta_s"] > 0


def test_queue_serves_live_index_under_writes(tds, tiny_queries):
    """Concurrent single queries through `AsyncBatchQueue` while a writer
    upserts: every answer is well formed and never holds a row deleted
    before any search."""
    qs = tiny_queries[Predicate.AND]
    with _live(tds) as live:
        ids = live.upsert(tds.vectors[:60] + np.float32(0.01),
                          tds.bitmaps[:60])
        live.delete(ids[:20])
        with AsyncBatchQueue(live, max_batch=8, max_wait_ms=5,
                             method="prefilter") as q:
            stop = threading.Event()

            def writer():
                i = 0
                while not stop.is_set() and i < 40:
                    live.upsert(tds.vectors[i: i + 1] + np.float32(0.2),
                                tds.bitmaps[i: i + 1])
                    i += 1
                    time.sleep(0.001)

            th = threading.Thread(target=writer)
            th.start()
            futs = [q.submit(qs.vectors[i % qs.q], qs.bitmaps[i % qs.q],
                             Predicate.AND) for i in range(24)]
            results = [f.result(timeout=120) for f in futs]
            stop.set()
            th.join(timeout=60)
            assert not th.is_alive()
        for r in results:
            assert r.ids.shape == (10,) and r.keys.shape == (10,)
            assert not np.isin(r.ids[r.ids >= 0], ids[:20]).any()

