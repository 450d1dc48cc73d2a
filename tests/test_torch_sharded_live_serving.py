"""Serving over the sharded live layer on the CPU against the JAX package:
the live routing features of a `ShardedLiveIndex` (exact live
selectivity, label frequencies, the `size` feature), `ShardedRouterService`
over it with the IVF pair's router (the tiny spec) and with the
five-method `router_all` (quickstart's dataset), both packages loading
the same assets with the same benchmark-table rows, before and after
writes, and `AsyncBatchQueue` over it answering as the batched calls do.
The helpers are `test_torch_sharded_live.py`'s.

Every test draws its randomness from its own seeded generator."""

import os
import threading

import numpy as np
import pytest

from repro.ann.index import QueryBatch as JQB
from repro.ann.service import ShardedRouterService as JShardedService
from repro.core import features as jF
from repro.core.router import MLRouter as JRouter
from repro.data import ann_synth as jsynth
from repro_torch.ann.index import FilteredIndex
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.live import LiveFilteredIndex, ShardedLiveIndex
from repro_torch.ann.predicates import eval_predicate_np
from repro_torch.ann.registry import candidate_methods
from repro_torch.ann.service import (AsyncBatchQueue, RouterService,
                                     ShardedRouterService)
from repro_torch.core import features as tF
from repro_torch.core.router import MLRouter as TRouter
from repro_torch.data import ann_synth as tsynth
from test_torch_sharded_live import (ALL_PREDS, _pair, _rows,  # noqa: F401
                                     _tol, _writes, tds)

ASSETS = os.path.join(os.path.dirname(__file__), os.pardir, "src",
                      "repro_torch", "assets")
# examples/quickstart.py's dataset
DEMO = ("demo", 4000, 48, 64, 8, 12, 1.3, 2.0, 0.5, 0.3, 42)


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_live_features_match_reference(tiny_ds, tds, tiny_queries, n_shards):
    """`live_stats()` and the selectivity, label-frequency and `size`
    features of the sharded live handle: the reference's numbers bit for
    bit, and the selectivity the oracle's over the live rows."""
    jl, tl = _pair(tiny_ds, tds, n_shards)
    with jl, tl:
        for live, ds in ((jl, tiny_ds), (tl, tds)):
            _writes(live, ds, 21)
        js, ts = jl.live_stats(), tl.live_stats()
        assert ts.n_live == js.n_live == tds.n + 30
        for f in ("label_freq", "base_tomb_bitmaps", "delta_bitmaps"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
        assert ts.base_ds is tds
        _, all_b, tomb = _rows(tl)
        for pred in ALL_PREDS:
            qb = tiny_queries[pred].bitmaps
            got = tF.batch_selectivity(tds, qb, pred, fx=tl)
            np.testing.assert_array_equal(
                got, jF.batch_selectivity(tiny_ds, qb, pred, fx=jl))
            want = np.array([
                float((eval_predicate_np(all_b, qb[i][None], pred)
                       & ~tomb).sum()) / ts.n_live
                for i in range(qb.shape[0])])
            np.testing.assert_allclose(got, want, atol=1e-12)
            names = tF.MINIMAL_FEATURES + ["size", "mean_label_freq"]
            x = tF.feature_matrix(tds, qb, pred, names, fx=tl)
            assert x.tobytes() == jF.feature_matrix(
                tiny_ds, qb, pred, names, fx=jl).tobytes()
            assert (x[:, names.index("size") + 2] == ts.n_live).all()


def _routers(ds, asset):
    """The committed router `asset`, loaded by each package, with the same
    seeded benchmark-table rows for the dataset `ds` (every setting of
    its methods, on both sides of the thresholds)."""
    path = os.path.join(ASSETS, asset)
    jr, tr = JRouter.load(path), TRouter.load(path)
    rand = np.random.default_rng(17)
    for pt in range(3):
        for name in tr.methods:
            for s in candidate_methods()[name].param_settings():
                rec, qps = rand.uniform(0.6, 1.0), rand.uniform(100, 2000)
                for r in (jr, tr):
                    r.table.add(ds.name, pt, name, s.ps_id, float(rec),
                                float(qps))
    return jr, tr


def _serve_alike(jds, tds, queries, asset, n_shards, write):
    """`ShardedRouterService` over each package's sharded live handle and
    the port's `RouterService` over a single live handle, before and
    after `write(handle, ds)`: the reference's decisions, ids and keys
    (distances within `_tol`), the single handle's decisions, the sharded
    and live stage timings, one cross-shard snapshot a batch (the epoch's
    reader count back to 0). Returns the methods chosen."""
    jr, tr = _routers(jds, asset)
    jl, tl = _pair(jds, tds, n_shards)
    seen = set()
    with jl, tl, LiveFilteredIndex(tds, device="cpu") as single:
        tsvc = ShardedRouterService(tl, tr, t=0.9)
        jsvc = JShardedService(jl, jr, t=0.9)
        ssvc = RouterService(single, tr, t=0.9)
        for written in (False, True):
            if written:
                for live, ds in ((jl, jds), (tl, tds), (single, tds)):
                    write(live, ds)
            vec, _, _ = _rows(tl)
            for pred, (qv, qb) in queries.items():
                tb = TQB(qv, qb, pred, 10)
                res = tsvc.search(tb)
                want = jsvc.search(JQB(qv, qb, pred, 10))
                assert [tuple(d) for d in res.decisions] == \
                    [tuple(d) for d in want.decisions]
                assert res.decisions == ssvc.route(tb)
                np.testing.assert_array_equal(res.ids, want.ids)
                np.testing.assert_array_equal(res.keys, want.keys)
                ok = res.ids >= 0
                assert (np.abs(res.distances - want.distances)[ok]
                        <= _tol(vec, qv, res.ids)[ok]).all()
                assert {"route_s", "base_s", "delta_s", "merge_s",
                        "shard_max_s"} <= res.timings.keys()
                assert not tl._epoch_readers
                seen |= {m for m, _ in res.decisions}
    return seen


@pytest.mark.parametrize("n_shards", [2, 3])
def test_ivf_router_serves_sharded_live_as_reference(tiny_ds, tds,
                                                     tiny_queries, n_shards):
    queries = {p: (qs.vectors, qs.bitmaps) for p, qs in tiny_queries.items()}
    seen = _serve_alike(tiny_ds, tds, queries, "router_ivf", n_shards,
                        lambda live, ds: _writes(live, ds, 22))
    assert seen == {"postfilter", "ivf_gamma"}


def test_router_all_serves_sharded_live_as_reference():
    """The five-method router over 2 shards of quickstart's dataset (the
    tiny spec's label groups are too small for the reference's labelnav
    at k = 10): decisions reach labelnav, sieve and fvamana."""
    jds = jsynth.synthesize(jsynth.DatasetSpec(*DEMO))
    tds_ = tsynth.synthesize(tsynth.DatasetSpec(*DEMO))
    queries = {}
    for pred in ALL_PREDS:
        qs = jsynth.make_queries(jds, pred, 40, seed=9,
                                 with_ground_truth=False)
        queries[pred] = (qs.vectors, qs.bitmaps)

    def write(live, ds):
        ids = live.upsert(ds.vectors[:200] + np.float32(0.05),
                          ds.bitmaps[:200])
        live.delete(np.concatenate([np.arange(100, 120), ids[:30]]))

    seen = _serve_alike(jds, tds_, queries, "router_all", 2, write)
    assert {"labelnav", "sieve", "fvamana"} <= seen, seen


def test_service_refuses_single_handles_and_chunks_alike(tds, tiny_queries,
                                                         tiny_ds):
    _, tr = _routers(tiny_ds, "router_ivf")
    with FilteredIndex(tds, device="cpu") as fx, \
            LiveFilteredIndex(tds, device="cpu") as single:
        for h in (fx, single):
            with pytest.raises(TypeError, match="ShardedLiveIndex"):
                ShardedRouterService(h, tr)
    qs = tiny_queries[ALL_PREDS[1]]
    b = TQB(qs.vectors, qs.bitmaps, ALL_PREDS[1], 10)
    with ShardedLiveIndex(tds, 2, device="cpu") as live:
        _writes(live, tds, 23)
        svc = ShardedRouterService(live, tr, t=0.9)
        whole, chunked = svc.search(b), svc.search_chunked(b, chunk=8)
        np.testing.assert_array_equal(chunked.ids, whole.ids)
        assert chunked.decisions == whole.decisions
        assert chunked.timings["delta_s"] > 0


def test_queue_over_sharded_live_answers_as_batched(tiny_ds, tds,
                                                    tiny_queries):
    """Single queries from 4 threads through `AsyncBatchQueue` over the
    routed sharded live service (the batched route's decisions and ids)
    and over the handle with `method="prefilter"` (the batched exact
    ids)."""
    _, tr = _routers(tiny_ds, "router_ivf")
    with ShardedLiveIndex(tds, 3, device="cpu") as live:
        _writes(live, tds, 24)
        svc = ShardedRouterService(live, tr, t=0.9)
        subs, want_dec, want_ids, want_exact = [], [], [], []
        for pred in ALL_PREDS:
            qs = tiny_queries[pred]
            b = TQB(qs.vectors[:12], qs.bitmaps[:12], pred, 10)
            res = svc.search(b)
            want_dec += res.decisions
            want_ids += list(res.ids)
            want_exact += list(live.search(b, "prefilter").ids)
            subs += [(pred, b.vectors[i], b.bitmaps[i]) for i in range(12)]
        order = np.random.default_rng(25).permutation(len(subs))
        for backend, kw in ((svc, {}), (live, {"method": "prefilter"})):
            futs = [None] * len(subs)

            def submit(t, q):
                for j in order[t::4]:
                    pred, v, bm = subs[j]
                    futs[j] = q.submit(v, bm, pred)

            with AsyncBatchQueue(backend, max_batch=8, max_wait_ms=5,
                                 **kw) as q:
                ths = [threading.Thread(target=submit, args=(t, q))
                       for t in range(4)]
                for th in ths:
                    th.start()
                for th in ths:
                    th.join(timeout=60)
                assert not any(th.is_alive() for th in ths)
                got = [f.result(timeout=120) for f in futs]
            ids = want_ids if not kw else want_exact
            assert all(np.array_equal(r.ids, w) for r, w in zip(got, ids))
            if not kw:
                assert [r.decision for r in got] == want_dec
            assert all(r.keys.shape == (10,) for r in got)


def test_queue_serves_sharded_live_under_writes(tds, tiny_queries):
    """Concurrent single queries while a writer upserts and a compaction
    runs: every answer is well formed and never holds a row deleted
    before any search."""
    qs = tiny_queries[ALL_PREDS[1]]
    with ShardedLiveIndex(tds, 2, device="cpu") as live:
        ids, dead = _writes(live, tds, 26)
        keys_dead = live.keys_of(dead)
        with AsyncBatchQueue(live, max_batch=8, max_wait_ms=5,
                             method="prefilter") as q:
            stop = threading.Event()

            def writer():
                for i in range(30):
                    if stop.is_set():
                        return
                    live.upsert(tds.vectors[i: i + 1] + np.float32(0.2),
                                tds.bitmaps[i: i + 1])

            th = threading.Thread(target=writer)
            th.start()
            fut = live.compact_async()
            futs = [q.submit(qs.vectors[i % qs.q], qs.bitmaps[i % qs.q],
                             ALL_PREDS[1]) for i in range(24)]
            results = [f.result(timeout=120) for f in futs]
            stop.set()
            th.join(timeout=60)
            assert not th.is_alive()
            fut.result(timeout=120)
        for r in results:
            assert r.ids.shape == (10,) and r.keys.shape == (10,)
            assert not np.isin(r.keys[r.keys >= 0], keys_dead).any()
