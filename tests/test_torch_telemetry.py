"""Serving telemetry and online adaptation on the CPU, the port against
the JAX package: `TelemetrySink` (counters, cells, shard cells and the
seeded reservoir), `RecallAuditor` on sealed, live and sharded handles,
`OnlineBenchmarkTable`, and `OnlineRouterAdapter`'s reroute and
promote-then-rollback loops, each fed the same traffic in both packages.
The patterns of `tests/test_telemetry.py`.

Every test draws its randomness from its own seeded generator."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.ann import telemetry as jtel
from repro.ann.index import FilteredIndex as JFX
from repro.ann.index import QueryBatch as JQB
from repro.ann.live import LiveFilteredIndex as JLive
from repro.ann.live import ShardedLiveIndex as JShLive
from repro.ann.registry import candidate_methods as jcand
from repro.ann.service import RouterService as JService
from repro.ann.sharded import ShardedFilteredIndex as JSharded
from repro.ann.store import IndexStore as JStore
from repro.core import features as jF
from repro.core.router import MLRouter as JRouter
from repro.core.table import BenchmarkTable as JTable
from repro.data.ann_synth import make_queries
from repro_torch.ann import telemetry as ttel
from repro_torch.ann.index import FilteredIndex as TFX
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.live import LiveFilteredIndex as TLive
from repro_torch.ann.live import ShardedLiveIndex as TShLive
from repro_torch.ann.predicates import Predicate
from repro_torch.ann.registry import candidate_methods as tcand
from repro_torch.ann.service import RouterService as TService
from repro_torch.ann.sharded import ShardedFilteredIndex as TSharded
from repro_torch.ann.store import IndexStore as TStore
from repro_torch.core import features as tF
from repro_torch.core.router import MLRouter as TRouter
from repro_torch.core.table import BenchmarkTable as TTable
from repro_torch.data.ann_synth import DatasetSpec, synthesize

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's
PAIR = ["ivf_gamma", "postfilter"]


@pytest.fixture(scope="module")
def tds():
    return synthesize(DatasetSpec(*TINY))


def two_method_tables(ds_name, *, degraded_qps=5000.0, alt_qps=500.0):
    """The same table in both packages: both methods pass t = 0.9
    offline, ivf_gamma with the best QPS (`tests/test_telemetry.py`)."""
    out = []
    for table_cls, cand in ((JTable, jcand()), (TTable, tcand())):
        table = table_cls.new()
        for pt in range(3):
            for s in cand["ivf_gamma"].param_settings():
                table.add(ds_name, pt, "ivf_gamma", s.ps_id, 0.97,
                          degraded_qps)
            for s in cand["postfilter"].param_settings():
                table.add(ds_name, pt, "postfilter", s.ps_id, 0.95, alt_qps)
        out.append(table)
    return out


def batches(ds, pred=Predicate.AND, q=32, k=10, seed=3):
    qs = make_queries(ds, pred, q, seed=seed)
    return (JQB(qs.vectors, qs.bitmaps, pred, k),
            TQB(qs.vectors, qs.bitmaps, pred, k))


def random_traffic(seed: int, n_batches: int = 12):
    """Batches of varying size, predicate and k, with per-query decisions,
    served keys and stage notes, drawn from one seeded generator."""
    g = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        q = int(g.integers(1, 9))
        k = int(g.integers(2, 6))
        pred = Predicate(int(g.integers(0, 3)))
        vec = g.standard_normal((q, 8)).astype(np.float32)
        bm = g.integers(0, 2 ** 32, (q, 2), dtype=np.uint64).astype(np.uint32)
        dec = [(f"m{int(g.integers(0, 3))}", f"p{int(g.integers(0, 2))}")
               for _ in range(q)]
        keys = g.integers(-1, 500, (q, k))
        out.append((vec, bm, pred, k, dec, keys, float(g.uniform(1e-4, 5e-3)),
                    int(g.integers(0, 3)), int(g.integers(0, 4))))
    return out


def feed(sink, qb_cls, traffic):
    for vec, bm, pred, k, dec, keys, sec, gen, shard in traffic:
        sink.record_batch(qb_cls(vec, bm, pred, k), dec, search_s=sec,
                          generation=gen, keys=keys)
        sink.note("base_s", sec / 3)
        sink.note_shard(shard, "exec", sec, len(dec))


def same_samples(js, ts):
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert a.vector.tobytes() == b.vector.tobytes()
        assert a.bitmap.tobytes() == b.bitmap.tobytes()
        assert (a.pred, a.k, a.method, a.ps_id, a.generation) == \
            (b.pred, b.k, b.method, b.ps_id, b.generation)
        np.testing.assert_array_equal(a.served_keys, b.served_keys)


# ------------------------------------------------------------------ sink


@pytest.mark.parametrize("seed,capacity,reservoir",
                         [(0, 64, 8), (1, 16, 32), (7, 512, 0), (9, 8, 3)])
def test_sink_matches_reference(seed, capacity, reservoir):
    """The same seed and the same batches: equal stats, drained cells and
    shard cells, and the same reservoir samples."""
    traffic = random_traffic(seed)
    js = jtel.TelemetrySink(capacity=capacity, reservoir=reservoir,
                            seed=seed)
    ts = ttel.TelemetrySink(capacity=capacity, reservoir=reservoir,
                            seed=seed)
    feed(js, JQB, traffic)
    feed(ts, TQB, traffic)
    assert ts.stats() == js.stats()
    assert ts.cell_aggregates() == js.cell_aggregates()
    assert ts.shard_aggregates() == js.shard_aggregates()
    assert ts.counter_values() == js.counter_values()
    # events equal but for their two clock stamps
    assert [e[:6] + e[8:] for e in ts.recent(200)] == \
        [e[:6] + e[8:] for e in js.recent(200)]
    assert ts.drain_cells() == js.drain_cells()
    assert ts.drain_shards() == js.drain_shards()
    assert ts.drain_cells() == {} and ts.drain_shards() == {}
    same_samples(js.take_samples(), ts.take_samples())
    assert ts.take_samples() == [] and ts.stats()["reservoir"]["seen"] == 0


def test_sink_concurrent_writers_keep_exact_totals():
    """More writer threads than cores, a short switch interval: the
    per-cell counters, the shard cells and the reservoir's seen count
    lose no update."""
    sink = ttel.TelemetrySink(capacity=64, reservoir=16, seed=0)
    batch = TQB(np.zeros((4, 4), np.float32), np.zeros((4, 1), np.uint32),
                Predicate.AND, 3)

    def writer():
        for _ in range(100):
            sink.record_batch(batch, ("m", "p"), search_s=1e-3)
            sink.note("queue_waits", 1)
            sink.note_shard(0, "exec", 1e-3, 4)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=writer)
                   for _ in range(2 * (os.cpu_count() or 4))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    n = 100 * len(threads)
    st = sink.stats()
    assert st["queries"] == 4 * n and st["batches"] == n
    assert st["cells"]["m/p/AND"]["queries"] == 4 * n
    assert st["counters"]["queue_waits"] == n
    assert st["shards"]["shard0/exec"]["calls"] == 4 * n
    assert st["reservoir"] == {"size": 16, "seen": 4 * n, "capacity": 16}


def test_sink_validation_and_percentiles():
    for cls in (jtel.TelemetrySink, ttel.TelemetrySink):
        with pytest.raises(ValueError):
            cls(capacity=0)
        with pytest.raises(ValueError):
            cls(reservoir=-1)
    assert ttel._percentile(np.array([]), 50) == 0.0
    v = np.sort(np.random.default_rng(4).uniform(0, 9, 33))
    for q in (50, 90, 99):
        assert ttel._percentile(v, q) == jtel._percentile(v, q)
    for served, exact, k in (([1, 2, 3], [1, 2, 3], 3),
                             ([1, -1, -1], [1, 2, 3], 3),
                             ([-1], [-1, -1], 5), ([7, 8, -1], [7, -1, -1], 3)):
        assert ttel._audit_recall(np.array(served), np.array(exact), k) == \
            jtel._audit_recall(np.array(served), np.array(exact), k)


# --------------------------------------------------------------- auditor


def _handles(kind, tiny_ds, tds):
    """(reference handle, port handle) of one kind over the same rows and
    the same writes."""
    if kind == "sealed":
        return JFX(tiny_ds), TFX(tds, device="cpu")
    if kind == "sharded":
        return JSharded(tiny_ds, 2), TSharded(tds, 2, device="cpu")
    j, t = JLive(tiny_ds), TLive(tds, device="cpu")
    g = np.random.default_rng(12)
    pick = g.integers(0, tiny_ds.n, 150)
    dead = g.choice(tiny_ds.n, 60, replace=False)
    for h in (j, t):
        h.upsert(tiny_ds.vectors[pick] + np.float32(0.01),
                 tiny_ds.bitmaps[pick])
        h.delete(dead)
    return j, t


@pytest.mark.parametrize("kind", ["sealed", "sharded", "live"])
@pytest.mark.parametrize("frac", [None, 0.25])
def test_auditor_matches_reference(kind, frac, tiny_ds, tds):
    """Served keys truncated to 4 of k = 10 for half the queries; both
    auditors (same seed, same budget draw) report the same samples, the
    same per-cell recalls, the same exact keys, and fold the same cells
    into their online tables."""
    jh, th = _handles(kind, tiny_ds, tds)
    jt, tt = two_method_tables(tiny_ds.name)
    jot = jtel.OnlineBenchmarkTable(jt, alpha=0.5)
    tot = ttel.OnlineBenchmarkTable(tt, alpha=0.5)
    reps = []
    try:
        for (h, qb, tel, ot) in ((jh, JQB, jtel, jot), (th, TQB, ttel, tot)):
            sink = tel.TelemetrySink(capacity=128, reservoir=48, seed=5)
            for pred in (Predicate.AND, Predicate.OR, Predicate.EQUALITY):
                qs = make_queries(tiny_ds, pred, 24, seed=int(pred) + 8)
                batch = qb(qs.vectors, qs.bitmaps, pred, 10)
                served = np.array(h.search(batch, "prefilter").keys)
                served[::2, 4:] = -1
                sink.record_batch(batch, ("ivf_gamma", "g1"),
                                  search_s=1e-3, keys=served)
            aud = tel.RecallAuditor(h, sink, table=ot, sample_frac=frac,
                                    min_budget=8, max_budget=40, seed=2)
            reps.append((aud.run_once(), aud))
    finally:
        jh.close()
        th.close()
    (jr, ja), (tr, ta) = reps
    assert tr["cells"] == jr["cells"] and tr["budget"] == jr["budget"]
    assert tr["samples"] == jr["samples"] > 0
    assert (ta.audits, ta.skipped, ta.runs) == (ja.audits, ja.skipped, ja.runs)
    for (js, jrec, jex), (ts, trec, tex) in zip(jr["results"], tr["results"]):
        assert ts.vector.tobytes() == js.vector.tobytes()
        assert trec == jrec
        np.testing.assert_array_equal(tex, jex)
    assert tot.audited_cells() == jot.audited_cells()
    assert tot.entries == jot.entries and tot.version == jot.version


def test_auditor_on_sharded_live_handle(tiny_ds, tds):
    """The JAX package's auditor cannot pin a `ShardedLiveIndex` (its
    `search` takes no `snapshot=`); the port's can, and its exact keys
    equal the reference handle's unpinned exact search over the same
    writes."""
    jl = JShLive(None, 2, name=tiny_ds.name, dim=tiny_ds.dim,
                 universe=tiny_ds.universe)
    tl = TShLive(None, 2, name=tds.name, dim=tds.dim, universe=tds.universe,
                 device="cpu")
    try:
        for h in (jl, tl):
            h.upsert(tiny_ds.vectors, tiny_ds.bitmaps)
            h.delete(np.arange(0, 600, 7))
        jb, tb = batches(tiny_ds, Predicate.AND, q=20)
        served = np.array(jl.search(jb, "prefilter").keys)
        served[:, 6:] = -1
        out = []
        for h, qb, tel in ((jl, jb, jtel), (tl, tb, ttel)):
            sink = tel.TelemetrySink(capacity=64, reservoir=64, seed=1)
            sink.record_batch(qb, ("prefilter", "exact"), search_s=1e-3,
                              keys=served)
            out.append(tel.RecallAuditor(h, sink))
        with pytest.raises(TypeError, match="snapshot"):
            out[0].run_once()
        rep = out[1].run_once()
        want = jl.search(jb, "prefilter").keys
        assert rep["samples"] == 20
        for j, (_s, r, ex) in enumerate(rep["results"]):
            np.testing.assert_array_equal(ex, want[j])
            assert r == jtel._audit_recall(served[j], want[j], 10)
    finally:
        jl.close()
        tl.close()


def test_auditor_budget_curve_and_validation(tds):
    aud = ttel.RecallAuditor.__new__(ttel.RecallAuditor)
    ref = jtel.RecallAuditor.__new__(jtel.RecallAuditor)
    for a in (aud, ref):
        a.sample_frac, a.min_budget, a.max_budget = 0.1, 8, 64
    for thr in (0, 79, 81, 200, 640, 100000):
        assert aud.budget_for(thr) == ref.budget_for(thr)
    with TFX(tds, device="cpu") as fx:
        sink = ttel.TelemetrySink(capacity=16, reservoir=16)
        for kw in ({"sample_frac": 0.0}, {"sample_frac": 1.5},
                   {"sample_frac": 0.5, "min_budget": 0},
                   {"sample_frac": 0.5, "min_budget": 9, "max_budget": 8}):
            with pytest.raises(ValueError):
                ttel.RecallAuditor(fx, sink, **kw)
        assert ttel.RecallAuditor(fx, sink).run_once() == {
            "samples": 0, "cells": {}, "results": [], "budget": None}


def test_auditor_background_loop(tds):
    with TFX(tds, device="cpu") as fx:
        sink = ttel.TelemetrySink(capacity=64, reservoir=32)
        aud = ttel.RecallAuditor(fx, sink)
        _, tb = batches(tds, Predicate.OR, q=8)
        sink.record_batch(tb, ("prefilter", "exact"), search_s=1e-3,
                          keys=fx.search(tb, "prefilter").keys)
        aud.start(interval_s=0.02)
        try:
            deadline = time.monotonic() + 10.0
            while not aud.audits and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            aud.stop()
        assert aud.last_error is None and aud.audits == 8
        assert aud._thread is None


# ---------------------------------------------------------- online table


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_online_table_matches_reference(seed):
    """Random observations (recall, QPS, both, new cells, shard cells)
    into both packages' tables: entries, drift, audited cells, shard
    cells, routing arrays and snapshots equal to 1e-12."""
    g = np.random.default_rng(seed)
    jt, tt = two_method_tables("d")
    alpha = float(g.uniform(0.1, 1.0))
    jo = jtel.OnlineBenchmarkTable(jt, alpha=alpha)
    to = ttel.OnlineBenchmarkTable(tt, alpha=alpha)
    cells = list(jt.entries) + [("d", 1, "sieve", "x"), ("e", 0, "m", "p")]
    for _ in range(60):
        key = cells[int(g.integers(len(cells)))]
        kw = {}
        if g.random() < 0.7:
            kw["recall"] = float(g.uniform(0, 1))
        if g.random() < 0.5:
            kw["qps"] = float(g.uniform(10, 9000))
        n = int(g.integers(1, 5))
        for o in (jo, to):
            o.observe(key[0], key[1], key[2], key[3], n=n, **kw)
        if g.random() < 0.3:
            sh, q = int(g.integers(0, 3)), float(g.uniform(100, 900))
            for o in (jo, to):
                o.observe_shard("d", sh, qps=q, n=n)
    assert to.version == jo.version and to.alpha == jo.alpha

    def close(a, b):
        assert a.keys() == b.keys()
        for k in a:
            for f in a[k]:
                assert abs(a[k][f] - b[k][f]) <= 1e-12

    close(to.entries, jo.entries)
    close(to.audited_cells(), jo.audited_cells())
    close(to.shard_cells(), jo.shard_cells())
    td, jd = to.drift(), jo.drift()
    assert td.keys() == jd.keys()
    assert all(abs(td[k] - jd[k]) <= 1e-12 for k in td)
    assert abs(to.max_drift() - jo.max_drift()) <= 1e-12
    assert abs(to.shard_divergence() - jo.shard_divergence()) <= 1e-12
    for pt in range(3):
        for t in (0.5, 0.9):
            got = to.routing_arrays("d", pt, PAIR, t)
            want = jo.routing_arrays("d", pt, PAIR, t)
            assert to.routing_arrays("d", pt, PAIR, t) is got    # cached
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)
            assert list(got[2]) == list(want[2])
            assert list(got[3]) == list(want[3])
    snap = to.snapshot()
    assert type(snap) is TTable
    close(snap.entries, jo.snapshot().entries)
    with pytest.raises(ValueError):
        ttel.OnlineBenchmarkTable(tt, alpha=0.0)


# -------------------------------------------------------- adaptation loop


def _constant_routers(tiny_ds, **kw):
    jt, tt = two_method_tables(tiny_ds.name, **kw)
    return (jtel.constant_router(jF.MINIMAL_FEATURES, list(PAIR), jt),
            ttel.constant_router(tF.MINIMAL_FEATURES, list(PAIR), tt))


def test_constant_router_predicts_exactly_value(tds):
    _, tt = two_method_tables(tds.name)
    router = ttel.constant_router(tF.MINIMAL_FEATURES, list(PAIR), tt,
                                  value=0.93)
    qs = make_queries(tds, Predicate.AND, 6, seed=1)
    r_hat = router.predict_recalls(tds, qs.bitmaps, Predicate.AND,
                                   device="cpu")
    assert r_hat.shape == (6, 2) and np.allclose(r_hat, 0.93, atol=1e-6)


def _degraded(cand, tel, keep=2):
    serving = dict(cand)
    serving["ivf_gamma"] = tel.DegradedMethod(serving["ivf_gamma"], keep=keep)
    return serving


def test_adaptation_reroutes_off_degraded_method_as_reference(tiny_ds, tds):
    """The audited EWMA drops the degraded method's cells below t and
    Algorithm 2 reroutes to the alternative, no retrain: the same
    decisions at every step and the same history in both packages."""
    jr, tr = _constant_routers(tiny_ds)
    jb, tb = batches(tiny_ds, Predicate.AND, q=32)
    runs = []
    with JFX(tiny_ds) as jfx, TFX(tds, device="cpu") as tfx:
        for fx, router, svc_cls, tel, cand, b in (
                (jfx, jr, JService, jtel, jcand(), jb),
                (tfx, tr, TService, ttel, tcand(), tb)):
            sink = tel.TelemetrySink(capacity=512, reservoir=64, seed=5)
            svc = svc_cls(fx, router, t=0.9,
                          methods=_degraded(cand, tel), telemetry=sink)
            adapter = tel.OnlineRouterAdapter(svc, sink, alpha=0.5,
                                              drift_threshold=2.0, seed=0)
            assert svc.router.table is adapter.table
            steps = [[d.method for d in svc.route(b)]]
            for _ in range(6):
                svc.search(b)
                adapter.step()
                steps.append([d.method for d in svc.route(b)])
                if "ivf_gamma" not in steps[-1]:
                    break
            runs.append((steps, adapter))
    (js, ja), (ts, ta) = runs
    assert ts == js
    assert set(ts[0]) == {"ivf_gamma"} and set(ts[-1]) == {"postfilter"}
    assert ta.history == ja.history
    assert not any(h["retrained"] for h in ta.history)
    assert ta.table.audited_cells() == ja.table.audited_cells()
    assert ta.table.max_drift() > 0.3


def _mask(history):
    return [{k: v for k, v in h.items() if k not in ("artifact", "versions")}
            for h in history]


def test_adaptation_promote_then_rollback_as_reference(tiny_ds, tds,
                                                       tmp_path):
    """Retrain (`retrain_fn=`) fires on drift: a better candidate
    promotes — artifact saved, store-linked, reference swapped — and a
    worse one rolls back, at the same steps and with the same shadow
    recalls in both packages; the port's promoted artifact opens in the
    reference's `MLRouter.load`."""
    runs = []
    for pkg, store_cls, live_cls, svc_cls, tel, cand, b, feats, kw in (
            ("j", JStore, JLive, JService, jtel, jcand(),
             batches(tiny_ds)[0], jF.MINIMAL_FEATURES, {}),
            ("t", TStore, TLive, TService, ttel, tcand(),
             batches(tiny_ds)[1], tF.MINIMAL_FEATURES, {"device": "cpu"})):
        ds = tiny_ds if pkg == "j" else tds
        table = two_method_tables(ds.name)[pkg == "t"]
        good = two_method_tables(ds.name, degraded_qps=1.0)[pkg == "t"]
        router = tel.constant_router(feats, list(PAIR), table)
        cand_good = tel.constant_router(feats, list(PAIR), good)
        cand_bad = tel.constant_router(feats, list(PAIR), table)
        plan = [cand_good, cand_bad]
        store = store_cls.create(str(tmp_path / f"store-{pkg}"),
                                 live_cls(ds, **kw))
        try:
            sink = tel.TelemetrySink(capacity=512, reservoir=96, seed=2)
            svc = svc_cls(store.index, router, t=0.9,
                          methods=_degraded(cand, tel), telemetry=sink)
            adapter = tel.OnlineRouterAdapter(
                svc, sink, store=store, alpha=0.5, drift_threshold=0.05,
                min_samples=8, seed=4, retrain_fn=lambda ad: plan.pop(0))
            decisions = []
            for _ in range(16):
                svc.search(b)
                rep = adapter.step()
                decisions.append([tuple(d) for d in svc.route(b)])
                if rep.get("retrained") and not rep.get("promoted"):
                    break
            promoted = [h for h in adapter.history if h.get("promoted")]
            assert len(promoted) == 1 and svc.router is cand_good
            assert svc.router.table is adapter.table
            path = promoted[0]["artifact"]
            assert store.manifest["router"]["content_sha1"] == \
                promoted[0]["versions"]["content_sha1"]
            runs.append((decisions, adapter.history, path, adapter))
        finally:
            store.close()
    (jd, jh, _, ja), (td, th, tpath, ta) = runs
    assert td == jd
    assert _mask(th) == _mask(jh)
    assert th[-1]["action"] == "rollback" and ta.promotions == 1
    assert os.path.basename(tpath) == "router-v001"
    loaded = JRouter.load(tpath)
    assert loaded.methods == list(PAIR)
    assert TRouter.load(tpath).table.entries == loaded.table.entries


def test_default_retrain_learns_from_audit_labels(tiny_ds, tds,
                                                  monkeypatch):
    """The real retrain path (`tests/test_telemetry.py`'s test of the same
    name): audit-derived per-method recall labels ->
    `train_models_from_xy` -> shadow eval. The incumbent routes everything
    to a degraded method, so the audit-trained candidate should beat it
    and promote. Both packages get the same traffic: the retrain fires at
    the same step in both and trains on the same features and labels
    (the fits themselves start from different initial weights)."""
    from repro.core import training as JT
    from repro_torch.core import training as TT

    fitted = {}
    for name, T in (("jax", JT), ("torch", TT)):
        def spy(x_raw, y, methods, *, _real=T.train_models_from_xy,
                _name=name, **kw):
            fitted[_name] = (x_raw, y, list(methods), kw)
            return _real(x_raw, y, methods, **kw)
        monkeypatch.setattr(T, "train_models_from_xy", spy)
    jr, tr = _constant_routers(tiny_ds)
    jb, tb = batches(tiny_ds, Predicate.AND, q=32)
    runs = []
    with JFX(tiny_ds) as jfx, TFX(tds, device="cpu") as tfx:
        for fx, router, svc_cls, tel, cand, b in (
                (jfx, jr, JService, jtel, jcand(), jb),
                (tfx, tr, TService, ttel, tcand(), tb)):
            sink = tel.TelemetrySink(capacity=512, reservoir=96, seed=6)
            svc = svc_cls(fx, router, t=0.9,
                          methods=_degraded(cand, tel, keep=1),
                          telemetry=sink)
            adapter = tel.OnlineRouterAdapter(
                svc, sink, alpha=0.5, drift_threshold=0.05, min_samples=8,
                retrain_epochs=30, retrain_hidden=(16,), seed=7)
            report = None
            for step in range(8):
                svc.search(b)
                rep = adapter.step()
                if rep.get("retrained"):
                    report = (step, rep)
                    break
            runs.append((report, svc, router))
    (jrep, _, _), (trep, svc, router) = runs
    assert trep is not None and jrep is not None
    assert trep[0] == jrep[0]                      # the same step
    report = trep[1]
    assert "shadow" in report
    if report["promoted"]:
        assert svc.router is not router
        assert report["shadow"]["candidate_recall"] > \
            report["shadow"]["incumbent_recall"]
    else:                       # rollback keeps the incumbent
        assert svc.router is router
    assert report["shadow"]["incumbent_recall"] == \
        jrep[1]["shadow"]["incumbent_recall"]
    jx, jy, jm, jkw = fitted["jax"]
    tx, ty, tm, tkw = fitted["torch"]
    assert tx.tobytes() == jx.tobytes() and np.array_equal(ty, jy)
    assert tm == jm == list(PAIR)
    assert tkw == dict(jkw, device=torch.device("cpu"))


class _TensorMethod:
    """A method whose search hands back tensors (as a kernel wrapper's
    output would be, before the host copy)."""
    name = "fake"
    builds_on_device = True

    def search(self, fx, index, qvecs, qbms, pred, k, search_params):
        ids = torch.arange(qvecs.shape[0] * k, dtype=torch.int32)
        raw = torch.arange(qvecs.shape[0] * k, dtype=torch.float32)
        return ids.reshape(-1, k), raw.reshape(-1, k)

    def build(self, ds, build_params, device=None):
        return ("built", device)


def test_degraded_method_truncates_arrays_and_tensors(tds):
    inner = _TensorMethod()
    dm = ttel.DegradedMethod(inner, keep=2)
    ids, raw = dm.search(None, None, np.zeros((3, 4)), None, 0, 5, {})
    assert isinstance(ids, torch.Tensor) and ids.shape == (3, 5)
    assert (ids[:, 2:] == -1).all() and torch.isinf(raw[:, 2:]).all()
    want = inner.search(None, None, np.zeros((3, 4)), None, 0, 5, {})
    assert torch.equal(ids[:, :2], want[0][:, :2])
    assert dm.builds_on_device and dm.build(tds, {}, device="cpu") == \
        ("built", "cpu")
    with TFX(tds, device="cpu") as fx:
        _, tb = batches(tds, Predicate.OR, q=5)
        real = tcand()["ivf_gamma"]
        dm = ttel.DegradedMethod(real, keep=3)
        st = real.param_settings()[0]
        full = fx.run_method(real, st, tb)
        cut = fx.run_method(dm, st, tb)
        np.testing.assert_array_equal(cut[0][:, :3], full[0][:, :3])
        assert (cut[0][:, 3:] == -1).all() and np.isinf(cut[1][:, 3:]).all()
