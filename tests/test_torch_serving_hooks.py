"""The serving-ops hooks on the CPU, the port against the JAX package: a
service with `telemetry=`, `tracer=`, `slo=` and `obslog=` answers as one
without them and as the reference's hooked service does; the span trees
of the service, the queue across its thread hop, the cache facade, the
live reads and the sharded fan-outs have the reference's names, nesting
and attributes; the sink, the SLO engine and the wide-event log see the
same traffic; the live handles' ledger gauges and leases, and the
queue's and the cache's collectors, match the reference's. Also the
repairs the hooks read: the sealed handles' `generation`/`label_clock`
and the delta segment's byte counts.

Every test draws its randomness from its own seeded generator."""

import contextlib

import jax
import numpy as np
import pytest

from repro.ann import ledger as jledger
from repro.ann import obslog as jlog
from repro.ann import slo as jslo
from repro.ann import telemetry as jtel
from repro.ann import trace as jtrace
from repro.ann.cache import SemanticResultCache as JCache
from repro.ann.index import FilteredIndex as JFX
from repro.ann.index import QueryBatch as JQB
from repro.ann.live import DeltaSegment as JDelta
from repro.ann.live import LiveFilteredIndex as JLive
from repro.ann.live import ShardedLiveIndex as JShLive
from repro.ann.service import AsyncBatchQueue as JQueue
from repro.ann.service import RouterService as JService
from repro.ann.service import ShardedRouterService as JShService
from repro.ann.sharded import ShardedFilteredIndex as JSharded
from repro.core import features as jF
from repro.core import mlp as jmlp
from repro.core.router import MLRouter as JRouter
from repro.core.table import BenchmarkTable as JTable
from repro.data.ann_synth import make_queries
from repro_torch.ann import ledger as tledger
from repro_torch.ann import obslog as tlog
from repro_torch.ann import slo as tslo
from repro_torch.ann import telemetry as ttel
from repro_torch.ann import trace as ttrace
from repro_torch.ann.cache import SemanticResultCache as TCache
from repro_torch.ann.index import FilteredIndex as TFX
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.live import DeltaSegment as TDelta
from repro_torch.ann.live import LiveFilteredIndex as TLive
from repro_torch.ann.live import ShardedLiveIndex as TShLive
from repro_torch.ann.predicates import Predicate
from repro_torch.ann.service import AsyncBatchQueue as TQueue
from repro_torch.ann.service import RouterService as TService
from repro_torch.ann.service import ShardedRouterService as TShService
from repro_torch.ann.sharded import ShardedFilteredIndex as TSharded
from repro_torch.core.router import MLRouter as TRouter
from repro_torch.data.ann_synth import DatasetSpec, synthesize

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's
METHODS = ["postfilter", "ivf_gamma"]
KINDS = ("sealed", "sharded", "live", "sharded_live")
J = dict(qb=JQB, tel=jtel, trace=jtrace, slo=jslo, log=jlog, led=jledger)
T = dict(qb=TQB, tel=ttel, trace=ttrace, slo=tslo, log=tlog, led=tledger)


@pytest.fixture(scope="module")
def tds():
    return synthesize(DatasetSpec(*TINY))


@pytest.fixture(scope="module")
def router_dir(tiny_ds, tiny_queries, tmp_path_factory):
    """A router with random MLP weights (mixed decisions, so a batch runs
    several groups), saved by the JAX package; both packages load it."""
    rand = np.random.default_rng(13)
    table = JTable.new()
    for pt in range(3):
        for name, ps_ids in (("postfilter", ("ef200", "ef800", "ef2000")),
                             ("ivf_gamma", ("g1", "g4", "g8"))):
            for ps in ps_ids:
                table.add(tiny_ds.name, pt, name, ps,
                          recall=float(rand.uniform(0.75, 1.0)),
                          qps=float(rand.uniform(100, 2000)))
    models = {m: jmlp.params_to_numpy(
        jmlp.init_mlp((5, 16, 8, 1), jax.random.PRNGKey(4 + j)))
        for j, m in enumerate(METHODS)}
    x = np.concatenate([jF.feature_matrix(tiny_ds, qs.bitmaps, p,
                                          jF.MINIMAL_FEATURES)
                        for p, qs in tiny_queries.items()])
    path = str(tmp_path_factory.mktemp("router") / "r")
    JRouter(feature_names=jF.MINIMAL_FEATURES, methods=METHODS,
            models=models, scaler=jmlp.Scaler.fit(x), table=table).save(path)
    return path


def handles(kind, jds, tds):
    """(reference handle, port handle) of one kind, with the same writes
    on the live kinds."""
    if kind == "sealed":
        return JFX(jds), TFX(tds, device="cpu")
    if kind == "sharded":
        return JSharded(jds, 2), TSharded(tds, 2, device="cpu")
    if kind == "live":
        out = (JLive(jds), TLive(tds, device="cpu"))
    else:
        out = (JShLive(jds, 2), TShLive(tds, 2, device="cpu"))
    g = np.random.default_rng(17)
    pick = g.integers(0, jds.n, 90)
    dead = g.choice(jds.n, 40, replace=False)
    for h in out:
        h.upsert(jds.vectors[pick] + np.float32(0.02), jds.bitmaps[pick])
        h.delete(dead)
    return out


def tree(span):
    """A span tree's names, attribute keys and nesting; siblings sorted
    (shards fan out in any order)."""
    return (span.name, tuple(sorted(span.attrs)),
            tuple(sorted(tree(c) for c in span.children)))


def hooks(mod, tmp_path, tag):
    tracer = mod["trace"].Tracer(slow_ms=None, sample=1.0, seed=7)
    return dict(
        telemetry=mod["tel"].TelemetrySink(capacity=256, reservoir=32,
                                           seed=5),
        tracer=tracer,
        slo=mod["slo"].SLOEngine(
            [mod["slo"].Objective(name="lat", kind="latency", target=0.99,
                                  threshold_us=5e6),
             mod["slo"].Objective(name="avail", kind="availability",
                                  target=0.99)],
            min_events=1, tracer=tracer),
        obslog=mod["log"].WideEventLog(str(tmp_path / f"{tag}.jsonl"),
                                       autostart=False))


def sink_view(sink):
    s = sink.stats()
    return ({k: v["queries"] for k, v in s["cells"].items()},
            s["by_method"], s["queries"], s["batches"],
            sorted(s["counters"]), sorted(s["shards"]))


@pytest.mark.parametrize("kind", KINDS)
def test_hooks_change_no_result_and_match_reference(kind, router_dir,
                                                    tiny_ds, tds, tmp_path):
    jh, th = handles(kind, tiny_ds, tds)
    svc_cls = ((JShService, TShService) if kind.startswith("sharded")
               else (JService, TService))
    try:
        hk = {"j": hooks(J, tmp_path, "j"), "t": hooks(T, tmp_path, "t")}
        jsvc = svc_cls[0](jh, JRouter.load(router_dir), t=0.9, **hk["j"])
        tsvc = svc_cls[1](th, TRouter.load(router_dir), t=0.9, **hk["t"])
        plain = svc_cls[1](th, TRouter.load(router_dir), t=0.9)
        for pred in (Predicate.AND, Predicate.OR, Predicate.EQUALITY):
            qs = make_queries(tiny_ds, pred, 20, seed=20 + int(pred))
            jr = jsvc.search(JQB(qs.vectors, qs.bitmaps, pred, 10))
            tr = tsvc.search(TQB(qs.vectors, qs.bitmaps, pred, 10))
            pr = plain.search(TQB(qs.vectors, qs.bitmaps, pred, 10))
            assert tr.decisions == pr.decisions
            np.testing.assert_array_equal(tr.ids, pr.ids)
            assert tr.distances.tobytes() == pr.distances.tobytes()
            assert [tuple(d) for d in tr.decisions] == \
                [tuple(d) for d in jr.decisions]
            np.testing.assert_array_equal(tr.ids, jr.ids)
            np.testing.assert_array_equal(tr.keys, jr.keys)
            np.testing.assert_allclose(tr.distances, jr.distances,
                                       rtol=1e-4, atol=1e-4, equal_nan=True)
            if pred == Predicate.AND:     # a batch of several groups
                assert len(set(tr.decisions)) == 2
            jroot = hk["j"]["tracer"].recent()[-1]
            troot = hk["t"]["tracer"].recent()[-1]
            assert tree(troot) == tree(jroot)
            assert troot.find("group") is not None
        want = {"sealed": set(), "sharded": {"shard", "merge"},
                "live": {"snapshot_pin", "live.base", "live.delta"},
                "sharded_live": {"snapshot_pin", "shard", "live.base",
                                 "live.delta"}}[kind]
        assert want <= {s.name for s in troot.walk()}
        assert sink_view(hk["t"]["telemetry"]) == \
            sink_view(hk["j"]["telemetry"])
        assert hk["t"]["slo"].stats() == hk["j"]["slo"].stats()
        assert hk["t"]["slo"].state() == "ok"
        rows = []
        for h in (hk["j"], hk["t"]):
            h["obslog"].close()
            rows.append([{k: v for k, v in e.items()
                          if k not in ("ts", "trace", "lat_us")}
                         for e in jlog.read_events(h["obslog"].path)])
        assert len(rows[1]) == 60
        assert [set(e.pop("timings_ms")) for e in rows[1]] == \
            [set(e.pop("timings_ms")) for e in rows[0]]
        assert rows[1] == rows[0]
    finally:
        jh.close()
        th.close()


def test_staged_live_read_opens_the_merge_span(tiny_ds, tds, router_dir):
    """The staged live read (`fused=False`) nests `live.merge` beside
    `live.base` and `live.delta`, as the reference's does."""
    jh, th = handles("live", tiny_ds, tds)
    trees = []
    try:
        for h, svc_cls, router_cls, mod in ((jh, JService, JRouter, J),
                                            (th, TService, TRouter, T)):
            h.fused = False
            tracer = mod["trace"].Tracer(seed=1)
            svc = svc_cls(h, router_cls.load(router_dir), tracer=tracer)
            qs = make_queries(tiny_ds, Predicate.OR, 8, seed=4)
            svc.search(mod["qb"](qs.vectors, qs.bitmaps, Predicate.OR, 10))
            trees.append(tree(tracer.recent()[-1]))
            live_spans = {s.name for s in tracer.recent()[-1].walk()}
        assert trees[1] == trees[0]
        assert {"live.base", "live.delta", "live.merge"} <= live_spans
    finally:
        jh.close()
        th.close()


def test_queue_traces_across_the_thread_hop_as_reference(router_dir,
                                                         tiny_ds, tds):
    """The queue opens one `request` root a (pred, k) group — its
    `enqueue_wait`, `batch_assembly` and `route` children on the worker
    thread, the `execute` subtree re-attached on the executor's — and
    reports its depth to the ledger until closed; its answers equal the
    batched search's, and both packages' trees agree."""
    subs = []
    for pred in (Predicate.AND, Predicate.OR):
        qs = make_queries(tiny_ds, pred, 6, seed=30 + int(pred))
        subs += [(qs.vectors[i], qs.bitmaps[i], pred) for i in range(6)]
    out = []
    with JFX(tiny_ds) as jfx, TFX(tds, device="cpu") as tfx:
        for fx, svc_cls, queue_cls, router_cls, mod in (
                (jfx, JService, JQueue, JRouter, J),
                (tfx, TService, TQueue, TRouter, T)):
            with mod["led"].scoped() as led:
                tracer = mod["trace"].Tracer(seed=2)
                sink = mod["tel"].TelemetrySink(capacity=64, reservoir=0)
                svc = svc_cls(fx, router_cls.load(router_dir),
                              tracer=tracer, telemetry=sink)
                q = queue_cls(svc, max_batch=64, max_wait_ms=60_000)
                futs = [q.submit(v, b, p) for v, b, p in subs]
                assert any(k.startswith("queue:")
                           for k in led.snapshot()["gauges"])
                q.flush()
                got = [f.result(30) for f in futs]
                st = q.stats()
                q.close()
                assert not any(k.startswith("queue:")
                               for k in led.snapshot()["gauges"])
            roots = tracer.recent()
            out.append(([tree(r) for r in roots], got, st, sink))
    (jt, jg, js, jsink), (tt, tg, ts, tsink) = out
    assert tt == jt and len(tt) == 2
    assert {c[0] for c in tt[0][2]} >= {"enqueue_wait", "batch_assembly",
                                        "route", "execute"}
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(b.ids, a.ids)
        assert tuple(b.decision) == tuple(a.decision) and b.cache is None
    assert ts["flush_reasons"] == js["flush_reasons"] == {"flush": 1}
    assert ts["cache_hits"] == 0 and ts["queries"] == 12
    assert ts["telemetry"]["queries"] == js["telemetry"]["queries"] == 12
    assert set(tsink.counter_values()) == set(jsink.counter_values()) == \
        {"queue_wait_s", "queue_waits"}


def test_cache_facade_and_queue_probe_as_reference(router_dir, tiny_ds, tds,
                                                   tmp_path):
    """A cache in front of a hooked service: `cache.search` is one
    `cache_search` tree with the service's subtree inside; behind the
    queue a repeated query is answered at submit time (`cache_hits`, a
    `cache_probe` root, an SLO request observation, a wide event tagged
    "exact"), and the cache's collector reports to the ledger."""
    qs = make_queries(tiny_ds, Predicate.AND, 6, seed=8)
    out = []
    with JFX(tiny_ds) as jfx, TFX(tds, device="cpu") as tfx:
        for fx, svc_cls, queue_cls, router_cls, cache_cls, mod, tag in (
                (jfx, JService, JQueue, JRouter, JCache, J, "j"),
                (tfx, TService, TQueue, TRouter, TCache, T, "t")):
            with mod["led"].scoped() as led:
                hk = hooks(mod, tmp_path, tag)
                svc = svc_cls(fx, router_cls.load(router_dir), t=0.9, **hk)
                cache = cache_cls(svc, threshold=None)
                qb = mod["qb"]
                cache.search(qb(qs.vectors[:4], qs.bitmaps[:4],
                                Predicate.AND, 10))
                first = tree(hk["tracer"].recent()[-1])
                with queue_cls(cache, max_batch=1, max_wait_ms=0) as q:
                    a = q.submit(qs.vectors[5], qs.bitmaps[5],
                                 Predicate.AND).result(30)
                    b = q.submit(qs.vectors[5], qs.bitmaps[5],
                                 Predicate.AND).result(30)
                    c = q.submit(qs.vectors[1], qs.bitmaps[1],
                                 Predicate.AND).result(30)
                    st = q.stats()
                gauges = led.snapshot()["gauges"]
                cache_g = [v for k, v in gauges.items()
                           if k.startswith("cache:")]
                cache.close()
                hk["obslog"].close()
                events = [e.get("cache") for e in
                          jlog.read_events(hk["obslog"].path)]
            roots = [tree(r) for r in hk["tracer"].recent()]
            out.append((first, roots, (a.cache, b.cache, c.cache), st,
                        cache_g, events, hk["slo"].stats()["observed"],
                        cache.stats()))
    j, t = out
    assert t[0] == j[0] and t[0][0] == "cache_search"
    assert t[1] == j[1] and ("cache_probe", ("cache", "k", "pred"), ()) \
        in t[1]
    assert t[2] == j[2] == (None, "exact", "exact")
    assert t[3]["cache_hits"] == j[3]["cache_hits"] == 2
    assert t[4] == j[4] and t[4][0]["entries"] == 5
    assert t[5] == j[5] and t[5].count("exact") == 2
    assert t[6] == j[6]
    assert t[7] == j[7]


class _Boom:
    name = "boom"
    builds_on_device = False

    def build(self, ds, build_params):
        return None

    def param_settings(self):
        from repro_torch.ann.engine import ps
        return [ps("x")]

    def search(self, *a, **kw):
        raise RuntimeError("boom")


def test_failed_batch_reaches_slo_and_log_then_raises(tds, tiny_ds,
                                                      router_dir, tmp_path):
    from repro.ann.engine import ps as jps
    from repro.ann.index import RoutingDecision as JDecision
    from repro_torch.ann.engine import ps as tps
    from repro_torch.ann.index import RoutingDecision as TDecision

    class JBoom(_Boom):
        def param_settings(self):
            return [jps("x")]

    class TBoom(_Boom):
        def param_settings(self):
            return [tps("x")]

    out = []
    with JFX(tiny_ds) as jfx, TFX(tds, device="cpu") as tfx:
        for fx, svc_cls, router_cls, boom, mod, tag, dec_cls in (
                (jfx, JService, JRouter, JBoom(), J, "j", JDecision),
                (tfx, TService, TRouter, TBoom(), T, "t", TDecision)):
            hk = hooks(mod, tmp_path, tag)
            svc = svc_cls(fx, router_cls.load(router_dir), t=0.9,
                          methods={"boom": boom}, **hk)
            qs = make_queries(tiny_ds, Predicate.OR, 5, seed=2)
            batch = mod["qb"](qs.vectors, qs.bitmaps, Predicate.OR, 10)
            dec = [dec_cls("boom", "x")] * 5
            with pytest.raises(RuntimeError, match="boom"):
                svc.execute(batch, dec)
            hk["obslog"].close()
            ev = list(jlog.read_events(hk["obslog"].path))
            out.append((hk["slo"].stats()["observed"], hk["slo"].evaluate(),
                        [{k: v for k, v in e.items() if k != "ts"}
                         for e in ev]))
    assert out[1] == out[0]
    assert out[1][0]["avail"] == 5 and out[1][2][0]["error"] == \
        "RuntimeError: boom"


# --------------------------------------------- ledger gauges and leases


def test_live_ledger_gauges_and_leases_match_reference(tiny_ds, tds):
    """The same writes, a pinned snapshot across a compaction, and its
    release: the same gauges (delta bytes on the host and the device
    included), the same `snapshot_pin` and `retired_generation` leases
    and counters, none held at the end, the collector gone on close."""
    out = []
    for live_cls, mod, ds, kw in ((JLive, J, tiny_ds, {}),
                                  (TLive, T, tds, {"device": "cpu"})):
        with mod["led"].scoped() as led:
            live = live_cls(ds, delta_chunk=64, **kw)
            g = np.random.default_rng(3)
            pick = g.integers(0, ds.n, 150)
            live.upsert(ds.vectors[pick] + np.float32(0.01),
                        ds.bitmaps[pick])
            live.delete(g.choice(ds.n, 30, replace=False))
            qs = make_queries(tiny_ds, Predicate.AND, 4, seed=1)
            live.search(mod["qb"](qs.vectors, qs.bitmaps, Predicate.AND,
                                  10), "prefilter")
            steps = [led.snapshot()]
            snap = live.snapshot()
            steps.append(led.snapshot())
            live.compact()
            steps.append(led.snapshot())
            snap.release()
            steps.append(led.snapshot())
            live.close()
            steps.append(led.snapshot())
        out.append([({k: v for k, v in s["gauges"].items()},
                     s["held"], s["counters"]) for s in steps])

    def strip(steps):
        return [([g for _, g in sorted(gauges.items())], held, counters)
                for gauges, held, counters in steps]
    j, t = strip(out[0]), strip(out[1])
    assert t == j
    first_gauges = t[0][0][0]
    assert first_gauges["delta_rows"] == 150
    assert first_gauges["delta_device_bytes"] > 0
    assert t[1][1]["snapshot_pin"]["tiny"]["leases"] == 1
    assert t[2][1]["retired_generation"]["tiny"]["leases"] == 1
    assert t[3][1] == {} and t[4][0] == []
    assert t[3][2]["retired_generation"] == {"acquired": 1, "released": 1}


def test_sealed_handles_generation_and_label_clock_match_reference(tiny_ds,
                                                                   tds):
    """The repairs the cache and the sink read: a sealed and a sharded
    sealed handle report generation 0 and a constant label clock, as the
    reference's do."""
    pairs = [(JFX(tiny_ds), TFX(tds, device="cpu")),
             (JSharded(tiny_ds, 2), TSharded(tds, 2, device="cpu"))]
    try:
        for j, t in pairs:
            assert t.generation == j.generation == 0
            for labels in (None, np.array([0, 3, 7]), np.arange(40)):
                assert t.label_clock(labels) == j.label_clock(labels) == 0
    finally:
        for j, t in pairs:
            j.close()
            t.close()


def test_delta_segment_byte_counts_match_reference(tiny_ds):
    """`host_bytes` (the host backing, growth headroom included) and
    `device_bytes` (the mirror's covered rows, not the process's device
    total) after the same appends and mirror reads."""
    g = np.random.default_rng(6)
    j = JDelta(tiny_ds.dim, tiny_ds.bitmaps.shape[1], chunk=16)
    t = TDelta(tiny_ds.dim, tiny_ds.bitmaps.shape[1], chunk=16,
               device="cpu")
    assert (t.host_bytes(), t.device_bytes()) == (0, 0)
    for n in (5, 11, 1, 40, 7):
        rows = g.integers(0, tiny_ds.n, n)
        for d in (j, t):
            d.append(tiny_ds.vectors[rows], tiny_ds.bitmaps[rows])
        assert t.host_bytes() == j.host_bytes()
        j.device_view(j.rows, contextlib.nullcontext)
        t.device_view(t.rows)
        assert t.device_rows() == j.device_rows()
        assert t.device_bytes() == j.device_bytes() == t.device_rows() * (
            tiny_ds.dim * 4 + 4 + tiny_ds.bitmaps.shape[1] * 4)
    t.drop_device()
    assert t.device_bytes() == 0
