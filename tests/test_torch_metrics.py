"""Prometheus exposition and the scrape server on the CPU, the port against
the JAX package: `metrics_text` over the same observed objects (sink,
tracer, cache, queue, online table, ledger, SLO engine, wide-event log),
fed the same traffic in both packages, gives the same metric families,
names and labels — the text equal once the sample values and the
objects' addresses are masked — and parses strictly as text format
0.0.4; `MetricsServer` answers `/metrics`, `/healthz`, `/statusz` and the
debug endpoints on 127.0.0.1:0, and `/healthz` degrades on backpressure.
The patterns of `tests/test_metrics_conformance.py`, whose strict parser
this file uses.

Every test draws its randomness from its own seeded generator."""

import json
import re
import threading
import urllib.error
import urllib.request

import pytest

from repro.ann.cache import SemanticResultCache as JCache
from repro.ann.index import FilteredIndex as JFX
from repro.ann.live import LiveFilteredIndex as JLive
from repro.ann.metrics import metrics_text as jtext
from repro.ann.service import AsyncBatchQueue as JQueue
from repro.ann.service import RouterService as JService
from repro.core import features as jF
from repro.data.ann_synth import make_queries
from repro_torch.ann import metrics as tmetrics
from repro_torch.ann.cache import SemanticResultCache as TCache
from repro_torch.ann.index import FilteredIndex as TFX
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.live import LiveFilteredIndex as TLive
from repro_torch.ann.metrics import (MetricsServer, backpressure_health,
                                     metrics_text)
from repro_torch.ann.predicates import Predicate
from repro_torch.ann.service import AsyncBatchQueue as TQueue
from repro_torch.ann.service import RouterService as TService
from repro_torch.core import features as tF
from repro_torch.data.ann_synth import DatasetSpec, synthesize
from test_metrics_conformance import _check_histograms, parse_exposition
from test_torch_serving_hooks import J, T, hooks
from test_torch_telemetry import PAIR, two_method_tables

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's


@pytest.fixture(scope="module")
def tds():
    return synthesize(DatasetSpec(*TINY))


def observe(pkg, ds, tiny_ds, tmp_path, led):
    """One package's serving stack — a sealed service with every hook, a
    cache and a queue in front of it, a live handle registered on the
    ledger `led`, an auditor folding into an online table — fed the same
    traffic. Returns the surfaces `metrics_text` renders."""
    mod, fx_cls, live_cls, svc_cls, cache_cls, queue_cls, tel, feats, kw = (
        (J, JFX, JLive, JService, JCache, JQueue, J["tel"], jF.MINIMAL_FEATURES,
         {}) if pkg == "j" else
        (T, TFX, TLive, TService, TCache, TQueue, T["tel"],
         tF.MINIMAL_FEATURES, {"device": "cpu"}))
    table = two_method_tables(ds.name)[pkg == "t"]
    router = tel.constant_router(feats, list(PAIR), table)
    hk = hooks(mod, tmp_path, pkg)
    fx = fx_cls(ds, **kw)
    live = live_cls(ds, **kw)
    live.upsert(ds.vectors[:40] + 0.01, ds.bitmaps[:40])
    svc = svc_cls(fx, router, t=0.9, **hk)
    online = tel.OnlineBenchmarkTable(table, alpha=0.5)
    cache = cache_cls(svc, threshold=None)
    qs = make_queries(tiny_ds, Predicate.AND, 8, seed=3)
    for _ in range(2):
        svc.search(mod["qb"](qs.vectors, qs.bitmaps, Predicate.AND, 5))
    with queue_cls(cache, max_batch=64, max_wait_ms=60_000) as queue:
        futs = [queue.submit(qs.vectors[i], qs.bitmaps[i], Predicate.OR)
                for i in range(4)]
        queue.flush()
        [f.result(30) for f in futs]
        queue.submit(qs.vectors[0], qs.bitmaps[0], Predicate.OR).result(30)
    tel.RecallAuditor(fx, hk["telemetry"], table=online).run_once()
    online.observe_shard(ds.name, 0, qps=1000.0)
    online.observe_shard(ds.name, 1, qps=250.0)
    hk["obslog"].flush()
    snap = live.snapshot()
    led.acquire("pin", "tiny", bytes=64)
    surfaces = dict(sink=hk["telemetry"], tracer=hk["tracer"], cache=cache,
                    queue=queue, ledger=led, slo=hk["slo"],
                    obslog=hk["obslog"], table=online)
    return surfaces, (fx, live, snap, cache, hk["obslog"])


def masked(text: str) -> str:
    """The exposition with every sample value and object address masked
    (timings and byte counts differ run to run)."""
    text = re.sub(r":[0-9a-f]{6,}", ":ADDR", text)
    text = re.sub(r'le="[^"]*"', 'le="B"', text)
    return "\n".join(re.sub(r" \S+$", " N", ln) if not ln.startswith("#")
                     else ln for ln in text.splitlines())


def test_metrics_text_matches_reference(tiny_ds, tds, tmp_path):
    """Every surface at once: the same families, names, labels and HELP /
    TYPE lines as the reference's, strict 0.0.4, histograms cumulative,
    no duplicate samples."""
    out = []
    for pkg, ds, led_mod, render in (("j", tiny_ds, J["led"], jtext),
                                     ("t", tds, T["led"], metrics_text)):
        with led_mod.scoped() as led:
            surfaces, owned = observe(pkg, ds, tiny_ds, tmp_path, led)
            text = render(**surfaces)
            by_service = render(service=owned[3], ledger=led)
            owned[2].release()
            for o in (owned[3], owned[0], owned[1], owned[4]):
                o.close()
        out.append((text, by_service))
    (jt, js), (tt, ts) = out
    assert masked(tt) == masked(jt)
    assert masked(ts) == masked(js)
    samples, helps, types = parse_exposition(tt)
    assert _check_histograms(samples, types) >= 5
    names = {n for n, _l, _v in samples}
    for expected in ("ann_queries_total", "ann_traces_total",
                     "ann_span_latency_us_bucket", "ann_cache_events_total",
                     "ann_queue_cache_hits_total", "ann_table_shard_qps",
                     "ann_ledger_gauge", "ann_ledger_leases_held",
                     "ann_slo_burn_rate", "ann_obslog_events_total"):
        assert expected in names, expected
    keys = [(n, lab) for n, lab, _v in samples]
    assert len(keys) == len(set(keys))
    gauges = {dict(lab)["name"] for n, lab, _v in samples
              if n == "ann_ledger_gauge"
              and dict(lab)["source"].startswith("live:")}
    assert {"delta_host_bytes", "delta_device_bytes",
            "pinned_readers"} <= gauges
    spans = {dict(lab)["span"] for n, lab, _v in samples
             if n == "ann_span_latency_us_count"}
    assert {"search", "route", "execute", "group", "resolve_keys",
            "request", "enqueue_wait", "batch_assembly", "cache_probe",
            "cache.admit"} <= spans
    for fam, t in types.items():
        if t == "counter" and fam != "ann_counter":
            assert fam.endswith("_total") or fam == "ann_table_version"


def test_empty_render_and_escaping():
    assert metrics_text() == "# HELP ann_up Exporter liveness.\n" \
        "# TYPE ann_up gauge\nann_up 1\n"
    tricky = 'sla\\sh "quote"\nnewline'
    led = T["led"].ResourceLedger()
    led.register_collector(tricky, lambda: {"v": 1, "_hidden": 2})
    samples, _h, _t = parse_exposition(metrics_text(ledger=led))
    assert [dict(lab)["source"] for n, lab, _v in samples
            if n == "ann_ledger_gauge"] == [tricky]
    w = tmetrics._Writer()
    w.header("m_total", "counter", 'line one\nline "two" \\ three')
    w.sample("m_total", None, float("inf"))
    assert len(w.text().splitlines()) == 3
    assert w.text().endswith("m_total +Inf\n")


def _get(url):
    try:
        r = urllib.request.urlopen(url, timeout=10)
        return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_server_endpoints_and_scrape_race(tds, tiny_ds, tmp_path):
    """`/metrics` (strict exposition) and `/healthz` answer 200 on
    127.0.0.1 at a port the system picked, `/statusz` and the debug
    endpoints JSON, while a thread keeps serving."""
    with T["led"].scoped() as led:
        surfaces, owned = observe("t", tds, tiny_ds, tmp_path, led)
        svc = owned[3].service
        qs = make_queries(tiny_ds, Predicate.AND, 8, seed=3)
        batch = TQB(qs.vectors, qs.bitmaps, Predicate.AND, 5)
        srv = MetricsServer(lambda: metrics_text(**surfaces),
                            health=backpressure_health(
                                queue=surfaces["queue"]),
                            ledger=led, slo=surfaces["slo"],
                            obslog=surfaces["obslog"])
        assert srv.host == "127.0.0.1" and srv.port > 0
        stop = threading.Event()
        errors = []

        def serve_loop():
            try:
                while not stop.is_set():
                    svc.search(batch)
            except BaseException as e:
                errors.append(e)

        th = threading.Thread(target=serve_loop, daemon=True)
        th.start()
        try:
            for _ in range(4):
                code, body = _get(srv.url + "/metrics")
                assert code == 200
                samples, _h, types = parse_exposition(body.decode())
                _check_histograms(samples, types)
                code, body = _get(srv.url + "/healthz")
                assert code == 200 and json.loads(body)["status"] == "ok"
                for route in ("/statusz", "/debug/ledger", "/debug/slo"):
                    code, body = _get(srv.url + route)
                    assert code == 200 and isinstance(json.loads(body), dict)
            assert _get(srv.url + "/nope")[0] == 404
            st = json.loads(_get(srv.url + "/statusz")[1])
            assert {"health", "slo", "ledger", "obslog"} <= set(st)
        finally:
            stop.set()
            th.join(timeout=30)
            srv.close()
            owned[2].release()
            for o in (owned[3], owned[0], owned[1], owned[4]):
                o.close()
    assert not errors


class _FakeQueue:
    def __init__(self, pending):
        self.pending = pending

    def stats(self):
        return {"pending": self.pending}


class _FakeWAL:
    def __init__(self):
        self.bl = {"records": 0, "bytes": 0}

    def backlog(self):
        return self.bl


def test_healthz_degrades_on_backpressure_and_errors():
    q, wal = _FakeQueue(0), _FakeWAL()
    health = backpressure_health(queue=q, wal=wal, queue_high_water=4,
                                 wal_records_max=10, wal_bytes_max=1000,
                                 extra=lambda: {"status": "ok", "n": 1})
    with MetricsServer(lambda: "ann_up 1\n", health=health) as srv:
        code, body = _get(srv.url + "/healthz")
        assert code == 200 and json.loads(body)["n"] == 1
        for change in (lambda: setattr(q, "pending", 100),
                       lambda: wal.bl.update(records=11),
                       lambda: wal.bl.update(bytes=2000)):
            change()
            code, body = _get(srv.url + "/healthz")
            assert code == 503 and json.loads(body)["reasons"]
            q.pending, wal.bl = 0, {"records": 0, "bytes": 0}
        assert _get(srv.url + "/healthz")[0] == 200       # recovers
        assert _get(srv.url + "/debug/ledger")[0] == 404
        assert _get(srv.url + "/debug/slo")[0] == 404

    def broken():
        raise RuntimeError("probe exploded")

    with MetricsServer(lambda: 1 / 0, health=broken) as srv:
        code, body = _get(srv.url + "/healthz")
        assert code == 503 and json.loads(body)["status"] == "degraded"
        assert _get(srv.url + "/metrics")[0] == 500
