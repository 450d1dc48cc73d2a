"""The SLO engine and the wide-event log on the CPU, the port against the
JAX package: with an injected clock the same observations give the same
evaluations, alerts and status in both packages; `request_events` builds
the same rows; a log written by either package's `WideEventLog` (with
rotation) reads back through either package's `read_events`; the
post-mortem payloads carry the same sections, and `install`/`uninstall`
put the previous `SIGUSR2` handler and `atexit` state back. The patterns
of `tests/test_slo.py` and `tests/test_obslog.py`.

Every test draws its randomness from its own seeded generator."""

import atexit
import json
import os
import signal
import time
from types import SimpleNamespace

import numpy as np
import pytest

from repro.ann import ledger as jledger
from repro.ann import obslog as jlog
from repro.ann import slo as jslo
from repro.ann import trace as jtrace
from repro_torch.ann import ledger as tledger
from repro_torch.ann import obslog as tlog
from repro_torch.ann import slo as tslo
from repro_torch.ann import trace as ttrace
from repro_torch.ann.predicates import Predicate


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def objectives(mod):
    return [mod.Objective(name="lat", kind="latency", target=0.9,
                          threshold_us=1000.0),
            mod.Objective(name="and_lat", kind="latency", target=0.99,
                          threshold_us=500.0, pred=int(Predicate.AND)),
            mod.Objective(name="avail", kind="availability", target=0.95),
            mod.Objective(name="rec", kind="recall", target=0.9, floor=0.8)]


def strip_wall(x):
    """`x` without its wall-clock stamps (`t_wall`), which differ by
    construction."""
    if isinstance(x, dict):
        return {k: strip_wall(v) for k, v in x.items() if k != "t_wall"}
    if isinstance(x, list):
        return [strip_wall(v) for v in x]
    return x


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_slo_engine_matches_reference(seed):
    """A seeded stream of batches, requests, errors, audited recalls and
    clock advances into both engines; `evaluate()`, `state()`, `stats()`,
    `alerts()` and `status()` agree after every step."""
    g = np.random.default_rng(seed)
    clocks = (FakeClock(), FakeClock())
    kw = dict(windows=((30.0, 5.0, 2.0), (120.0, 20.0, 1.5)),
              bucket_s=float(g.choice([0.5, 1.0, 2.0])), min_events=3)
    engines = (jslo.SLOEngine(objectives(jslo), clock=clocks[0], **kw),
               tslo.SLOEngine(objectives(tslo), clock=clocks[1], **kw))
    for step in range(80):
        kind = int(g.integers(0, 5))
        pred = int(g.integers(0, 3))
        if kind == 0:
            args = (int(g.integers(1, 40)),)
            kwa = dict(per_query_us=float(g.uniform(10, 2500)), pred=pred,
                       errors=int(g.integers(0, 3)))
            for e in engines:
                e.observe_batch(*args, **kwa)
        elif kind == 1:
            lat, err = float(g.uniform(10, 2500)), bool(g.random() < 0.2)
            for e in engines:
                e.observe_request(lat, error=err, pred=pred)
        elif kind == 2:
            rec, n = float(g.uniform(0.5, 1.0)), int(g.integers(1, 4))
            for e in engines:
                e.observe_recall(rec, pred=pred, n=n)
        elif kind == 3:
            v = int(g.integers(0, 9))
            for e in engines:
                e.note_provenance(table_version=v)
        else:
            dt = float(g.uniform(0, 15))
            for c in clocks:
                c.t += dt
        assert engines[1].evaluate() == engines[0].evaluate()
        assert engines[1].state() == engines[0].state()
    assert engines[1].stats() == engines[0].stats()
    ja = [strip_wall(a.to_dict()) for a in engines[0].alerts()]
    ta = [strip_wall(a.to_dict()) for a in engines[1].alerts()]
    assert ta == ja
    assert strip_wall(engines[1].status()) == strip_wall(engines[0].status())


def test_slo_ingest_audit_and_alert_evidence():
    """An audit report ingests as one recall observation a sample; a
    firing alert carries the flight recorder's trace ids and the noted
    provenance, in both packages alike."""
    report = {"results": [(SimpleNamespace(pred=0), 0.5, None),
                          (SimpleNamespace(pred=1), 0.4, None),
                          (SimpleNamespace(pred=2), 0.95, None)]}
    out = []
    for mod, trace_mod in ((jslo, jtrace), (tslo, ttrace)):
        tracer = trace_mod.Tracer(slow_ms=0.0, sample=1.0,
                                  flight_capacity=8, seed=3)
        with tracer.trace("request"):
            pass
        eng = mod.SLOEngine([mod.Objective(name="rec", kind="recall",
                                           target=0.9, floor=0.8)],
                            windows=((10.0, 2.0, 2.0),), min_events=2,
                            clock=FakeClock(), tracer=tracer,
                            provenance=lambda: {"generation": 4})
        eng.note_provenance(table_version=7)
        eng.ingest_audit(report)
        st = eng.evaluate()
        (alert,) = eng.alerts()
        assert alert.trace_ids and alert.provenance == {
            "table_version": 7, "generation": 4}
        d = strip_wall(alert.to_dict())
        d["trace_ids"] = len(d["trace_ids"])
        out.append((st, d))
    assert out[1] == out[0]


def test_slo_validation_and_background_thread():
    for mod in (jslo, tslo):
        for bad in ({"kind": "throughput", "target": 0.9},
                    {"kind": "latency", "target": 0.9},
                    {"kind": "recall", "target": 0.9},
                    {"kind": "availability", "target": 1.0}):
            with pytest.raises(ValueError):
                mod.Objective(name="x", **bad)
        with pytest.raises(ValueError):
            mod.SLOEngine([])
        with pytest.raises(ValueError):
            mod.SLOEngine(objectives(mod)[:1] * 2)
        with pytest.raises(ValueError):
            mod.SLOEngine(objectives(mod), windows=((5.0, 5.0, 2.0),))
    assert tslo.DEFAULT_WINDOWS == jslo.DEFAULT_WINDOWS
    eng = tslo.SLOEngine([tslo.Objective(name="lat", kind="latency",
                                         target=0.9, threshold_us=100.0)],
                         windows=((60.0, 5.0, 2.0),), min_events=1)
    eng.observe_batch(8, per_query_us=9000.0)
    eng.start(interval_s=0.01)
    try:
        deadline = time.monotonic() + 5.0
        while eng.state() == "ok" and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        eng.stop()
    assert eng.state() == "firing:lat" and eng._thread is None


# ------------------------------------------------------ wide-event log


def test_request_events_match_reference():
    batch = SimpleNamespace(q=3, pred=Predicate.AND, k=5)
    decisions = [SimpleNamespace(method="sieve", ps_id="s1"),
                 SimpleNamespace(method="ivf_gamma", ps_id="g0"), None]
    for kw in ({"timings": {"search_s": 0.002, "total_s": 0.003,
                            "queries": 3}, "generation": 2,
                "table_version": 5, "slo_state": "firing:lat",
                "cache": [None, "exact", None]},
               {"error": "RuntimeError: boom"}, {}):
        want = jlog.request_events(batch, decisions, per_query_us=123.4,
                                   trace_id="t1-abc", **kw)
        got = tlog.request_events(batch, decisions, per_query_us=123.4,
                                  trace_id="t1-abc", **kw)
        assert [{k: v for k, v in e.items() if k != "ts"} for e in got] == \
            [{k: v for k, v in e.items() if k != "ts"} for e in want]
        assert [set(e) for e in got] == [set(e) for e in want]


@pytest.mark.parametrize("writer,reader", [(tlog, jlog), (jlog, tlog),
                                           (tlog, tlog)])
def test_wide_event_log_rotates_and_reads_across_packages(tmp_path, writer,
                                                          reader):
    """Small rotation limits: the writer rotates, keeps `rotate_keep`
    generations, counts what it wrote; the other package's reader gets
    the kept events oldest first, skipping a torn tail line."""
    path = str(tmp_path / "ev.jsonl")
    g = np.random.default_rng(5)
    events = [{"qi": i, "method": f"m{int(g.integers(3))}",
               "lat_us": float(g.uniform(1, 99))} for i in range(300)]
    with writer.WideEventLog(path, capacity=64, rotate_bytes=2048,
                             rotate_keep=2, autostart=False) as log:
        for lo in range(0, 300, 50):
            for ev in events[lo:lo + 50]:
                log.emit(ev)
            log.flush()
        st = log.stats()
    assert st["emitted"] == st["written"] == 300
    assert st["rotations"] > 2 and st["dropped"] == 0
    assert os.path.exists(path + ".2") and not os.path.exists(path + ".3")
    with open(path, "a") as f:
        f.write('{"qi": 999, "meth')              # torn mid-crash write
    got = list(reader.read_events(path))
    assert got and got == events[-len(got):]
    assert list(reader.read_events(path, include_rotated=False)) == \
        list(writer.read_events(path, include_rotated=False))


def test_wide_event_log_background_writer_and_overrun(tmp_path):
    out = []
    for mod in (jlog, tlog):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        with mod.WideEventLog(path, capacity=8, autostart=False) as log:
            for i in range(20):
                log.emit({"qi": i})
            log.emit({"qi": 20, "bad": object()})
            log.flush()
            st = log.stats()
        out.append(({k: v for k, v in st.items()
                     if k not in ("path", "file_bytes")},
                    [e["qi"] for e in mod.read_events(path)]))
    assert out[1] == out[0]
    path = str(tmp_path / "bg.jsonl")
    with tlog.WideEventLog(path, capacity=64, flush_interval_s=0.01) as log:
        for i in range(5):
            log.emit({"qi": i})
        deadline = time.monotonic() + 5.0
        while log.stats()["written"] < 5 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert log._thread is not None
    assert log._thread is None and log._f.closed
    assert [e["qi"] for e in tlog.read_events(path)] == list(range(5))


def _tiny_slo(mod):
    eng = mod.SLOEngine([mod.Objective(name="lat", kind="latency",
                                       target=0.9, threshold_us=1.0)],
                        min_events=1)
    eng.observe_batch(4, per_query_us=100.0)
    return eng


def test_postmortem_payload_matches_reference(tmp_path):
    payloads = []
    for mod, slo_mod, trace_mod, led_mod in (
            (jlog, jslo, jtrace, jledger), (tlog, tslo, ttrace, tledger)):
        tracer = trace_mod.Tracer(slow_ms=0.0, sample=1.0, seed=1)
        with tracer.trace("request"):
            pass
        led = led_mod.ResourceLedger()
        led.acquire("pin", "x")
        out = tmp_path / mod.__name__
        out.mkdir()
        with mod.WideEventLog(str(out / "ev.jsonl"), autostart=False) as log:
            log.emit({"qi": 0})
            dumper = mod.PostmortemDumper(
                tracer=tracer, ledger=led, slo=_tiny_slo(slo_mod),
                obslog=log, out_dir=str(out), extra=lambda: {"note": "hi"})
            with open(dumper.dump("unit-test")) as f:
                payloads.append(json.load(f))
    j, t = payloads
    assert set(t) == set(j)
    for key in ("flight", "tracer_stats", "ledger", "slo", "obslog"):
        assert set(t[key][0] if key == "flight" else t[key]) == \
            set(j[key][0] if key == "flight" else j[key]), key
    assert t["reason"] == "unit-test" and t["extra"] == {"note": "hi"}
    assert t["ledger"]["held"]["pin"]["x"]["leases"] == 1
    assert t["slo"]["state"].startswith("firing")
    assert t["obslog"]["written"] == 1


@pytest.mark.skipif(not hasattr(signal, "SIGUSR2"),
                    reason="platform has no SIGUSR2")
def test_postmortem_install_uninstall_restores_handlers(tmp_path,
                                                        monkeypatch):
    """`install` chains to the previous SIGUSR2 handler and registers the
    atexit dump; `uninstall` puts the previous handler back and drops
    the atexit hook. The default out_dir is the port's own
    `artifacts_dir("serve")`."""
    seen = []

    def prev(signum, frame):
        seen.append(signum)

    old = signal.signal(signal.SIGUSR2, prev)
    registered, unregistered = [], []
    monkeypatch.setattr(atexit, "register", registered.append)
    monkeypatch.setattr(atexit, "unregister", unregistered.append)
    try:
        dumper = tlog.install_postmortem(ledger=tledger.ResourceLedger(),
                                         out_dir=str(tmp_path))
        assert signal.getsignal(signal.SIGUSR2) is not prev
        assert registered == [dumper._atexit_dump]
        os.kill(os.getpid(), signal.SIGUSR2)
        files = [f for f in os.listdir(tmp_path)
                 if f.startswith("postmortem-")]
        assert len(files) == 1 and seen == [signal.SIGUSR2]
        with open(tmp_path / files[0]) as f:
            assert json.load(f)["reason"] == "SIGUSR2"
        calls = []
        dump = dumper.dump
        dumper.dump = lambda reason: calls.append(reason) or dump(reason)
        dumper._atexit_dump()
        dumper._atexit_dump()                    # second call is a no-op
        assert calls == ["atexit"]
        dumper.uninstall()
        assert signal.getsignal(signal.SIGUSR2) is prev
        assert unregistered == [dumper._atexit_dump]
        dumper.uninstall()                       # idempotent
        assert unregistered == [dumper._atexit_dump]
    finally:
        signal.signal(signal.SIGUSR2, old)
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path / "arts"))
    d = tlog.PostmortemDumper()
    assert d.out_dir == str(tmp_path / "arts" / "serve")
    assert os.path.isdir(d.out_dir)
