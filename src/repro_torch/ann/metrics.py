"""Prometheus text exposition + a lightweight scrape endpoint.

`metrics_text()` renders one consistent snapshot of the serving stack's
observability surfaces in Prometheus text format 0.0.4:

* `TelemetrySink` — query/batch counters, per-(method, ps, predicate)
  cells, per-shard stage-time cells (skew), named counters, and the
  ring-derived latency percentiles as gauges;
* `Tracer` — per-span latency histograms with *fixed* log2-µs buckets
  (`trace.BUCKET_BOUNDS_US` — bucket layout is independent of any ring
  capacity, so rates and quantiles are comparable across deployments
  and restarts) plus trace/keep/drop counters;
* `SemanticResultCache` — hit/miss/eviction counters and occupancy;
* `AsyncBatchQueue` — served queries/batches, submit-time cache hits,
  queue-depth high-water mark, flush reasons;
* `OnlineBenchmarkTable` — table version, audited-vs-offline drift,
  and the shard-keyed EWMA QPS cells (shard-divergent throughput is
  visible per shard, not just in aggregate);
* `ResourceLedger` — held leases per kind/owner (counts + bytes), leak
  count, lifetime acquire/release counters, and every registered
  collector gauge (delta/device bytes, cache occupancy, WAL backlog,
  queue depth);
* `SLOEngine` — per-objective burn rates per alert window, firing
  state, and the alert count (**each scrape runs one evaluation
  pass**, so scraping *is* the alerting cadence when no background
  evaluator is started);
* `WideEventLog` — emitted/written/dropped/rotation counters and the
  active file size.

`MetricsServer` serves `/metrics` (the exposition) and `/healthz`
(JSON readiness: HTTP 200 while ``status == "ok"``, 503 once the
health payload degrades — see `backpressure_health`) on a daemon
`ThreadingHTTPServer`, plus the debug surfaces `/statusz` (one merged
operator view), `/debug/ledger` and `/debug/slo`.

This is the JAX package's module with this package's imports; its text
and its endpoints are the same, so one scraper reads either package.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Callable

__all__ = ["metrics_text", "MetricsServer", "backpressure_health"]

_PREFIX = "ann"


def _esc(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _esc_help(v) -> str:
    # HELP text escapes only backslash and newline (exposition format
    # 0.0.4) — quotes stay literal, unlike label values
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(value) -> str:
    if value is None:
        return "0"
    if isinstance(value, float):
        if math.isinf(value):
            return "+Inf" if value > 0 else "-Inf"
        if math.isnan(value):
            return "NaN"
    return repr(float(value)) if isinstance(value, float) else str(value)


class _Writer:
    def __init__(self):
        self.lines: list[str] = []
        self._typed: set[str] = set()

    def header(self, name: str, mtype: str, help_: str) -> None:
        if name in self._typed:
            return
        self._typed.add(name)
        self.lines.append(f"# HELP {name} {_esc_help(help_)}")
        self.lines.append(f"# TYPE {name} {mtype}")

    def sample(self, name: str, labels: dict | None, value) -> None:
        if labels:
            lab = ",".join(f'{k}="{_esc(v)}"' for k, v in labels.items())
            self.lines.append(f"{name}{{{lab}}} {_fmt(value)}")
        else:
            self.lines.append(f"{name} {_fmt(value)}")

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def _sink_metrics(w: _Writer, sink, prefix: str) -> None:
    from repro_torch.ann.predicates import Predicate

    s = sink.stats()
    w.header(f"{prefix}_queries_total", "counter",
             "Queries recorded by the telemetry sink.")
    w.sample(f"{prefix}_queries_total", None, s["queries"])
    w.header(f"{prefix}_batches_total", "counter",
             "Executed batches recorded by the telemetry sink.")
    w.sample(f"{prefix}_batches_total", None, s["batches"])
    w.header(f"{prefix}_latency_us", "gauge",
             "Ring-derived per-query latency percentiles (µs).")
    for q, v in s["latency_us"].items():
        w.sample(f"{prefix}_latency_us", {"quantile": q}, v)
    w.header(f"{prefix}_method_queries_total", "counter",
             "Queries served per routed method.")
    for m, n in sorted(s["by_method"].items()):
        w.sample(f"{prefix}_method_queries_total", {"method": m}, n)
    w.header(f"{prefix}_cell_queries_total", "counter",
             "Queries per (method, param-setting, predicate) cell.")
    w.header(f"{prefix}_cell_latency_us_mean", "gauge",
             "Mean per-query latency per cell (µs).")
    for (m, ps, p), (n, us) in sorted(sink.cell_aggregates().items(),
                                      key=lambda kv: str(kv[0])):
        if n <= 0:
            continue
        lab = {"method": m, "ps": ps if ps is not None else "",
               "pred": Predicate(p).name}
        w.sample(f"{prefix}_cell_queries_total", lab, n)
        w.sample(f"{prefix}_cell_latency_us_mean", lab, us / n)
    w.header(f"{prefix}_shard_stage_seconds_total", "counter",
             "Per-shard stage seconds (fan-out skew).")
    w.header(f"{prefix}_shard_stage_calls_total", "counter",
             "Per-shard stage fold count.")
    for (sh, stage), (n, sec) in sorted(sink.shard_aggregates().items()):
        lab = {"shard": sh, "stage": stage}
        w.sample(f"{prefix}_shard_stage_seconds_total", lab, sec)
        w.sample(f"{prefix}_shard_stage_calls_total", lab, n)
    w.header(f"{prefix}_counter", "counter",
             "Named sink counters (stage seconds, cache notes, waits).")
    for name, val in sorted(sink.counter_values().items()):
        w.sample(f"{prefix}_counter", {"name": name}, val)


def _tracer_metrics(w: _Writer, tracer, prefix: str) -> None:
    from repro_torch.ann.trace import BUCKET_BOUNDS_US

    t = tracer.stats()
    w.header(f"{prefix}_traces_total", "counter",
             "Finished traces, by sampling outcome.")
    for key in ("traces", "kept", "dropped", "slow", "errors"):
        w.sample(f"{prefix}_traces_total", {"outcome": key}, t[key])
    w.header(f"{prefix}_flight_size", "gauge",
             "Span trees currently held by the flight recorder.")
    w.sample(f"{prefix}_flight_size", None, t["flight_size"])
    name = f"{prefix}_span_latency_us"
    w.header(name, "histogram",
             "Per-span latency, fixed log2-µs buckets "
             "(independent of ring capacity).")
    for span_name, h in sorted(tracer.histograms().items()):
        acc = 0
        for bound, c in zip(BUCKET_BOUNDS_US, h["counts"]):
            acc += c
            le = "+Inf" if math.isinf(bound) else _fmt(bound)
            w.sample(f"{name}_bucket", {"span": span_name, "le": le}, acc)
        w.sample(f"{name}_sum", {"span": span_name}, h["sum_us"])
        w.sample(f"{name}_count", {"span": span_name}, h["count"])


def _cache_metrics(w: _Writer, cache, prefix: str) -> None:
    c = cache.stats()
    w.header(f"{prefix}_cache_events_total", "counter",
             "Semantic-cache events (hits by kind, misses, evictions).")
    for key, val in sorted(c.items()):
        if key in ("entries", "capacity", "partitions", "hit_rate"):
            continue
        w.sample(f"{prefix}_cache_events_total", {"event": key}, val)
    w.header(f"{prefix}_cache_entries", "gauge", "Cached entries.")
    w.sample(f"{prefix}_cache_entries", None, c["entries"])
    w.header(f"{prefix}_cache_capacity", "gauge", "Cache capacity.")
    w.sample(f"{prefix}_cache_capacity", None, c["capacity"])
    w.header(f"{prefix}_cache_hit_rate", "gauge",
             "Lifetime hit rate (0 when nothing probed yet).")
    w.sample(f"{prefix}_cache_hit_rate", None, c["hit_rate"] or 0.0)


def _queue_metrics(w: _Writer, queue, prefix: str) -> None:
    s = queue.stats()
    w.header(f"{prefix}_queue_queries_total", "counter",
             "Queries served through the async batch queue.")
    w.sample(f"{prefix}_queue_queries_total", None, s["queries"])
    w.header(f"{prefix}_queue_batches_total", "counter",
             "Micro-batches flushed by the queue worker.")
    w.sample(f"{prefix}_queue_batches_total", None, s["batches"])
    w.header(f"{prefix}_queue_cache_hits_total", "counter",
             "Queries answered from the cache at submit time.")
    w.sample(f"{prefix}_queue_cache_hits_total", None, s["cache_hits"])
    w.header(f"{prefix}_queue_pending", "gauge",
             "Requests currently waiting for a flush.")
    w.sample(f"{prefix}_queue_pending", None, s["pending"])
    w.header(f"{prefix}_queue_depth_high_water", "gauge",
             "Queue-depth high-water mark.")
    w.sample(f"{prefix}_queue_depth_high_water", None,
             s["max_queue_depth"])
    w.header(f"{prefix}_queue_flushes_total", "counter",
             "Flushes by trigger reason.")
    for reason, n in sorted(s["flush_reasons"].items()):
        w.sample(f"{prefix}_queue_flushes_total", {"reason": reason}, n)


def _ledger_metrics(w: _Writer, ledger, prefix: str) -> None:
    snap = ledger.snapshot()
    w.header(f"{prefix}_ledger_leases_held", "gauge",
             "Held resource leases per (kind, owner).")
    w.header(f"{prefix}_ledger_lease_count", "gauge",
             "Summed lease counts per (kind, owner).")
    w.header(f"{prefix}_ledger_lease_bytes", "gauge",
             "Summed lease bytes per (kind, owner).")
    for kind, owners in sorted(snap["held"].items()):
        for owner, agg in sorted(owners.items()):
            lab = {"kind": kind, "owner": owner}
            w.sample(f"{prefix}_ledger_leases_held", lab, agg["leases"])
            w.sample(f"{prefix}_ledger_lease_count", lab, agg["count"])
            w.sample(f"{prefix}_ledger_lease_bytes", lab, agg["bytes"])
    w.header(f"{prefix}_ledger_acquired_total", "counter",
             "Lifetime lease acquisitions per kind.")
    w.header(f"{prefix}_ledger_released_total", "counter",
             "Lifetime lease releases per kind.")
    for kind, c in sorted(snap["counters"].items()):
        w.sample(f"{prefix}_ledger_acquired_total", {"kind": kind},
                 c["acquired"])
        w.sample(f"{prefix}_ledger_released_total", {"kind": kind},
                 c["released"])
    w.header(f"{prefix}_ledger_leaks", "gauge",
             "Leases held past the configured leak age.")
    w.sample(f"{prefix}_ledger_leaks", None, len(snap["leaks"]))
    w.header(f"{prefix}_ledger_gauge", "gauge",
             "Collector-sourced resource gauges "
             "(delta/device bytes, WAL backlog, queue depth, cache).")
    for source, gauges in sorted(snap["gauges"].items()):
        for gname, val in sorted(gauges.items()):
            if gname.startswith("_"):
                continue
            w.sample(f"{prefix}_ledger_gauge",
                     {"source": source, "name": gname}, val)
    w.header(f"{prefix}_ledger_collector_errors", "gauge",
             "Registered collectors that raised at scrape time.")
    w.sample(f"{prefix}_ledger_collector_errors", None,
             len(snap.get("collector_errors", {})))


def _table_metrics(w: _Writer, table, prefix: str) -> None:
    w.header(f"{prefix}_table_version", "counter",
             "Online benchmark-table version (bumps per observation).")
    w.sample(f"{prefix}_table_version", None, table.version)
    w.header(f"{prefix}_table_shard_qps", "gauge",
             "Shard-keyed EWMA QPS cells folded from per-shard "
             "telemetry (shard-divergent throughput, per shard).")
    w.header(f"{prefix}_table_shard_samples_total", "counter",
             "Samples folded into each shard cell.")
    for (ds, shard, stage), cell in sorted(table.shard_cells().items()):
        lab = {"ds": ds, "shard": shard, "stage": stage}
        w.sample(f"{prefix}_table_shard_qps", lab, cell["qps"])
        w.sample(f"{prefix}_table_shard_samples_total", lab, cell["n"])
    w.header(f"{prefix}_table_shard_divergence", "gauge",
             "max/min shard EWMA QPS ratio (1 = even, 0 = <2 shards).")
    w.sample(f"{prefix}_table_shard_divergence", None,
             table.shard_divergence())
    w.header(f"{prefix}_table_max_drift", "gauge",
             "Largest audited-vs-offline recall divergence.")
    w.sample(f"{prefix}_table_max_drift", None, table.max_drift())


def _slo_metrics(w: _Writer, slo, prefix: str) -> None:
    # evaluate() is deliberately called at scrape time: with no
    # background evaluator running, the scrape cadence is the alerting
    # cadence (rising-edge alerts are recorded on the engine)
    status = slo.evaluate()
    st = slo.stats()
    w.header(f"{prefix}_slo_firing", "gauge",
             "1 when the objective's burn-rate alert is firing.")
    w.header(f"{prefix}_slo_burn_rate", "gauge",
             "Error-budget burn rate per (objective, window, span).")
    w.header(f"{prefix}_slo_events_total", "counter",
             "Events observed per objective.")
    for name, obj in sorted(status.items()):
        w.sample(f"{prefix}_slo_firing", {"objective": name},
                 1 if obj["firing"] else 0)
        for win in obj["windows"]:
            wl = _fmt(float(win["long_s"]))
            w.sample(f"{prefix}_slo_burn_rate",
                     {"objective": name, "window_s": wl, "span": "long"},
                     win["burn_long"])
            w.sample(f"{prefix}_slo_burn_rate",
                     {"objective": name, "window_s": wl, "span": "short"},
                     win["burn_short"])
        w.sample(f"{prefix}_slo_events_total", {"objective": name},
                 obj["observed"])
    w.header(f"{prefix}_slo_alerts_total", "counter",
             "Rising-edge burn-rate alerts since start.")
    w.sample(f"{prefix}_slo_alerts_total", None, st["alerts"])


def _obslog_metrics(w: _Writer, obslog, prefix: str) -> None:
    s = obslog.stats()
    w.header(f"{prefix}_obslog_events_total", "counter",
             "Wide events by disposition (emitted/written/dropped).")
    for key in ("emitted", "written", "dropped"):
        w.sample(f"{prefix}_obslog_events_total", {"disposition": key},
                 s[key])
    w.header(f"{prefix}_obslog_rotations_total", "counter",
             "Log-file rotations performed by the writer.")
    w.sample(f"{prefix}_obslog_rotations_total", None, s["rotations"])
    w.header(f"{prefix}_obslog_write_errors_total", "counter",
             "Writer I/O errors (events are shed, never block).")
    w.sample(f"{prefix}_obslog_write_errors_total", None,
             s["write_errors"])
    w.header(f"{prefix}_obslog_file_bytes", "gauge",
             "Size of the active wide-event log file.")
    w.sample(f"{prefix}_obslog_file_bytes", None, s["file_bytes"])


def metrics_text(*, sink=None, tracer=None, cache=None, queue=None,
                 ledger=None, slo=None, obslog=None, table=None,
                 service=None, prefix: str = _PREFIX) -> str:
    """Render one Prometheus text-format snapshot of whatever surfaces
    are passed.  `service=` is a convenience: its `telemetry`,
    `tracer`, `slo` and `obslog` attributes fill the matching slots
    when those are omitted (an `OnlineBenchmarkTable` behind the
    service's router fills `table`, and a `SemanticResultCache` passed
    as `service` fills `cache`)."""
    if service is not None:
        if sink is None:
            sink = getattr(service, "telemetry", None)
        if tracer is None:
            tracer = getattr(service, "tracer", None)
        if slo is None:
            slo = getattr(service, "slo", None)
        if obslog is None:
            obslog = getattr(service, "obslog", None)
        if table is None:
            t = getattr(getattr(service, "router", None), "table", None)
            if hasattr(t, "shard_cells"):
                table = t
        if cache is None and hasattr(service, "probe_one"):
            cache = service
    w = _Writer()
    if sink is not None:
        _sink_metrics(w, sink, prefix)
    if tracer is not None:
        _tracer_metrics(w, tracer, prefix)
    if cache is not None:
        _cache_metrics(w, cache, prefix)
    if queue is not None:
        _queue_metrics(w, queue, prefix)
    if table is not None:
        _table_metrics(w, table, prefix)
    if ledger is not None:
        _ledger_metrics(w, ledger, prefix)
    if slo is not None:
        _slo_metrics(w, slo, prefix)
    if obslog is not None:
        _obslog_metrics(w, obslog, prefix)
    if not w.lines:
        w.header(f"{prefix}_up", "gauge", "Exporter liveness.")
        w.sample(f"{prefix}_up", None, 1)
    return w.text()


def backpressure_health(*, queue=None, wal=None,
                        queue_high_water: int = 256,
                        wal_records_max: int = 4096,
                        wal_bytes_max: int = 64 << 20,
                        extra: Callable[[], dict] | None = None,
                        ) -> Callable[[], dict]:
    """Build a `/healthz` payload callable that degrades on
    backpressure, not just on exceptions.

    The returned callable reports ``status: "degraded"`` (which
    `MetricsServer` maps to HTTP 503) when the async batch queue's
    pending depth exceeds `queue_high_water` or the WAL's fsync
    backlog exceeds `wal_records_max` records / `wal_bytes_max`
    bytes.  `extra()` results are merged in; an ``extra`` that sets
    ``status`` itself wins only if it degrades further.
    """
    def health() -> dict:
        payload: dict = {"status": "ok"}
        reasons: list[str] = []
        if queue is not None:
            pending = int(queue.stats()["pending"])
            payload["queue_pending"] = pending
            if pending > queue_high_water:
                reasons.append(
                    f"queue_pending {pending} > {queue_high_water}")
        if wal is not None:
            bl = wal.backlog()
            payload["wal_backlog_records"] = int(bl["records"])
            payload["wal_backlog_bytes"] = int(bl["bytes"])
            if bl["records"] > wal_records_max:
                reasons.append(
                    f"wal_backlog_records {bl['records']} > "
                    f"{wal_records_max}")
            if bl["bytes"] > wal_bytes_max:
                reasons.append(
                    f"wal_backlog_bytes {bl['bytes']} > {wal_bytes_max}")
        if extra is not None:
            ext = dict(extra())
            ext_status = ext.pop("status", "ok")
            payload.update(ext)
            if ext_status != "ok":
                reasons.append(f"extra: {ext_status}")
        if reasons:
            payload["status"] = "degraded"
            payload["reasons"] = reasons
        return payload

    return health


class MetricsServer:
    """Daemon HTTP server exposing `/metrics` (Prometheus text),
    `/healthz` (JSON readiness), `/statusz` (merged operator view) and
    the `/debug/ledger` / `/debug/slo` JSON surfaces.

    Args:
        render: zero-arg callable returning the exposition text —
            typically `lambda: metrics_text(sink=..., tracer=...)`.
        host / port: bind address; port 0 picks a free port (read it
            back from `.port`).
        health: optional zero-arg callable returning a JSON-serialisable
            health payload (merged over {"status": "ok"}).  A payload
            whose ``status`` is anything but ``"ok"`` — including one
            produced by `backpressure_health` on queue/WAL backlog —
            is served with HTTP 503 so load-balancer probes actually
            drain the replica, instead of the former always-200.
        ledger / slo / obslog: optional observability handles backing
            `/debug/ledger`, `/debug/slo` and the `/statusz` summary.
        statusz: optional zero-arg callable merged into `/statusz`.
    """

    def __init__(self, render: Callable[[], str], *,
                 host: str = "127.0.0.1", port: int = 0,
                 health: Callable[[], dict] | None = None,
                 ledger=None, slo=None, obslog=None,
                 statusz: Callable[[], dict] | None = None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802  (http.server API)
                route = self.path.split("?", 1)[0]
                if route == "/metrics":
                    try:
                        body = outer.render().encode()
                    except Exception as e:   # surface, don't kill serving
                        self._reply(500, f"# render error: {e}\n".encode(),
                                    "text/plain; charset=utf-8")
                        return
                    self._reply(200, body,
                                "text/plain; version=0.0.4; charset=utf-8")
                elif route == "/healthz":
                    payload = {"status": "ok"}
                    if outer.health is not None:
                        try:
                            payload.update(outer.health())
                        except Exception as e:
                            payload = {"status": "degraded",
                                       "error": str(e)}
                    code = 200 if payload.get("status") == "ok" else 503
                    self._json(code, payload)
                elif route == "/statusz":
                    self._json(200, outer._statusz())
                elif route == "/debug/ledger":
                    if outer.ledger is None:
                        self._json(404, {"error": "no ledger attached"})
                    else:
                        self._debug_json(lambda: outer.ledger.snapshot())
                elif route == "/debug/slo":
                    if outer.slo is None:
                        self._json(404, {"error": "no slo engine attached"})
                    else:
                        self._debug_json(lambda: outer.slo.status())
                else:
                    self._reply(404, b"not found\n",
                                "text/plain; charset=utf-8")

            def _debug_json(self, fn) -> None:
                try:
                    self._json(200, fn())
                except Exception as e:
                    self._json(500, {"error": str(e)})

            def _json(self, code: int, payload) -> None:
                body = (json.dumps(payload, default=str) + "\n").encode()
                self._reply(code, body, "application/json")

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:   # silence access log
                pass

        self.render = render
        self.health = health
        self.ledger = ledger
        self.slo = slo
        self.obslog = obslog
        self.statusz = statusz
        self._srv = ThreadingHTTPServer((host, int(port)), _Handler)
        self._srv.daemon_threads = True
        self.host, self.port = self._srv.server_address[:2]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="ann-metrics",
            daemon=True)
        self._thread.start()

    def _statusz(self) -> dict:
        """One compact operator view: health, SLO state, resource
        accounting and wide-event-log throughput, each section guarded
        so a failing surface degrades to an error string."""
        out: dict = {"t_wall": time.time()}
        try:
            payload = {"status": "ok"}
            if self.health is not None:
                payload.update(self.health())
            out["health"] = payload
        except Exception as e:
            out["health"] = {"status": "degraded", "error": str(e)}
        if self.slo is not None:
            try:
                self.slo.evaluate()
                out["slo"] = {"state": self.slo.state(),
                              **self.slo.stats()}
            except Exception as e:
                out["slo"] = {"error": str(e)}
        if self.ledger is not None:
            try:
                snap = self.ledger.snapshot()
                out["ledger"] = {"held": snap["held"],
                                 "leaks": len(snap["leaks"]),
                                 "collector_errors":
                                     snap.get("collector_errors", {})}
            except Exception as e:
                out["ledger"] = {"error": str(e)}
        if self.obslog is not None:
            try:
                out["obslog"] = self.obslog.stats()
            except Exception as e:
                out["obslog"] = {"error": str(e)}
        if self.statusz is not None:
            try:
                out.update(self.statusz())
            except Exception as e:
                out["statusz_error"] = str(e)
        return out

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=10)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
