"""Request-scoped hierarchical tracing for the serving stack.

A *trace* is one tree of :class:`Span` nodes rooted at a request (a
routed search, a queue micro-batch, a cache probe).  The design goals,
in order:

1. **Zero cost when off.**  Instrumented layers call the module-level
   :func:`span` / :func:`annotate` unconditionally; both are no-ops
   (one ``ContextVar.get`` returning ``None``) unless an enclosing
   trace is active.  Layers below the service (live index, store)
   therefore need no tracer reference at all.
2. **Explicit cross-thread propagation.**  ``contextvars`` do *not*
   flow into worker threads spawned before the request, so thread hops
   (the async queue's pipeline executor, per-shard thread pools)
   re-enter a tree with :func:`attach`.
3. **Tail-based sampling.**  :meth:`Tracer.finish` always keeps traces
   that breached the slow threshold or errored (into the flight
   recorder) and head-samples the rest with probability ``sample``;
   per-span latency histograms update for *every* trace regardless of
   the sampling verdict, so `/metrics` stays unbiased.

Exports render a finished tree as Chrome-trace/Perfetto JSON
(:func:`perfetto_json`) — overlapping siblings (parallel shard fan-out)
are pushed onto separate ``tid`` lanes so every lane is properly
nested, which is what trace viewers require of ``"ph": "X"`` events.

This is the JAX package's module, line for line. In this package only
the store opens spans so far (``wal.append``, ``wal.fsync``,
``store.checkpoint``, ``store.commit_manifest``); the service's, the
queue's, the live handles' and the ``shard`` spans are not wired yet.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import math
import random
import threading
import time
from collections import deque
from typing import Any, Iterator

__all__ = [
    "Span",
    "Tracer",
    "span",
    "annotate",
    "count",
    "attach",
    "current",
    "trace_id",
    "maybe_trace",
    "perfetto_json",
    "BUCKET_BOUNDS_US",
    "LatencyHistogram",
]

_ACTIVE: "contextvars.ContextVar[Span | None]" = contextvars.ContextVar(
    "repro_torch_ann_active_span", default=None)

# Attribute keys hoisted from any span of a kept tree into the flight
# record's flat ``annotations`` dict (first writer wins).
_ANNOT_KEYS = ("decisions", "table_version", "cache", "generation", "shards")


def _jsonable(v: Any) -> Any:
    """Best-effort conversion of span attributes to JSON-safe values."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_jsonable(x) for x in v]
    item = getattr(v, "item", None)  # numpy scalars
    if callable(item):
        try:
            return _jsonable(item())
        except Exception:
            pass
    return str(v)


class Span:
    """One timed node in a trace tree.  Times are ``time.monotonic()``
    seconds; ``t1 is None`` marks a still-open span.  Children may be
    appended from other threads (list.append is atomic under the GIL);
    the owner closes stragglers at :meth:`Tracer.finish`."""

    __slots__ = ("name", "t0", "t1", "attrs", "children", "error",
                 "trace_id")

    def __init__(self, name: str, attrs: dict | None = None,
                 t0: float | None = None):
        self.name = name
        self.t0 = time.monotonic() if t0 is None else float(t0)
        self.t1: float | None = None
        self.attrs: dict = dict(attrs) if attrs else {}
        self.children: list[Span] = []
        self.error: str | None = None
        self.trace_id: str | None = None

    # -- construction ------------------------------------------------------
    def child(self, name: str, *, t0: float | None = None,
              t1: float | None = None, **attrs) -> "Span":
        """Append a child; pass explicit bounds for spans reconstructed
        after the fact (e.g. enqueue-wait measured from submit time)."""
        s = Span(name, attrs, t0=t0)
        if t1 is not None:
            s.t1 = float(t1)
        s.trace_id = self.trace_id
        self.children.append(s)
        return s

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def finish(self, t1: float | None = None) -> "Span":
        if self.t1 is None:
            self.t1 = time.monotonic() if t1 is None else float(t1)
        return self

    # -- inspection --------------------------------------------------------
    @property
    def duration_s(self) -> float:
        return max(0.0, (self.t1 if self.t1 is not None else self.t0)
                   - self.t0)

    def walk(self) -> Iterator["Span"]:
        stack = [self]
        while stack:
            s = stack.pop()
            yield s
            stack.extend(s.children)

    def find(self, name: str) -> "Span | None":
        for s in self.walk():
            if s.name == name:
                return s
        return None

    def to_dict(self, origin: float | None = None) -> dict:
        origin = self.t0 if origin is None else origin
        d: dict = {"name": self.name,
                   "t0_ms": round((self.t0 - origin) * 1e3, 4),
                   "dur_ms": round(self.duration_s * 1e3, 4)}
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.attrs:
            d["attrs"] = _jsonable(self.attrs)
        if self.error:
            d["error"] = self.error
        if self.children:
            d["children"] = [c.to_dict(origin) for c in self.children]
        return d

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, dur={self.duration_s * 1e3:.3f}ms, "
                f"children={len(self.children)})")


# ---------------------------------------------------------------------------
# Ambient-context API (no-ops outside an active trace)
# ---------------------------------------------------------------------------

class _SpanCtx:
    __slots__ = ("_name", "_attrs", "_span", "_token")

    def __init__(self, name: str, attrs: dict):
        self._name = name
        self._attrs = attrs
        self._span: Span | None = None
        self._token = None

    def __enter__(self) -> Span | None:
        parent = _ACTIVE.get()
        if parent is None:
            return None
        s = Span(self._name, self._attrs)
        s.trace_id = parent.trace_id
        parent.children.append(s)
        self._span = s
        self._token = _ACTIVE.set(s)
        return s

    def __exit__(self, et, ev, tb) -> bool:
        s = self._span
        if s is None:
            return False
        if et is not None and s.error is None:
            s.error = f"{et.__name__}: {ev}"
        s.finish()
        _ACTIVE.reset(self._token)
        return False


def span(name: str, **attrs) -> _SpanCtx:
    """Open a child span under the ambient trace; no-op (yields ``None``)
    when no trace is active, so call sites need no enabled-check."""
    return _SpanCtx(name, attrs)


def current() -> Span | None:
    return _ACTIVE.get()


def trace_id() -> str | None:
    """Trace id of the ambient trace, ``None`` outside one (or for a
    root created without a `Tracer`).  The id is assigned at the root
    and inherited by every child span, so any layer can stamp logs or
    resource leases with the request it served."""
    s = _ACTIVE.get()
    return s.trace_id if s is not None else None


def annotate(**attrs) -> None:
    """Attach attributes to the innermost active span, if any."""
    s = _ACTIVE.get()
    if s is not None:
        s.attrs.update(attrs)


def count(name: str, n: int = 1) -> None:
    """Increment a numeric attribute on the innermost active span."""
    s = _ACTIVE.get()
    if s is not None:
        s.attrs[name] = s.attrs.get(name, 0) + n


class _Attach:
    __slots__ = ("_span", "_token")

    def __init__(self, s: Span | None):
        self._span = s
        self._token = None

    def __enter__(self) -> Span | None:
        if self._span is not None:
            self._token = _ACTIVE.set(self._span)
        return self._span

    def __exit__(self, et, ev, tb) -> bool:
        if self._token is not None:
            _ACTIVE.reset(self._token)
        return False


def attach(s: Span | None) -> _Attach:
    """Re-enter a span's context on another thread (explicit propagation
    across the queue's pipeline executor / shard pools).  ``attach(None)``
    is a no-op, so call sites can pass an optional root unconditionally."""
    return _Attach(s)


class _RootCtx:
    __slots__ = ("_tracer", "_name", "_attrs", "_root", "_token")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._root: Span | None = None
        self._token = None

    def __enter__(self) -> Span:
        self._root = Span(self._name, self._attrs)
        self._root.trace_id = self._tracer.new_trace_id()
        self._token = _ACTIVE.set(self._root)
        return self._root

    def __exit__(self, et, ev, tb) -> bool:
        _ACTIVE.reset(self._token)
        root = self._root
        if et is not None and root.error is None:
            root.error = f"{et.__name__}: {ev}"
        self._tracer.finish(root)
        return False


def maybe_trace(tracer: "Tracer | None", name: str, **attrs):
    """Nest under the ambient trace if one is active (e.g. the cache or
    queue already opened a root); else open a fresh root on ``tracer``;
    else no-op.  This is how stacked facades produce *one* tree."""
    if _ACTIVE.get() is not None:
        return _SpanCtx(name, attrs)
    if tracer is not None:
        return tracer.trace(name, **attrs)
    return _Attach(None)  # inert context manager yielding None


# ---------------------------------------------------------------------------
# Latency histograms — fixed log2 buckets, independent of any ring size
# ---------------------------------------------------------------------------

# Upper bounds in microseconds: 2^0 .. 2^24 (≈16.8 s), then +Inf.
BUCKET_BOUNDS_US: tuple = tuple(float(1 << i) for i in range(25)) + (math.inf,)


def bucket_index(us: float) -> int:
    if us <= 1.0:
        return 0
    i = (int(math.ceil(us)) - 1).bit_length()
    return i if i < len(BUCKET_BOUNDS_US) - 1 else len(BUCKET_BOUNDS_US) - 1


class LatencyHistogram:
    """Counts per log2-µs bucket plus sum/count, Prometheus-compatible."""

    __slots__ = ("counts", "sum_us", "count")

    def __init__(self):
        self.counts = [0] * len(BUCKET_BOUNDS_US)
        self.sum_us = 0.0
        self.count = 0

    def observe(self, us: float) -> None:
        self.counts[bucket_index(us)] += 1
        self.sum_us += us
        self.count += 1

    def snapshot(self) -> dict:
        return {"bounds_us": BUCKET_BOUNDS_US, "counts": list(self.counts),
                "sum_us": self.sum_us, "count": self.count}

    def quantile_us(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the hit bucket)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return BUCKET_BOUNDS_US[i]
        return BUCKET_BOUNDS_US[-1]


# ---------------------------------------------------------------------------
# Tracer: sampling, flight recorder, histograms
# ---------------------------------------------------------------------------

class Tracer:
    """Owns finished-trace policy: per-span histograms (always), the
    flight recorder (slow/error traces, bounded ring), and head
    sampling for the rest.

    ``slow_ms=None`` disables the threshold (nothing is "slow");
    ``sample`` in [0, 1] is the keep probability for ordinary traces.
    Thread-safe: ``finish`` may be called from any worker thread.
    """

    def __init__(self, *, slow_ms: float | None = None, sample: float = 1.0,
                 flight_capacity: int = 32, recent_capacity: int = 64,
                 seed: int = 0):
        if flight_capacity <= 0:
            raise ValueError("flight_capacity must be positive")
        self.slow_ms = None if slow_ms is None else float(slow_ms)
        self.sample = float(sample)
        self._lock = threading.Lock()
        self._recent: deque[Span] = deque(maxlen=int(recent_capacity))
        self._flight: deque[dict] = deque(maxlen=int(flight_capacity))
        self._hist: dict[str, LatencyHistogram] = {}
        self._seq = itertools.count()
        self._rng = random.Random(seed)
        # separate stream for ids: drawing them from the sampling rng
        # would shift the tail-sampling sequence under a fixed seed
        self._id_rng = random.Random((int(seed) << 1) ^ 0x9E3779B9)
        self._id_seq = itertools.count(1)
        self._counters = {"traces": 0, "kept": 0, "dropped": 0,
                          "slow": 0, "errors": 0}

    # -- roots -------------------------------------------------------------
    def new_trace_id(self) -> str:
        """Deterministic-under-seed unique id: ordinal + random tag."""
        with self._lock:
            return (f"t{next(self._id_seq):06d}-"
                    f"{self._id_rng.getrandbits(32):08x}")

    def start(self, name: str, **attrs) -> Span:
        """Create a detached root; the caller attaches/finishes it
        explicitly (queue-style, where the root outlives one thread)."""
        s = Span(name, attrs)
        s.trace_id = self.new_trace_id()
        return s

    def trace(self, name: str, **attrs) -> _RootCtx:
        """Context manager: root + ambient attach + finish-on-exit."""
        return _RootCtx(self, name, attrs)

    def finish(self, root: Span, *, error: str | None = None) -> None:
        """Close a tree and apply the tail-sampling verdict."""
        if error is not None and root.error is None:
            root.error = str(error)
        root.finish()
        t1 = root.t1
        err = None
        annot: dict = {}
        spans = list(root.walk())
        for s in spans:
            if s.t1 is None:      # straggler (e.g. exception skipped exit)
                s.t1 = t1
            if err is None and s.error:
                err = s.error
            for k in _ANNOT_KEYS:
                if k in s.attrs and k not in annot:
                    annot[k] = s.attrs[k]
        dur_ms = root.duration_s * 1e3
        slow = self.slow_ms is not None and dur_ms >= self.slow_ms
        with self._lock:
            c = self._counters
            c["traces"] += 1
            for s in spans:
                h = self._hist.get(s.name)
                if h is None:
                    h = self._hist[s.name] = LatencyHistogram()
                h.observe(s.duration_s * 1e6)
            if err is not None:
                c["errors"] += 1
            if slow:
                c["slow"] += 1
            if slow or err is not None:
                c["kept"] += 1
                self._flight.append({
                    "seq": next(self._seq),
                    "trace_id": root.trace_id,
                    "t_wall": time.time(),
                    "duration_ms": dur_ms,
                    "reason": "error" if err is not None else "slow",
                    "error": err,
                    "annotations": _jsonable(annot),
                    "root": root,
                })
                self._recent.append(root)
            elif self._rng.random() < self.sample:
                c["kept"] += 1
                self._recent.append(root)
            else:
                c["dropped"] += 1

    # -- inspection --------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            out["flight_size"] = len(self._flight)
            out["span_p50_us"] = {n: h.quantile_us(0.5)
                                  for n, h in self._hist.items()}
        return out

    def histograms(self) -> dict:
        with self._lock:
            return {n: h.snapshot() for n, h in self._hist.items()}

    def recent(self) -> list[Span]:
        with self._lock:
            return list(self._recent)

    def flight(self) -> list[dict]:
        """Flight-recorder entries, oldest first (roots are live Spans)."""
        with self._lock:
            return list(self._flight)

    def clear(self) -> None:
        with self._lock:
            self._recent.clear()
            self._flight.clear()
            self._hist.clear()
            for k in self._counters:
                self._counters[k] = 0

    # -- dumps -------------------------------------------------------------
    def dump_flight_json(self, path: str | None = None, *,
                         indent: int | None = 2) -> str:
        recs = self.flight()
        payload = [{**{k: v for k, v in r.items() if k != "root"},
                    "trace": r["root"].to_dict()} for r in recs]
        text = json.dumps({"flight": payload}, indent=indent)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def perfetto_json(self, roots=None, *, indent: int | None = None) -> str:
        if roots is None:
            roots = [r["root"] for r in self.flight()] or self.recent()
        return perfetto_json(roots, indent=indent)


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export
# ---------------------------------------------------------------------------

def _lane_events(root: Span, origin: float, tid_counter,
                 events: list[dict]) -> None:
    """Emit ``"ph": "X"`` events for one tree.  Children are clamped into
    their parent's bounds, and siblings that overlap in time (parallel
    fan-out) move to fresh ``tid`` lanes — every lane then satisfies the
    viewer's stack discipline (events on a lane nest or are disjoint)."""

    root_tid = next(tid_counter)

    def emit(s: Span, tid: int, lo: float, hi: float) -> None:
        t0 = min(max(s.t0, lo), hi)
        t1 = min(max(s.t1 if s.t1 is not None else t0, t0), hi)
        ev = {"name": s.name, "ph": "X", "pid": 0, "tid": tid,
              "ts": round((t0 - origin) * 1e6, 3),
              "dur": round((t1 - t0) * 1e6, 3)}
        args = _jsonable(s.attrs) if s.attrs else {}
        if s.error:
            args = dict(args)
            args["error"] = s.error
        if args:
            ev["args"] = args
        events.append(ev)
        # Greedy lane assignment for the children: lane 0 is the
        # parent's own tid (nested rendering); overflow lanes get
        # fresh tids from the shared counter.
        lanes: list[tuple[int, float]] = [(tid, -math.inf)]
        for c in sorted(s.children, key=lambda x: x.t0):
            c0 = min(max(c.t0, t0), t1)
            c1 = min(max(c.t1 if c.t1 is not None else c0, c0), t1)
            for i, (ltid, lend) in enumerate(lanes):
                if c0 >= lend:
                    lanes[i] = (ltid, c1)
                    emit(c, ltid, c0, c1)
                    break
            else:
                ltid = next(tid_counter)
                lanes.append((ltid, c1))
                emit(c, ltid, c0, c1)

    emit(root, root_tid, root.t0,
         root.t1 if root.t1 is not None else root.t0)


def perfetto_json(roots, *, indent: int | None = None) -> str:
    """Serialise one Span tree (or an iterable of them) as Chrome-trace
    JSON (µs timestamps, complete events) loadable in Perfetto."""
    if isinstance(roots, Span):
        roots = [roots]
    roots = list(roots)
    if not roots:
        return json.dumps({"traceEvents": [], "displayTimeUnit": "ms"})
    origin = min(r.t0 for r in roots)
    events: list[dict] = []
    tid_counter = itertools.count()
    for r in roots:
        _lane_events(r, origin, tid_counter, events)
    return json.dumps({"traceEvents": events, "displayTimeUnit": "ms"},
                      indent=indent)
