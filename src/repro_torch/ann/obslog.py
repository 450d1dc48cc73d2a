"""Structured wide-event log: one JSONL event per served request.

The "wide event" is the canonical observability-2.0 record: instead of
scattering a request across log lines, metrics and traces, every serve
emits *one* wide row carrying everything known about it — trace id,
route decision (method / param setting), cache provenance, shard
timings, live generation, table version, and the SLO state at serve
time.  Post-hoc debugging then is a ``jq`` filter, not a reproduction.

Hot-path discipline mirrors `TelemetrySink`: :meth:`WideEventLog.emit`
claims a slot from an atomic counter (``itertools.count`` — the GIL
makes ``next()`` atomic) and stores ``(seq, event)`` into a fixed ring;
no locks, no I/O.  A daemon writer thread drains the ring by sequence
watermark to a JSONL file with size-based rotation; if producers lap
the writer, the overrun is *counted*, never blocked on — load sheds
log rows, not requests.

:func:`install_postmortem` registers ``SIGUSR2`` + ``atexit`` handlers
that dump the flight recorder, ledger snapshot and SLO status to
``artifacts/serve/postmortem-<ts>.json`` so a crashed or killed server
still leaves evidence.

This is the JAX package's module with this package's imports: the
same event rows and files, which either package's `read_events` reads.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import signal
import threading
import time
from typing import Any, Callable, Iterator

__all__ = [
    "WideEventLog",
    "read_events",
    "install_postmortem",
    "PostmortemDumper",
]


class WideEventLog:
    """Lock-free ring → background JSONL writer with rotation.

    Args:
        path: output JSONL file; rotated siblings get ``.1`` … ``.N``.
        capacity: ring slots; producers overrun the writer at most this
            far before rows drop (counted in ``stats()['dropped']``).
        rotate_bytes: rotate when the active file exceeds this size.
        rotate_keep: rotated generations kept (older ones deleted).
        flush_interval_s: writer wake period.
        autostart: start the writer thread immediately.
    """

    def __init__(self, path: str, *, capacity: int = 4096,
                 rotate_bytes: int = 32 << 20, rotate_keep: int = 3,
                 flush_interval_s: float = 0.2, autostart: bool = True):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.path = str(path)
        self.capacity = int(capacity)
        self.rotate_bytes = int(rotate_bytes)
        self.rotate_keep = int(rotate_keep)
        self.flush_interval_s = float(flush_interval_s)
        self._ring: list = [None] * self.capacity
        self._seq = itertools.count()
        self._head = 0              # racy publish of emit progress
        self._written = 0           # next seq the writer will drain
        self._drain_mu = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._counters = {"emitted": 0, "written": 0, "dropped": 0,
                          "rotations": 0, "write_errors": 0}
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")
        self._bytes = self._f.tell()
        self._thread: threading.Thread | None = None
        if autostart:
            self.start()

    # -- hot path ----------------------------------------------------------
    def emit(self, event: dict) -> int:
        """Store one event; returns its sequence number.  No locks, no
        I/O — safe on the serve path and from any thread."""
        seq = next(self._seq)
        self._ring[seq % self.capacity] = (seq, event)
        # racy watermark: may briefly regress under contention, which
        # only delays (never loses) the regressed rows by one tick
        self._head = seq + 1
        return seq

    # -- writer ------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self._wake.wait(self.flush_interval_s)
                self._wake.clear()
                self._drain()
            self._drain()           # final sweep on stop

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="obslog-writer")
        self._thread.start()

    def _drain(self) -> None:
        with self._drain_mu:
            head = max(self._head, self._written)
            lo = self._written
            if head - lo > self.capacity:   # writer lapped: shed oldest
                dropped = head - lo - self.capacity
                self._counters["dropped"] += dropped
                lo = head - self.capacity
            lines: list[str] = []
            for s in range(lo, head):
                slot = self._ring[s % self.capacity]
                if slot is None or slot[0] != s:
                    continue                # reserved-but-unfilled slot
                try:
                    lines.append(json.dumps(slot[1], default=str))
                except (TypeError, ValueError):
                    self._counters["write_errors"] += 1
            self._written = head
            if not lines:
                return
            try:
                self._f.write("\n".join(lines) + "\n")
                self._f.flush()
                self._bytes = self._f.tell()
                self._counters["written"] += len(lines)
                if self._bytes >= self.rotate_bytes:
                    self._rotate()
            except OSError:
                self._counters["write_errors"] += 1

    def _rotate(self) -> None:
        self._f.close()
        # shift path.N-1 -> path.N, ... , path -> path.1
        oldest = f"{self.path}.{self.rotate_keep}"
        if os.path.exists(oldest):
            os.unlink(oldest)
        for i in range(self.rotate_keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        if self.rotate_keep > 0:
            os.replace(self.path, f"{self.path}.1")
        else:
            os.unlink(self.path)
        self._f = open(self.path, "a", encoding="utf-8")
        self._bytes = 0
        self._counters["rotations"] += 1

    def flush(self) -> None:
        """Synchronously drain everything emitted so far."""
        self._drain()

    def close(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._wake.set()
            self._thread.join(timeout=5.0)
            self._thread = None
        else:
            self._drain()
        with self._drain_mu:
            if not self._f.closed:
                self._f.close()

    def __enter__(self) -> "WideEventLog":
        return self

    def __exit__(self, et, ev, tb) -> bool:
        self.close()
        return False

    def stats(self) -> dict:
        with self._drain_mu:
            out = dict(self._counters)
            out["emitted"] = self._head
            out["file_bytes"] = self._bytes
            out["path"] = self.path
        return out


def read_events(path: str, *, include_rotated: bool = True
                ) -> Iterator[dict]:
    """Parse a wide-event JSONL file (rotated generations first, so
    iteration order is oldest → newest).  Skips torn lines."""
    paths: list[str] = []
    if include_rotated:
        i = 1
        rotated = []
        while os.path.exists(f"{path}.{i}"):
            rotated.append(f"{path}.{i}")
            i += 1
        paths.extend(reversed(rotated))   # .N is oldest
    if os.path.exists(path):
        paths.append(path)
    for p in paths:
        with open(p, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    continue


# ---------------------------------------------------------------------------
# Serve-path event construction (kept here so `service.py` stays lean)
# ---------------------------------------------------------------------------

def request_events(batch, decisions, *, per_query_us: float,
                   trace_id: str | None, timings: dict | None = None,
                   generation: int | None = None,
                   table_version: int | None = None,
                   slo_state: str | None = None,
                   cache: list | None = None,
                   error: str | None = None) -> list[dict]:
    """Build one wide event per query of a served batch.  The batch
    shares a trace root, timings and serve-time state; per-query fields
    are the route decision and cache provenance."""
    now = time.time()
    shared: dict[str, Any] = {"ts": round(now, 6), "trace": trace_id,
                              "pred": int(batch.pred), "k": int(batch.k),
                              "batch_q": int(batch.q),
                              "lat_us": round(per_query_us, 1)}
    if generation is not None:
        shared["generation"] = int(generation)
    if table_version is not None:
        shared["table_version"] = int(table_version)
    if slo_state is not None:
        shared["slo"] = slo_state
    if error is not None:
        shared["error"] = error
    if timings:
        shared["timings_ms"] = {k[:-2]: round(v * 1e3, 3)
                                for k, v in timings.items()
                                if k.endswith("_s")}
    events: list[dict] = []
    for i in range(batch.q):
        ev = dict(shared)
        ev["qi"] = i
        d = decisions[i] if decisions is not None else None
        if d is not None:
            ev["method"] = d.method
            ev["ps"] = d.ps_id   # int or named setting like "g1"
        ev["cache"] = cache[i] if cache is not None else None
        events.append(ev)
    return events


# ---------------------------------------------------------------------------
# Post-mortem dumps: SIGUSR2 + atexit
# ---------------------------------------------------------------------------

class PostmortemDumper:
    """Writes flight-recorder + ledger + SLO evidence on demand, on
    ``SIGUSR2``, and at interpreter exit."""

    def __init__(self, *, tracer=None, ledger=None, slo=None, obslog=None,
                 out_dir: str | None = None,
                 extra: Callable[[], dict] | None = None):
        self.tracer = tracer
        self.ledger = ledger
        self.slo = slo
        self.obslog = obslog
        self.extra = extra
        if out_dir is None:
            from repro_torch.common import artifacts_dir
            out_dir = artifacts_dir("serve")
        self.out_dir = out_dir
        self._prev_handler: Any = None
        self._installed_signal = False
        self._installed_atexit = False
        self._dumped_atexit = False

    # -- payload -----------------------------------------------------------
    def payload(self, reason: str) -> dict:
        out: dict[str, Any] = {"reason": reason, "t_wall": time.time(),
                               "pid": os.getpid()}
        if self.tracer is not None:
            try:
                out["flight"] = json.loads(
                    self.tracer.dump_flight_json(indent=None))["flight"]
                out["tracer_stats"] = self.tracer.stats()
            except Exception as e:
                out["flight_error"] = str(e)
        if self.ledger is not None:
            try:
                out["ledger"] = self.ledger.snapshot()
            except Exception as e:
                out["ledger_error"] = str(e)
        if self.slo is not None:
            try:
                out["slo"] = self.slo.status()
            except Exception as e:
                out["slo_error"] = str(e)
        if self.obslog is not None:
            try:
                self.obslog.flush()
                out["obslog"] = self.obslog.stats()
            except Exception as e:
                out["obslog_error"] = str(e)
        if self.extra is not None:
            try:
                out["extra"] = self.extra()
            except Exception as e:
                out["extra_error"] = str(e)
        return out

    def dump(self, reason: str = "manual") -> str:
        ts = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(self.out_dir,
                            f"postmortem-{ts}-{os.getpid()}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.payload(reason), f, indent=2, default=str)
        return path

    # -- installation ------------------------------------------------------
    def install(self, *, install_signal: bool = True,
                install_atexit: bool = True) -> "PostmortemDumper":
        if install_signal and hasattr(signal, "SIGUSR2") \
                and threading.current_thread() is threading.main_thread():
            def on_usr2(signum, frame):
                try:
                    self.dump("SIGUSR2")
                except Exception:
                    pass
                prev = self._prev_handler
                if callable(prev):
                    prev(signum, frame)

            self._prev_handler = signal.signal(signal.SIGUSR2, on_usr2)
            self._installed_signal = True
        if install_atexit:
            atexit.register(self._atexit_dump)
            self._installed_atexit = True
        return self

    def _atexit_dump(self) -> None:
        if self._dumped_atexit:
            return
        self._dumped_atexit = True
        try:
            self.dump("atexit")
        except Exception:
            pass

    def uninstall(self) -> None:
        if self._installed_signal:
            signal.signal(signal.SIGUSR2, self._prev_handler
                          if self._prev_handler is not None
                          else signal.SIG_DFL)
            self._installed_signal = False
        if self._installed_atexit:
            try:
                atexit.unregister(self._atexit_dump)
            except Exception:
                pass
            self._installed_atexit = False


def install_postmortem(*, tracer=None, ledger=None, slo=None, obslog=None,
                       out_dir: str | None = None,
                       extra: Callable[[], dict] | None = None,
                       install_signal: bool = True,
                       install_atexit: bool = True) -> PostmortemDumper:
    """Convenience: build + install a :class:`PostmortemDumper`."""
    return PostmortemDumper(tracer=tracer, ledger=ledger, slo=slo,
                            obslog=obslog, out_dir=out_dir,
                            extra=extra).install(
        install_signal=install_signal, install_atexit=install_atexit)
