"""Resource ledger: central accounting for lifecycle-bound resources.

Serving leaks are rarely loud: a snapshot pin that is never released
keeps a whole retired generation's device arrays alive, an unsynced WAL
tail silently grows until a crash eats minutes of writes, a cache that
never evicts looks healthy until the allocator stalls.  The ledger
makes all of those *observable* through one registry with two
complementary mechanisms:

* **Leases** — explicit acquire/release records for resources with a
  lifecycle (snapshot pins, retired generations).  Each lease stamps
  the acquiring request's trace id (via :func:`repro_torch.ann.trace.trace_id`)
  and a short caller stack, so a leak report answers "who took it and
  from where", not just "something is held".  :meth:`ResourceLedger.leaks`
  returns every lease held past a configurable age.
* **Collectors** — zero-hot-path-cost pull gauges.  A subsystem
  registers a callable returning ``{gauge_name: number}``; the ledger
  invokes it only at :meth:`snapshot` / scrape time.  Delta/device
  bytes, cache entries/bytes, WAL backlog and queue depth all report
  this way, so attaching the ledger costs the serve path nothing.

A process-wide default ledger (:func:`get_ledger`) lets deep layers
(live index, WAL) register without threading a handle through every
constructor; tests isolate with :func:`scoped`.
"""

from __future__ import annotations

import contextlib
import itertools
import sys
import threading
import time
from typing import Any, Callable

from repro_torch.ann import trace

__all__ = [
    "Lease",
    "ResourceLedger",
    "get_ledger",
    "set_ledger",
    "scoped",
]


def _caller_stack(skip: int, depth: int) -> list[str]:
    """``file:line:function`` for up to ``depth`` frames above the
    acquire call.  A manual frame walk, not ``traceback.extract_stack``:
    the latter renders source lines and costs tens of µs, which matters
    on the snapshot-pin path."""
    out: list[str] = []
    try:
        f = sys._getframe(skip)
    except ValueError:  # pragma: no cover - shallow interpreter stack
        return out
    while f is not None and len(out) < depth:
        code = f.f_code
        fname = code.co_filename.rsplit("/", 1)[-1]
        out.append(f"{fname}:{f.f_lineno}:{code.co_name}")
        f = f.f_back
    return out


class Lease:
    """One held resource.  Release exactly once (idempotent); usable as
    a context manager for scope-bound holds."""

    __slots__ = ("lease_id", "kind", "owner", "count", "bytes", "meta",
                 "t0", "t_wall", "trace_id", "stack", "_ledger",
                 "released")

    def __init__(self, lease_id: int, kind: str, owner: str, *,
                 count: int, bytes: int, meta: dict | None,
                 trace_id: str | None, stack: list[str],
                 ledger: "ResourceLedger"):
        self.lease_id = lease_id
        self.kind = kind
        self.owner = owner
        self.count = int(count)
        self.bytes = int(bytes)
        self.meta = meta or {}
        self.t0 = time.monotonic()
        self.t_wall = time.time()
        self.trace_id = trace_id
        self.stack = stack
        self._ledger = ledger
        self.released = False

    @property
    def age_s(self) -> float:
        return time.monotonic() - self.t0

    def release(self) -> None:
        led = self._ledger
        if led is not None:
            self._ledger = None
            led._release(self)

    def __enter__(self) -> "Lease":
        return self

    def __exit__(self, et, ev, tb) -> bool:
        self.release()
        return False

    def to_dict(self) -> dict:
        return {"id": self.lease_id, "kind": self.kind,
                "owner": self.owner, "count": self.count,
                "bytes": self.bytes, "age_s": round(self.age_s, 3),
                "trace_id": self.trace_id, "stack": list(self.stack),
                "meta": dict(self.meta)}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Lease({self.kind}/{self.owner}, id={self.lease_id}, "
                f"age={self.age_s:.3f}s)")


class ResourceLedger:
    """Registry of held leases + pull-time gauge collectors.

    Args:
        leak_age_s: default age beyond which a held lease counts as a
            leak (override per :meth:`leaks` call).
        capture_stacks: stamp a short caller stack on every acquire
            (cheap frame walk; disable for the absolute minimum cost).
        stack_depth: frames kept per lease.
    """

    def __init__(self, *, leak_age_s: float = 30.0,
                 capture_stacks: bool = True, stack_depth: int = 5):
        self.leak_age_s = float(leak_age_s)
        self.capture_stacks = bool(capture_stacks)
        self.stack_depth = int(stack_depth)
        self._mu = threading.Lock()
        self._ids = itertools.count(1)
        self._leases: dict[int, Lease] = {}
        self._collectors: dict[str, Callable[[], dict]] = {}
        self._acquired: dict[str, int] = {}
        self._released: dict[str, int] = {}

    # -- leases ------------------------------------------------------------
    def acquire(self, kind: str, owner: str, *, count: int = 1,
                bytes: int = 0, meta: dict | None = None) -> Lease:
        """Record a held resource; returns the lease to release."""
        stack = (_caller_stack(2, self.stack_depth)
                 if self.capture_stacks else [])
        lease = Lease(next(self._ids), str(kind), str(owner),
                      count=count, bytes=bytes, meta=meta,
                      trace_id=trace.trace_id(), stack=stack, ledger=self)
        with self._mu:
            self._leases[lease.lease_id] = lease
            self._acquired[lease.kind] = \
                self._acquired.get(lease.kind, 0) + 1
        return lease

    def _release(self, lease: Lease) -> None:
        with self._mu:
            if self._leases.pop(lease.lease_id, None) is None:
                return
            lease.released = True
            self._released[lease.kind] = \
                self._released.get(lease.kind, 0) + 1

    def leases(self, kind: str | None = None) -> list[Lease]:
        with self._mu:
            out = list(self._leases.values())
        if kind is not None:
            out = [l for l in out if l.kind == kind]
        return sorted(out, key=lambda l: l.lease_id)

    def leaks(self, max_age_s: float | None = None) -> list[dict]:
        """Held leases older than ``max_age_s`` (default: the ledger's
        ``leak_age_s``), oldest first — each with the acquiring trace id
        and stack so the pin can be chased to its call site."""
        limit = self.leak_age_s if max_age_s is None else float(max_age_s)
        out = [l.to_dict() for l in self.leases() if l.age_s > limit]
        out.sort(key=lambda d: -d["age_s"])
        return out

    # -- collectors --------------------------------------------------------
    def register_collector(self, name: str,
                           fn: Callable[[], dict]) -> None:
        """Register a pull gauge source: ``fn() -> {gauge: number}``.
        Re-registering a name replaces the previous collector."""
        with self._mu:
            self._collectors[str(name)] = fn

    def deregister_collector(self, name: str) -> None:
        with self._mu:
            self._collectors.pop(str(name), None)

    def gauges(self) -> dict[str, dict[str, float]]:
        """Pull every collector; a failing collector reports an
        ``error`` pseudo-gauge instead of poisoning the scrape."""
        with self._mu:
            items = list(self._collectors.items())
        out: dict[str, dict[str, float]] = {}
        for name, fn in items:
            try:
                vals = fn()
                out[name] = {str(k): float(v) for k, v in vals.items()}
            except Exception as e:  # collector bug != scrape outage
                out[name] = {"error": 1.0}
                out[name]["_error_msg"] = str(e)  # type: ignore[assignment]
        return out

    # -- accounting --------------------------------------------------------
    def accounting(self) -> dict[str, dict[str, dict[str, int]]]:
        """``{kind: {owner: {leases, count, bytes}}}`` over held leases."""
        out: dict[str, dict[str, dict[str, int]]] = {}
        for l in self.leases():
            row = out.setdefault(l.kind, {}).setdefault(
                l.owner, {"leases": 0, "count": 0, "bytes": 0})
            row["leases"] += 1
            row["count"] += l.count
            row["bytes"] += l.bytes
        return out

    def counters(self) -> dict[str, dict[str, int]]:
        with self._mu:
            kinds = set(self._acquired) | set(self._released)
            return {k: {"acquired": self._acquired.get(k, 0),
                        "released": self._released.get(k, 0)}
                    for k in sorted(kinds)}

    def snapshot(self, *, leak_age_s: float | None = None) -> dict:
        """One JSON-able view: held accounting, lifetime counters,
        collector gauges, and the current leak report."""
        gauges = self.gauges()
        errors = {n: g.pop("_error_msg") for n, g in gauges.items()
                  if "_error_msg" in g}
        snap = {"t_wall": time.time(),
                "held": self.accounting(),
                "counters": self.counters(),
                "gauges": gauges,
                "leaks": self.leaks(leak_age_s)}
        if errors:
            snap["collector_errors"] = errors
        return snap

    def clear(self) -> None:
        with self._mu:
            self._leases.clear()
            self._collectors.clear()
            self._acquired.clear()
            self._released.clear()


_DEFAULT = ResourceLedger()
_CURRENT: ResourceLedger = _DEFAULT


def get_ledger() -> ResourceLedger:
    """The process-wide ledger deep layers register against."""
    return _CURRENT


def set_ledger(ledger: ResourceLedger) -> ResourceLedger:
    """Swap the process-wide ledger; returns the previous one."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = ledger
    return prev


@contextlib.contextmanager
def scoped(ledger: ResourceLedger | None = None):
    """Install a fresh (or given) ledger for the scope — test isolation
    without cross-test lease bleed-through."""
    led = ledger if ledger is not None else ResourceLedger()
    prev = set_ledger(led)
    try:
        yield led
    finally:
        set_ledger(prev)
