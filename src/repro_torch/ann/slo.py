"""Declarative SLOs with multi-window multi-burn-rate alerting.

The router trades recall for QPS; an operator needs *both* sides held
to explicit objectives.  This module evaluates three objective kinds
over sliding windows of good/bad observations:

* ``latency`` — a request is *bad* when its per-query latency exceeds
  ``threshold_us`` (a p99 SLO of 2 ms at target 0.99 reads: "≤1 % of
  queries slower than 2 ms").
* ``recall`` — an audited sample is *bad* when its exact recall falls
  below ``floor``.  Fed by :class:`repro_torch.ann.telemetry.RecallAuditor`
  (``slo=`` hookup), so silent quality sag pages before users notice.
* ``availability`` — a request is *bad* when it errored.

Alerting follows the Google-SRE multi-window multi-burn-rate recipe:
for an objective with target ``T`` the error *budget* is ``1 - T``;
the **burn rate** of a window is ``bad_fraction / budget`` (1.0 means
"spending the budget exactly on schedule").  An alert pair
``(long_s, short_s, factor)`` fires only when *both* windows burn at
≥ ``factor``: the long window gives significance, the short window
confirms the problem is still happening (fast reset once fixed).

Every :class:`Alert` carries provenance: the flight-recorder trace ids
live at fire time and the latest noted routing/table version, so the
page links straight to evidence.

Windows are bucketed monotonic-time rings (``bucket_s`` granularity),
so observation cost is O(objectives) per batch and memory is bounded
by ``horizon / bucket_s``.

This is the JAX package's module with this package's imports: the
same objectives, windows and alerts.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

__all__ = ["Objective", "Alert", "SLOEngine", "DEFAULT_WINDOWS"]

# (long_s, short_s, factor) pairs — the classic SRE page/ticket ladder
# compressed to serving-bench timescales (hours, not days).
DEFAULT_WINDOWS: tuple = ((3600.0, 300.0, 14.4), (21600.0, 1800.0, 6.0))


@dataclass(frozen=True)
class Objective:
    """One declarative objective.

    ``target`` is the good-fraction target (0.999 = "three nines");
    the error budget is ``1 - target``.  ``kind`` selects which
    observations feed it; ``pred`` (optional, recall/latency) restricts
    the objective to one predicate type, mirroring the paper's finding
    that quality degrades per predicate regime, not uniformly.
    """

    name: str
    kind: str                       # "latency" | "recall" | "availability"
    target: float
    threshold_us: float | None = None   # latency: bad above this
    floor: float | None = None          # recall: bad below this
    pred: int | None = None             # restrict to one predicate type
    description: str = ""

    def __post_init__(self):
        if self.kind not in ("latency", "recall", "availability"):
            raise ValueError(f"unknown objective kind: {self.kind!r}")
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1)")
        if self.kind == "latency" and self.threshold_us is None:
            raise ValueError("latency objective needs threshold_us")
        if self.kind == "recall" and self.floor is None:
            raise ValueError("recall objective needs floor")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


@dataclass
class Alert:
    """One firing transition, with evidence attached."""

    objective: str
    kind: str
    t_wall: float
    window: tuple                   # (long_s, short_s, factor) that fired
    burn_long: float
    burn_short: float
    bad_frac_long: float
    budget: float
    trace_ids: list = field(default_factory=list)
    provenance: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"objective": self.objective, "kind": self.kind,
                "t_wall": self.t_wall,
                "window": {"long_s": self.window[0],
                           "short_s": self.window[1],
                           "factor": self.window[2]},
                "burn_long": round(self.burn_long, 3),
                "burn_short": round(self.burn_short, 3),
                "bad_frac_long": round(self.bad_frac_long, 5),
                "budget": self.budget,
                "trace_ids": list(self.trace_ids),
                "provenance": dict(self.provenance)}


class _Window:
    """Bucketed good/bad ring over monotonic time."""

    __slots__ = ("bucket_s", "horizon_buckets", "buckets")

    def __init__(self, bucket_s: float, horizon_s: float):
        self.bucket_s = float(bucket_s)
        self.horizon_buckets = max(int(horizon_s / bucket_s) + 2, 4)
        # list of [bucket_idx, good, bad]; append-only at the tail,
        # evicted at the head once past the horizon
        self.buckets: list[list] = []

    def observe(self, now: float, good: int, bad: int) -> None:
        idx = int(now / self.bucket_s)
        b = self.buckets
        if b and b[-1][0] == idx:
            b[-1][1] += good
            b[-1][2] += bad
        else:
            b.append([idx, good, bad])
            floor = idx - self.horizon_buckets
            while b and b[0][0] < floor:
                b.pop(0)

    def totals(self, now: float, window_s: float) -> tuple[int, int]:
        """(good, bad) inside the trailing ``window_s`` seconds."""
        lo = int((now - window_s) / self.bucket_s)
        good = bad = 0
        for idx, g, x in reversed(self.buckets):
            if idx <= lo:
                break
            good += g
            bad += x
        return good, bad


class SLOEngine:
    """Sliding-window SLO evaluation + burn-rate alerting.

    Args:
        objectives: the declarative targets.
        windows: ``(long_s, short_s, factor)`` alert pairs, shared by
            all objectives.
        bucket_s: observation bucket granularity.
        min_events: a window with fewer observations than this can't
            fire (protects cold starts from one unlucky request).
        tracer: optional — alerts snapshot its flight-recorder trace
            ids as evidence.
        provenance: optional zero-arg callable merged into each alert's
            provenance at fire time (e.g. the live table version).
        clock: injectable monotonic clock for deterministic tests.
    """

    def __init__(self, objectives, *, windows: tuple = DEFAULT_WINDOWS,
                 bucket_s: float = 1.0, min_events: int = 10,
                 tracer=None, provenance: Callable[[], dict] | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.objectives: list[Objective] = list(objectives)
        if not self.objectives:
            raise ValueError("need at least one objective")
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError("objective names must be unique")
        self.windows = tuple((float(l), float(s), float(f))
                             for (l, s, f) in windows)
        if any(s >= l for (l, s, _f) in self.windows):
            raise ValueError("short window must be < long window")
        self.min_events = int(min_events)
        self.tracer = tracer
        self._provenance = provenance
        self._clock = clock
        self._mu = threading.Lock()
        horizon = max(l for (l, _s, _f) in self.windows)
        self._win = {o.name: _Window(bucket_s, horizon)
                     for o in self.objectives}
        self._firing: dict[str, bool] = {o.name: False
                                         for o in self.objectives}
        self._noted: dict[str, Any] = {}
        self._alerts: list[Alert] = []
        self._evals = 0
        self._observed = {o.name: 0 for o in self.objectives}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- observation (hot path: O(objectives) dict/list ops) ---------------
    def observe_batch(self, q: int, *, per_query_us: float | None = None,
                      errors: int = 0, pred: int | None = None) -> None:
        """Fold one served batch: ``q`` requests at ``per_query_us``
        each (the batch's per-query share), ``errors`` of them failed."""
        now = self._clock()
        q = int(q)
        errors = int(errors)
        with self._mu:
            for o in self.objectives:
                if o.pred is not None and pred is not None \
                        and o.pred != pred:
                    continue
                if o.kind == "latency" and per_query_us is not None:
                    ok = q - errors
                    bad = ok if per_query_us > o.threshold_us else 0
                    self._win[o.name].observe(now, ok - bad, bad)
                    self._observed[o.name] += ok
                elif o.kind == "availability":
                    self._win[o.name].observe(now, q - errors, errors)
                    self._observed[o.name] += q

    def observe_request(self, latency_us: float, *, error: bool = False,
                        pred: int | None = None) -> None:
        """Single-request convenience wrapper over ``observe_batch``."""
        self.observe_batch(1, per_query_us=latency_us,
                           errors=1 if error else 0, pred=pred)

    def observe_recall(self, recall: float, *, pred: int | None = None,
                       n: int = 1) -> None:
        """Fold an audited-recall measurement into recall objectives."""
        now = self._clock()
        with self._mu:
            for o in self.objectives:
                if o.kind != "recall":
                    continue
                if o.pred is not None and pred is not None \
                        and o.pred != pred:
                    continue
                bad = n if recall < o.floor else 0
                self._win[o.name].observe(now, n - bad, bad)
                self._observed[o.name] += n

    def ingest_audit(self, report: dict) -> None:
        """Consume a ``RecallAuditor.run_once`` report: one recall
        observation per audited sample, tagged with its predicate."""
        for sample, recall, _exact in report.get("results", ()):
            self.observe_recall(float(recall),
                                pred=int(getattr(sample, "pred", -1)))

    def note_provenance(self, **kv) -> None:
        """Stamp latest-seen provenance (e.g. ``table_version=…``)
        merged into any alert that fires later."""
        with self._mu:
            self._noted.update(kv)

    # -- evaluation --------------------------------------------------------
    def _burn(self, o: Objective, now: float, window_s: float
              ) -> tuple[float, float, int]:
        good, bad = self._win[o.name].totals(now, window_s)
        total = good + bad
        if total == 0:
            return 0.0, 0.0, 0
        frac = bad / total
        return frac / o.budget, frac, total

    def evaluate(self) -> dict:
        """Run one evaluation pass; fires/clears alerts, returns
        per-objective status (also served at ``/debug/slo``)."""
        now = self._clock()
        new_alerts: list[Alert] = []
        with self._mu:
            self._evals += 1
            status: dict[str, dict] = {}
            for o in self.objectives:
                fired_window = None
                detail: dict[str, Any] = {"kind": o.kind,
                                          "target": o.target,
                                          "budget": o.budget,
                                          "observed": self._observed[o.name]}
                pairs = []
                for (long_s, short_s, factor) in self.windows:
                    bl, fl, nl = self._burn(o, now, long_s)
                    bs, _fs, ns = self._burn(o, now, short_s)
                    pairs.append({"long_s": long_s, "short_s": short_s,
                                  "factor": factor,
                                  "burn_long": round(bl, 3),
                                  "burn_short": round(bs, 3),
                                  "events_long": nl})
                    if (fired_window is None and nl >= self.min_events
                            and ns >= 1 and bl >= factor
                            and bs >= factor):
                        fired_window = ((long_s, short_s, factor),
                                        bl, bs, fl)
                detail["windows"] = pairs
                firing = fired_window is not None
                if firing and not self._firing[o.name]:
                    win, bl, bs, fl = fired_window
                    trace_ids = []
                    if self.tracer is not None:
                        trace_ids = [r.get("trace_id")
                                     for r in self.tracer.flight()
                                     if r.get("trace_id")]
                    prov = dict(self._noted)
                    if self._provenance is not None:
                        try:
                            prov.update(self._provenance())
                        except Exception:
                            pass
                    new_alerts.append(Alert(
                        objective=o.name, kind=o.kind, t_wall=time.time(),
                        window=win, burn_long=bl, burn_short=bs,
                        bad_frac_long=fl, budget=o.budget,
                        trace_ids=trace_ids, provenance=prov))
                self._firing[o.name] = firing
                detail["firing"] = firing
                status[o.name] = detail
            self._alerts.extend(new_alerts)
        return status

    # -- inspection --------------------------------------------------------
    def state(self) -> str:
        """Compact serve-time state: ``"ok"`` or ``"firing:a,b"`` —
        cheap enough to stamp on every wide event."""
        with self._mu:
            firing = [n for n, f in self._firing.items() if f]
        return "firing:" + ",".join(sorted(firing)) if firing else "ok"

    def alerts(self) -> list[Alert]:
        with self._mu:
            return list(self._alerts)

    def status(self) -> dict:
        """Full JSON-able status for ``/debug/slo`` and post-mortems."""
        snap = self.evaluate()
        with self._mu:
            return {"t_wall": time.time(),
                    "state": ("firing:" + ",".join(
                        sorted(n for n, f in self._firing.items() if f))
                        if any(self._firing.values()) else "ok"),
                    "evaluations": self._evals,
                    "objectives": snap,
                    "alerts": [a.to_dict() for a in self._alerts]}

    def stats(self) -> dict:
        with self._mu:
            return {"evaluations": self._evals,
                    "alerts": len(self._alerts),
                    "firing": sum(self._firing.values()),
                    "observed": dict(self._observed)}

    # -- background evaluation --------------------------------------------
    def start(self, interval_s: float = 5.0) -> None:
        """Evaluate on a daemon thread every ``interval_s``."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.evaluate()
                except Exception:  # pragma: no cover - never kill serving
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="slo-eval")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
