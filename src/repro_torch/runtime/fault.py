"""Fault-tolerance runtime: straggler detection and preemption handling,
the JAX package's `runtime/fault.py` on one device.

  * `StepMonitor` — rolling-median step-time watchdog. A step exceeding
    `factor ×` median (or `deadline_s`) is recorded as a straggler event;
    after `escalate_after` consecutive events the monitor recommends
    checkpoint-and-reschedule.
  * `PreemptionHandler` — converts SIGTERM/SIGUSR1 into a checked flag so
    the loop checkpoints and exits cleanly at the next step boundary.
"""

from __future__ import annotations

import signal
import time
from collections import deque


class StepMonitor:
    def __init__(self, *, factor: float = 3.0, window: int = 32,
                 escalate_after: int = 3, deadline_s: float | None = None):
        self.factor = factor
        self.window: deque = deque(maxlen=window)
        self.escalate_after = escalate_after
        self.deadline_s = deadline_s
        self.straggler_events = 0
        self.consecutive = 0
        self._t0 = None

    def start_step(self) -> None:
        self._t0 = time.perf_counter()

    def end_step(self) -> dict:
        dt = time.perf_counter() - self._t0
        med = sorted(self.window)[len(self.window) // 2] if self.window else dt
        straggler = bool(self.window) and (
            dt > self.factor * med or
            (self.deadline_s is not None and dt > self.deadline_s))
        self.window.append(dt)
        if straggler:
            self.straggler_events += 1
            self.consecutive += 1
        else:
            self.consecutive = 0
        return {"step_time_s": dt, "median_s": med, "straggler": straggler,
                "escalate": self.consecutive >= self.escalate_after}


class PreemptionHandler:
    """Installs its handler for `signals` (from the main thread) and keeps
    the previous ones for `restore()`."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGUSR1)):
        self.requested = False
        self._previous = {}
        for sig in signals:
            self._previous[sig] = signal.signal(sig, self._handle)

    def _handle(self, signum, frame):
        self.requested = True

    def restore(self) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
