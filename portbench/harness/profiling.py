"""Reduce a `torch.profiler` session over a stretch of the window.

The stretch is the host range `WINDOW_RANGE`, opened just after the
profiler starts and closed just before it stops; everything is read in
the profiler's own time base.

* busy: the union of the device's activity intervals (kernels, copies,
  fills) inside the stretch;
* the device time inside each named host range (`record_function`):
  the device activity whose launch (the runtime call with the same
  correlation id: `cudaLaunchKernel`, `cuLaunchKernel`, a copy or a
  fill) the host made inside it, whichever op or library made it;
* the device's operations that took most time;
* the idle gaps, each named by what the host was doing at its middle:
  the innermost span range (`span:<name>`) and the innermost host op.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

WINDOW_RANGE = "portbench.window"
SPAN_PREFIX = "span:"
TOP = 10


@dataclasses.dataclass
class DeviceProfile:
    window_s: float
    busy_s: float
    range_device_s: dict          # range name -> device seconds inside
    device_ops: list              # [[name, seconds], ...] most first
    idle_gaps: list               # [[host activity, seconds], ...]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


@dataclasses.dataclass
class Event:
    name: str
    start: float        # microseconds, the profiler's time base
    end: float
    thread: int = 0
    corr: int = -1      # a runtime call's or a device activity's
                        # correlation id (-1: none)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(host: list, device: list,
                  range_names=()) -> DeviceProfile | None:
    """Reduce host events (with the device time of the kernels each
    launched) and device events. None where the stretch has no range or
    the device recorded nothing."""
    win = [e for e in host if e.name == WINDOW_RANGE]
    if not win or not device:
        return None
    w0, w1 = win[0].start, win[0].end
    dev = [(max(e.start, w0), min(e.end, w1), e.name) for e in device
           if e.end > w0 and e.start < w1]
    merged = _merge([(s, e) for s, e, _ in dev if e > s])
    busy = sum(e - s for s, e in merged)
    by_op = defaultdict(float)
    for s, e, name in dev:
        by_op[name] += e - s
    device_ops = [[n, us / 1e6] for n, us in
                  sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]]

    # device time inside each named range: the activity launched from
    # inside it on its thread
    launch = {e.corr: (e.thread, e.start) for e in host
              if e.corr >= 0 and e.name.startswith("cu")}
    ranges = defaultdict(list)
    for r in host:
        if r.name in range_names and r.start >= w0 and r.end <= w1:
            ranges[r.name].append((r.thread, r.start, r.end))
    range_s = defaultdict(float)
    for name, rs in ranges.items():
        rs.sort()
        keys = [(t, s) for t, s, _ in rs]
        for e in device:
            at = launch.get(e.corr)
            if at is None:
                continue
            j = bisect.bisect_right(keys, at) - 1
            if j >= 0 and rs[j][0] == at[0] and at[1] <= rs[j][2]:
                range_s[name] += (e.end - e.start) / 1e6

    # idle gaps, by the host's activity at their middle
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    ops = sorted((e.start, e.end, e.name) for e in host
                 if e.name != WINDOW_RANGE and e.end > e.start)
    by_host = defaultdict(float)
    active, nxt = [], 0
    for g0, g1 in gaps:                       # in time order: one sweep
        mid = 0.5 * (g0 + g1)
        while nxt < len(ops) and ops[nxt][0] <= mid:
            active.append(ops[nxt])
            nxt += 1
        active = [o for o in active if o[1] >= mid]
        spans = [o for o in active if o[2].startswith(SPAN_PREFIX)]
        plain = [o for o in active if not o[2].startswith(SPAN_PREFIX)]
        parts = []
        if spans:
            parts.append(min(spans, key=lambda o: o[1] - o[0])[2][
                len(SPAN_PREFIX):])
        if plain:
            parts.append(min(plain, key=lambda o: o[1] - o[0])[2])
        by_host[" > ".join(parts) or "python"] += (g1 - g0) / 1e6
    idle_gaps = [[n, s] for n, s in
                 sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]]
    return DeviceProfile(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6,
                         range_device_s=dict(range_s),
                         device_ops=device_ops, idle_gaps=idle_gaps)


def from_profiler(prof, range_names=()) -> DeviceProfile | None:
    """Reduce a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CPU:
            if not e.is_async:
                host.append(Event(e.name, tr.start, tr.end, int(e.thread),
                                  int(e.id)))
        elif not getattr(e, "is_user_annotation", False):
            device.append(Event(e.name, tr.start, tr.end, corr=int(e.id)))
    return reduce_events(host, device, range_names)
