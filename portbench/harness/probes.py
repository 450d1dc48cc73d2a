"""Hooks on the program, opened from the benchmark's side without
editing it: the kernel ops it calls through their module
(`repro_torch.kernels.ops.selectivity`, `ops.masked_topk`) and the
service's span function (`repro_torch.ann.trace.span`).

An op probe calls its listeners with each call's arguments and output,
and while `ranges` is on wraps the call in a `record_function` range
`portbench.op:<op>`; the span probe opens a range `span:<name>` (with
the group's method) around each span while on. Every probe is put back
by `close()`.
"""

from __future__ import annotations

import contextlib

OP_RANGE = "portbench.op:"


class OpProbe:
    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.listeners: list = []
        self.ranges = False
        self.range_name = OP_RANGE + name
        probe = self

        def wrapper(*args, **kwargs):
            if probe.ranges:
                from torch.autograd.profiler import record_function
                with record_function(probe.range_name):
                    out = probe.orig(*args, **kwargs)
            else:
                out = probe.orig(*args, **kwargs)
            for fn in probe.listeners:
                fn(args, kwargs, out)
            return out

        setattr(module, name, wrapper)

    def close(self) -> None:
        setattr(self.module, self.name, self.orig)


class SpanProbe:
    def __init__(self, trace_module):
        self.module = trace_module
        self.orig = trace_module.span
        self.ranges = False
        probe = self

        @contextlib.contextmanager
        def span(name, **attrs):
            if not probe.ranges:
                with probe.orig(name, **attrs) as s:
                    yield s
                return
            from torch.autograd.profiler import record_function
            label = f"span:{name}"
            if "method" in attrs:
                label += f"({attrs['method']})"
            with record_function(label), probe.orig(name, **attrs) as s:
                yield s

        trace_module.span = span

    def close(self) -> None:
        self.module.span = self.orig


class Probes:
    """The op probes by op name of one run, and in a traced run the span
    probe."""

    def __init__(self, ops_module, op_names, trace_module=None):
        self.ops = {n: OpProbe(ops_module, n) for n in op_names}
        self.span = None if trace_module is None else SpanProbe(
            trace_module)

    def set_ranges(self, on: bool) -> None:
        for p in self.ops.values():
            p.ranges = on
        if self.span is not None:
            self.span.ranges = on

    def range_names(self) -> list:
        return [p.range_name for p in self.ops.values()]

    def close(self) -> None:
        if self.span is not None:
            self.span.close()
        for p in self.ops.values():
            p.close()
