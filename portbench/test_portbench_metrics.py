"""Each metric reader on a synthetic run, and the reduction of a trace
to busy time, device time inside named ranges and idle gaps."""

import math
import os

import pytest

from portbench.harness import profiling
from portbench.harness.cell import Cell, RunRecord, load_module
from portbench.harness.probes import OP_RANGE
from repro_torch.ann.trace import Span

PB = os.path.dirname(os.path.abspath(__file__))


def _span(name, t0, t1, children=()):
    s = Span(name, t0=t0)
    s.t1 = t1
    s.children = list(children)
    return s


def _search(t0):
    """search 10 ms: route 3 ms, execute 6.5 ms with groups 2 + 3 ms."""
    return _span("search", t0, t0 + 0.010, [
        _span("route", t0, t0 + 0.003),
        _span("execute", t0 + 0.003, t0 + 0.0095, [
            _span("group", t0 + 0.003, t0 + 0.005),
            _span("group", t0 + 0.005, t0 + 0.008),
            _span("resolve_keys", t0 + 0.008, t0 + 0.009)])])


def _profile():
    return profiling.DeviceProfile(
        window_s=2.0, busy_s=1.5,
        range_device_s={OP_RANGE + "selectivity": 0.02,
                        OP_RANGE + "masked_topk": 0.5},
        device_ops=[], idle_gaps=[])


def _run(**kw):
    base = dict(
        cell=Cell("c", "cfg", {}, {}, 1, [], [], {}, PB),
        setup_s=12.5, window_s=4.0, latencies_s=[0.01 * i for i in range(1, 101)],
        batch_queries=[256] * 100, timings=[{"search_s": 0.02}] * 10,
        spans=[_search(0.0), _search(1.0)], profile=_profile(),
        least_s={"selectivity_roofline": 0.001,
                 "masked_topk_roofline": 0.05}, recall=0.93,
        device_name="NVIDIA H100 80GB HBM3", power_limit=None)
    base.update(kw)
    return RunRecord(**base)


@pytest.mark.parametrize("name, want", [
    ("qps", 6400.0),
    ("batch_p95_ms", 950.5),
    ("recall_at_10", 0.93),
    ("setup_s", 12.5),
    ("search_ms", 20.0),
    ("route_ms", 3.0),
    ("service_self_ms", 2.0),
    ("selectivity_roofline", 5.0),
    ("masked_topk_roofline", 10.0),
    ("device_idle", 25.0),
])
def test_reader(name, want):
    mod = load_module("metrics", name)
    assert math.isclose(mod.read(_run()), want, rel_tol=1e-9)
    assert isinstance(mod.UNIT, str) and 1 <= len(mod.UNIT) <= 16


@pytest.mark.parametrize("name", ["service_self_ms", "route_ms",
                                  "selectivity_roofline",
                                  "masked_topk_roofline", "device_idle",
                                  "recall_at_10", "search_ms"])
def test_reader_finds_nothing(name):
    run = _run(spans=None, profile=None, least_s={}, recall=None,
               timings=[])
    assert load_module("metrics", name).read(run) is None


def test_roofline_reads_nothing_without_device_time():
    prof = _profile()
    prof.range_device_s = {}
    run = _run(profile=prof)
    assert load_module("metrics", "selectivity_roofline").read(run) is None


def _ev(name, s, e, corr=-1):
    return profiling.Event(name, s, e, 1, corr)


def test_reduce_events():
    host = [
        _ev(profiling.WINDOW_RANGE, 0, 1000),
        _ev("span:route", 100, 400),
        _ev(OP_RANGE + "selectivity", 150, 300),
        _ev("cuLaunchKernel", 152, 155, corr=7),     # a library's launch
        _ev("aten::index", 160, 170),
        _ev("cudaLaunchKernel", 162, 165, corr=8),
        _ev("aten::mm", 500, 520),
        _ev("cudaLaunchKernel", 505, 510, corr=9),
        _ev("cudaStreamSynchronize", 700, 990),
    ]
    device = [
        profiling.Event("sel_kernel", 200, 220, corr=7),
        profiling.Event("index_kernel", 230, 280, corr=8),
        profiling.Event("gemm", 520, 620, corr=9),
        profiling.Event("late", 990, 1100, corr=10),  # clipped at the window
    ]
    p = profiling.reduce_events(host, device, [OP_RANGE + "selectivity"])
    assert p.window_s == pytest.approx(1000e-6)
    assert p.busy_s == pytest.approx(180e-6)
    assert p.idle_share == pytest.approx(0.82)
    assert p.range_device_s[OP_RANGE + "selectivity"] == pytest.approx(70e-6)
    assert p.device_ops[0] == ["gemm", pytest.approx(100e-6)]
    gaps = dict(p.idle_gaps)
    # 0-200 and 280-520: the host inside route, in no op of its own
    assert gaps["route"] == pytest.approx(440e-6)
    assert gaps["route > " + OP_RANGE + "selectivity"] == pytest.approx(10e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(370e-6)
    assert sum(gaps.values()) == pytest.approx(820e-6)


def test_reduce_events_without_device_or_window():
    host = [_ev(profiling.WINDOW_RANGE, 0, 10)]
    assert profiling.reduce_events(host, []) is None
    assert profiling.reduce_events([], [profiling.Event("k", 1, 2)]) is None
