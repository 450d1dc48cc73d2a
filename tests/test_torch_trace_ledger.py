"""The port's `trace` and `ledger` modules against the JAX package's: the
same span, sampling, lease and gauge sequences through both give equal
trees, counters, histograms, exports, gauges and leak reports, modulo
clocks; and the store's own spans and WAL gauge come out alike from
both packages' `IndexStore`.

Every test draws its randomness from its own seeded generator."""

import json
import threading

import numpy as np
import pytest

from repro.ann import ledger as jledger
from repro.ann import trace as jtrace
from repro.ann.live import LiveFilteredIndex as JLive
from repro.ann.store import IndexStore as JStore
from repro.ann.store import WriteAheadLog as JWal
from repro_torch.ann import ledger as tledger
from repro_torch.ann import trace as ttrace
from repro_torch.ann.live import LiveFilteredIndex
from repro_torch.ann.store import IndexStore, WriteAheadLog
from repro_torch.data.ann_synth import DatasetSpec, synthesize

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's
MODS = {"torch": (ttrace, tledger), "repro": (jtrace, jledger)}
CLOCKS = {"t0_ms", "dur_ms", "age_s", "t_wall", "duration_ms", "ts", "dur",
          "span_p50_us"}


def unclocked(x):
    """`x` with every clock field dropped, recursively."""
    if isinstance(x, dict):
        return {k: unclocked(v) for k, v in x.items() if k not in CLOCKS}
    if isinstance(x, list):
        return [unclocked(v) for v in x]
    return x


def both(fn):
    """`fn(trace_module, ledger_module)` for each package, unclocked."""
    out = {pkg: unclocked(fn(*mods)) for pkg, mods in MODS.items()}
    assert out["torch"] == out["repro"]
    return out["torch"]


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

def _span_program(tr, _):
    """Nesting, attributes, annotate/count, an error, a thread hop."""
    tracer = tr.Tracer(slow_ms=None, sample=1.0, seed=7)
    with tracer.trace("request", batch=3) as root:
        with tr.span("route", q=3):
            tr.annotate(decisions=[["ivf_gamma", "p8"]])
            tr.count("groups")
            tr.count("groups", 2)
        with pytest.raises(KeyError):
            with tr.span("execute", method="prefilter"):
                raise KeyError("boom")
        parent = tr.current()

        def worker(j):
            with tr.attach(parent):
                with tr.span("shard", shard=j):
                    tr.annotate(rows=np.int64(10 * j))
        t = threading.Thread(target=worker, args=(0,))
        t.start()
        t.join()
        with tr.maybe_trace(tracer, "nested"):
            assert tr.trace_id() == root.trace_id
    assert tr.span("outside").__enter__() is None
    tr.annotate(ignored=True)
    return {"tree": root.to_dict(), "stats": tracer.stats(),
            "hist": sorted(tracer.histograms())}


def test_span_trees_equal_modulo_clocks():
    out = both(_span_program)
    tree = out["tree"]
    assert [c["name"] for c in tree["children"]] == [
        "route", "execute", "shard", "nested"]
    assert tree["children"][0]["attrs"] == {
        "q": 3, "decisions": [["ivf_gamma", "p8"]], "groups": 3}
    assert tree["children"][1]["error"] == "KeyError: 'boom'"
    assert out["stats"]["errors"] == 1       # a failed child keeps the tree


def test_tail_sampling_and_ids_equal_under_a_seed():
    def program(tr, _):
        tracer = tr.Tracer(slow_ms=5.0, sample=0.5, seed=3,
                           flight_capacity=4, recent_capacity=8)
        for i in range(40):
            root = tracer.start("req", i=i)
            if i % 9 == 0:
                root.child("slow", t0=root.t0, t1=root.t0 + 0.01)
                root.finish(root.t0 + 0.01)
            tracer.finish(root, error="bad" if i == 13 else None)
        return {"stats": tracer.stats(),
                "recent": [(r.name, r.attrs, r.trace_id)
                           for r in tracer.recent()],
                "flight": json.loads(tracer.dump_flight_json())}
    out = both(program)
    assert out["stats"]["slow"] == 5 and out["stats"]["errors"] == 1
    assert len(out["flight"]["flight"]) == 4


def test_histograms_and_buckets_equal():
    rng = np.random.default_rng(61)
    obs = rng.lognormal(3.0, 2.0, 500).tolist() + [0.0, 1.0, 2.0, 1e9]

    def program(tr, _):
        h = tr.LatencyHistogram()
        for us in obs:
            h.observe(us)
        return {"snap": {**h.snapshot(),
                         "bounds_us": [str(b) for b in tr.BUCKET_BOUNDS_US]},
                "q": [h.quantile_us(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
                "idx": [tr.bucket_index(us) for us in obs]}
    both(program)


def test_perfetto_export_identical_with_fixed_clocks():
    """Explicit span bounds (overlapping siblings on their own lanes):
    the two packages' Chrome-trace JSON is the same string."""
    def program(tr, _):
        root = tr.Span("batch", {"q": 8}, t0=10.0)
        root.trace_id = "t000001-00000000"
        a = root.child("shard", t0=10.001, t1=10.004, shard=0)
        root.child("shard", t0=10.002, t1=10.005, shard=1)
        a.child("kernel", t0=10.0015, t1=10.0035, k=10)
        root.child("merge", t0=10.005, t1=10.006)
        root.finish(10.007)
        return {"one": tr.perfetto_json(root),
                "many": tr.perfetto_json([root, root], indent=1),
                "none": tr.perfetto_json([])}
    out = {pkg: program(*mods) for pkg, mods in MODS.items()}
    assert out["torch"] == out["repro"]
    events = json.loads(out["torch"]["one"])["traceEvents"]
    assert len({e["tid"] for e in events if e["name"] == "shard"}) == 2


# ---------------------------------------------------------------------------
# ledger
# ---------------------------------------------------------------------------

def _acquire(led, *a, **kw):
    return led.acquire(*a, **kw)             # one call site for both


def _lease_program(tr, lg):
    led = lg.ResourceLedger(leak_age_s=30.0, stack_depth=2)
    tracer = tr.Tracer(slow_ms=None, seed=2)
    a = _acquire(led, "pin", "ds0", count=2, bytes=100)
    with tracer.trace("request"):
        b = _acquire(led, "pin", "ds1", count=1, bytes=50,
                     meta={"generation": 3})
    c = _acquire(led, "cache", "ds0", bytes=7)
    with _acquire(led, "pin", "scoped"):
        held = led.accounting()
    b.release()
    b.release()                               # idempotent
    out = {"held": held, "after": led.accounting(),
           "counters": led.counters(), "leaks_default": led.leaks(),
           "leaks": led.leaks(max_age_s=0.0)}
    a.release()
    c.release()
    out["final"] = led.accounting()
    return out


def test_lease_accounting_and_leak_reports_equal():
    out = both(_lease_program)
    assert out["counters"]["pin"] == {"acquired": 3, "released": 2}
    assert [lk["owner"] for lk in out["leaks"]] == ["ds0", "ds0"]
    assert out["leaks_default"] == [] and out["final"] == {}


def test_collectors_gauges_and_snapshot_equal():
    def program(tr, lg):
        led = lg.ResourceLedger(capture_stacks=False)
        led.register_collector("delta", lambda: {"rows": 5, "bytes": 640})
        led.register_collector("bad", lambda: 1 / 0)
        led.register_collector("gone", lambda: {"x": 1})
        led.deregister_collector("gone")
        _acquire(led, "pin", "ds0")
        snap = led.snapshot(leak_age_s=0.0)
        return {"gauges": led.gauges(), "snap": snap}
    out = both(program)
    assert out["gauges"]["delta"] == {"rows": 5.0, "bytes": 640.0}
    assert out["gauges"]["bad"]["error"] == 1.0
    assert out["snap"]["collector_errors"] == {"bad": "division by zero"}


def test_scoped_ledger_isolates_and_restores():
    before = tledger.get_ledger()
    with tledger.scoped() as led:
        assert tledger.get_ledger() is led and led is not before
        _acquire(led, "pin", "x")
    assert tledger.get_ledger() is before
    mine = tledger.ResourceLedger()
    prev = tledger.set_ledger(mine)
    try:
        assert prev is before and tledger.get_ledger() is mine
    finally:
        tledger.set_ledger(prev)


# ---------------------------------------------------------------------------
# the store's spans and gauge
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tds():
    return synthesize(DatasetSpec(*TINY))


def test_store_spans_equal_across_packages(tmp_path, tiny_ds, tds):
    """`create`, an upsert, a delete and a checkpoint under a trace open
    the same `store.*` and `wal.*` spans, with the same attributes, in
    both packages."""
    def program(pkg):
        tr = MODS[pkg][0]
        tracer = tr.Tracer(slow_ms=None, seed=5)
        ds = tds if pkg == "torch" else tiny_ds
        live = (LiveFilteredIndex(ds, device="cpu") if pkg == "torch"
                else JLive(ds))
        store_cls = IndexStore if pkg == "torch" else JStore
        with tracer.trace("ops") as root:
            with store_cls.create(str(tmp_path / pkg), live) as st:
                ids = st.index.upsert(ds.vectors[:30] + np.float32(0.5),
                                      ds.bitmaps[:30])
                st.index.delete(ids[::4])
                st.checkpoint()
        return unclocked(root.to_dict())
    tree = program("torch")
    assert tree == program("repro")
    names = [c["name"] for c in tree["children"]]
    assert names == ["store.checkpoint", "wal.append", "wal.fsync",
                     "wal.append", "wal.fsync", "store.checkpoint"]
    ck = tree["children"][-1]["children"]
    assert [c["name"] for c in ck] == ["wal.append", "wal.append",
                                      "wal.fsync", "store.commit_manifest"]


def test_wal_backlog_gauges_equal_across_packages(tmp_path):
    def program(tr, lg):
        with lg.scoped() as led:
            smod = WriteAheadLog if lg is tledger else JWal
            wal = smod.create(str(tmp_path / f"{id(lg)}.log"), dim=4,
                              width=1, generation=0, sync_every=50)
            for i in range(3):
                wal.commit(wal.log_upsert(
                    0, np.array([i], np.int64),
                    np.full((1, 4), i, np.float32),
                    np.ones((1, 1), np.uint32)))
            wal.commit(wal.log_delete(0, np.array([0, 1], np.int64)))
            gauges = list(led.gauges().values())
            wal.close()
            return {"before": gauges, "after": led.gauges()}
    out = both(program)
    assert out["before"] == [{"records": 4.0,
                              "bytes": 3 * (21 + 4 + 8 + 16 + 4)
                              + 21 + 4 + 16}]
    assert out["after"] == {}
