"""A cell, a traffic mix, an entry, an op and a per-layer metric that
the harness has never seen, added as files of a checkout and entries
of its BENCHMARK.json, run through the harness and the control with no
harness file edited (a tiny size on the CPU)."""

import copy
import json
import os
import shutil
import time

import pytest

from portbench.harness import cell as cell_mod
from portbench.harness.control import control_numbers

PB = os.path.dirname(os.path.abspath(__file__))

ENTRY = '''
import time


class Dummy:
    probes = ()

    def __init__(self, ctx):
        from repro_torch.kernels import ops
        self.ops, self.out = ops, {}

    def listen(self, probe):
        pass

    def attach_tracer(self, tracer):
        pass

    def warm(self, pred, qv, qb):
        self.ops.dummy_op(qv)

    def serve(self, i, pred, qv, qb):
        t0 = time.perf_counter()
        self.out[i] = self.ops.dummy_op(qv)
        time.sleep(0.002)
        return {"search_s": time.perf_counter() - t0}

    def close(self):
        pass

    def judge(self, ref, pool, seed, limits):
        wrong = sum(int(n != pool.get(i)[1].shape[0])
                    for i, n in self.out.items())
        return {"wrong": wrong}, {"failed": wrong}


def setup(ctx):
    return Dummy(ctx)


def control(ctl):
    k = int(ctl.cell.traffic["k"])
    answered = 0
    for i in range(ctl.n_batches):
        pred, qv, qb = ctl.pool.get(i)
        ids, d, counts = ctl.answers(pred, qv, qb)
        answered += int(ids.shape == (qv.shape[0], k) == d.shape)
    return {"wrong": answered}
'''

METRIC = '''
UNIT = "queries"
OP = "dummy_op"


def record(args, kwargs, out):
    return out


def least_seconds(records, peaks):
    return float(sum(records))


def read(run):
    return run.least_s.get("dummy_op_queries")
'''


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    """A checkout holding only the new cell's files and the metric
    readers; the op added to the program's ops module. The pool holds
    every batch the window serves (a batch drawn late on a loaded CPU
    can outlast the profiled stretch)."""
    from repro_torch.kernels import ops

    monkeypatch.setattr(ops, "dummy_op", lambda qv: qv.shape[0],
                        raising=False)
    pb = tmp_path / "portbench"
    shutil.copytree(os.path.join(PB, "metrics"), pb / "metrics")
    for d in ("configs", "traffic", "entries", "limits"):
        (pb / d).mkdir()
    with open(os.path.join(PB, "configs", "synth192d-1m.json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["data"]["n"] = 1200
    (pb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "dummy-mix.json").write_text(json.dumps({
        "entry": "dummy", "batch": 16, "k": 10,
        "predicates": ["EQUALITY", "AND", "OR"], "pool_mb": 4,
        "profile_s": 0.2}))
    (pb / "entries" / "dummy.py").write_text(ENTRY)
    (pb / "metrics" / "dummy_op_queries.py").write_text(METRIC)
    (pb / "limits" / "tiny.dummy.json").write_text(
        json.dumps({"limits": {"wrong": 0}}))
    metric = {"unit": "s", "better": "lower", "bound": 0.25,
              "source": "host_clock"}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "tiny", "source": "a test",
                     "file": "portbench/configs/tiny.json", "reduced": []}],
        "workloads": [{"name": "tiny.dummy", "config": "tiny",
                       "traffic": "dummy-mix", "chips": 1}],
        "end_to_end": [dict(metric, name="qps"),
                       dict(metric, name="setup_s")],
        "per_layer": [{"name": "dummy_op_queries", "unit": "queries",
                       "better": "higher", "source": "program_counter",
                       "layer": "Kernels", "moves": "qps",
                       "workloads": ["tiny.dummy"]}]}))
    return str(tmp_path)


@pytest.mark.parametrize("trace", [False, True])
def test_a_new_cell_runs_without_a_harness_edit(checkout, trace):
    cell = cell_mod.load_cell(checkout, "tiny.dummy")
    result, checks, ok = cell_mod.run(cell, 5, 0.6, trace, "cpu",
                                      time.perf_counter(),
                                      log=lambda m: None)
    assert ok and checks == {"wrong": {"value": 0, "limit": 0}}
    if trace:
        n = result["metrics"]["dummy_op_queries"]["value"]
        assert n > 0 and n % 16 == 0
        assert result["device"]["batch_ms_profiled"] > 0
    else:
        assert set(result["metrics"]) == {"qps", "setup_s"}


def test_a_new_entrys_control_runs_without_a_harness_edit(checkout):
    cell = cell_mod.load_cell(checkout, "tiny.dummy")
    assert control_numbers(cell, 5, 4, "cpu") == {"wrong": 4}
