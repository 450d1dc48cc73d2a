"""Each configuration's frozen table B: the program's router loads it,
it holds every (method, setting, predicate) of the router's candidates
for the configuration, it says where it was measured, and the
reference reads the same routing arrays from it as the program."""

import json
import os
import shutil
import types

import numpy as np
import pytest

from portbench.reference.router import Router as RefRouter
from repro_torch.ann import methods  # noqa: F401  (registers them)
from repro_torch.ann.registry import candidate_methods
from repro_torch.core.router import MLRouter

PB = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB)
ROUTER = os.path.join(ROOT, "src", "repro_torch", "assets", "router_all")
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CONFIGS = [c["name"] for c in json.load(_f)["configs"]]


def _table(name):
    return os.path.join(PB, "configs", f"{name}.tableB.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_router_loads_the_frozen_table(tmp_path, name):
    art = tmp_path / "router"
    shutil.copytree(ROUTER, art)
    shutil.copy(_table(name), art / "table.json")
    router = MLRouter.load(str(art))
    want = {(m, s.ps_id, p) for m, meth in candidate_methods().items()
            for s in meth.param_settings() for p in (0, 1, 2)}
    got = {(m, ps, p) for (d, p, m, ps) in router.table.entries
           if d == name}
    assert got == want
    assert set(router.methods) == set(candidate_methods())
    for v in router.table.entries.values():
        assert 0.0 <= v["recall"] <= 1.0 and v["qps"] > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_the_table_says_where_it_was_measured(name):
    with open(_table(name)) as f:
        frozen = json.load(f)["frozen"]
    assert frozen["device"].startswith("NVIDIA H100")
    assert frozen["commit"] and isinstance(frozen["seed"], int)
    with open(os.path.join(PB, "configs", f"{name}.json")) as f:
        assert frozen["data_seed"] == json.load(f)["data"]["seed"]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("pred", ["EQUALITY", "AND", "OR"])
def test_reference_reads_the_programs_routing_arrays(name, pred):
    router = MLRouter.load(ROUTER)
    from repro_torch.core.table import BenchmarkTable
    for (d, p, m, ps), v in BenchmarkTable.load(_table(name)).entries.items():
        router.table.add(d, p, m, ps, v["recall"], v["qps"])
    has, qps, ps_pass, ps_fb = router.table.routing_arrays(
        name, ("EQUALITY", "AND", "OR").index(pred), router.methods, 0.9)
    ref = RefRouter(ROUTER, _table(name)).table_arrays(name, pred, 0.9)
    assert [a[0] for a in ref] == list(has)
    np.testing.assert_array_equal([a[1] for a in ref], qps)
    assert [a[2] for a in ref] == list(ps_pass)
    assert [a[3] for a in ref] == list(ps_fb)


def _tiny_config(n=2000):
    with open(os.path.join(PB, "configs", "synth192d-1m.json")) as f:
        cfg = json.load(f)
    cfg["data"]["n"] = n
    return cfg


def test_the_sweep_scores_recall_against_the_reference(monkeypatch):
    """The recall column's ground truth is the reference's exact answer
    (as served row ids); the program's exact search is never asked."""
    from portbench.harness import freeze_tableb
    from portbench.harness import gen
    from portbench.harness.judge import Reference
    from portbench.reference.exact import exact_topk
    from repro_torch.ann import bench
    from repro_torch.ann.index import FilteredIndex

    seen = {}

    def run_method(fx, method, setting, qs):
        seen.setdefault(int(qs.pred), qs.ground_truth.copy())
        return types.SimpleNamespace(mean_recall=1.0, qps=1.0)

    def no_search(*a, **kw):
        raise AssertionError("the program's exact search was asked")

    monkeypatch.setattr(bench, "run_method", run_method)
    monkeypatch.setattr(FilteredIndex, "search", no_search)
    cfg = _tiny_config()
    table = freeze_tableb.sweep("synth192d-1m", cfg, 4, 32, "cpu",
                                log=lambda m: None)
    assert len(table["rows"]) == 48 and sorted(seen) == [0, 1, 2]

    spec = gen.DataSpec.from_config(cfg)
    data = gen.make_data(spec, int(cfg["data"]["seed"]), "cpu")
    pool = gen.QueryPool(data, 4, "tableB", 32, freeze_tableb.PREDS,
                         chunk=3)
    ref = Reference(data.vectors.numpy(),
                    data.bitmaps.numpy().view(np.uint32), "cpu")
    for i, p in enumerate(freeze_tableb.PREDS):
        _, qv, qb = pool.get(i)
        ids, _, _ = exact_topk(ref.vectors, ref.groups,
                               *ref.on_device(qv, qb), p, 10)
        np.testing.assert_array_equal(ref.to_drawn(seen[i]), ids)


def test_the_programs_exact_search_agrees_with_the_reference():
    """`--check-truth` at a tiny size: no query's top-k set differs."""
    from portbench.harness import freeze_tableb

    out = freeze_tableb.truth_check("synth192d-1m", _tiny_config(), 0, 64,
                                    "cpu")
    assert out == {p: {"differ": 0, "queries": 64}
                   for p in freeze_tableb.PREDS}
