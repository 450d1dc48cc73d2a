"""The whole slice on the CPU: `RouterService` in the port and in the JAX
package, over the same dataset and the same router artifact, routes every
query alike and returns the same ids; distances agree to fp32 summation
order."""

import jax
import numpy as np
import pytest

from repro.ann.index import QueryBatch as JQB
from repro.ann.service import RouterService as JService
from repro.core import features as jF
from repro.core import mlp as jmlp
from repro.core.router import MLRouter as JRouter
from repro.core.table import BenchmarkTable as JTable
from repro_torch.ann.index import FilteredIndex
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.service import RouterService as TService
from repro_torch.core.router import MLRouter as TRouter
from repro_torch.data.ann_synth import DatasetSpec, synthesize

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's
METHODS = ["postfilter", "ivf_gamma"]
RTOL = ATOL = 1e-4     # fp32 scores from two matmuls summing in two orders


@pytest.fixture(scope="module")
def services(tiny_index, tiny_ds, tiny_queries, tmp_path_factory):
    """One router (random MLP weights, a table in which both methods
    have settings on both sides of the thresholds), saved by the JAX
    package and loaded by each."""
    rand = np.random.default_rng(11)
    table = JTable.new()
    for pt in range(3):
        for name, ps_ids in (("postfilter", ("ef200", "ef800", "ef2000")),
                             ("ivf_gamma", ("g1", "g4", "g8"))):
            for ps in ps_ids:
                table.add(tiny_ds.name, pt, name, ps,
                          recall=float(rand.uniform(0.75, 1.0)),
                          qps=float(rand.uniform(100, 2000)))
    models = {m: jmlp.params_to_numpy(
        jmlp.init_mlp((5, 16, 8, 1), jax.random.PRNGKey(7 + j)))
        for j, m in enumerate(METHODS)}
    x = np.concatenate([jF.feature_matrix(tiny_ds, qs.bitmaps, p,
                                          jF.MINIMAL_FEATURES)
                        for p, qs in tiny_queries.items()])
    path = str(tmp_path_factory.mktemp("router") / "r")
    JRouter(feature_names=jF.MINIMAL_FEATURES, methods=METHODS,
            models=models, scaler=jmlp.Scaler.fit(x), table=table).save(path)
    tfx = FilteredIndex(synthesize(DatasetSpec(*TINY)), device="cpu")
    yield (JService(tiny_index, JRouter.load(path), t=0.9),
           TService(tfx, TRouter.load(path), t=0.9))
    tfx.close()


def _batches(qs, pred):
    return (JQB(qs.vectors, qs.bitmaps, pred, 10),
            TQB(qs.vectors, qs.bitmaps, pred, 10))


def _assert_same(jr, tr):
    assert [tuple(d) for d in tr.decisions] == \
        [tuple(d) for d in jr.decisions]
    np.testing.assert_array_equal(tr.ids, jr.ids)
    np.testing.assert_array_equal(tr.keys, jr.keys)
    np.testing.assert_allclose(tr.distances, jr.distances, rtol=RTOL,
                               atol=ATOL, equal_nan=True)
    assert {"route_s", "search_s", "total_s"} <= set(tr.timings)


@pytest.mark.parametrize("t", [0.85, 0.9, 0.97])
@pytest.mark.parametrize("pred", [0, 1, 2])
def test_search_routes_and_returns_alike(pred, t, services, tiny_queries):
    js, ts = services
    jb, tb = _batches(tiny_queries[pred], pred)
    jr, tr = js.search(jb, t=t), ts.search(tb, t=t)
    _assert_same(jr, tr)
    assert {m for m, _ in tr.decisions} <= set(METHODS)


def test_decisions_cover_both_methods(services, tiny_queries):
    """The comparison above exercises more than one execution group."""
    _, ts = services
    seen = set()
    for t in (0.85, 0.9, 0.97):
        for pred in range(3):
            seen |= set(ts.route(_batches(tiny_queries[pred], pred)[1], t=t))
    assert len(seen) >= 2 and {m for m, _ in seen} == set(METHODS)


@pytest.mark.parametrize("pred", [0, 1, 2])
def test_search_chunked_alike(pred, services, tiny_queries):
    js, ts = services
    jb, tb = _batches(tiny_queries[pred], pred)
    jr, tr = js.search_chunked(jb, chunk=8), ts.search_chunked(tb, chunk=8)
    _assert_same(jr, tr)
    np.testing.assert_array_equal(tr.ids, ts.search(tb).ids)


@pytest.mark.parametrize("pred", [0, 1, 2])
def test_explain_alike(pred, services, tiny_queries):
    js, ts = services
    jb, tb = _batches(tiny_queries[pred], pred)
    je, te = js.explain(jb), ts.explain(tb)
    assert len(je) == len(te) == tb.q
    for a, b in zip(je, te):
        assert (b.query, b.method, b.ps_id, b.passing, b.table_row,
                b.threshold) == (a.query, a.method, a.ps_id, a.passing,
                                 a.table_row, a.threshold)
        assert b.r_hat.keys() == a.r_hat.keys()
        np.testing.assert_allclose(list(b.r_hat.values()),
                                   list(a.r_hat.values()), rtol=0,
                                   atol=1e-6)
