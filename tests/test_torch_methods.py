"""The port's six filtered-ANN methods on the CPU against the JAX
package's on one dataset: identical index arrays, identical ids,
distances to fp32 summation order. A JAX-built index round-trips through
`index_arrays`. Then the JAX package's method invariants
(`tests/test_methods.py`) on the port: results pass the predicate, no
duplicates, UNG's exact Equality, the empty-result query, recall that
does not fall with the search budget."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import bench as jbench
from repro.ann import topk as jtopk
from repro.ann.engine import run_chunked as j_run_chunked
from repro.ann.index import QueryBatch as JQB
from repro.ann.registry import all_methods as j_all
from repro.ann.registry import candidate_methods as j_candidates
from repro.ann.registry import get_method as j_get
from repro_torch.ann import bench as tbench
from repro_torch.ann import labels as tlb
from repro_torch.ann import topk as ttopk
from repro_torch.ann.dataset import QuerySet
from repro_torch.ann.engine import run_chunked as t_run_chunked
from repro_torch.ann.index import FilteredIndex
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.methods import PAPER_NAMES
from repro_torch.ann.predicates import PREDICATES, Predicate
from repro_torch.ann.registry import all_methods, candidate_methods
from repro_torch.ann.registry import get_method as t_get
from repro_torch.data.ann_synth import DatasetSpec, synthesize

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's
METHODS = ["prefilter", "labelnav", "postfilter", "sieve", "ivf_gamma",
           "fvamana"]
CANDIDATES = ["labelnav", "postfilter", "sieve", "ivf_gamma", "fvamana"]
# Scores are ‖v‖² − 2·q·v in fp32 from two matmul implementations whose
# sums run in different orders: they agree to a few ulps of the largest
# term, well inside rtol = atol = 1e-4 at these norms (‖v‖² ≲ 100).
RTOL = ATOL = 1e-4


@pytest.fixture(scope="module")
def tfx():
    fx = FilteredIndex(synthesize(DatasetSpec(*TINY)), device="cpu")
    yield fx
    fx.close()


@pytest.fixture(scope="module")
def batches(tiny_queries):
    return {int(p): (JQB(qs.vectors, qs.bitmaps, p, 10),
                     TQB(qs.vectors, qs.bitmaps, int(p), 10))
            for p, qs in tiny_queries.items()}


def test_registry_holds_the_ported_methods():
    """The reference's registry: the same names, order, candidate flags
    and param settings."""
    assert list(candidate_methods()) == list(j_candidates()) == CANDIDATES
    assert list(all_methods()) == list(j_all()) == METHODS
    from repro.ann.methods import PAPER_NAMES as J_PAPER_NAMES
    assert PAPER_NAMES == J_PAPER_NAMES
    for name in METHODS:
        t, j = t_get(name), j_get(name)
        assert [s.ps_id for s in t.param_settings()] == \
            [s.ps_id for s in j.param_settings()]
        assert [(s.build, s.search) for s in t.param_settings()] == \
            [(s.build, s.search) for s in j.param_settings()]


@pytest.mark.parametrize("name", ["postfilter", "ivf_gamma"])
def test_ivf_arrays_identical(name, tiny_index, tfx):
    build = t_get(name).param_settings()[0].build
    ja = j_get(name).index_arrays(tiny_index.get_index(name, build))
    ta = t_get(name).index_arrays(tfx.get_index(name, build))
    assert sorted(ja) == sorted(ta)
    for key in ja:
        assert ja[key].dtype == ta[key].dtype, key
        np.testing.assert_array_equal(ja[key], ta[key], err_msg=key)


@pytest.mark.parametrize("name", ["labelnav", "sieve", "fvamana"])
def test_index_arrays_identical(name, tiny_index, tfx):
    """Each build setting's index arrays equal the JAX package's (the
    fvamana graph from the host build of a CPU handle)."""
    for setting in t_get(name).param_settings():
        ja = j_get(name).index_arrays(
            tiny_index.get_index(name, setting.build))
        ta = t_get(name).index_arrays(tfx.get_index(name, setting.build))
        assert sorted(ja) == sorted(ta)
        for key in ja:
            assert np.asarray(ja[key]).dtype == np.asarray(ta[key]).dtype
            np.testing.assert_array_equal(ja[key], ta[key],
                                          err_msg=f"{setting.ps_id} {key}")


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("name", METHODS)
def test_method_matches_reference(name, pred, tiny_index, tfx, batches):
    jb, tb = batches[pred]
    for setting in t_get(name).param_settings():
        jids, jraw = tiny_index.run_method(j_get(name), setting, jb)
        tids, traw = tfx.run_method(name, setting, tb)
        np.testing.assert_array_equal(tids, jids, err_msg=setting.ps_id)
        np.testing.assert_array_equal(np.isfinite(traw), np.isfinite(jraw))
        fin = np.isfinite(jraw)
        np.testing.assert_allclose(traw[fin], jraw[fin], rtol=RTOL,
                                   atol=ATOL)
    jr = tiny_index.search(jb, name)
    tr = tfx.search(tb, name)
    np.testing.assert_array_equal(tr.ids, jr.ids)
    np.testing.assert_array_equal(tr.keys, jr.keys)
    np.testing.assert_allclose(tr.distances, jr.distances, rtol=RTOL,
                               atol=ATOL, equal_nan=True)


@pytest.mark.parametrize("name", CANDIDATES)
def test_jax_built_index_round_trips(name, tiny_index, tfx, batches):
    setting = t_get(name).param_settings()[1]
    arrays = j_get(name).index_arrays(
        tiny_index.get_index(name, setting.build))
    index = t_get(name).index_from_arrays(tfx.ds, setting.build_dict,
                                          arrays)
    _, tb = batches[1]
    ids, _ = t_get(name).search(tfx, index, tb.vectors, tb.bitmaps, tb.pred,
                                tb.k, setting.search_dict)
    jids, _ = tiny_index.run_method(j_get(name), setting, batches[1][0])
    np.testing.assert_array_equal(ids, jids)
    again = t_get(name).index_arrays(index)
    for key in arrays:
        np.testing.assert_array_equal(again[key], arrays[key])


def test_bench_run_method_recall_matches(tiny_index, tfx, tiny_queries):
    qs = tiny_queries[2]
    for name in ("postfilter", "ivf_gamma"):
        setting = t_get(name).param_settings()[0]
        jr = jbench.run_method(tiny_index, j_get(name), setting, qs)
        tr = tbench.run_method(tfx, t_get(name), setting, qs)
        np.testing.assert_array_equal(tr.ids, jr.ids)
        np.testing.assert_array_equal(tr.recall_per_query,
                                      jr.recall_per_query)
        assert (tr.dataset, tr.pred, tr.method, tr.ps_id) == \
            (jr.dataset, jr.pred, jr.method, jr.ps_id)


def test_topk_ids_ties_match_reference():
    """Heavy ties go to the lowest position in both packages. Scores avoid
    zero: `jax.lax.top_k` ranks -0.0 before +0.0 where the port's stable
    sort keeps them in position order (the methods' scores ‖v‖² − 2·q·v
    are never -0.0, so no search result is affected)."""
    rng = np.random.default_rng(4)
    scores = (np.round(rng.normal(size=(6, 40)), 1) + 0.05).astype(
        np.float32)
    ids = rng.integers(-1, 50, (6, 40)).astype(np.int32)
    valid = rng.random((6, 40)) < 0.7
    for k in (5, 40, 45):
        ti, ts = ttopk.topk_ids(torch.from_numpy(scores),
                                torch.from_numpy(ids), k,
                                valid=torch.from_numpy(valid))
        ji, js = jtopk.topk_ids(jnp.asarray(scores), jnp.asarray(ids),
                                min(k, 40), valid=jnp.asarray(valid))
        np.testing.assert_array_equal(ti.numpy()[:, :40], np.asarray(ji))
        np.testing.assert_array_equal(ts.numpy()[:, :40], np.asarray(js))
        assert (ti.numpy()[:, 40:] == -1).all()


def test_run_chunked_pads_like_reference():
    x = np.arange(23 * 3, dtype=np.float32).reshape(23, 3)

    def fn(a):
        return a * 2, a.sum(1)

    for chunk in (4, 8, 64):
        t = t_run_chunked(fn, 23, x, chunk=chunk)
        j = j_run_chunked(fn, 23, x, chunk=chunk)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# the JAX package's method invariants (tests/test_methods.py) on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CANDIDATES)
@pytest.mark.parametrize("pred", PREDICATES)
def test_results_satisfy_predicate(tfx, tiny_queries, name, pred):
    """Every returned id satisfies the query predicate (no false hits)."""
    m = t_get(name)
    qs = tiny_queries[pred]
    r = tbench.run_method(tfx, m, m.param_settings()[-1], qs)
    for qi in range(qs.q):
        mask = tfx.ds.matching_mask(qs.bitmaps[qi], pred)
        ids = r.ids[qi][r.ids[qi] >= 0]
        assert mask[ids].all(), (name, pred, qi)


@pytest.mark.parametrize("name", CANDIDATES)
def test_no_duplicate_results(tfx, tiny_queries, name):
    m = t_get(name)
    qs = tiny_queries[Predicate.OR]
    r = tbench.run_method(tfx, m, m.param_settings()[-1], qs)
    for qi in range(qs.q):
        ids = r.ids[qi][r.ids[qi] >= 0]
        assert len(ids) == len(set(ids.tolist())), (name, qi)


def test_labelnav_equality_exact(tfx, tiny_queries):
    """The UNG analogue is exact on Equality (its structural sweet spot)."""
    m = t_get("labelnav")
    r = tbench.run_method(tfx, m, m.param_settings()[0],
                          tiny_queries[Predicate.EQUALITY])
    assert r.mean_recall == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["postfilter", "ivf_gamma", "fvamana"])
def test_param_settings_monotone_recall(tfx, tiny_queries, name):
    """Bigger search budgets do not reduce recall materially, with the
    JAX package's 0.05 margin."""
    qs = tiny_queries[Predicate.AND]
    m = t_get(name)
    settings = m.param_settings()
    lo = tbench.run_method(tfx, m, settings[0], qs).mean_recall
    hi = tbench.run_method(tfx, m, settings[-1], qs).mean_recall
    assert hi >= lo - 0.05, (name, lo, hi)


def test_empty_result_query(tfx):
    """A label set absent from the dataset gives zero Equality matches:
    −1 ids, +inf scores, vacuous recall 1."""
    qbm = tlb.pack_one([0, 1, 2, 3, 4, 5, 6, 7], tfx.ds.universe)[None, :]
    assert tfx.ds.group_id_of_bitmap(qbm[0]) < 0
    qs = QuerySet(dataset="tiny", pred=Predicate.EQUALITY,
                  vectors=tfx.ds.vectors[:1].copy(), bitmaps=qbm,
                  ground_truth=np.full((1, 10), -1, np.int32), k=10)
    m = t_get("labelnav")
    r = tbench.run_method(tfx, m, m.param_settings()[0], qs)
    assert (r.ids == -1).all()
    assert np.isinf(r.dists).all()
    assert r.mean_recall == pytest.approx(1.0)
