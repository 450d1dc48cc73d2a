"""The port's filtered-ANN methods (Pre-filter, Post-filter, IVF-γ) on
the CPU against the JAX package's on one dataset: identical IVF arrays,
identical ids, distances to fp32 summation order. A JAX-built index
round-trips through `index_arrays`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import bench as jbench
from repro.ann import topk as jtopk
from repro.ann.engine import run_chunked as j_run_chunked
from repro.ann.index import QueryBatch as JQB
from repro.ann.registry import get_method as j_get
from repro_torch.ann import bench as tbench
from repro_torch.ann import topk as ttopk
from repro_torch.ann.engine import run_chunked as t_run_chunked
from repro_torch.ann.index import FilteredIndex
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.registry import candidate_methods, get_method as t_get
from repro_torch.data.ann_synth import DatasetSpec, synthesize

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's
METHODS = ["prefilter", "postfilter", "ivf_gamma"]
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
    assert list(candidate_methods()) == ["postfilter", "ivf_gamma"]
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


@pytest.mark.parametrize("name", ["postfilter", "ivf_gamma"])
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
