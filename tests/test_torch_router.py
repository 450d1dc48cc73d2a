"""The port's routing stage against the JAX package's: the features are
bit-identical, one router artifact gives the same predicted recalls and
the same decisions in both packages whichever package saved it, and the
MLP parameters carry across through `params_from_numpy`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as jF
from repro.core import mlp as jmlp
from repro.core.router import MLRouter as JRouter
from repro.core.router import artifact_versions as j_versions
from repro.core.table import BenchmarkTable as JTable
from repro_torch.core import features as tF
from repro_torch.core import mlp as tmlp
from repro_torch.core.router import MLRouter as TRouter
from repro_torch.core.router import artifact_versions as t_versions
from repro_torch.data.ann_synth import DatasetSpec, synthesize

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's
METHODS = ["postfilter", "ivf_gamma"]
ASSET = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                     "assets", "router_ivf")


@pytest.fixture(scope="module")
def tds():
    return synthesize(DatasetSpec(*TINY))


def _table(ds_name, seed=5):
    rand = np.random.default_rng(seed)
    table = JTable.new()
    for pt in range(3):
        for name, ps_ids in (("postfilter", ("ef200", "ef800", "ef2000")),
                             ("ivf_gamma", ("g1", "g4", "g8"))):
            for ps in ps_ids:
                table.add(ds_name, pt, name, ps,
                          recall=float(rand.uniform(0.7, 1.0)),
                          qps=float(rand.uniform(100, 2000)))
    return table


@pytest.fixture(scope="module")
def jrouter(tiny_ds, tiny_queries):
    models = {m: jmlp.params_to_numpy(
        jmlp.init_mlp((5, 16, 8, 1), jax.random.PRNGKey(j)))
        for j, m in enumerate(METHODS)}
    return JRouter(feature_names=jF.MINIMAL_FEATURES, methods=METHODS,
                   models=models,
                   scaler=jmlp.Scaler.fit(np.concatenate([
                       jF.feature_matrix(tiny_ds, qs.bitmaps, p,
                                         jF.MINIMAL_FEATURES)
                       for p, qs in tiny_queries.items()])),
                   table=_table(tiny_ds.name))


def test_feature_lists_match():
    for name in ("QUERY_FEATURES", "DATASET_FEATURES", "ALL_FEATURES",
                 "MINIMAL_FEATURES"):
        assert getattr(tF, name) == getattr(jF, name)


def test_dataset_features_identical(tiny_ds, tds):
    jd, td = jF.dataset_features(tiny_ds), tF.dataset_features(tds)
    assert jd.values == td.values
    np.testing.assert_array_equal(jd.label_freq, td.label_freq)


@pytest.mark.parametrize("pred", [0, 1, 2])
def test_feature_matrix_bit_identical(pred, tiny_ds, tds, tiny_queries):
    qbms = tiny_queries[pred].bitmaps.copy()
    qbms[1] = 0                                  # an empty label set
    dsf_j = jF.dataset_features(tiny_ds)
    dsf_t = tF.dataset_features(tds)
    jq = jF.query_feature_arrays(tiny_ds, dsf_j, qbms, pred)
    tq = tF.query_feature_arrays(tds, dsf_t, qbms, pred)
    assert sorted(jq) == sorted(tq)
    for name in jq:
        a, b = np.asarray(jq[name]), np.asarray(tq[name])
        assert a.dtype == b.dtype == np.float64, name
        assert a.tobytes() == b.tobytes(), name
    for names in (jF.MINIMAL_FEATURES, jF.ALL_FEATURES):
        a = jF.feature_matrix(tiny_ds, qbms, pred, names)
        b = tF.feature_matrix(tds, qbms, pred, names)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_stacked_mlp_matches_jax_forward(jrouter):
    x = np.random.default_rng(0).normal(size=(17, 5)).astype(np.float32)
    net = tmlp.StackedMLP([jrouter.models[m] for m in METHODS],
                          device="cpu")
    got = net(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jmlp.forward_stacked(jrouter.stacked_params(),
                                           jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for m in METHODS:
        layers = tmlp.params_from_numpy(jrouter.models[m], "cpu")
        for tl, jl in zip(layers, jrouter.models[m]):
            assert tl["w"].dtype == torch.float32
            np.testing.assert_array_equal(tl["w"].numpy(), jl["w"])
            np.testing.assert_array_equal(tl["b"].numpy(), jl["b"])


def _same_routing(jr, tr, jds, tds, queries, t):
    for pred, qs in queries.items():
        a = jr.predict_recalls(jds, qs.bitmaps, pred)
        b = tr.predict_recalls(tds, qs.bitmaps, pred, device="cpu")
        assert a.shape == b.shape == (qs.q, len(METHODS))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        assert tr.route(tds, qs.bitmaps, pred, t, device="cpu") == \
            jr.route(jds, qs.bitmaps, pred, t)


@pytest.mark.parametrize("t", [0.8, 0.9, 0.95])
def test_router_saved_by_jax_loads_in_port(t, jrouter, tiny_ds, tds,
                                           tiny_queries, tmp_path):
    jrouter.save(str(tmp_path / "r"))
    tr = TRouter.load(str(tmp_path / "r"))
    assert tr.methods == METHODS
    assert t_versions(str(tmp_path / "r")) == j_versions(str(tmp_path / "r"))
    _same_routing(jrouter, tr, tiny_ds, tds, tiny_queries, t)


def test_router_saved_by_port_loads_in_jax(jrouter, tiny_ds, tds,
                                           tiny_queries, tmp_path):
    jrouter.save(str(tmp_path / "j"))
    TRouter.load(str(tmp_path / "j")).save(str(tmp_path / "t"))
    jr = JRouter.load(str(tmp_path / "t"))
    for name in ("router.json", "table.json"):
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes()
    _same_routing(jr, TRouter.load(str(tmp_path / "t")), tiny_ds, tds,
                  tiny_queries, 0.9)


def test_committed_artifact_routes_alike(tiny_ds, tds, tiny_queries):
    jr, tr = JRouter.load(ASSET), TRouter.load(ASSET)
    assert tr.methods == METHODS and tr.feature_names == \
        jF.MINIMAL_FEATURES
    assert t_versions(ASSET) == j_versions(ASSET)
    _same_routing(jr, tr, tiny_ds, tds, tiny_queries, 0.9)
    # a dataset the table covers: the table's own rows decide
    for pred in range(3):
        r_hat = np.random.default_rng(pred).uniform(0.5, 1.0, (40, 2))
        assert tr.route_from_predictions(r_hat, "laion", pred, 0.9) == \
            jr.route_from_predictions(r_hat, "laion", pred, 0.9)


def test_router_entry_points_default_to_the_card(jrouter, tds, monkeypatch):
    """Without a handle the MLPs run where `device=` says: "cuda" by
    default, which raises without a card instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = TRouter.load(ASSET)
    qbms = tds.bitmaps[:4]
    x = np.zeros((4, len(tr.scaler.mean)), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.predict_recalls(tds, qbms, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.predict_recalls_from_features(x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmlp.StackedMLP([jrouter.models[m] for m in METHODS])
    assert tr.predict_recalls(tds, qbms, 1, device="cpu").shape == \
        (4, len(tr.methods))
    assert tr.predict_recalls_from_features(x, device="cpu").shape == \
        (4, len(tr.methods))
