"""The port's router baselines against the JAX package's, on the CPU:
`rule_router`, `oracle` and `forest` (numpy copies, held bit for bit),
ridge (bit for bit), and the MLP rows of `baselines`, which train through
each package's `train_mlp` and are held to the MLP's tolerance.

The MLP rows seed their fits themselves, so the port's `init_mlp` is
patched to draw the JAX package's initial parameters (`jax.random`,
which torch cannot reproduce); the batch order is numpy's in both.

Every test draws its randomness from its own seeded generator."""

import itertools

import jax
import numpy as np
import pytest

from repro.ann.predicates import Predicate as JPred
from repro.core import baselines as jb
from repro.core import forest as jforest
from repro.core import mlp as jmlp
from repro.core import oracle as jor
from repro.core import training as JT
from repro.core.rule_router import RuleRouter as JRule
from repro_torch.ann.predicates import Predicate
from repro_torch.core import baselines as tb
from repro_torch.core import forest as tforest
from repro_torch.core import mlp as tmlp
from repro_torch.core import oracle as tor
from repro_torch.core import training as TT
from repro_torch.core.rule_router import RuleRouter as TRule

# The MLP rows: a fit from the reference's initial parameters and batch
# order agrees with it to fp32 rounding (tests/test_torch_training.py's
# PRED_TOL, 1e-4, for 200 epochs).
PRED_TOL = 1e-4


@pytest.fixture
def reference_init(monkeypatch):
    monkeypatch.setattr(
        tmlp, "init_mlp", lambda sizes, *, seed, device: tmlp.params_from_numpy(
            jmlp.params_to_numpy(jmlp.init_mlp(sizes, jax.random.PRNGKey(seed))),
            device))


def regression_data(seed, n=300, f=6, m=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=(f, m))
    y = (np.tanh(x @ w) * 0.5 + 0.5 + 0.05 * rng.normal(size=(n, m))
         ).astype(np.float32)
    return x, y


# ---- rule router, oracle ----------------------------------------------------

@pytest.mark.parametrize("lid_hi,card_lo", [(40.0, 100.0), (100.0, 100.0),
                                            (12.5, 30.0)])
def test_rule_router_decides_as_reference(lid_hi, card_lo):
    jr, tr = JRule(lid_hi, card_lo), TRule(lid_hi, card_lo)
    assert TRule() == TRule(40.0, 100.0)
    for pt, lid, card in itertools.product(
            range(3), (5.0, 12.5, 39.9, 40.0, 40.1, 150.0),
            (10.0, 29.9, 30.0, 99.0, 100.0, 1000.0)):
        assert tr.route(Predicate(pt), lid, card) == \
            jr.route(JPred(pt), lid, card), (pt, lid, card)
        assert tr.route(pt, lid, card) == tr.route(Predicate(pt), lid, card)


def _collections(seed):
    """The same cells' recall labels in both packages' `Collection`."""
    out = []
    for T in (JT, TT):
        cells = {}
        r = np.random.default_rng(seed)
        for ds, pt in itertools.product(("a", "b"), range(3)):
            q = int(r.integers(5, 30))
            rec = {m: r.choice([0.0, 0.3, 0.7, 0.9, 1.0], size=q)
                   for m in T.METHOD_ORDER}
            cells[(ds, pt)] = T.CellRecord(
                dataset=ds, pred=pt, numeric=np.zeros((q, 21), np.float32),
                recall=rec, best_ps={}, qvecs=None, qbms=None, gt=None,
                sweep=[])
        out.append(T.Collection(cells=cells, table=None))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_oracle_bit_for_bit(seed):
    jc, tc = _collections(seed)
    for ds, pt in jc.cells:
        for methods in (TT.METHOD_ORDER, ["sieve", "labelnav"]):
            a = tor.oracle_recall(tc, ds, pt, methods)
            b = jor.oracle_recall(jc, ds, pt, methods)
            assert a.tobytes() == b.tobytes() and a.dtype == b.dtype
            assert np.array_equal(tor.oracle_choice(tc, ds, pt, methods),
                                  jor.oracle_choice(jc, ds, pt, methods))
    assert TT.METHOD_ORDER == JT.METHOD_ORDER


# ---- forest ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["regression", "classification"])
@pytest.mark.parametrize("max_features", [None, 2])
def test_random_forest_bit_for_bit(kind, max_features):
    rng = np.random.default_rng(3 + (max_features or 0))
    x = rng.normal(size=(250, 5)).astype(np.float32)
    if kind == "regression":
        y = (x[:, 0] * 2 + np.sin(x[:, 1])).astype(np.float32)
    else:
        y = np.eye(3, dtype=np.float32)[(x[:, 0] > 0).astype(int)
                                        + (x[:, 2] > 1)]
    kw = dict(n_trees=6, max_depth=5, seed=7, max_features=max_features)
    a = tforest.RandomForest(**kw).fit(x, y)
    b = jforest.RandomForest(**kw).fit(x, y)
    assert a.feature_importances_.tobytes() == \
        b.feature_importances_.tobytes()
    for ta, tb_ in zip(a.trees, b.trees):
        for f in ("feature", "threshold", "left", "right", "value"):
            assert getattr(ta, f).tobytes() == getattr(tb_, f).tobytes()
    xq = rng.normal(size=(60, 5)).astype(np.float32)
    assert a.predict(xq).tobytes() == b.predict(xq).tobytes()


def test_fit_tree_and_predict_tree_bit_for_bit():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(120, 4)).astype(np.float32)
    y = (x[:, 1] > 0).astype(np.float32)
    imp_a, imp_b = np.zeros(4), np.zeros(4)
    ta = tforest.fit_tree(x, y, max_depth=4, importance=imp_a)
    tj = jforest.fit_tree(x, y, max_depth=4, importance=imp_b)
    assert imp_a.tobytes() == imp_b.tobytes()
    assert tforest.predict_tree(ta, x).tobytes() == \
        jforest.predict_tree(tj, x).tobytes()
    assert tforest._best_split(x, y[:, None], range(4), 12, 8) == \
        jforest._best_split(x, y[:, None], range(4), 12, 8)


# ---- regressors -----------------------------------------------------------------

@pytest.mark.parametrize("lam", [1e-2, 1.0])
def test_ridge_bit_for_bit(lam):
    x, y = regression_data(8)
    w = tb.ridge_fit(x, y[:, 0], lam)
    assert w.tobytes() == jb.ridge_fit(x, y[:, 0], lam).tobytes()
    assert tb.ridge_predict(w, x).tobytes() == \
        jb.ridge_predict(w, x).tobytes()


@pytest.mark.parametrize("kind", ["ridge", "rf"])
def test_per_method_regressor_host_kinds_bit_for_bit(kind):
    x, y = regression_data(9)
    a = tb.PerMethodRegressor(kind, seed=2, device="cpu").fit(x, y)
    b = jb.PerMethodRegressor(kind, seed=2).fit(x, y)
    assert a.predict(x).tobytes() == b.predict(x).tobytes()


def test_per_method_regressor_mlp_within_tolerance(reference_init):
    x, y = regression_data(10, n=260)
    a = tb.PerMethodRegressor("mlp", seed=4, device="cpu").fit(x, y)
    b = jb.PerMethodRegressor("mlp", seed=4).fit(x, y)
    got, want = a.predict(x), b.predict(x)
    assert got.shape == want.shape == (260, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=PRED_TOL)


def test_unknown_kind_raises():
    x, y = regression_data(0, n=20)
    with pytest.raises(ValueError):
        tb.PerMethodRegressor("svm", device="cpu").fit(x, y)
    with pytest.raises(ValueError):
        tb.BestMethodClassifier("svm", 3, device="cpu").fit(x, y[:, 0])


# ---- classifiers ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["logistic", "mlp", "rf"])
def test_best_method_classifier_matches_reference(kind, reference_init):
    x, y = regression_data(12, n=280, m=4)
    best = y.argmax(1)
    a = tb.BestMethodClassifier(kind, 4, seed=1, device="cpu").fit(x, best)
    b = jb.BestMethodClassifier(kind, 4, seed=1).fit(x, best)
    got, want = a.predict(x), b.predict(x)
    if kind == "rf":
        assert np.array_equal(got, want)
        return
    logits = tmlp.predict(a.model, x)
    np.testing.assert_allclose(logits, np.asarray(jmlp.predict(b.model, x)),
                               rtol=0, atol=PRED_TOL)
    # decisions equal wherever the two largest logits are apart by more
    # than the tolerance
    top2 = np.sort(logits, 1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * PRED_TOL
    assert np.array_equal(got[clear], want[clear])
    if kind == "logistic":
        assert [l["w"].shape for l in tmlp.params_to_numpy(a.model)] == \
            [(6, 4)]                                   # hidden=()
