"""The port's offline stage against the JAX package's, on the CPU: the
dataset key and the default pool, `get_dataset`, `bench.sweep`, the MLP's
forward, losses, gradients, Adam step and fits, `collect` (features,
per-query recall labels, best settings, table B), `assemble_xy`, the
per-method fits and the routers they make, the shared router artifact,
and `build_all`'s cache.

The JAX package draws its initial weights with `jax.random`, which torch
cannot reproduce, so every fit compared here starts from the reference's
own initial parameters (`init=`, or `init_mlp` patched to the
reference's draw for the functions that seed their fits themselves); the
batch order is numpy's in both. `collect` picks each method's best
setting by (recall, QPS), and QPS is wall-clock time, so both packages'
`bench` modules read a fake clock here: every run takes one second, and
recall ties go to the first setting in both.

Every test draws its randomness from its own seeded generator."""

import dataclasses
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import bench as jbench
from repro.ann.index import FilteredIndex as JFX
from repro.ann.registry import candidate_methods as jcand
from repro.core import mlp as jmlp
from repro.core import training as JT
from repro.core.router import MLRouter as JRouter
from repro.data import ann_synth as jsynth
from repro.optim import AdamConfig, adam_init, adam_update
from repro_torch.ann import bench as tbench
from repro_torch.ann import index as tindex
from repro_torch.ann.index import FilteredIndex as TFX
from repro_torch.ann.live import LiveFilteredIndex as TLive
from repro_torch.ann.predicates import Predicate
from repro_torch.ann.registry import candidate_methods as tcand
from repro_torch.ann.sharded import ShardedFilteredIndex as TSharded
from repro_torch.core import features as tF
from repro_torch.core import mlp as tmlp
from repro_torch.core import training as TT
from repro_torch.core.router import MLRouter as TRouter
from repro_torch.data import ann_synth as tsynth

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's
NQ = 25

# A fit from the same initial parameters and batch order agrees with the
# JAX package's to fp32 rounding of the two libraries' matmuls and Adam
# arithmetic: 2e-6 on predictions of magnitude ~7 after 800 Adam steps
# on this CPU. PRED_TOL leaves room for that drift over the longest fit
# here; LOSS_RTOL holds one epoch's mean loss.
PRED_TOL = 1e-4
LOSS_RTOL = 1e-5


class FakeClock:
    """`time` for both `bench` modules: every call is one second later,
    so every timed run takes one second."""

    def __init__(self):
        self.t = itertools.count()

    def perf_counter(self):
        return float(next(self.t))


def j_init(sizes, seed):
    """The JAX package's initial parameters for `train_mlp(seed=seed)`,
    as numpy layer dicts."""
    return jmlp.params_to_numpy(jmlp.init_mlp(sizes, jax.random.PRNGKey(seed)))


def use_reference_init(monkeypatch):
    """Make the port's `init_mlp` draw the reference's parameters."""
    monkeypatch.setattr(
        tmlp, "init_mlp", lambda sizes, *, seed, device: tmlp.params_from_numpy(
            j_init(sizes, seed), device))


@pytest.fixture(scope="module")
def dss():
    return (jsynth.synthesize(jsynth.DatasetSpec(*TINY)),
            tsynth.synthesize(tsynth.DatasetSpec(*TINY)))


@pytest.fixture(scope="module")
def colls(dss):
    """`collect` over the tiny spec in both packages, on the fake clock."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jbench, "time", FakeClock())
        mp.setattr(tbench, "time", FakeClock())
        jds, tds = dss
        with JFX(jds) as jfx, TFX(tds, device="cpu") as tfx:
            jc = JT.collect({"tiny": jfx}, n_queries=NQ, seed=0,
                            verbose=False)
            tc = TT.collect({"tiny": tfx}, n_queries=NQ, seed=0,
                            verbose=False)
    finally:
        mp.undo()
    return jc, tc


# ---- inputs from ported modules ---------------------------------------------

def test_cache_key_same_in_both_packages(dss):
    jds, tds = dss
    assert tds.cache_key() == jds.cache_key()
    assert tds.cache_key() is tds.cache_key()          # memoised
    other = tsynth.synthesize(tsynth.DatasetSpec(*TINY[:-1], 8))
    assert other.cache_key() != tds.cache_key()


def test_default_pool_by_dataset_and_device(dss, monkeypatch):
    _, tds = dss
    monkeypatch.setattr(tindex, "_POOL", {})
    fx = tindex.default_index(tds, device="cpu")
    assert fx.torch_device.type == "cpu"
    assert tindex.default_index(tds, "cpu") is fx
    assert tindex.as_index(tds, device="cpu") is fx
    copy = tsynth.synthesize(tsynth.DatasetSpec(*TINY))  # same content
    assert tindex.as_index(copy, device="cpu") is fx
    fx.close()
    fx2 = tindex.default_index(tds, "cpu")
    assert fx2 is not fx and not fx2.closed
    tindex.clear_pool()
    assert fx2.closed and tindex._POOL == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tindex.default_index(tds)


def test_as_index_passes_handles_through(dss):
    _, tds = dss
    for h in (TFX(tds, device="cpu"), TLive(tds, device="cpu"),
              TSharded(tds, 2, device="cpu")):
        try:
            assert tindex.as_index(h) is h
            assert tindex.as_index(h, device="cuda") is h
        finally:
            h.close()


def test_get_dataset_arrays_identical():
    name = "ytb_video"                     # the smallest training spec
    j, t = jsynth.get_dataset(name), tsynth.get_dataset(name)
    assert tsynth.get_dataset(name) is t
    for f in ("vectors", "bitmaps", "group_of", "group_bitmaps",
              "group_start", "group_size", "norms_sq"):
        assert getattr(t, f).tobytes() == getattr(j, f).tobytes(), f
    assert (t.name, t.universe) == (j.name, j.universe)
    assert t.cache_key() == j.cache_key()


@pytest.mark.parametrize("pred", [Predicate.EQUALITY, Predicate.AND,
                                  Predicate.OR])
def test_bench_sweep_matches_reference(dss, pred, monkeypatch):
    jds, tds = dss
    qs = tsynth.make_queries(tds, pred, 16, seed=4)
    monkeypatch.setattr(tindex, "_POOL", {})
    with JFX(jds) as jfx:
        want = jbench.sweep(jfx, jcand(), qs)
    got = tbench.sweep(tds, tcand(), qs, device="cpu")   # a bare dataset
    tindex.clear_pool()
    assert [(r.method, r.ps_id) for r in got] == \
        [(r.method, r.ps_id) for r in want]
    for g, w in zip(got, want):
        assert np.array_equal(g.ids, w.ids), (g.method, g.ps_id)
        assert np.array_equal(g.recall_per_query, w.recall_per_query)
        assert g.mean_recall == w.mean_recall


# ---- the MLP ----------------------------------------------------------------

@pytest.mark.parametrize("hidden", [(64, 32), (16,), ()])
@pytest.mark.parametrize("classification", [False, True])
def test_forward_loss_and_grads_match_jax(hidden, classification):
    rng = np.random.default_rng(len(hidden) * 2 + classification)
    n_out = 4 if classification else 1
    x = rng.normal(size=(40, 5)).astype(np.float32)
    y = (rng.integers(0, n_out, 40) if classification
         else rng.normal(size=40).astype(np.float32))
    init = j_init((5,) + hidden + (n_out,), 3)
    jp = jmlp.params_from_numpy(init)
    jloss = jmlp._ce_loss if classification else jmlp._mse_loss
    jl, jg = jax.value_and_grad(jloss)(
        jp, jnp.asarray(x), jnp.asarray(y.astype(
            np.int32 if classification else np.float32)))
    tp = tmlp.params_from_numpy(init, "cpu")
    leaves = [v.requires_grad_(True) for p in tp for v in p.values()]
    tloss = tmlp._ce_loss if classification else tmlp._mse_loss
    yt = torch.from_numpy(y.astype(np.int64) if classification else y)
    tl = tloss(tp, torch.from_numpy(x), yt)
    tg = iter(torch.autograd.grad(tl, leaves))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6, atol=0)
    for layer, jlayer in zip(tp, jg):
        for k in layer:
            np.testing.assert_allclose(next(tg).numpy(),
                                       np.asarray(jlayer[k]), rtol=1e-5,
                                       atol=1e-6)
    np.testing.assert_allclose(
        tmlp.forward(tp, torch.from_numpy(x)).detach().numpy(),
        np.asarray(jmlp.forward(jp, jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_adam_steps_match_reference():
    rng = np.random.default_rng(11)
    init = j_init((6, 8, 1), 0)
    cfg = AdamConfig(lr=1e-3)
    jp = jmlp.params_from_numpy(init)
    jstate = adam_init(jp, cfg)
    tp = tmlp.params_from_numpy(init, "cpu")
    tstate = tmlp._adam_init(tp)
    for _ in range(3):
        grads = [{k: rng.normal(size=v.shape).astype(np.float32)
                  for k, v in layer.items()} for layer in init]
        jp, jstate = adam_update(jmlp.params_from_numpy(grads), jstate, jp,
                                 cfg)
        tmlp._adam_update(tmlp.params_from_numpy(grads, "cpu"), tstate, tp,
                          1e-3)
        for tl, jl in zip(tmlp.params_to_numpy(tp), jmlp.params_to_numpy(jp)):
            for k in ("w", "b"):
                np.testing.assert_allclose(tl[k], jl[k], rtol=0, atol=1e-7)
    assert tstate["step"] == int(jstate["step"]) == 3


def test_epoch_losses_match_reference():
    """`_train_epoch` on the same batches: the mean loss of each of 20
    epochs within LOSS_RTOL of the reference's."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(300, 4)).astype(np.float32)
    y = (x[:, 0] * x[:, 1] + 0.1 * rng.normal(size=300)).astype(np.float32)
    init = j_init((4, 64, 32, 1), 1)
    cfg = AdamConfig(lr=1e-3)
    jp = jmlp.params_from_numpy(init)
    jstate = adam_init(jp, cfg)
    tp = tmlp.params_from_numpy(init, "cpu")
    tstate = tmlp._adam_init(tp)
    order = np.random.default_rng(1)
    for _ in range(20):
        perm = order.permutation(300)[:256 * 1]
        xb, yb = x[perm].reshape(1, 256, 4), y[perm].reshape(1, 256)
        jp, jstate, jl = jmlp._train_epoch(jp, jstate, jnp.asarray(xb),
                                           jnp.asarray(yb), cfg, False)
        tl = tmlp._train_epoch(tp, tstate, torch.from_numpy(xb),
                               torch.from_numpy(yb), 1e-3, False)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)


@pytest.mark.parametrize("hidden,classification,epochs", [
    ((64, 32), False, 200), ((16,), False, 30), ((32, 16), True, 60),
    ((), True, 100)])
def test_train_mlp_matches_reference_from_its_init(hidden, classification,
                                                   epochs):
    rng = np.random.default_rng(len(hidden) + 10 * classification)
    x = rng.normal(size=(700, 6)).astype(np.float32)
    if classification:
        y = ((x[:, 0] > 0).astype(int) + (x[:, 1] > 0.5)).astype(np.int64)
        n_out = 3
    else:
        y = (x[:, 0] ** 2 + x[:, 1]).astype(np.float32)
        n_out = 1
    kw = dict(hidden=hidden, n_out=n_out, classification=classification,
              epochs=epochs, seed=3)
    jp = jmlp.train_mlp(x, y, **kw)
    tp = tmlp.train_mlp(x, y, device="cpu",
                        init=j_init((6,) + hidden + (n_out,), 3), **kw)
    want = np.asarray(jmlp.predict(jp, x))
    got = tmlp.predict(tp, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=PRED_TOL)
    if classification:
        assert (got.argmax(1) == want.argmax(1)).mean() >= 0.99
    else:
        np.testing.assert_allclose(np.mean((got[:, 0] - y) ** 2),
                                   np.mean((want[:, 0] - y) ** 2),
                                   rtol=1e-4)
    assert [{k: v.shape for k, v in l.items()}
            for l in tmlp.params_to_numpy(tp)] == \
        [{k: v.shape for k, v in l.items()}
         for l in jmlp.params_to_numpy(jp)]


def test_init_mlp_and_fit_follow_the_seed():
    a = tmlp.init_mlp((5, 7, 1), seed=4, device="cpu")
    b = tmlp.init_mlp((5, 7, 1), generator=torch.Generator().manual_seed(4),
                      device="cpu")
    assert all(torch.equal(p[k], q[k]) for p, q in zip(a, b) for k in p)
    assert torch.equal(a[0]["b"], torch.zeros(7))
    std = tmlp.init_mlp((400, 300), seed=0, device="cpu")[0]["w"].std()
    assert abs(std.item() - np.sqrt(2 / 400)) < 0.003      # He-normal
    with pytest.raises(ValueError):
        tmlp.init_mlp((5, 1), device="cpu")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(100, 5)).astype(np.float32)
    y = x[:, 0].astype(np.float32)
    f1 = tmlp.params_to_numpy(tmlp.train_mlp(x, y, epochs=5, seed=9,
                                             device="cpu"))
    f2 = tmlp.params_to_numpy(tmlp.train_mlp(x, y, epochs=5, seed=9,
                                             device="cpu"))
    assert all(np.array_equal(p[k], q[k]) for p, q in zip(f1, f2) for k in p)


# ---- collect, assemble, fits -------------------------------------------------

def test_collect_matches_reference(colls):
    jc, tc = colls
    assert sorted(tc.cells) == sorted(jc.cells)
    for key, jcell in jc.cells.items():
        tcell = tc.cells[key]
        assert tcell.numeric.tobytes() == jcell.numeric.tobytes(), key
        assert tcell.best_ps == jcell.best_ps, key
        for m, rec in jcell.recall.items():
            assert np.array_equal(tcell.recall[m], rec), (key, m)
        assert np.array_equal(tcell.gt, jcell.gt)
        assert np.array_equal(tcell.qbms, jcell.qbms)
        assert [s[:3] for s in tcell.sweep] == [s[:3] for s in jcell.sweep]
    assert tc.table.entries.keys() == jc.table.entries.keys()
    for key, cell in jc.table.entries.items():
        assert tc.table.entries[key]["recall"] == cell["recall"], key


def test_collect_opens_bare_datasets_in_the_pool(dss, monkeypatch):
    _, tds = dss
    monkeypatch.setattr(tindex, "_POOL", {})
    one = {"postfilter": tcand()["postfilter"]}
    c = TT.collect({"tiny": tds}, one, n_queries=8, verbose=False,
                   device="cpu")
    assert len(tindex._POOL) == 1
    fx = tindex.default_index(tds, "cpu")
    assert fx.built_keys()                     # postfilter's index built
    assert sorted(c.cells) == [("tiny", 0), ("tiny", 1), ("tiny", 2)]
    tindex.clear_pool()


@pytest.mark.parametrize("names", [tF.MINIMAL_FEATURES, tF.ALL_FEATURES,
                                   ["pred", "label_cardinality", "selectivity"]])
def test_assemble_xy_bit_identical(colls, names):
    jc, tc = colls
    jx, jy, jm = JT.assemble_xy(jc, names)
    tx, ty, tm = TT.assemble_xy(tc, names)
    assert tx.tobytes() == jx.tobytes() and tx.shape == jx.shape
    assert ty.tobytes() == jy.tobytes()
    assert tm == jm


def _decisions(router, coll, device=None):
    """Each cell's predicted recalls and Algorithm 2 decisions at T = 0.9:
    a port router (and collection) with `device`, else the reference's."""
    T = JT if device is None else TT
    out = {}
    for (ds, pt), cell in sorted(coll.cells.items()):
        x, _, _ = T.assemble_xy(
            T.Collection(cells={(ds, pt): cell}, table=coll.table),
            router.feature_names)
        r = (router.predict_recalls_from_features(x) if device is None
             else router.predict_recalls_from_features(x, device=device))
        out[(ds, pt)] = (r, router.route_from_predictions(r, ds, pt, 0.9))
    return out


def test_train_models_from_xy_routes_as_reference(colls, monkeypatch):
    jc, tc = colls
    use_reference_init(monkeypatch)
    x, y, _ = TT.assemble_xy(tc, tF.MINIMAL_FEATURES)
    jmodels, jscaler = JT.train_models_from_xy(x, y, JT.METHOD_ORDER,
                                               seed=2, epochs=60)
    tmodels, tscaler = TT.train_models_from_xy(x, y, TT.METHOD_ORDER,
                                               seed=2, epochs=60,
                                               device="cpu")
    assert np.array_equal(tscaler.mean, jscaler.mean)
    assert np.array_equal(tscaler.std, jscaler.std)
    for m in TT.METHOD_ORDER:
        xs = tscaler.transform(x)
        np.testing.assert_allclose(
            tmlp.predict(tmlp.params_from_numpy(tmodels[m], "cpu"), xs),
            jmlp.forward_np(jmodels[m], xs), rtol=0, atol=PRED_TOL)
    jr = JRouter(feature_names=tF.MINIMAL_FEATURES, methods=JT.METHOD_ORDER,
                 models=jmodels, scaler=jscaler, table=jc.table)
    tr = TRouter(feature_names=tF.MINIMAL_FEATURES, methods=TT.METHOD_ORDER,
                 models=tmodels, scaler=tscaler, table=tc.table)
    want, got = _decisions(jr, jc), _decisions(tr, tc, "cpu")
    for key in want:
        np.testing.assert_allclose(got[key][0], want[key][0], rtol=0,
                                   atol=PRED_TOL)
        assert got[key][1] == want[key][1], key


@pytest.mark.parametrize("saved_by", ["port", "reference"])
def test_router_artifact_opens_in_both_packages(colls, tmp_path, saved_by,
                                                monkeypatch):
    jc, tc = colls
    use_reference_init(monkeypatch)
    if saved_by == "port":
        router = TT.train_router(tc, tc.table, epochs=20, device="cpu")
    else:
        router = JT.train_router(jc, jc.table, epochs=20)
    path = str(tmp_path / "router")
    router.save(path)
    jl, tl = JRouter.load(path), TRouter.load(path)
    want, got = _decisions(jl, jc), _decisions(tl, tc, "cpu")
    for key in want:
        assert got[key][1] == want[key][1], key
    assert tl.table.entries == jl.table.entries
    # the loaded router decides as the one that was saved
    mine = _decisions(router, tc if saved_by == "port" else jc,
                      "cpu" if saved_by == "port" else None)
    for key in want:
        assert mine[key][1] == want[key][1], key


def test_build_all_collects_once_then_loads(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    spec = tsynth.DatasetSpec(*TINY)
    specs = {"tiny_train": dataclasses.replace(spec, name="tiny_train"),
             "tiny_val": dataclasses.replace(spec, name="tiny_val", seed=8)}
    monkeypatch.setattr(tsynth, "TRAIN_SPECS", {"tiny_train":
                                                specs["tiny_train"]})
    monkeypatch.setattr(tsynth, "VALIDATION_SPECS", {"tiny_val":
                                                     specs["tiny_val"]})
    for name, s in specs.items():
        monkeypatch.setitem(tsynth.ALL_SPECS, name, s)
    monkeypatch.setattr(tindex, "_POOL", {})
    ct, cv, router = TT.build_all(n_queries=8, device="cpu", verbose=False)
    p_train, p_val, p_router = TT.default_paths()
    assert p_router == str(tmp_path / "router" / "router")
    assert os.path.exists(p_train) and os.path.exists(p_val)
    assert sorted(ct.cells) == [("tiny_train", p) for p in range(3)]
    assert sorted(cv.cells) == [("tiny_val", p) for p in range(3)]
    assert {k[0] for k in router.table.entries} == {"tiny_train", "tiny_val"}

    def no_collect(*a, **kw):
        raise AssertionError("build_all collected again")
    monkeypatch.setattr(TT, "collect", no_collect)
    ct2, cv2, router2 = TT.build_all(n_queries=8, device="cpu",
                                     verbose=False)
    assert sorted(ct2.cells) == sorted(ct.cells)
    assert router2.table.entries == router.table.entries
    x, _, _ = TT.assemble_xy(cv, router.feature_names)
    np.testing.assert_array_equal(
        router2.predict_recalls_from_features(x, device="cpu"),
        router.predict_recalls_from_features(x, device="cpu"))
    # a router artifact the reference wrote in its place loads too
    JRouter.load(p_router).save(p_router + "_j")
    os.replace(p_router, p_router + "_old")
    os.replace(p_router + "_j", p_router)
    _, _, router3 = TT.build_all(n_queries=8, device="cpu", verbose=False)
    assert router3.table.entries == router.table.entries
    tindex.clear_pool()


def test_entry_points_default_to_the_card(dss, monkeypatch):
    """Without a card, every entry point of the offline stage raises on
    its default device instead of moving to the CPU."""
    _, tds = dss
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tindex, "_POOL", {})
    x = np.zeros((8, 3), np.float32)
    y = np.zeros(8, np.float32)
    calls = (lambda: tmlp.train_mlp(x, y, epochs=1),
             lambda: tmlp.init_mlp((3, 1), seed=0),
             lambda: TT.train_models_from_xy(x, y[:, None], ["m"], epochs=1),
             lambda: TT.collect({"tiny": tds}, n_queries=2, verbose=False),
             lambda: tbench.sweep(tds, tcand(), tsynth.make_queries(
                 tds, Predicate.AND, 2, seed=0)),
             lambda: tindex.as_index(tds))
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tindex._POOL == {}
