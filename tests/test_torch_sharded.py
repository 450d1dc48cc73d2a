"""The sharded layer on the CPU against the JAX package on one dataset:
`row_slice` and `shard_bounds`, `ShardedFilteredIndex` exact search equal
to single-index search (1/2/4 shards, ragged bounds, k above a shard's
matches, serial and parallel fan-out), its lifecycle, and
`ShardedRouterService` routing and results equal to the JAX
`ShardedRouterService`'s."""

import os

import numpy as np
import pytest
import torch

from repro.ann import sharded as jsh
from repro.ann.distributed import shard_bounds as j_shard_bounds
from repro.ann.index import QueryBatch as JQB
from repro.ann.service import ShardedRouterService as JShardedService
from repro.ann.sharded import ShardedFilteredIndex as JSharded
from repro.core.router import MLRouter as JRouter
from repro_torch.ann import distributed as tdist
from repro_torch.ann import sharded as tsh
from repro_torch.ann.index import FilteredIndex
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.predicates import Predicate
from repro_torch.ann.registry import get_method
from repro_torch.ann.service import RouterService, ShardedRouterService
from repro_torch.ann.sharded import ShardedFilteredIndex
from repro_torch.core.router import MLRouter as TRouter
from repro_torch.data.ann_synth import DatasetSpec, synthesize

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's
ALL_PREDS = (Predicate.EQUALITY, Predicate.AND, Predicate.OR)
ROUTER = os.path.join(os.path.dirname(__file__), os.pardir, "src",
                      "repro_torch", "assets", "router_ivf")


@pytest.fixture(scope="module")
def tds():
    return synthesize(DatasetSpec(*TINY))


@pytest.fixture(scope="module")
def tfx(tds):
    fx = FilteredIndex(tds, device="cpu")
    yield fx
    fx.close()


def _batch(qs, pred, k=10):
    return TQB(qs.vectors, qs.bitmaps, pred, k)


def _tol(ds, batch, ids):
    """Exact distances from fp32 scores summed in different orders (shard
    matmuls of other shapes, another package) differ by at most about
    2·D·u·(‖v‖ + ‖q‖)² each (u = 2^-24); twice that is the bound used."""
    v = np.linalg.norm(ds.vectors[np.maximum(ids, 0)], axis=-1)
    q = np.linalg.norm(batch.vectors, axis=-1)[:, None]
    return 4 * ds.dim * 2.0 ** -24 * (v + q) ** 2


def _assert_same(res, want, ds, batch):
    """Same ids and keys; exact distances within `_tol` (NaN at −1)."""
    np.testing.assert_array_equal(res.ids, want.ids)
    np.testing.assert_array_equal(res.keys, want.keys)
    ok = res.ids >= 0
    assert np.isnan(res.distances[~ok]).all()
    assert (np.abs(res.distances - want.distances)[ok]
            <= _tol(ds, batch, res.ids)[ok]).all()


# ---------------------------------------------------------------------------
# partition helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,stop", [(0, 600), (100, 350), (599, 600),
                                        (0, 1), (123, 457)])
def test_row_slice_matches_reference(tiny_ds, tds, start, stop):
    want = tiny_ds.row_slice(start, stop, name="s")
    got = tds.row_slice(start, stop, name="s")
    for f in ("vectors", "bitmaps", "group_of", "group_bitmaps",
              "group_start", "group_size", "norms_sq"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.name, got.universe) == (want.name, want.universe)
    assert got.group_lookup == want.group_lookup
    assert tds.row_slice(start, stop).name == \
        tiny_ds.row_slice(start, stop).name
    with pytest.raises(ValueError, match="out of range"):
        tds.row_slice(0, tds.n + 1)
    with pytest.raises(ValueError, match="out of range"):
        tds.row_slice(5, 5)


@pytest.mark.parametrize("n,s", [(10, 3), (8, 4), (600, 4), (7, 7),
                                 (1, 1), (1000, 6)])
def test_shard_bounds_matches_reference(n, s):
    np.testing.assert_array_equal(tdist.shard_bounds(n, s),
                                  j_shard_bounds(n, s))


def test_shard_bounds_rejects():
    for n, s in ((3, 5), (4, 0)):
        with pytest.raises(ValueError, match="n_shards"):
            tdist.shard_bounds(n, s)


def test_shard_devices(monkeypatch):
    assert tdist.shard_devices(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist.shard_devices(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert tdist.shard_devices(4) == [torch.device("cuda", i)
                                      for i in (0, 1, 2, 0)]
    assert tdist.shard_devices(2, "cuda:1") == [torch.device("cuda", 1)] * 2


def test_stack_and_merge_candidates_match_reference():
    rng = np.random.default_rng(4)
    parts = []
    for j, kk in enumerate((5, 3, 5)):
        i = rng.integers(0, 50, (6, kk)).astype(np.int32) + 100 * j
        r = np.round(rng.normal(size=(6, kk)), 1).astype(np.float32)
        i[rng.random(i.shape) < 0.2] = -1
        parts.append((i, r))
    ids, raw = tsh.stack_candidates(parts)
    jids, jraw = jsh.stack_candidates(parts)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(raw, jraw)
    for k in (3, 5, 9):
        gi, gr = tsh.merge_candidates(ids, raw, k, torch.device("cpu"))
        ji, jr = jsh.merge_candidates(jids, jraw, k)
        np.testing.assert_array_equal(gi, ji)
        np.testing.assert_array_equal(gr.view(np.int32), jr.view(np.int32))


# ---------------------------------------------------------------------------
# sharded == single-index exact search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("pred", ALL_PREDS)
def test_sharded_matches_single_index(tiny_index, tfx, tds, tiny_queries,
                                      n_shards, pred):
    qs = tiny_queries[pred]
    batch = _batch(qs, pred)
    want = tfx.search(batch, "prefilter")
    jwant = tiny_index.search(JQB(qs.vectors, qs.bitmaps, pred, 10),
                              "prefilter")
    with ShardedFilteredIndex(tds, n_shards, device="cpu") as sfx:
        res = sfx.search(batch, "prefilter")
    _assert_same(res, want, tds, batch)
    _assert_same(res, jwant, tds, batch)
    assert set(res.timings) == {"search_s", "total_s"}


@pytest.mark.parametrize("pred", ALL_PREDS)
def test_sharded_ragged_bounds(tfx, tds, tiny_queries, pred):
    """Deliberately unbalanced shards (97/203/150/150) stay exact."""
    batch = _batch(tiny_queries[pred], pred)
    want = tfx.search(batch, "prefilter")
    with ShardedFilteredIndex(tds, bounds=[0, 97, 300, 450, 600],
                              device="cpu") as sfx:
        assert sfx.stats()["shard_rows"] == [97, 203, 150, 150]
        _assert_same(sfx.search(batch, "prefilter"), want, tds, batch)


@pytest.mark.parametrize("pred", ALL_PREDS)
def test_sharded_k_exceeds_per_shard_matches(tiny_index, tfx, tds,
                                             tiny_queries, pred):
    """k larger than any single shard's match count: the merge pulls from
    several shards and pads with −1 only when the global matches run
    out."""
    qs = tiny_queries[pred]
    batch = _batch(qs, pred, k=40)
    want = tiny_index.search(JQB(qs.vectors, qs.bitmaps, pred, 40),
                             "prefilter")
    with ShardedFilteredIndex(tds, 4, device="cpu") as sfx:
        res = sfx.search(batch, "prefilter")
        per_shard = [fx.search(_batch(qs, pred, k=40), "prefilter")
                     for fx in sfx.shards]
    _assert_same(res, want, tds, batch)
    assert (res.ids >= 0).sum() > max((r.ids >= 0).sum() for r in per_shard)
    if pred == Predicate.EQUALITY:
        assert (res.ids < 0).any()


def test_sharded_serial_matches_parallel(tds, tiny_queries):
    batch = _batch(tiny_queries[Predicate.AND], Predicate.AND)
    with ShardedFilteredIndex(tds, 3, parallel=False, device="cpu") as ser, \
            ShardedFilteredIndex(tds, 3, parallel=True, device="cpu") as par:
        assert ser.stats()["parallel"] is False
        assert par.stats()["parallel"] is True
        a, b = par.search(batch, "prefilter"), ser.search(batch, "prefilter")
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.distances, b.distances)


def test_sharded_lifecycle_and_validation(tds):
    sfx = ShardedFilteredIndex(tds, 2, device="cpu")
    assert sfx.n_shards == 2
    assert sfx.torch_device == torch.device("cpu")
    assert [s["dataset"] for s in sfx.stats()["shards"]] == \
        ["tiny/shard0", "tiny/shard1"]
    assert sfx.feature_index.ds is tds
    assert sfx.device.vectors.shape == (tds.n, tds.dim)
    sfx.search(_batch(tds, Predicate.AND, 5), "postfilter", "ef200")
    assert sfx.evict("postfilter") == 2 and sfx.evict() == 0
    assert sfx.label_clock() == 0
    np.testing.assert_array_equal(sfx.keys_of([[3, -1]]), [[3, -1]])
    sfx.close()
    assert sfx.closed and all(fx.closed for fx in sfx.shards)
    sfx.close()                                       # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        sfx.search(TQB(tds.vectors[:2], tds.bitmaps[:2], Predicate.AND, 5),
                   "prefilter")
    with pytest.raises(ValueError, match="strictly increase"):
        ShardedFilteredIndex(tds, bounds=[0, 300, 200, 600], device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        ShardedFilteredIndex(tds, 0, device="cpu")


def test_sharded_defaults_to_cuda(tds, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedFilteredIndex(tds, 2)


def test_sharded_stage_timings(tds, tiny_queries):
    """The handle leaves shard{j}_s, shard_max_s and merge_s on the
    calling thread's slate; `RouterService.execute` drains them into
    the result's timings."""
    batch = _batch(tiny_queries[Predicate.OR], Predicate.OR)
    stages = {"shard0_s", "shard1_s", "shard2_s", "shard_max_s", "merge_s"}
    with ShardedFilteredIndex(tds, 3, device="cpu") as sfx:
        sfx.pop_stage_timings()             # what earlier searches left
        sfx.search(batch, "prefilter")
        got = sfx.pop_stage_timings()
        assert set(got) == stages and sfx.pop_stage_timings() == {}
        assert got["shard_max_s"] == max(got[f"shard{j}_s"]
                                         for j in range(3))
        svc = RouterService(sfx, None,
                            methods={"prefilter": get_method("prefilter")})
        sfx.search(batch, "prefilter")              # a stale slate
        res = svc.execute(batch, [("prefilter", "exact")] * batch.q)
    assert stages <= set(res.timings)
    assert res.timings["shard0_s"] < res.timings["search_s"]


# ---------------------------------------------------------------------------
# ShardedRouterService
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def routers(tiny_ds):
    """The committed router (postfilter + ivf_gamma), loaded by each
    package, with the same benchmark-table rows for the tiny dataset:
    settings on both sides of the thresholds, so decisions vary."""
    jr, tr = JRouter.load(ROUTER), TRouter.load(ROUTER)
    rand = np.random.default_rng(11)
    for pt in range(3):
        for name, ps_ids in (("postfilter", ("ef200", "ef800", "ef2000")),
                             ("ivf_gamma", ("g1", "g4", "g8"))):
            for ps in ps_ids:
                rec, qps = rand.uniform(0.6, 1.0), rand.uniform(100, 2000)
                jr.table.add(tiny_ds.name, pt, name, ps, float(rec),
                             float(qps))
                tr.table.add(tiny_ds.name, pt, name, ps, float(rec),
                             float(qps))
    return jr, tr


@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("pred", ALL_PREDS)
@pytest.mark.parametrize("t", [0.7, 0.9])
def test_sharded_router_service_matches_reference(tiny_ds, tds, tfx,
                                                  tiny_queries, routers,
                                                  n_shards, pred, t):
    """Same routing decisions as the JAX sharded service and as the
    port's single-index service; the same ids as the JAX sharded service
    (each shard builds the same IVF in both packages)."""
    jr, tr = routers
    qs = tiny_queries[pred]
    batch = _batch(qs, pred)
    with JSharded(tiny_ds, n_shards) as jsfx, \
            ShardedFilteredIndex(tds, n_shards, device="cpu") as sfx:
        want = JShardedService(jsfx, jr, t=t).search(
            JQB(qs.vectors, qs.bitmaps, pred, 10))
        res = ShardedRouterService(sfx, tr, t=t).search(batch)
        single = RouterService(tfx, tr, t=t).route(batch)
    assert [tuple(d) for d in res.decisions] == \
        [tuple(d) for d in want.decisions]
    assert res.decisions == single
    _assert_same(res, want, tds, batch)
    assert {"route_s", "search_s", "shard_max_s", "merge_s"} <= \
        set(res.timings)


def test_sharded_router_decisions_vary(tds, tiny_queries, routers):
    """The comparison above exercises more than one execution group."""
    _, tr = routers
    seen = set()
    with ShardedFilteredIndex(tds, 2, device="cpu") as sfx:
        svc = ShardedRouterService(sfx, tr)
        for t in (0.7, 0.9):
            for pred in ALL_PREDS:
                seen |= set(svc.route(_batch(tiny_queries[pred], pred), t=t))
    assert len(seen) >= 2


@pytest.mark.parametrize("pred", ALL_PREDS)
def test_sharded_router_service_exact_for_prefilter(tfx, tds, tiny_queries,
                                                    routers, pred):
    """Routed through an exact-only pool, sharded == single end to end."""
    _, tr = routers
    batch = _batch(tiny_queries[pred], pred)
    pool = {m: get_method("prefilter") for m in tr.methods}
    want = RouterService(tfx, tr, t=0.9, methods=pool).search(batch)
    with ShardedFilteredIndex(tds, 2, device="cpu") as sfx:
        res = ShardedRouterService(sfx, tr, t=0.9, methods=pool).search(batch)
    assert res.decisions == want.decisions
    _assert_same(res, want, tds, batch)


def test_sharded_router_service_rejects_plain_index(tfx, routers):
    with pytest.raises(TypeError, match="ShardedFilteredIndex"):
        ShardedRouterService(tfx, routers[1])
