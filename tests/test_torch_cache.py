"""`SemanticResultCache` on the CPU, the port against the JAX package: the
same query stream through both packages' caches over the same handle
(sealed, sharded, live, sharded live) and the same writes gives the same
hit kinds, ids, keys and counters, and distances to 1e-5 relative where
the cache computed them (fp32 summation order where a query was
searched) — through
exact and semantic hits, a write that makes entries stale, a compaction
after which entries survive with their ids re-resolved, TTL expiry,
capacity eviction, `admit_after` and the subset/superset transfer rule.
An exact hit is also bit-identical to a fresh search of the handle. The
patterns of `tests/test_cache.py`.

Every test draws its randomness from its own seeded generator."""

import time

import numpy as np
import pytest
import torch

from repro.ann import labels as jlb
from repro.ann.cache import SemanticResultCache as JCache
from repro.ann.dataset import ANNDataset as JDS
from repro.ann.index import FilteredIndex as JFX
from repro.ann.index import QueryBatch as JQB
from repro.ann.live import LiveFilteredIndex as JLive
from repro.ann.live import ShardedLiveIndex as JShLive
from repro.ann.sharded import ShardedFilteredIndex as JSharded
from repro.data.ann_synth import make_queries
from repro_torch.ann import cache as cache_mod
from repro_torch.ann.cache import SemanticResultCache as TCache
from repro_torch.ann.dataset import ANNDataset as TDS
from repro_torch.ann.index import FilteredIndex as TFX
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.live import LiveFilteredIndex as TLive
from repro_torch.ann.live import ShardedLiveIndex as TShLive
from repro_torch.ann.predicates import Predicate
from repro_torch.ann.sharded import ShardedFilteredIndex as TSharded
from repro_torch.data.ann_synth import DatasetSpec, synthesize

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's
ALL_PREDS = (Predicate.EQUALITY, Predicate.AND, Predicate.OR)
KINDS = ("sealed", "sharded", "live", "sharded_live")


@pytest.fixture(scope="module")
def tds():
    return synthesize(DatasetSpec(*TINY))


def handles(kind, jds, tds):
    """(reference handle, port handle) of one kind over the same rows."""
    if kind == "sealed":
        return JFX(jds), TFX(tds, device="cpu")
    if kind == "sharded":
        return JSharded(jds, 2), TSharded(tds, 2, device="cpu")
    if kind == "live":
        return JLive(jds), TLive(tds, device="cpu")
    out = (JShLive(None, 2, name=jds.name, dim=jds.dim,
                   universe=jds.universe),
           TShLive(None, 2, name=tds.name, dim=tds.dim,
                   universe=tds.universe, device="cpu"))
    for h in out:
        h.upsert(jds.vectors, jds.bitmaps)
    return out


def same(jres, tres, tags=None, qvecs=None, vmax=None):
    """The two caches' answers agree: tags, ids and keys exactly,
    distances to 1e-5 relative — or, given the query vectors and the
    largest row norm, to fp32 summation order where a query was searched
    (two matmuls summing in two orders differ by at most about
    2·D·u·(‖v‖ + ‖q‖)² a distance, u = 2^-24; twice that)."""
    assert tres.cache == jres.cache
    if tags is not None:
        assert tres.cache == tags
    np.testing.assert_array_equal(tres.ids, jres.ids)
    np.testing.assert_array_equal(tres.keys, jres.keys)
    np.testing.assert_array_equal(np.isnan(tres.distances),
                                  np.isnan(jres.distances))
    tol = np.full(tres.distances.shape, 1e-5)
    if qvecs is not None:
        q = np.linalg.norm(qvecs, axis=1)[:, None]
        tol = np.maximum(tol, 4 * qvecs.shape[1] * 2.0 ** -24
                         * (vmax + q) ** 2)
    ok = np.isnan(jres.distances) | (
        np.abs(tres.distances - jres.distances)
        <= np.maximum(tol, 1e-5 * np.abs(jres.distances)))
    assert ok.all(), (tres.distances, jres.distances)


def both(caches, vectors, bitmaps, pred, k):
    return [c.search(qb(vectors, bitmaps, pred, k))
            for c, qb in zip(caches, (JQB, TQB))]


def vmax(ds) -> float:
    return float(np.linalg.norm(ds.vectors, axis=1).max()) + 1.0


def check(caches, vectors, bitmaps, pred, k, tags, vm):
    same(*both(caches, vectors, bitmaps, pred, k), tags, vectors, vm)


@pytest.mark.parametrize("kind", KINDS)
def test_stream_matches_reference(kind, tiny_ds, tds):
    """Fills, exact hits (bit-identical to a fresh search), semantic hits
    on seeded near-duplicates through the rebuilt similarity index, then
    on the live kinds a write that stales some entries and a compaction
    that the rest survive: the same answers and counters in both
    packages."""
    g = np.random.default_rng(31)
    jh, th = handles(kind, tiny_ds, tds)
    caches = (JCache(jh, method="prefilter", threshold=0.98,
                     rebuild_every=4, sim_probe=4),
              TCache(th, method="prefilter", threshold=0.98,
                     rebuild_every=4, sim_probe=4))
    try:
        stream = []
        for pred in ALL_PREDS:
            qs = make_queries(tiny_ds, pred, 6, seed=40 + int(pred))
            stream.append((qs.vectors, qs.bitmaps, pred))
        vm = vmax(tiny_ds)
        for vec, bm, pred in stream:
            j, t = both(caches, vec, bm, pred, 10)
            same(j, t, [None] * 6, vec, vm)
            j, t = both(caches, vec, bm, pred, 10)
            same(j, t, ["exact"] * 6, vec, vm)
            fresh = th.search(TQB(vec, bm, pred, 10), "prefilter")
            np.testing.assert_array_equal(t.ids, fresh.ids)
            assert t.distances.tobytes() == fresh.distances.tobytes()
        for vec, bm, pred in stream:
            near = (vec + g.normal(0, 1e-4, vec.shape)).astype(np.float32)
            j, t = both(caches, near, bm, pred, 10)
            same(j, t)
            assert t.cache.count("semantic") >= 4
        if kind in ("live", "sharded_live"):
            vec, bm, pred = stream[1]                    # AND
            filled = jh.search(JQB(vec, bm, pred, 10), "prefilter")
            victims = np.unique(filled.keys[:2][filled.keys[:2] >= 0])[:2]
            for h in (jh, th):
                h.delete_keys(victims)
                h.upsert(vec[4:5] + np.float32(0.001), bm[4:5])
            j, t = both(caches, vec, bm, pred, 10)
            same(j, t, None, vec, vm)
            assert t.cache.count(None) >= 3 and "exact" not in t.cache[:2]
            for vec, bm, pred in stream:          # refill what went stale
                j, t = both(caches, vec, bm, pred, 10)
                same(j, t, None, vec, vm)
            for h in (jh, th):
                h.compact()
            for vec, bm, pred in stream:
                j, t = both(caches, vec, bm, pred, 10)
                same(j, t, ["exact"] * 6, vec, vm)
                fresh = th.search(TQB(vec, bm, pred, 10), "prefilter")
                np.testing.assert_array_equal(t.ids, fresh.ids)
                np.testing.assert_array_equal(t.keys, fresh.keys)
        assert caches[1].stats() == caches[0].stats()
    finally:
        for c in caches:
            c.close()
        jh.close()
        th.close()


def test_ttl_capacity_and_admission_match_reference(tiny_ds, tds):
    qs = make_queries(tiny_ds, Predicate.AND, 8, seed=5)
    vm = vmax(tiny_ds)
    with JFX(tiny_ds) as jfx, TFX(tds, device="cpu") as tfx:
        # TTL: a hit, then past the TTL a miss counted as an eviction;
        # both handles warmed first, so no fill outlasts the TTL
        v, b = qs.vectors[:3], qs.bitmaps[:3]
        jfx.search(JQB(v, b, Predicate.AND, 5), "prefilter")
        tfx.search(TQB(v, b, Predicate.AND, 5), "prefilter")
        caches = (JCache(jfx, method="prefilter", threshold=None,
                         ttl_s=1.0),
                  TCache(tfx, method="prefilter", threshold=None,
                         ttl_s=1.0))
        check(caches, v, b, Predicate.AND, 5, [None] * 3, vm)
        check(caches, v, b, Predicate.AND, 5, ["exact"] * 3, vm)
        time.sleep(1.2)
        check(caches, v, b, Predicate.AND, 5, [None] * 3, vm)
        assert caches[1].stats() == caches[0].stats()
        assert caches[1].stats()["evictions_ttl"] == 3
        # capacity: the oldest four go, the newest four hit
        caches = (JCache(jfx, method="prefilter", threshold=None,
                         capacity=4),
                  TCache(tfx, method="prefilter", threshold=None,
                         capacity=4))
        for i in range(8):
            check(caches, qs.vectors[i:i + 1], qs.bitmaps[i:i + 1],
                  Predicate.AND, 5, [None], vm)
        for i, want in ((0, None), (7, "exact"), (5, "exact")):
            check(caches, qs.vectors[i:i + 1], qs.bitmaps[i:i + 1],
                  Predicate.AND, 5, [want], vm)
        assert caches[1].stats() == caches[0].stats()
        assert caches[1].stats()["evictions_capacity"] >= 4
        # admission: two misses before a key is cached
        caches = (JCache(jfx, method="prefilter", threshold=None,
                         admit_after=2),
                  TCache(tfx, method="prefilter", threshold=None,
                         admit_after=2))
        for want in ([None, None], [None, None], ["exact", "exact"]):
            check(caches, qs.vectors[:2], qs.bitmaps[:2], Predicate.AND, 5,
                  want, vm)
        assert caches[1].stats() == caches[0].stats()
        assert caches[1].stats()["insertions"] == 2


def transfer_ds(ds_cls):
    g = np.random.default_rng(11)
    anchor = np.ones(8, np.float32)
    a = anchor + g.normal(0, 0.01, (4, 8)).astype(np.float32)
    b = anchor + np.float32(0.5) + g.normal(0, 0.02, (4, 8)).astype(
        np.float32)
    far = g.normal(5.0, 1.0, (24, 8)).astype(np.float32)
    vecs = np.concatenate([a, b, far]).astype(np.float32)
    labels = [[0, 1]] * 4 + [[1]] * 4 + [[2]] * 24
    return ds_cls.build("transfer", vecs, labels, 6), anchor


@pytest.mark.parametrize("cached,probe,pred,k,want", [
    ([0, 1], [0], Predicate.OR, 4, "transfer"),      # OR superset serves
    ([0, 1], [0], Predicate.OR, 6, None),            # row re-check blocks
    ([1], [0, 1], Predicate.AND, 4, "transfer"),     # AND subset serves
    ([1], [0, 1], Predicate.AND, 6, None),           # row re-check blocks
    ([], [0, 1], Predicate.AND, 4, None),            # label-less: never
])
def test_transfer_rule_matches_reference(cached, probe, pred, k, want):
    out = []
    for ds_cls, fx_cls, cache_cls, qb, kw in (
            (JDS, JFX, JCache, JQB, {}),
            (TDS, TFX, TCache, TQB, {"device": "cpu"})):
        ds, anchor = transfer_ds(ds_cls)
        with fx_cls(ds, **kw) as fx:
            cache = cache_cls(fx, method="prefilter", threshold=0.95)

            def one(labels):
                bm = jlb.pack_one(labels, 6)[None].astype(np.uint32)
                return qb(anchor[None], bm, pred, k)
            cache.search(one(cached))
            res = cache.search(one(probe))
            fresh = fx.search(one(probe), "prefilter")
            np.testing.assert_array_equal(res.ids, fresh.ids)
            np.testing.assert_allclose(res.distances, fresh.distances,
                                       rtol=1e-5, atol=1e-5, equal_nan=True)
            out.append((res, cache.stats()))
            cache.close()
    same(out[0][0], out[1][0], [want])
    assert out[1][1] == out[0][1]


def test_transfer_obeys_the_write_clock_as_reference():
    """A write touching a label of the cached entry's set stales the
    transfer: the next probe misses and refills to the post-write
    answer, in both packages alike."""
    out = []
    for ds_cls, live_cls, cache_cls, qb, kw in (
            (JDS, JLive, JCache, JQB, {}),
            (TDS, TLive, TCache, TQB, {"device": "cpu"})):
        ds, anchor = transfer_ds(ds_cls)
        with live_cls(ds, **kw) as live:
            cache = cache_cls(live, method="prefilter", threshold=0.95)

            def one(labels):
                bm = jlb.pack_one(labels, 6)[None].astype(np.uint32)
                return qb(anchor[None], bm, Predicate.OR, 4)
            cache.search(one([0, 1]))
            tags = [cache.search(one([0])).cache]
            new = live.upsert(anchor[None],
                              jlb.pack_one([0], 6)[None].astype(np.uint32))
            res = cache.search(one([0]))
            tags.append(res.cache)
            assert int(new[0]) in res.ids[0]
            out.append((tags, res, cache.stats()))
            cache.close()
    assert out[1][0] == out[0][0] == [["transfer"], [None]]
    same(out[0][1], out[1][1])
    assert out[1][2] == out[0][2]


def test_routed_cache_matches_reference(tiny_ds, tds):
    """A cache in front of both packages' `RouterService` (the same
    router): misses are routed with the same decisions, hits carry no
    decision, and the answers agree."""
    from repro.ann.service import RouterService as JService
    from repro.ann.telemetry import constant_router as jconst
    from repro_torch.ann.service import RouterService as TService
    from repro_torch.ann.telemetry import constant_router as tconst
    from test_torch_telemetry import two_method_tables

    jt, tt = two_method_tables(tiny_ds.name)
    qs = make_queries(tiny_ds, Predicate.OR, 10, seed=6)
    with JFX(tiny_ds) as jfx, TFX(tds, device="cpu") as tfx:
        from repro.core import features as jF
        from repro_torch.core import features as tF
        svcs = (JService(jfx, jconst(jF.MINIMAL_FEATURES,
                                     ["ivf_gamma", "postfilter"], jt)),
                TService(tfx, tconst(tF.MINIMAL_FEATURES,
                                     ["ivf_gamma", "postfilter"], tt)))
        caches = [JCache(svcs[0], threshold=None),
                  TCache(svcs[1], threshold=None)]
        vm = vmax(tiny_ds)
        j, t = both(caches, qs.vectors[:6], qs.bitmaps[:6], Predicate.OR, 10)
        same(j, t, [None] * 6, qs.vectors[:6], vm)
        assert [tuple(d) for d in t.decisions] == \
            [tuple(d) for d in j.decisions]
        j, t = both(caches, qs.vectors[3:], qs.bitmaps[3:], Predicate.OR, 10)
        same(j, t, ["exact"] * 3 + [None] * 4, qs.vectors[3:], vm)
        assert t.decisions[:3] == [None] * 3 and t.decisions[3] is not None
        assert {"cache_s", "total_s", "search_s"} <= set(t.timings)
        assert caches[1].stats() == caches[0].stats()
        for c in caches:
            c.close()


def test_constructor_validation_and_facade(tds):
    with TFX(tds, device="cpu") as fx:
        for kw in ({"capacity": 0}, {"threshold": 1.5},
                   {"admit_after": 0}):
            with pytest.raises(ValueError):
                TCache(fx, method="prefilter", **kw)
        with pytest.raises(ValueError, match="method="):
            TCache(fx)                       # no route/execute surface
        c = TCache(fx, method="prefilter")
        assert c.index is fx and c.ds is fx.ds and c.telemetry is None
        assert not hasattr(c, "route") and not hasattr(c, "execute")
        assert c.stats()["hit_rate"] is None
        c.close()


class _TensorHandle:
    """A handle whose `fetch` and `_bitmaps_of` hand back tensors (as a
    device-resident store would)."""

    def __init__(self, fx):
        self.fx = fx
        self.ds = fx.ds
        self.torch_device = fx.torch_device

    def fetch(self, ids):
        out = np.full((ids.size, self.ds.dim), np.nan, np.float32)
        ok = ids >= 0
        out[ok] = self.ds.vectors[ids[ok]]
        return torch.from_numpy(out)

    def _bitmaps_of(self, ids):
        return torch.from_numpy(self.ds.bitmaps[ids].view(np.int32))


def test_rescore_and_bitmaps_come_to_the_host(tds):
    """The semantic and transfer hit paths read row vectors and bitmaps
    through the handle; tensors are brought to the host before the
    float64 rescoring, which then equals the numpy path's bit for bit."""
    with TFX(tds, device="cpu") as fx:
        plain = TCache(fx, method="prefilter")
        wrapped = TCache(_TensorHandle(fx), method="prefilter")
        wrapped._index = _TensorHandle(fx)
        g = np.random.default_rng(2)
        ids = np.array([5, -1, 17, 3, 299], np.int32)
        keys = ids.astype(np.int64)
        vec = g.standard_normal(tds.dim).astype(np.float32)
        a = plain._rescore(vec, ids, keys)
        b = wrapped._rescore(vec, ids, keys)
        for x, y in zip(a, b):
            assert x.tobytes() == y.tobytes()
        rb = wrapped._row_bitmaps(np.array([5, 17]))
        assert rb.dtype == np.uint32
        np.testing.assert_array_equal(rb, tds.bitmaps[[5, 17]])
        assert cache_mod._host(torch.ones(2, dtype=torch.int32),
                               np.uint32).dtype == np.uint32
        plain.close()
        wrapped.close()


def test_similarity_index_lives_on_the_handles_device(tds):
    """The per-(predicate, k) similarity index over cached queries opens
    on the wrapped handle's device, and its probe is one exact masked
    top-k over the cached queries."""
    qs = make_queries(tds, Predicate.EQUALITY, 8, seed=9)
    with TFX(tds, device="cpu") as fx:
        cache = TCache(fx, method="prefilter", threshold=0.98,
                       rebuild_every=4)
        cache.search(TQB(qs.vectors, qs.bitmaps, Predicate.EQUALITY, 5))
        part = cache._parts[(int(Predicate.EQUALITY), 5)]
        assert part.fx is not None and part.fx.torch_device == \
            fx.torch_device
        assert len(part.built) == 8 and part.tail == []
        got = part.candidates(qs.vectors[2], qs.bitmaps[2], 3)
        assert got and got[0].vector.tobytes() == qs.vectors[2].tobytes()
        cache.close()
        assert cache._parts == {}
