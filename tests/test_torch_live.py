"""The live layer on the CPU against the JAX package: the same upserts,
deletes, snapshots and compactions run through both packages'
`LiveFilteredIndex` on one dataset give the same ids, keys, remaps,
tombstones and routing features; distances agree to fp32 summation
order. The single-index patterns of `tests/test_live.py`, and the key
table and graft compaction of `tests/test_live_fused.py`; the fused read
and its pruners are in `test_torch_live_fused.py`, serving over a live
handle in `test_torch_live_serving.py`.

Every test draws its randomness from its own seeded generator."""

import numpy as np
import pytest
import torch

from repro.ann import ivf as jivf
from repro.ann.index import QueryBatch as JQB
from repro.ann.live import KeyTable as JKeyTable
from repro.ann.live import LiveFilteredIndex as JLive
from repro_torch.ann import ivf as tivf
from repro_torch.ann.index import FilteredIndex
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.live import DeltaSegment, KeyTable, LiveFilteredIndex
from repro_torch.ann.predicates import Predicate, eval_predicate_np
from repro_torch.ann.registry import default_registry
from repro_torch.data.ann_synth import DatasetSpec, synthesize
from repro_torch.kernels import masked_topk as mk

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's
ALL_PREDS = (Predicate.EQUALITY, Predicate.AND, Predicate.OR)


@pytest.fixture(scope="module")
def tds():
    return synthesize(DatasetSpec(*TINY))


def _live(ds, **kw):
    return LiveFilteredIndex(ds, device="cpu", **kw)


def _empty(ds, **kw):
    return LiveFilteredIndex.empty(ds.name, ds.dim, ds.universe,
                                   device="cpu", **kw)


def _batches(qs, pred, k=10, take=None):
    sl = slice(None) if take is None else slice(0, take)
    return (JQB(qs.vectors[sl], qs.bitmaps[sl], pred, k),
            TQB(qs.vectors[sl], qs.bitmaps[sl], pred, k))


def _tol(vectors, qvecs, ids):
    """Exact distances from fp32 scores summed in different orders differ
    by at most about 2·D·u·(‖v‖ + ‖q‖)² each (u = 2^-24); twice that."""
    v = np.linalg.norm(vectors[np.maximum(ids, 0)], axis=-1)
    q = np.linalg.norm(qvecs, axis=-1)[:, None]
    return 4 * vectors.shape[1] * 2.0 ** -24 * (v + q) ** 2


def _state(live):
    """(vectors, bitmaps, tombstones) in global-id order (either package)."""
    dvec, dbm, _ = live._delta.host_view(live._delta.rows)
    if live._base_fx is not None:
        return (np.concatenate([live.ds.vectors, dvec]),
                np.concatenate([live.ds.bitmaps, dbm]), live._tomb.copy())
    return dvec, dbm, live._tomb.copy()


def _same(tlive, jlive, tb, jb, method="prefilter"):
    """Search both handles with one batch: the same ids and keys, NaN at
    −1, distances within `_tol` of each other."""
    tres = tlive.search(tb, method)
    jres = jlive.search(jb, method)
    np.testing.assert_array_equal(tres.ids, jres.ids)
    np.testing.assert_array_equal(tres.keys, jres.keys)
    ok = tres.ids >= 0
    assert np.isnan(tres.distances[~ok]).all()
    vec, _, _ = _state(tlive)
    tol = _tol(vec, tb.vectors, tres.ids)
    assert (np.abs(tres.distances - jres.distances)[ok] <= tol[ok]).all()
    return tres, jres


def _oracle(vectors, bitmaps, tomb, qv, qb, pred, k):
    """Exact masked top-k ids over an explicit (rows, tombstones) state."""
    norms = np.sum(vectors.astype(np.float64) ** 2, axis=1)
    out = np.full((qv.shape[0], k), -1, np.int32)
    for qi in range(qv.shape[0]):
        ok = eval_predicate_np(bitmaps, qb[qi][None], pred) & ~tomb
        idx = np.nonzero(ok)[0]
        if not idx.size:
            continue
        d = norms[idx] - 2.0 * vectors[idx] @ qv[qi].astype(np.float64)
        o = np.argsort(d, kind="stable")[:k]
        out[qi, : o.size] = idx[o]
    return out


# ---------------------------------------------------------------------------
# sealed/live equivalence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pred", ALL_PREDS)
def test_live_equals_sealed_before_writes(tiny_ds, tds, tiny_queries, pred):
    jb, tb = _batches(tiny_queries[pred], pred)
    with _live(tds) as tl, JLive(tiny_ds) as jl:
        res, _ = _same(tl, jl, tb, jb)
        want = FilteredIndex(tds, device="cpu").search(tb, "prefilter")
        np.testing.assert_array_equal(res.ids, want.ids)
        np.testing.assert_array_equal(res.distances, want.distances)
        assert {"base_s", "delta_s", "merge_s"} <= res.timings.keys()


@pytest.mark.parametrize("pred", ALL_PREDS)
def test_upsert_all_matches_sealed_pre_compact(tiny_ds, tds, tiny_queries,
                                               pred):
    """Everything in the delta, no base: the delta path alone is exact."""
    jb, tb = _batches(tiny_queries[pred], pred)
    with _empty(tds) as tl, JLive.empty("tiny", tiny_ds.dim,
                                        tiny_ds.universe) as jl:
        for s in range(0, tds.n, 150):
            assert np.array_equal(
                tl.upsert(tds.vectors[s: s + 150], tds.bitmaps[s: s + 150]),
                jl.upsert(tiny_ds.vectors[s: s + 150],
                          tiny_ds.bitmaps[s: s + 150]))
        res, _ = _same(tl, jl, tb, jb)
        want = FilteredIndex(tds, device="cpu").search(tb, "prefilter")
        np.testing.assert_array_equal(res.ids, want.ids)


@pytest.mark.parametrize("pred", ALL_PREDS)
@pytest.mark.parametrize("q_take,k", [(25, 10), (1, 10), (7, 40)])
def test_upsert_all_then_compact_matches_fresh(tiny_ds, tds, tiny_queries,
                                               pred, q_take, k):
    """Empty live + upsert everything + compact is bit-identical (ids and
    distances) to a FilteredIndex built directly, across predicates,
    ragged Q, and k above the matches; and equal to the JAX package's."""
    jb, tb = _batches(tiny_queries[pred], pred, k, q_take)
    with _empty(tds) as tl, JLive.empty("tiny", tiny_ds.dim,
                                        tiny_ds.universe) as jl:
        tl.upsert(tds.vectors, tds.bitmaps)
        jl.upsert(tiny_ds.vectors, tiny_ds.bitmaps)
        assert tl.compact() == jl.compact() == 1
        assert tl.stats()["delta_rows"] == 0
        np.testing.assert_array_equal(tl.ds.vectors, tds.vectors)
        np.testing.assert_array_equal(tl.ds.bitmaps, tds.bitmaps)
        np.testing.assert_array_equal(tl.last_remap(), jl.last_remap())
        res, _ = _same(tl, jl, tb, jb)
        want = FilteredIndex(tds, device="cpu").search(tb, "prefilter")
        np.testing.assert_array_equal(res.ids, want.ids)
        np.testing.assert_array_equal(res.distances, want.distances)


def test_mixed_base_plus_delta_is_exact(tiny_ds, tds, tiny_queries):
    """Sealed base + delta + tombstones in both: the JAX package's ids and
    keys, the oracle's ids, no deleted id."""
    with _live(tds) as tl, JLive(tiny_ds) as jl:
        new = tl.upsert(tds.vectors[:80] + np.float32(0.01), tds.bitmaps[:80])
        jnew = jl.upsert(tiny_ds.vectors[:80] + np.float32(0.01),
                         tiny_ds.bitmaps[:80])
        np.testing.assert_array_equal(new, jnew)
        dele = np.concatenate([np.arange(10, 40), new[5:20]])
        assert tl.delete(dele) == jl.delete(dele) == 45
        assert tl.delete(dele[:3]) == 0
        vec, bm, tomb = _state(tl)
        for pred in ALL_PREDS:
            jb, tb = _batches(tiny_queries[pred], pred)
            res, _ = _same(tl, jl, tb, jb)
            np.testing.assert_array_equal(res.ids, _oracle(
                vec, bm, tomb, tb.vectors, tb.bitmaps, pred, 10))
            assert not np.isin(res.ids[res.ids >= 0], dele).any()


def test_all_tombstoned_and_empty_index(tiny_ds, tds, tiny_queries):
    jb, tb = _batches(tiny_queries[Predicate.OR], Predicate.OR)
    with _live(tds) as tl:
        tl.upsert(tds.vectors[:30], tds.bitmaps[:30])
        tl.delete(np.arange(tl.n_total))
        assert tl.n_live == 0
        res = tl.search(tb, "prefilter")
        assert (res.ids == -1).all() and np.isnan(res.distances).all()
    with _empty(tds) as tl:
        res = tl.search(TQB(tb.vectors, tb.bitmaps, Predicate.AND, 5),
                        "prefilter")
        assert (res.ids == -1).all() and np.isnan(res.distances).all()


def test_compact_preserves_results_and_remaps_ids(tiny_ds, tds,
                                                  tiny_queries):
    """Pre/post-compact results agree on distances and on the vectors
    behind the ids; the remap, the ids and keys equal the JAX package's."""
    jb, tb = _batches(tiny_queries[Predicate.AND], Predicate.AND)
    with _live(tds) as tl, JLive(tiny_ds) as jl:
        for live, ds in ((tl, tds), (jl, tiny_ds)):
            ids = live.upsert(ds.vectors[:60] + np.float32(0.02),
                              ds.bitmaps[:60])
            live.delete(np.concatenate([np.arange(0, 20), ids[:10]]))
        before, _ = _same(tl, jl, tb, jb)
        vec_before = tl.fetch(before.ids.ravel())
        assert tl.compact() == jl.compact() == 1
        np.testing.assert_array_equal(tl.last_remap(), jl.last_remap())
        after, _ = _same(tl, jl, tb, jb)
        np.testing.assert_array_equal(after.keys, before.keys)
        np.testing.assert_allclose(after.distances, before.distances,
                                   rtol=1e-5, atol=1e-5, equal_nan=True)
        np.testing.assert_array_equal(tl.fetch(after.ids.ravel()),
                                      vec_before)


def test_last_remap_translates_ids(tiny_ds, tds):
    with _live(tds) as tl, JLive(tiny_ds) as jl:
        for live, ds in ((tl, tds), (jl, tiny_ds)):
            ids = live.upsert(ds.vectors[:20] + np.float32(0.01),
                              ds.bitmaps[:20])
            live.delete([0, 1, int(ids[0])])
        assert tl.last_remap() is None
        tl.compact()
        jl.compact()
        remap = tl.last_remap()
        np.testing.assert_array_equal(remap, jl.last_remap())
        assert remap.shape == (tds.n + 20,)
        assert remap[0] == remap[1] == remap[tds.n] == -1
        np.testing.assert_array_equal(tl.ds.vectors[remap[5]],
                                      tds.vectors[5])
        np.testing.assert_array_equal(tl.keys_of(remap[remap >= 0]),
                                      jl.keys_of(remap[remap >= 0]))


# ---------------------------------------------------------------------------
# snapshots / epochs
# ---------------------------------------------------------------------------

def test_snapshot_isolates_from_writes(tds, tiny_queries):
    qs = tiny_queries[Predicate.AND]
    batch = TQB(qs.vectors, qs.bitmaps, Predicate.AND, 10)
    with _live(tds) as live:
        want = live.search(batch, "prefilter")
        with live.snapshot() as snap:
            live.upsert(tds.vectors[:40] + np.float32(0.5), tds.bitmaps[:40])
            live.delete(np.arange(0, 50))
            got = live.search(batch, "prefilter", snapshot=snap)
            np.testing.assert_array_equal(got.ids, want.ids)
            np.testing.assert_array_equal(got.distances, want.distances)
            assert not np.array_equal(live.search(batch, "prefilter").ids,
                                      want.ids)


def test_snapshot_survives_compaction(tds, tiny_queries):
    """An old-epoch reader keeps its base across a compact() and frees it
    on release."""
    qs = tiny_queries[Predicate.OR]
    batch = TQB(qs.vectors, qs.bitmaps, Predicate.OR, 10)
    with _live(tds) as live:
        live.upsert(tds.vectors[:20] + np.float32(0.1), tds.bitmaps[:20])
        snap = live.snapshot()
        want = live.search(batch, "prefilter", snapshot=snap)
        live.compact()
        assert live.generation == 1
        assert live.stats()["retired_generations"] == [0]
        got = live.search(batch, "prefilter", snapshot=snap)
        np.testing.assert_array_equal(got.ids, want.ids)
        snap.release()
        assert live.stats()["retired_generations"] == []
        with pytest.raises(RuntimeError, match="released"):
            live.search(batch, "prefilter", snapshot=snap)


def test_snapshot_of_empty_base_generation_survives_compact(tds):
    with _empty(tds) as live:
        ids = live.upsert(tds.vectors[:50], tds.bitmaps[:50])
        with live.snapshot() as snap:
            live.compact()
            assert live.generation == 1
            np.testing.assert_array_equal(live.fetch(ids, snapshot=snap),
                                          tds.vectors[:50])


def test_writes_during_compaction_carry_over(tds, tiny_queries):
    """Rows upserted and deleted while a compaction rebuilds survive the
    swap: the late rows become the new delta, late deletes are remapped."""
    qs = tiny_queries[Predicate.OR]
    batch = TQB(qs.vectors, qs.bitmaps, Predicate.OR, 10)
    with _live(tds) as live:
        fut = live.compact_async()
        live.upsert(tds.vectors[:15] + np.float32(0.25), tds.bitmaps[:15])
        live.delete([3, 7])
        fut.result(timeout=120)
        st = live.stats()
        assert st["generation"] == 1
        assert st["n_live"] == tds.n + 15 - 2
        vec, bm, tomb = _state(live)
        res = live.search(batch, "prefilter")
        np.testing.assert_array_equal(res.ids, _oracle(
            vec, bm, tomb, batch.vectors, batch.bitmaps, Predicate.OR, 10))


# ---------------------------------------------------------------------------
# stable keys and label clocks
# ---------------------------------------------------------------------------

def test_keys_and_label_clocks_match_reference(tiny_ds, tds):
    """Upserts with and without keys, a key re-pointed after its delete,
    delete_keys, rows_of and the label clocks: both packages agree
    through a compaction."""
    with _live(tds) as tl, JLive(tiny_ds) as jl:
        for live, ds in ((tl, tds), (jl, tiny_ds)):
            live.upsert(ds.vectors[:10], ds.bitmaps[:10])
            live.upsert(ds.vectors[10:14], ds.bitmaps[10:14],
                        keys=[9000, 9001, 9002, 9003])
            with pytest.raises(ValueError, match="already names a live"):
                live.upsert(ds.vectors[:1], ds.bitmaps[:1], keys=[9001])
            with pytest.raises(ValueError, match="unique"):
                live.upsert(ds.vectors[:2], ds.bitmaps[:2], keys=[5, 5])
            assert live.delete_keys([9001, 3]) == 2
            with pytest.raises(KeyError, match="unknown"):
                live.delete_keys([123456])
            live.upsert(ds.vectors[20:21], ds.bitmaps[20:21], keys=[9001])
        probe = [0, 3, 9000, 9001, 9003, 123456, tds.n + 2]
        np.testing.assert_array_equal(tl.rows_of(probe), jl.rows_of(probe))
        for labels in (None, [], [0, 5], [int(tds.universe) - 1]):
            assert tl.label_clock(labels) == jl.label_clock(labels)
        tl.compact()
        jl.compact()
        np.testing.assert_array_equal(tl.rows_of(probe), jl.rows_of(probe))
        ids = np.arange(tl.n_total)
        np.testing.assert_array_equal(tl.keys_of(ids), jl.keys_of(ids))
        assert tl.stats()["next_key"] == jl.stats()["next_key"]


@pytest.mark.parametrize("with_base", [True, False])
def test_from_state_opens_the_reference_export(tiny_ds, tds, tiny_queries,
                                               with_base):
    """`from_state` on the JAX package's `export_state` (its base dataset
    given as packed arrays) answers as the JAX index does: ids, keys,
    tombstones; and the port's own export round-trips."""
    seed = np.random.default_rng(21)
    jl = JLive(tiny_ds) if with_base else JLive.empty(
        "tiny", tiny_ds.dim, tiny_ds.universe)
    with jl:
        jl.upsert(tiny_ds.vectors[:70] + np.float32(0.03),
                  tiny_ds.bitmaps[:70])
        jl.upsert(tiny_ds.vectors[70:75], tiny_ds.bitmaps[70:75],
                  keys=[7000, 7001, 7002, 7003, 7004])
        jl.delete(seed.choice(jl.n_total, 60, replace=False))
        with jl.snapshot() as snap:
            state = dict(jl.export_state(snap))
        base = state.pop("base_ds")
        state.update(
            name="tiny", universe=tiny_ds.universe,
            base_vectors=(base.vectors if base is not None else
                          np.zeros((0, tiny_ds.dim), np.float32)),
            base_bitmaps=(base.bitmaps if base is not None else
                          np.zeros((0, tiny_ds.bitmaps.shape[1]), np.uint32)))
        with LiveFilteredIndex.from_state(state, device="cpu") as tl:
            assert tl.n_total == jl.n_total and tl.n_live == jl.n_live
            assert tl.generation == jl.generation
            np.testing.assert_array_equal(tl._tomb, jl._tomb)
            assert tl.stats()["next_key"] == jl.stats()["next_key"]
            np.testing.assert_allclose(tl.live_stats().label_freq,
                                       jl.live_stats().label_freq, atol=0)
            for pred in ALL_PREDS:
                jb, tb = _batches(tiny_queries[pred], pred)
                _same(tl, jl, tb, jb)
            with tl.snapshot() as snap:
                again = tl.export_state(snap)
            for key in ("base_keys", "delta_vectors", "delta_bitmaps",
                        "delta_keys", "dead_ids", "base_vectors",
                        "base_bitmaps"):
                np.testing.assert_array_equal(again[key], state[key])
            assert again["next_key"] == state["next_key"]


# ---------------------------------------------------------------------------
# the key table, graft compaction
# ---------------------------------------------------------------------------

def test_key_table_matches_reference():
    rng = np.random.default_rng(12)
    t, j = KeyTable(), JKeyTable()
    for s in range(0, 20000, 1000):            # several rehashes
        ks = rng.choice(10 ** 12, size=1000, replace=False).astype(np.int64)
        t.insert(ks, np.arange(s, s + 1000))
        j.insert(ks, np.arange(s, s + 1000))
    t.insert(np.array([7, 7, 9, 7]), np.array([1, 2, 3, 4]))
    j.insert(np.array([7, 7, 9, 7]), np.array([1, 2, 3, 4]))
    probe = np.concatenate([rng.integers(0, 10 ** 12, 3000), [7, 9, 8]])
    np.testing.assert_array_equal(t.lookup(probe), j.lookup(probe))
    assert len(t) == len(j)
    assert t.lookup(np.array([7]))[0] == 4


def test_graft_ivf_equals_reference():
    rng = np.random.default_rng(4)
    n, d = 2000, 16
    v = rng.normal(size=(n, d)).astype(np.float32)
    old = tivf.build_ivf(v, 24, seed=13)
    jold = jivf.build_ivf(v, 24, seed=13)
    keep = np.setdiff1d(np.arange(n), rng.choice(n, 200, replace=False))
    nv = np.concatenate([v[keep], rng.normal(size=(300, d)).astype(
        np.float32)])
    o2n = np.full(n, -1, np.int64)
    o2n[keep] = np.arange(keep.size)
    got = tivf.graft_ivf(old, nv, o2n)
    want = jivf.graft_ivf(jold, nv, o2n)
    for f in ("centroids", "centroid_norms", "lists", "list_len"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assign = tivf.assign_to_centroids(nv, old.centroids)
    lists, _ = tivf.pack_lists(assign, old.centroids.shape[0])
    np.testing.assert_array_equal(got.lists, lists)


@pytest.mark.parametrize("graft", [True, False])
def test_compaction_grafts_as_reference(tiny_ds, tds, tiny_queries, graft):
    """With deletes + delta, compaction grafts the IVF indexes (frozen
    centroids, the JAX package's lists) or, with graft=False, rebuilds
    them; ivf_gamma and prefilter answers then match the reference's."""
    pred = Predicate.AND
    jb, tb = _batches(tiny_queries[pred], pred)
    dead = np.random.default_rng(6).choice(tds.n, 60, replace=False)
    with _live(tds, graft=graft) as tl, JLive(tiny_ds, graft=graft) as jl:
        _same(tl, jl, tb, jb, "ivf_gamma")
        (key, old), = tl._base_fx._indexes.items()
        for live, ds in ((tl, tds), (jl, tiny_ds)):
            live.upsert(ds.vectors[:100] + np.float32(0.02),
                        ds.bitmaps[:100])
            live.delete(dead)
            live.compact()
        new = tl._base_fx._indexes[key]
        want = jl._base_fx._indexes[key]
        np.testing.assert_array_equal(new.centroids, want.centroids)
        np.testing.assert_array_equal(new.lists, want.lists)
        if graft:
            np.testing.assert_array_equal(new.centroids, old.centroids)
        else:
            fresh = default_registry().get(key[0]).build(tl.ds,
                                                         dict(key[1]))
            np.testing.assert_array_equal(new.lists, fresh.lists)
        assert tl.built_keys() == [key]
        _same(tl, jl, tb, jb, "ivf_gamma")
        _same(tl, jl, tb, jb)



# ---------------------------------------------------------------------------
# delta segment mechanics, validation, lifecycle, devices
# ---------------------------------------------------------------------------

def test_delta_segment_growth_and_mirror(tds):
    seg = DeltaSegment(tds.dim, tds.bitmaps.shape[1], chunk=16,
                       device="cpu")
    for s in range(0, 40, 8):
        seg.append(tds.vectors[s: s + 8], tds.bitmaps[s: s + 8])
    assert seg.rows == 40
    vec, norms, bm = seg.device_view(40)
    # 32 mirrored rows (two sealed chunks) + one padded tail chunk
    assert vec.shape[0] == 48 and seg.device_rows() == 32
    np.testing.assert_array_equal(vec[:40].numpy(), tds.vectors[:40])
    np.testing.assert_array_equal(bm[:40].numpy().view(np.uint32),
                                  tds.bitmaps[:40])
    assert bm.dtype == torch.int32 and (bm[40:] == 0).all()
    assert (norms[40:] >= mk.PAD_SCORE).all() and (vec[40:] == 0).all()
    assert seg.device_view(40) is seg.device_view(40)
    seg.append(tds.vectors[40:41], tds.bitmaps[40:41])
    vec2, _, _ = seg.device_view(41)
    assert seg.device_rows() == 32 and vec2.shape[0] == 48


def test_live_validation_and_lifecycle(tds, monkeypatch):
    live = _live(tds)
    with pytest.raises(ValueError, match="vectors"):
        live.upsert(tds.vectors[:2, :-3], tds.bitmaps[:2])
    with pytest.raises(ValueError, match="bitmaps"):
        live.upsert(tds.vectors[:2],
                    np.concatenate([tds.bitmaps[:2]] * 2, axis=1))
    with pytest.raises(IndexError, match="delete ids"):
        live.delete([tds.n + 5])
    live.close()
    live.close()                                  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        live.upsert(tds.vectors[:1], tds.bitmaps[:1])
    with pytest.raises(RuntimeError, match="closed"):
        live.snapshot()
    with pytest.raises(ValueError, match="needs name"):
        LiveFilteredIndex(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LiveFilteredIndex(tds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LiveFilteredIndex.empty("x", tds.dim, tds.universe)
