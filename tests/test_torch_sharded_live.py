"""The sharded live layer on the CPU against the JAX package: the same
upserts, deletes, snapshots and compactions run through both packages'
`ShardedLiveIndex` (1, 2 and 3 shards) give the same ids, keys, remaps,
exported states and searches. On an integer-grid dataset, ids and
distances are equal bit for bit (every score is exact in fp32 whatever
the summation order); on random floats ids are equal and distances
agree within `_tol` (fp32 scores summed in other orders: about
2·D·u·(‖v‖ + ‖q‖)² each, u = 2^-24, and twice that is allowed). Also
held: the sharded handle against the port's single `LiveFilteredIndex`
over the same writes, and its compaction against a
`ShardedFilteredIndex` over the compacted rows. Serving over it is in
`test_torch_sharded_live_serving.py`.

Every test draws its randomness from its own seeded generator."""

import numpy as np
import pytest
import torch

from repro.ann.dataset import ANNDataset as JDataset
from repro.ann.index import QueryBatch as JQB
from repro.ann.live import ShardedLiveIndex as JSharded
from repro_torch.ann.dataset import ANNDataset
from repro_torch.ann.engine import resolve_setting
from repro_torch.ann.index import FilteredIndex
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.live import (LiveFilteredIndex, ShardedLiveIndex,
                                  ShardedLiveSnapshot)
from repro_torch.ann.predicates import Predicate, eval_predicate_np
from repro_torch.ann.registry import get_method
from repro_torch.ann.sharded import ShardedFilteredIndex
from repro_torch.data.ann_synth import DatasetSpec, synthesize

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's
ALL_PREDS = (Predicate.EQUALITY, Predicate.AND, Predicate.OR)
SHARDS = (1, 2, 3)


@pytest.fixture(scope="module")
def tds():
    return synthesize(DatasetSpec(*TINY))


@pytest.fixture(scope="module")
def grids(tiny_ds):
    """The tiny spec's label sets under integer-grid vectors (multiples of
    1/4, a quarter of the rows duplicated): one dataset per package."""
    rng = np.random.default_rng(31)
    v = (rng.integers(-6, 7, (tiny_ds.n, tiny_ds.dim)) / 4.0).astype(
        np.float32)
    v[300:450] = v[:150]
    bm = tiny_ds.bitmaps
    return (JDataset.from_packed("grid", v, bm, tiny_ds.universe),
            ANNDataset.from_packed("grid", v, bm, tiny_ds.universe))


def _grid_queries(ds, tiny_queries, pred):
    """The tiny queries' label sets with grid query vectors."""
    qs = tiny_queries[pred]
    rng = np.random.default_rng(32 + int(pred))
    qv = (rng.integers(-6, 7, (qs.q, ds.dim)) / 4.0).astype(np.float32)
    return qv, qs.bitmaps


def _data(kind, tiny_ds, tds, grids):
    return (tiny_ds, tds) if kind == "float" else grids


def _queries(kind, ds, tiny_queries, pred):
    if kind == "float":
        qs = tiny_queries[pred]
        return qs.vectors, qs.bitmaps
    return _grid_queries(ds, tiny_queries, pred)


def _pair(jds, tds, n_shards, **kw):
    return (JSharded(jds, n_shards, **kw),
            ShardedLiveIndex(tds, n_shards, device="cpu", **kw))


def _empty_pair(ds, n_shards, **kw):
    return (JSharded(None, n_shards, name=ds.name, dim=ds.dim,
                     universe=ds.universe, **kw),
            ShardedLiveIndex(None, n_shards, name=ds.name, dim=ds.dim,
                             universe=ds.universe, device="cpu", **kw))


def _tol(vectors, qvecs, ids):
    v = np.linalg.norm(vectors[np.maximum(ids, 0)], axis=-1)
    q = np.linalg.norm(qvecs, axis=-1)[:, None]
    return 4 * vectors.shape[1] * 2.0 ** -24 * (v + q) ** 2


def _rows(live):
    """(vectors, bitmaps, tombstones) of the port's sharded live handle in
    global id order, from its exported state."""
    with live.snapshot() as snap:
        st = live.export_state(snap)
    vec = np.concatenate([st["base_vectors"], st["delta_vectors"]])
    bm = np.concatenate([st["base_bitmaps"], st["delta_bitmaps"]])
    tomb = np.zeros(vec.shape[0], bool)
    tomb[st["dead_ids"]] = True
    return vec, bm, tomb


def _oracle(vectors, bitmaps, tomb, qv, qb, pred, k):
    """Exact masked top-k ids over an explicit (rows, tombstones) state."""
    norms = np.sum(vectors.astype(np.float64) ** 2, axis=1)
    out = np.full((qv.shape[0], k), -1, np.int32)
    for qi in range(qv.shape[0]):
        ok = eval_predicate_np(bitmaps, qb[qi][None], pred) & ~tomb
        idx = np.nonzero(ok)[0]
        if idx.size:
            d = norms[idx] - 2.0 * vectors[idx] @ qv[qi].astype(np.float64)
            o = np.argsort(d, kind="stable")[:k]
            out[qi, : o.size] = idx[o]
    return out


def _dist(vectors, qv, ids):
    """float64 squared distances of `ids` (inf at −1) to their queries."""
    d = ((vectors[np.maximum(ids, 0)].astype(np.float64)
          - qv[:, None, :].astype(np.float64)) ** 2).sum(-1)
    return np.where(ids >= 0, d, np.inf)


def _same(tl, jl, qv, qb, pred, exact, k=10):
    """One batch through both handles: ids and keys equal; distances
    bit-identical when `exact`, else within `_tol`. Returns the port's."""
    tres = tl.search(TQB(qv, qb, pred, k), "prefilter")
    jres = jl.search(JQB(qv, qb, pred, k), "prefilter")
    np.testing.assert_array_equal(tres.ids, jres.ids)
    np.testing.assert_array_equal(tres.keys, jres.keys)
    ok = tres.ids >= 0
    assert np.isnan(tres.distances[~ok]).all()
    if exact:
        np.testing.assert_array_equal(tres.distances, jres.distances)
    else:
        vec, _, _ = _rows(tl)
        tol = _tol(vec, qv, tres.ids)
        assert (np.abs(tres.distances - jres.distances)[ok] <= tol[ok]).all()
    return tres


def _writes(live, ds, seed):
    """Upserts (shifted base rows) and deletes of base and delta ids."""
    rng = np.random.default_rng(seed)
    ids = live.upsert(ds.vectors[:90] + np.float32(0.25), ds.bitmaps[:90])
    dead = np.concatenate([rng.choice(ds.n, 40, replace=False),
                           ids[rng.choice(90, 20, replace=False)]])
    assert live.delete(dead) == 60
    return ids, dead


# ---------------------------------------------------------------------------
# writes and reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", SHARDS)
def test_empty_form_upsert_all_equals_sealed(grids, tiny_queries, n_shards):
    """Empty handle, every row upserted (in three batches), then
    compacted: bit for bit the reference's before and after, and the
    distances of a sealed `FilteredIndex` over the rows. Its ids too once
    compacted; before, the delta rows sit round-robin across the shards,
    so rows of equal distance on different shards fold in shard order."""
    jds, tds = grids
    jl, tl = _empty_pair(tds, n_shards)
    with jl, tl:
        for s in range(0, tds.n, 250):
            np.testing.assert_array_equal(
                tl.upsert(tds.vectors[s: s + 250], tds.bitmaps[s: s + 250]),
                jl.upsert(jds.vectors[s: s + 250], jds.bitmaps[s: s + 250]))
        sealed = FilteredIndex(tds, device="cpu")
        for gen in (0, 1):
            if gen:
                assert tl.compact() == jl.compact() == 1
                np.testing.assert_array_equal(tl.ds.vectors, tds.vectors)
                np.testing.assert_array_equal(tl.last_remap(),
                                              jl.last_remap())
            for pred in ALL_PREDS:
                qv, qb = _grid_queries(tds, tiny_queries, pred)
                res = _same(tl, jl, qv, qb, pred, exact=True)
                want = sealed.search(TQB(qv, qb, pred, 10), "prefilter")
                np.testing.assert_array_equal(res.distances, want.distances)
                if gen or n_shards == 1:
                    np.testing.assert_array_equal(res.ids, want.ids)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_same_upsert_ids_as_single_handle(tds, tiny_queries, n_shards):
    """The sharded and the single handle share one global id space: the
    same upsert ids, the same deletes counted, the same answers."""
    with LiveFilteredIndex(tds, device="cpu") as single, \
            ShardedLiveIndex(tds, n_shards, device="cpu") as sharded:
        extra_v = tds.vectors[:90] + np.float32(0.03)
        ids_s = single.upsert(extra_v, tds.bitmaps[:90])
        np.testing.assert_array_equal(
            sharded.upsert(extra_v, tds.bitmaps[:90]), ids_s)
        dele = np.concatenate([np.arange(25, 55), ids_s[10:30]])
        assert single.delete(dele) == sharded.delete(dele) == 50
        assert sharded.n_live == single.n_live == tds.n + 40
        for pred in ALL_PREDS:
            qs = tiny_queries[pred]
            b = TQB(qs.vectors, qs.bitmaps, pred, 10)
            got, want = sharded.search(b, "prefilter"), \
                single.search(b, "prefilter")
            np.testing.assert_array_equal(got.ids, want.ids)
            np.testing.assert_array_equal(got.keys, want.keys)


@pytest.mark.parametrize("kind", ["grid", "float"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_search_after_writes_matches_reference(tiny_ds, tds, grids,
                                               tiny_queries, kind, n_shards):
    """Base and delta rows, base and delta deletes: the reference's ids
    and keys for each predicate (and its distances bit for bit on the
    grid, there also the oracle's: rows of equal distance on different
    shards fold in shard order), no deleted row; the staged read (`fused
    = False`, reaching every shard) answers the same."""
    jds, tds_ = _data(kind, tiny_ds, tds, grids)
    jl, tl = _pair(jds, tds_, n_shards, delta_chunk=32)
    with jl, tl:
        _, dead = _writes(tl, tds_, 5)
        _writes(jl, jds, 5)
        vec, bm, tomb = _rows(tl)
        for pred in ALL_PREDS:
            qv, qb = _queries(kind, tds_, tiny_queries, pred)
            res = _same(tl, jl, qv, qb, pred, exact=kind == "grid")
            if kind == "grid":       # ties across shards fold in shard order
                want = _oracle(vec, bm, tomb, qv, qb, pred, 10)
                np.testing.assert_array_equal(_dist(vec, qv, res.ids),
                                              _dist(vec, qv, want))
            assert not np.isin(res.ids[res.ids >= 0], dead).any()
            tl.fused = False
            assert not any(s.fused for s in tl.shards)
            staged = tl.search(TQB(qv, qb, pred, 10), "prefilter")
            tl.fused = True
            np.testing.assert_array_equal(staged.ids, res.ids)
            if kind == "grid":
                np.testing.assert_array_equal(staged.distances,
                                              res.distances)


def test_one_shard_past_k_128_and_an_empty_shard(grids, tiny_queries):
    """Deletes crowd one shard's base so its overfetch passes 128 (the
    k > 128 top-k) while the others stay below: [S, Q, K] folds with the
    widest K. An empty-form handle with fewer rows than shards keeps an
    empty shard, whose reads are all pads. Bit for bit the reference's."""
    jds, tds = grids
    jl, tl = _pair(jds, tds, 3)
    with jl, tl:
        for live in (jl, tl):
            live.delete(np.arange(0, 180))          # all in shard 0
            live.upsert(tds.vectors[:5], tds.bitmaps[:5])
        for pred in ALL_PREDS:
            qv, qb = _grid_queries(tds, tiny_queries, pred)
            _same(tl, jl, qv, qb, pred, exact=True, k=40)
    jl, tl = _empty_pair(tds, 3)
    with jl, tl:
        for live in (jl, tl):
            live.upsert(tds.vectors[:2], tds.bitmaps[:2])
        assert tl.shards[2].n_total == 0
        qv, qb = _grid_queries(tds, tiny_queries, Predicate.OR)
        res = _same(tl, jl, qv, qb, Predicate.OR, exact=True)
        assert (res.ids[:, 2:] == -1).all()
        assert np.isnan(res.distances[:, 2:]).all()


def test_serial_equals_parallel_with_stage_timings(tds, tiny_queries):
    qs = tiny_queries[Predicate.AND]
    b = TQB(qs.vectors, qs.bitmaps, Predicate.AND, 10)
    with ShardedLiveIndex(tds, 3, device="cpu") as par, \
            ShardedLiveIndex(tds, 3, device="cpu", parallel=False) as ser:
        for live in (par, ser):
            _writes(live, tds, 6)
        a, c = par.search(b, "prefilter"), ser.search(b, "prefilter")
        np.testing.assert_array_equal(a.ids, c.ids)
        np.testing.assert_array_equal(a.distances, c.distances)
        for res in (a, c):
            assert {"base_s", "delta_s", "merge_s", "shard0_s", "shard2_s",
                    "shard_max_s"} <= res.timings.keys()
            assert res.timings["shard_max_s"] <= res.timings["search_s"]
        assert par.stats()["shards"][0]["device"] == "cpu"


# ---------------------------------------------------------------------------
# snapshots, epochs, compaction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", SHARDS)
def test_snapshot_pinned_across_write_and_compact(tds, tiny_queries,
                                                  n_shards):
    """A pinned epoch answers unchanged across a write and across
    `compact()`, keeps its old shards open until released, then they
    close; a fresh snapshot sees the write."""
    qs = tiny_queries[Predicate.OR]
    b = TQB(qs.vectors, qs.bitmaps, Predicate.OR, 10)
    with ShardedLiveIndex(tds, n_shards, device="cpu") as live:
        _writes(live, tds, 7)
        snap = live.snapshot()
        assert isinstance(snap, ShardedLiveSnapshot)
        ps = resolve_setting(get_method("prefilter"), None)
        want = live.run_method("prefilter", ps, b, snapshot=snap)
        new = live.upsert(b.vectors[:5], b.bitmaps[:5])
        live.delete(want[0][:5, 0][want[0][:5, 0] >= 0])
        got = live.run_method("prefilter", ps, b, snapshot=snap)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(
            live.search(b, "prefilter").ids[:5, 0], new)
        old = list(live.shards)
        assert live.compact() == 1
        assert live.stats()["generation"] == 1
        got = live.run_method("prefilter", ps, b, snapshot=snap)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
        assert not any(s.closed for s in old)
        snap.release()
        snap.release()                        # idempotent
        assert all(s.closed for s in old)
        assert not live._old_shards and not live._epoch_readers


@pytest.mark.parametrize("kind", ["grid", "float"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_compaction_equals_sharded_index_and_reference(
        tiny_ds, tds, grids, tiny_queries, kind, n_shards):
    """After writes, `compact()` gives the reference's remap, keys and
    bounds, and answers as a `ShardedFilteredIndex` over the compacted
    dataset, bit for bit; `last_remap` takes the ids before to the ids
    after, with the same keys (on the grid, where rows of equal distance
    on different shards folded in shard order before, to the same id
    sets)."""
    jds, tds_ = _data(kind, tiny_ds, tds, grids)
    jl, tl = _pair(jds, tds_, n_shards)
    with jl, tl:
        for live, ds in ((jl, jds), (tl, tds_)):
            _writes(live, ds, 8)
        assert tl.last_remap() is None
        before = {}
        for pred in ALL_PREDS:
            qv, qb = _queries(kind, tds_, tiny_queries, pred)
            before[pred] = tl.search(TQB(qv, qb, pred, 10), "prefilter")
        assert tl.compact() == jl.compact() == 1
        remap = tl.last_remap()
        np.testing.assert_array_equal(remap, jl.last_remap())
        np.testing.assert_array_equal(tl.bounds, jl.bounds)
        np.testing.assert_array_equal(tl.ds.vectors, jl.ds.vectors)
        st = tl.stats()
        assert st["base_n"] == tds_.n + 90 - 60 and st["delta_rows"] == 0
        with ShardedFilteredIndex(tl.ds, n_shards, device="cpu") as sfx:
            for pred in ALL_PREDS:
                qv, qb = _queries(kind, tds_, tiny_queries, pred)
                got = _same(tl, jl, qv, qb, pred, exact=kind == "grid")
                want = sfx.search(TQB(qv, qb, pred, 10), "prefilter")
                np.testing.assert_array_equal(got.ids, want.ids)
                np.testing.assert_array_equal(got.distances, want.distances)
                pre = before[pred]
                moved = np.where(pre.ids >= 0,
                                 remap[np.maximum(pre.ids, 0)], -1)
                np.testing.assert_array_equal(pre.distances, got.distances)
                if kind == "float":
                    np.testing.assert_array_equal(moved, got.ids)
                    np.testing.assert_array_equal(pre.keys, got.keys)
                else:      # before, grid ties across shards in shard order
                    np.testing.assert_array_equal(np.sort(moved, axis=1),
                                                  np.sort(got.ids, axis=1))


@pytest.mark.parametrize("n_shards", [2, 3])
def test_writes_during_compaction_carry_over(tds, tiny_queries, n_shards):
    """Rows upserted and deleted while the global rebuild runs survive the
    swap: late rows become the new delta, late deletes of base and delta
    rows are remapped; the answers are the oracle's over the live rows."""
    qs = tiny_queries[Predicate.OR]
    b = TQB(qs.vectors, qs.bitmaps, Predicate.OR, 10)
    with ShardedLiveIndex(tds, n_shards, device="cpu") as live:
        ids = live.upsert(tds.vectors[:30] + np.float32(0.5),
                          tds.bitmaps[:30])
        fut = live.compact_async()
        late = live.upsert(tds.vectors[30:45] + np.float32(0.25),
                           tds.bitmaps[30:45])
        live.delete([3, 7, int(ids[4]), int(late[2])])
        assert fut.result(timeout=120) == 1
        assert live.n_live == tds.n + 45 - 4
        vec, bm, tomb = _rows(live)
        assert int((~tomb).sum()) == live.n_live
        res = live.search(b, "prefilter")
        np.testing.assert_array_equal(res.ids, _oracle(
            vec, bm, tomb, b.vectors, b.bitmaps, Predicate.OR, 10))


def test_compaction_below_the_shard_count_restarts_empty(tds):
    """Fewer surviving rows than shards: the reference's empty-shard
    restart, the rows replayed as delta with their keys."""
    jl, tl = _empty_pair(tds, 3)
    with jl, tl:
        for live in (jl, tl):
            live.upsert(tds.vectors[:4], tds.bitmaps[:4], keys=[7, 8, 9, 10])
            live.delete([0, 2])
            live.compact()
        assert tl.ds is None and tl.base_n == 0
        np.testing.assert_array_equal(tl.last_remap(), jl.last_remap())
        np.testing.assert_array_equal(tl.keys_of(np.arange(tl.n_total)),
                                      jl.keys_of(np.arange(jl.n_total)))
        np.testing.assert_array_equal(tl.fetch([0, 1]), tds.vectors[[1, 3]])


# ---------------------------------------------------------------------------
# state, keys, lifecycle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", SHARDS)
def test_export_state_equals_reference(tiny_ds, tds, n_shards):
    """The exported state of a pinned epoch in global id order: the
    reference's dict, its `base_ds` given as packed arrays."""
    jl, tl = _pair(tiny_ds, tds, n_shards)
    with jl, tl:
        for live, ds in ((jl, tiny_ds), (tl, tds)):
            _writes(live, ds, 9)
            live.upsert(ds.vectors[:3], ds.bitmaps[:3], keys=[7000, 7001, 7002])
        with tl.snapshot() as ts, jl.snapshot() as js:
            got, want = tl.export_state(ts), jl.export_state(js)
        base = want.pop("base_ds")
        np.testing.assert_array_equal(got.pop("base_vectors"), base.vectors)
        np.testing.assert_array_equal(got.pop("base_bitmaps"), base.bitmaps)
        assert (got.pop("name"), got.pop("universe")) == \
            (tds.name, tds.universe)
        assert got.keys() == want.keys()
        for key, val in want.items():
            np.testing.assert_array_equal(got[key], val)
            assert np.asarray(got[key]).dtype == np.asarray(val).dtype


@pytest.mark.parametrize("n_shards", [2, 3])
def test_keys_rows_fetch_and_label_clocks(tiny_ds, tds, n_shards):
    """`keys_of`, `rows_of`, `delete_keys`, `fetch` and the label clocks
    agree with the reference's through a compaction."""
    jl, tl = _pair(tiny_ds, tds, n_shards)
    with jl, tl:
        for live, ds in ((jl, tiny_ds), (tl, tds)):
            live.upsert(ds.vectors[:10], ds.bitmaps[:10])
            live.upsert(ds.vectors[10:14], ds.bitmaps[10:14],
                        keys=[9000, 9001, 9002, 9003])
            with pytest.raises(ValueError, match="already names a live"):
                live.upsert(ds.vectors[:1], ds.bitmaps[:1], keys=[9001])
            assert live.delete_keys([9001, 3]) == 2
            with pytest.raises(KeyError, match="unknown"):
                live.delete_keys([123456])
            live.upsert(ds.vectors[20:21], ds.bitmaps[20:21], keys=[9001])
        probe = [0, 3, 9000, 9001, 9003, 123456, tds.n + 2]
        np.testing.assert_array_equal(tl.rows_of(probe), jl.rows_of(probe))
        for labels in (None, [], [0, 5], [int(tds.universe) - 1]):
            assert tl.label_clock(labels) == jl.label_clock(labels)
        ids = np.array([-1, 0, 5, tds.n, tds.n + 11, tds.n + 14])
        np.testing.assert_array_equal(tl.keys_of(ids), jl.keys_of(ids))
        got = tl.fetch(ids)
        np.testing.assert_array_equal(got, jl.fetch(ids))
        assert np.isnan(got[0]).all()
        np.testing.assert_array_equal(got[5], tds.vectors[20])
        with pytest.raises(IndexError):
            tl.delete([tl.n_total])
        tl.compact()
        jl.compact()
        np.testing.assert_array_equal(tl.rows_of(probe), jl.rows_of(probe))
        ids = np.arange(tl.n_total)
        np.testing.assert_array_equal(tl.keys_of(ids), jl.keys_of(ids))
        assert tl.stats()["next_key"] == jl.stats()["next_key"]


def test_validation_and_lifecycle(tds, monkeypatch):
    with pytest.raises(ValueError, match="n_shards"):
        ShardedLiveIndex(tds, 0, device="cpu")
    with pytest.raises(ValueError, match="name="):
        ShardedLiveIndex(None, 2, device="cpu")
    live = ShardedLiveIndex(tds, 2, device="cpu")
    with pytest.raises(ValueError, match="upsert vectors"):
        live.upsert(np.zeros((2, 3), np.float32), tds.bitmaps[:2])
    assert live.feature_index.ds is tds
    assert live.torch_device == torch.device("cpu")
    assert live.device.vectors.device.type == "cpu"
    live.close()
    live.close()                              # idempotent
    assert live.closed and all(s.closed for s in live.shards)
    with pytest.raises(RuntimeError, match="closed"):
        live.snapshot()
    with pytest.raises(RuntimeError, match="closed"):
        live.upsert(tds.vectors[:1], tds.bitmaps[:1])
    empty = ShardedLiveIndex(None, 2, name="e", dim=tds.dim,
                             universe=tds.universe, device="cpu")
    with pytest.raises(RuntimeError, match="no sealed base"):
        empty.feature_index
    empty.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedLiveIndex(tds, 2)
