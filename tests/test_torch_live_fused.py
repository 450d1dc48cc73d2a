"""The live layer's read path on the CPU against the JAX package: the
fused read against the staged one (bit for bit on an integer grid, where
every score is exact whatever the summation order; on random floats the
reference's own two paths differ in the last ulp) and against the
reference's fused read, the sealed-chunk pruner (distance and label
bounds) and its chunk indexes. The read-path patterns of
`tests/test_live_fused.py`; the helpers are `test_torch_live.py`'s.

Every test draws its randomness from its own seeded generator."""

import numpy as np
import pytest

from repro.ann.index import QueryBatch as JQB
from repro.ann.live import LiveFilteredIndex as JLive
from repro.ann.live import build_chunk_index as j_build_chunk_index
from repro_torch.ann.dataset import ANNDataset
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.live import (ChunkIndex, LiveFilteredIndex,
                                  build_chunk_index)
from repro_torch.ann.predicates import Predicate, eval_predicate_np
from test_torch_live import (ALL_PREDS, _batches, _empty, _live,  # noqa: F401
                             _oracle, _same, _state, tds)


# ---------------------------------------------------------------------------
# the fused read: against the staged path and the reference
# ---------------------------------------------------------------------------

def _grid_ds(n=700, d=16, seed=3):
    """A dataset on the integer grid (multiples of 1/4, duplicated rows):
    every score is exact in fp32 whatever the summation order, so the
    fused and staged paths must agree bit for bit."""
    rng = np.random.default_rng(seed)
    vec = (rng.integers(-6, 7, (n, d)) / 4.0).astype(np.float32)
    vec[n // 2: n // 2 + n // 5] = vec[: n // 5]
    bm = (rng.integers(0, 2, (n, 2)) * rng.integers(1, 8, (n, 2))
          ).astype(np.uint32)
    qv = (rng.integers(-6, 7, (25, d)) / 4.0).astype(np.float32)
    qb = bm[rng.integers(0, n, 25)] & rng.integers(0, 8, (25, 2)
                                                   ).astype(np.uint32)
    return ANNDataset.from_packed("grid", vec, bm, 64), qv, qb


@pytest.mark.parametrize("pred", ALL_PREDS)
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_fused_equals_staged_on_grid(pred, density):
    """Fused (pruned and unpruned) against staged, bit for bit on the
    grid, over base + delta + tombstones, ragged Q and k above the
    matches; both against the oracle."""
    ds, qv, qb = _grid_ds()
    with _live(ds, delta_chunk=64) as live, \
            _live(ds, delta_chunk=64, delta_prune_min_rows=0) as pruned:
        for h in (live, pruned):
            h.upsert(ds.vectors[:300] + np.float32(0.25), ds.bitmaps[:300])
            if density:
                h.delete(np.random.default_rng(7).choice(
                    h.n_total, int(round(h.n_total * density)),
                    replace=False))
        vec, bm, tomb = _state(live)
        for q_take, k in ((1, 5), (7, 41), (25, 10)):
            batch = TQB(qv[:q_take], qb[:q_take], pred, k)
            fused = live.search(batch, "prefilter")
            pr = pruned.search(batch, "prefilter")
            live.fused = False
            staged = live.search(batch, "prefilter")
            live.fused = True
            for res in (pr, staged):
                np.testing.assert_array_equal(fused.ids, res.ids)
                np.testing.assert_array_equal(fused.distances, res.distances)
                np.testing.assert_array_equal(fused.keys, res.keys)
            want = _oracle(vec, bm, tomb, batch.vectors, batch.bitmaps,
                           pred, k)
            # the oracle ranks ties by id, as the kernels do
            np.testing.assert_array_equal(fused.ids, want)
            if density >= 1.0:
                assert (fused.ids == -1).all()


@pytest.mark.parametrize("pred", ALL_PREDS)
@pytest.mark.parametrize("density", [0.0, 0.5])
def test_fused_matches_reference(tiny_ds, tds, tiny_queries, pred, density):
    """The fused path against the JAX package's fused path on random
    floats: ids and keys equal, distances to fp32 summation order."""
    with _live(tds, delta_chunk=64) as tl, \
            JLive(tiny_ds, delta_chunk=64) as jl:
        for live, ds in ((tl, tds), (jl, tiny_ds)):
            live.upsert(ds.vectors[:150] + np.float32(0.01),
                        ds.bitmaps[:150])
            if density:
                live.delete(np.random.default_rng(5).choice(
                    live.n_total, int(live.n_total * density),
                    replace=False))
        for take, k in ((1, 5), (7, 41), (25, 10)):
            jb, tb = _batches(tiny_queries[pred], pred, k, take)
            _same(tl, jl, tb, jb)


def test_delta_prune_engages_and_stays_exact(tiny_ds, tds, tiny_queries):
    """The sealed-chunk pruner fires on far-away delta clusters without
    changing a result, and drops what the JAX package's drops."""
    pred = Predicate.AND
    qs = tiny_queries[pred]
    n_match = np.array([eval_predicate_np(tds.bitmaps, qb[None], pred).sum()
                        for qb in qs.bitmaps])
    keep = n_match >= 10
    tb = TQB(qs.vectors[keep], qs.bitmaps[keep], pred, 10)
    jb = JQB(qs.vectors[keep], qs.bitmaps[keep], pred, 10)
    with _live(tds, delta_chunk=64, delta_prune_min_rows=0) as tp, \
            _live(tds, delta_chunk=64) as tf, \
            JLive(tiny_ds, delta_chunk=64, delta_prune_min_rows=0) as jp:
        for h, ds in ((tp, tds), (tf, tds), (jp, tiny_ds)):
            h.upsert(ds.vectors[:192] + np.float32(50.0), ds.bitmaps[:192])
        res_p, _ = _same(tp, jp, tb, jb)
        res_f = tf.search(tb, "prefilter")
        np.testing.assert_array_equal(res_p.ids, res_f.ids)
        np.testing.assert_array_equal(res_p.distances, res_f.distances)
        assert tp.stats()["delta_chunk_indexes"] == 3
        assert tp.stats()["delta_prune"]["pruned"] > 0
        assert tp.stats()["delta_prune"] == jp.stats()["delta_prune"]


@pytest.mark.parametrize("pred", ALL_PREDS)
def test_label_prune_matches_reference_under_churn(tiny_ds, tds,
                                                   tiny_queries, pred):
    """Label bounds active, every predicate: the JAX package's ids, keys
    and prune counts."""
    pick = np.random.default_rng(31).integers(0, tds.n, 512)
    jb, tb = _batches(tiny_queries[pred], pred, 10, 16)
    with _live(tds, delta_chunk=64, delta_prune_min_rows=0) as tl, \
            JLive(tiny_ds, delta_chunk=64, delta_prune_min_rows=0) as jl:
        for live, ds in ((tl, tds), (jl, tiny_ds)):
            live.upsert(ds.vectors[pick] + np.float32(0.01),
                        ds.bitmaps[pick])
        _same(tl, jl, tb, jb)
        assert tl.stats()["delta_prune"] == jl.stats()["delta_prune"]
        assert tl.stats()["delta_prune"]["calls"] > 0


def test_label_prune_fires_where_distance_bound_cannot(tiny_ds, tds):
    from repro.data.ann_synth import make_queries

    qs = make_queries(tiny_ds, Predicate.EQUALITY, 8, seed=4)
    jb = JQB(qs.vectors, qs.bitmaps, Predicate.EQUALITY, 5)
    tb = TQB(qs.vectors, qs.bitmaps, Predicate.EQUALITY, 5)
    pick = np.random.default_rng(9).integers(0, tds.n, 512)
    with _empty(tds, delta_chunk=64, delta_prune_min_rows=0) as tl, \
            JLive.empty("tiny", tiny_ds.dim, tiny_ds.universe,
                        delta_chunk=64, delta_prune_min_rows=0) as jl:
        for live, ds in ((tl, tds), (jl, tiny_ds)):
            live.upsert(ds.vectors[pick], ds.bitmaps[pick])
        _same(tl, jl, tb, jb)
        assert tl.stats()["delta_prune"]["label_pruned"] > 0
        assert tl.stats()["delta_prune"] == jl.stats()["delta_prune"]


def test_label_drop_rules_directly():
    """`_label_drop`'s three predicate rules on a handcrafted cluster:
    union = 0b0011, inter = 0b0001."""
    ci = ChunkIndex(centroids=np.zeros((1, 4), np.float32),
                    cnorms=np.zeros(1), radius=np.zeros(1),
                    members=np.arange(2, dtype=np.int32),
                    starts=np.array([0, 2], np.int32),
                    label_union=np.array([[0b0011]], np.uint32),
                    label_inter=np.array([[0b0001]], np.uint32))

    def drop(bits, pred):
        b = TQB(np.zeros((1, 4), np.float32),
                np.array([[bits]], np.uint32), pred, 3)
        return bool(LiveFilteredIndex._label_drop([ci], b)[0, 0])

    assert drop(0b0100, Predicate.OR) and not drop(0b0010, Predicate.OR)
    assert drop(0b0110, Predicate.AND) and not drop(0b0011, Predicate.AND)
    assert drop(0b0010, Predicate.EQUALITY)
    assert not drop(0b0011, Predicate.EQUALITY)


# ---------------------------------------------------------------------------
# chunk indexes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_bitmaps", [True, False])
def test_chunk_index_equals_reference(tiny_ds, with_bitmaps):
    v = tiny_ds.vectors[:128]
    bm = tiny_ds.bitmaps[:128] if with_bitmaps else None
    got = build_chunk_index(v, bitmaps=bm, seed=2)
    want = j_build_chunk_index(v, bitmaps=bm, seed=2)
    assert set(got.arrays()) == set(want.arrays())
    for key, arr in want.arrays().items():
        np.testing.assert_array_equal(got.arrays()[key], arr)
    rt = ChunkIndex.from_arrays(got.arrays())
    np.testing.assert_array_equal(rt.members, got.members)
