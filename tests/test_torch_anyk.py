"""Any k in every top-k entry point, on the CPU, against the JAX package:
k past `MAX_K` = 128 (a reranking stage's candidate count) through the
sharded index, the live index (fused and staged, after upserts, deletes
and a compaction) and the kernels' entry points (`masked_topk_multiblock`,
`merge_topk`, the fused live read), which once refused it. Ids and keys
equal; distances bit-identical on the integer grid, within fp32
summation order (`_tol`) on random floats.

Every test draws its randomness from its own seeded generator."""

import numpy as np
import pytest
import torch

from repro.ann.index import QueryBatch as JQB
from repro.ann.live import LiveFilteredIndex as JLive
from repro.ann.sharded import ShardedFilteredIndex as JSharded
from repro.kernels import ops as jops
from repro_torch.ann.index import FilteredIndex
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.sharded import ShardedFilteredIndex
from repro_torch.kernels import ops as tops
from test_torch_kernels import (_assert_bitwise, _assert_merge_alike,  # noqa: F401
                                _jax, _live_both, _live_case, _merge_case,
                                _tie_case, _torch)
from test_torch_live import (ALL_PREDS, _batches, _live, _oracle,  # noqa: F401
                             _state, _tol, tds)
from test_torch_live_fused import _grid_ds

K = 140                      # past MAX_K, below a 4-shard tiny shard's 150


# ---------------------------------------------------------------------------
# the sharded index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pred", ALL_PREDS)
def test_sharded_search_any_k_matches_reference(tiny_ds, tds, tiny_queries,
                                                pred):
    """Four shards of the tiny spec at k = 140: the same ids and keys as
    the reference's sharded index and as the port's single index,
    distances within fp32 summation order."""
    qs = tiny_queries[pred]
    tb = TQB(qs.vectors, qs.bitmaps, pred, K)
    jb = JQB(qs.vectors, qs.bitmaps, pred, K)
    with ShardedFilteredIndex(tds, 4, device="cpu") as sfx, \
            JSharded(tiny_ds, 4) as jsfx:
        res = sfx.search(tb, "prefilter")
        jres = jsfx.search(jb, "prefilter")
    single = FilteredIndex(tds, device="cpu").search(tb, "prefilter")
    assert res.ids.shape == (qs.vectors.shape[0], K)
    for want in (jres, single):
        np.testing.assert_array_equal(res.ids, want.ids)
        np.testing.assert_array_equal(res.keys, want.keys)
        ok = res.ids >= 0
        assert np.isnan(res.distances[~ok]).all()
        tol = _tol(tds.vectors, tb.vectors, res.ids)
        assert (np.abs(res.distances - want.distances)[ok] <= tol[ok]).all()
    assert (res.ids >= 0).any(axis=1).all() or pred != 2


# ---------------------------------------------------------------------------
# the live index
# ---------------------------------------------------------------------------

def _same_near(tlive, jlive, tb, jb):
    """Search both live handles with one batch: the same fill, keys where
    the ids agree, distances within `_tol`; at k = 140 over random floats
    an id may differ from the reference's only where the exact (float64)
    distances of both ids lie within `_tol` of each other (a near-tie the
    two packages' fp32 sums order differently)."""
    tres = tlive.search(tb, "prefilter")
    jres = jlive.search(jb, "prefilter")
    ok = tres.ids >= 0
    np.testing.assert_array_equal(ok, jres.ids >= 0)
    assert np.isnan(tres.distances[~ok]).all()
    vec, _, _ = _state(tlive)
    tol = _tol(vec, tb.vectors, tres.ids)
    assert (np.abs(tres.distances - jres.distances)[ok] <= tol[ok]).all()
    differ = tres.ids != jres.ids
    assert differ.mean() < 0.01
    np.testing.assert_array_equal(tres.keys[~differ], jres.keys[~differ])

    def exact(ids):
        v = vec[np.maximum(ids, 0)].astype(np.float64)
        return ((v - tb.vectors[:, None, :].astype(np.float64)) ** 2).sum(-1)

    assert (np.abs(exact(tres.ids) - exact(jres.ids))[differ]
            <= tol[differ]).all()
    return tres, jres


def _writes(live, ds, seed):
    live.upsert(ds.vectors[:150] + np.float32(0.01), ds.bitmaps[:150])
    live.delete(np.random.default_rng(seed).choice(live.n_total, 60,
                                                   replace=False))


@pytest.mark.parametrize("pred", ALL_PREDS)
def test_live_search_any_k_matches_reference(tiny_ds, tds, tiny_queries,
                                             pred):
    """k = 140 over base + delta + tombstones, then after a compaction:
    fused and staged reads against the reference's, ids and keys equal."""
    with _live(tds, delta_chunk=64) as tl, \
            JLive(tiny_ds, delta_chunk=64) as jl:
        for live, ds in ((tl, tds), (jl, tiny_ds)):
            _writes(live, ds, 11)
        jb, tb = _batches(tiny_queries[pred], pred, K)
        fused, _ = _same_near(tl, jl, tb, jb)
        tl.fused = False
        staged, _ = _same_near(tl, jl, tb, jb)
        tl.fused = True
        np.testing.assert_array_equal(fused.ids, staged.ids)
        np.testing.assert_array_equal(fused.keys, staged.keys)
        assert (fused.ids < 0).sum() > 0 or pred != 0    # fill past matches
        for live in (tl, jl):
            live.compact()
        _same_near(tl, jl, tb, jb)


@pytest.mark.parametrize("pred", ALL_PREDS)
def test_live_fused_equals_staged_any_k_on_grid(pred):
    """On the integer grid the fused and staged reads agree bit for bit at
    k = 140 and at k past every live row (the fill), and equal the
    oracle; the same after a compaction."""
    ds, qv, qb = _grid_ds()
    with _live(ds, delta_chunk=64) as live:
        live.upsert(ds.vectors[:300] + np.float32(0.25), ds.bitmaps[:300])
        live.delete(np.random.default_rng(3).choice(live.n_total, 200,
                                                    replace=False))
        for compacted in (False, True):
            vec, bm, tomb = _state(live)
            for k in (K, int((~tomb).sum()) + 25):
                batch = TQB(qv, qb, pred, k)
                fused = live.search(batch, "prefilter")
                live.fused = False
                staged = live.search(batch, "prefilter")
                live.fused = True
                np.testing.assert_array_equal(fused.ids, staged.ids)
                np.testing.assert_array_equal(fused.keys, staged.keys)
                np.testing.assert_array_equal(fused.distances,
                                              staged.distances)
                np.testing.assert_array_equal(
                    fused.ids, _oracle(vec, bm, tomb, qv, qb, pred, k))
            if not compacted:
                live.compact()


# ---------------------------------------------------------------------------
# the kernels' entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("k", [129, K])
def test_masked_topk_multiblock_any_k_matches_reference(pred, k):
    """Per-block lists at k past MAX_K (and past bn), merged: bit-identical
    to the reference's multi-block entry point on the tie grid, and to
    `ops.masked_topk`."""
    case = _tie_case(np.random.default_rng(40 + k), 9, 700)
    ids, dists = tops.masked_topk_multiblock(*_torch(case), pred=pred, k=k,
                                             bn=128)
    _assert_bitwise(ids, dists, *jops.masked_topk_multiblock(
        *_jax(case), pred=pred, k=k, bn=128))
    want_i, want_d = tops.masked_topk(*_torch(case), pred=pred, k=k)
    assert torch.equal(ids, want_i) and torch.equal(dists, want_d)


@pytest.mark.parametrize("k", [129, K])
@pytest.mark.parametrize("s", [3, 40])
def test_merge_topk_any_k_matches_reference(s, k):
    """k past MAX_K over 3 and 40 lists (the kernel's warp and block
    modes): ids and distance bits as the reference's, −0.0 ranked before
    +0.0."""
    ids, d = _merge_case(np.random.default_rng(s + k), s, 6, 12)
    d[0, :, 0] = np.float32(0.0)
    d[s - 1, :, 1] = np.float32(-0.0)
    ids[0, :, 0], ids[s - 1, :, 1] = 7, 9
    gi, gd = _assert_merge_alike(ids, d, k=k)
    assert gi.shape == (6, k)
    assert (gi[:, 0] == 9).all() and np.signbit(gd[:, 0]).all()
    assert (gi[:, 1] == 7).all()


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("k,ns", [(129, None), (K, None), (K, 90)])
def test_fused_live_any_k_matches_reference(pred, k, ns):
    """The fused live read at k past MAX_K, with and without `sel`: ids and
    distance bits as the reference's on the grid, −0.0 base candidates
    before +0.0 ones."""
    base_n = 500
    case = list(_live_case(np.random.default_rng(k + pred), 5, 90, 300,
                           base_n, ns=ns))
    cd, ci = case[3], case[2]
    cd[:, 0], cd[:, 1] = np.float32(0.0), np.float32(-0.0)
    ci[:, 0], ci[:, 1] = 3, 4
    words = case[7].copy()
    words[0] &= np.uint32(~np.uint32(0b11000))     # ids 3 and 4 live
    case[7] = words
    (ids, dists), want = _live_both(tuple(case), base_n, pred, k)
    assert ids.shape == (5, k)
    _assert_bitwise(ids, dists, *want)
    np.testing.assert_array_equal(np.signbit(dists.numpy()),
                                  np.signbit(np.asarray(want[1])))
    zero = dists.numpy() == 0.0
    first = np.argmax(zero, axis=1)
    assert (ids.numpy()[np.arange(5), first] == 4).all() or not zero.any()
