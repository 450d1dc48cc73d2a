"""LabelNav, Sieve and FVamana on a `ShardedFilteredIndex` on the CPU
against the JAX package's sharded handle: every shard builds its own
groups, posting lists and graph, and the merged answers are the
reference's."""

import pytest

from repro.ann.index import QueryBatch as JQB
from repro.ann.sharded import ShardedFilteredIndex as JSharded
from repro_torch.ann.predicates import Predicate
from repro_torch.ann.sharded import ShardedFilteredIndex
from test_torch_sharded import ALL_PREDS, _assert_same, _batch, tds  # noqa: F401


@pytest.mark.parametrize("name", ["labelnav", "sieve", "fvamana"])
@pytest.mark.parametrize("pred", ALL_PREDS)
def test_sharded_candidate_methods_match_reference(tiny_index, tiny_ds, tds,
                                                   tiny_queries, name, pred):
    """The candidates ported with the graph run on every shard (each shard
    builds its own groups, posting lists and graph) and merge as the
    reference's shards do. LabelNav's Equality scan is exact; there the
    reference's shards refuse k = 10 (its `top_k` over a shard's largest
    group, 8 rows), the port answers, and both are held to the exact
    answer."""
    qs = tiny_queries[pred]
    batch = _batch(qs, pred)
    jb = JQB(qs.vectors, qs.bitmaps, pred, 10)
    with ShardedFilteredIndex(tds, 2, device="cpu") as sfx, \
            JSharded(tiny_ds, 2) as jsfx:
        res = sfx.search(batch, name)
        if name == "labelnav" and pred == Predicate.EQUALITY:
            want = tiny_index.search(jb, "prefilter")
        else:
            want = jsfx.search(jb, name)
    _assert_same(res, want, tds, batch)
