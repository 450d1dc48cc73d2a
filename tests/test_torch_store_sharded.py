"""`IndexStore` over a `ShardedLiveIndex` on the CPU, across packages:
the same writes and compaction through a reference and a port sharded
store, each directory opened by the other package, reads equal to the
reference's never-persisted sharded handle (ids and keys identical,
distance bits identical on the integer grid, within `tol` on random
floats, as in `test_torch_store.py`); the compaction barrier replayed;
raced deletes translated, also when the compaction leaves fewer rows
than shards; per-shard method indexes adopted without a rebuild.

Every test draws its randomness from its own seeded generator."""

import os

import numpy as np
import pytest

from repro.ann import registry as jregistry
from repro.ann.index import QueryBatch as JQB
from repro.ann.live import ShardedLiveIndex as JSharded
from repro.ann.store import IndexStore as JStore
from repro.ann.store import WriteAheadLog as JWal
from repro_torch.ann import registry as tregistry
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.live import ShardedLiveIndex
from repro_torch.ann.predicates import Predicate
from repro_torch.ann.store import IndexStore, WriteAheadLog
from test_torch_store import (ALL_PREDS, SHIFT, assert_reads,  # noqa: F401
                              count_builds, data, grids, ops, open_store,
                              read_all, rows_of, tds)


def _sharded(pkg, ds, n_shards):
    if pkg == "torch":
        return ShardedLiveIndex(ds, n_shards, device="cpu")
    return JSharded(ds, n_shards)


@pytest.mark.parametrize("kind", ["grid", "float"])
@pytest.mark.parametrize("writer", ["torch", "repro"])
def test_sharded_store_opens_in_both_packages(tmp_path, tiny_ds, tds,
                                              grids, tiny_queries, writer,
                                              kind):
    jds, ds = data(kind, tiny_ds, tds, grids)
    with JSharded(jds, 2) as ref:
        ops(ref, jds)
        want = read_all(ref, kind, jds, tiny_queries)
        vectors = rows_of(ref)
    p = str(tmp_path / "s")
    src = _sharded(writer, ds if writer == "torch" else jds, 2)
    st = (IndexStore.create(p, src) if writer == "torch"
          else JStore.create(p, src))
    with st:
        ops(st.index, ds)
        assert st.index.stats()["wal_attached"]
    for reader in ("torch", "repro"):
        with open_store(reader, p) as st2:
            assert st2.manifest["kind"] == "sharded"
            assert st2.index.n_shards == 2 and st2.index.generation == 1
            got = read_all(st2.index, kind, ds, tiny_queries)
            for pred in ALL_PREDS:
                qv, res = got[pred]
                assert_reads(res, want[pred][1], kind == "grid", vectors,
                             qv)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_roundtrip_and_compact(tmp_path, tds, tiny_queries,
                                       n_shards):
    """Port sharded store: reopen equals the never-persisted handle bit
    for bit; a store compaction commits a generation that reopens the
    same, with nothing left to replay."""
    qs = tiny_queries[Predicate.OR]
    batch = TQB(qs.vectors, qs.bitmaps, Predicate.OR, 10)
    with ShardedLiveIndex(tds, n_shards, device="cpu") as ref:
        ops(ref, tds, compact=False)
        want = ref.search(batch, "prefilter")
        p = str(tmp_path / "s")
        with IndexStore.create(p, ShardedLiveIndex(tds, n_shards,
                                                   device="cpu")) as st:
            ops(st.index, tds, compact=False)
        with IndexStore.open(p, device="cpu") as st2:
            assert st2.index.n_shards == n_shards
            assert_reads(st2.index.search(batch, "prefilter"), want, True,
                         None, None)
            ref.compact()
            st2.compact()
            want2 = ref.search(batch, "prefilter")
            assert_reads(st2.index.search(batch, "prefilter"), want2, True,
                         None, None)
        with IndexStore.open(p, device="cpu") as st3:
            assert st3.stats()["replayed_records"] == 0
            assert_reads(st3.index.search(batch, "prefilter"), want2, True,
                         None, None)


@pytest.mark.parametrize("writer", ["torch", "repro"])
def test_replay_tail_delete_when_compaction_collapses_below_shards(
        tmp_path, tds, writer):
    """Survivors fewer than the shards: the replayed compaction puts
    them back as delta (base_n = 0); a raced delete of a tail row lands
    on the tail row, not on the survivor, in both packages."""
    p = str(tmp_path / "s")
    st = IndexStore.create(p, ShardedLiveIndex(tds, 2, device="cpu"))
    st.index.delete(np.arange(tds.n - 1))
    survivor_key = tds.n - 1
    next_key = st.index.stats()["next_key"]
    wal_path = os.path.join(p, st.manifest["wal"])
    st.close()
    wal = (WriteAheadLog if writer == "torch" else JWal).open_append(
        wal_path, dim=tds.dim, width=tds.bitmaps.shape[1])
    wal.log_compact(0)
    wal.log_upsert(0, np.array([next_key], np.int64),
                   tds.vectors[:1] + SHIFT, tds.bitmaps[:1])
    wal.log_delete(0, np.array([tds.n], np.int64))
    wal.close()
    for reader, qb_cls in (("torch", TQB), ("repro", JQB)):
        with open_store(reader, p) as st2:
            assert st2.index.generation == 1 and st2.index.n_live == 1
            assert st2.index.base_n == 0
            assert st2.index.rows_of([survivor_key])[0] >= 0
            res = st2.index.search(qb_cls(tds.vectors[-1:],
                                          tds.bitmaps[-1:],
                                          Predicate.AND, 1), "prefilter")
            assert res.keys[0, 0] == survivor_key
            assert res.distances[0, 0] <= 1e-3


def test_sharded_replay_translates_raced_deletes(tmp_path, tds,
                                                 tiny_queries):
    """A barrier, then a tail upsert and deletes of it and of a base row
    at the old generation: both packages translate them on replay and
    read as a handle that made the same writes in order."""
    qs = tiny_queries[Predicate.AND]
    p = str(tmp_path / "s")
    st = IndexStore.create(p, ShardedLiveIndex(tds, 2, device="cpu"))
    next_key = st.index.stats()["next_key"]
    wal_path = os.path.join(p, st.manifest["wal"])
    st.close()
    wal = WriteAheadLog.open_append(wal_path, dim=tds.dim,
                                    width=tds.bitmaps.shape[1])
    wal.log_compact(0)
    wal.log_upsert(0, np.array([next_key, next_key + 1], np.int64),
                   tds.vectors[:2] + SHIFT, tds.bitmaps[:2])
    wal.log_delete(0, np.array([tds.n, 7], np.int64))
    wal.close()
    with ShardedLiveIndex(tds, 2, device="cpu") as ref:
        ref.compact()
        ref.upsert(tds.vectors[:2] + SHIFT, tds.bitmaps[:2])
        ref.delete([tds.n, 7])
        want = ref.search(TQB(qs.vectors, qs.bitmaps, Predicate.AND, 10),
                          "prefilter")
    for reader, qb_cls in (("torch", TQB), ("repro", JQB)):
        with open_store(reader, p) as st2:
            assert st2.index.n_live == tds.n
            res = st2.index.search(qb_cls(qs.vectors, qs.bitmaps,
                                          Predicate.AND, 10), "prefilter")
            np.testing.assert_array_equal(res.ids, want.ids)
            np.testing.assert_array_equal(res.keys, want.keys)


def test_compaction_below_the_shards_logs_no_internal_replay(tmp_path,
                                                           tds):
    """A compaction that leaves fewer rows than shards puts the survivors
    back as delta through the handle's own upserts: with a log attached
    they stay out of it (only the barrier is logged), so both packages
    replay the store to the same single survivor and a later write."""
    p = str(tmp_path / "s")
    with IndexStore.create(p, ShardedLiveIndex(tds, 2, device="cpu")) as st:
        st.index.delete(np.arange(tds.n - 1))
        st.index.compact()
        assert st.index.base_n == 0 and st.index.n_live == 1
        st.index.upsert(tds.vectors[:1] + SHIFT, tds.bitmaps[:1])
        want_keys = st.index.keys_of(np.arange(st.index.n_total))
    recs = WriteAheadLog.replay(os.path.join(p, "wal", "wal-000000.log"),
                                dim=tds.dim, width=tds.bitmaps.shape[1])
    assert [r.kind for r in recs] == ["delete", "compact", "upsert"]
    for reader in ("torch", "repro"):
        with open_store(reader, p) as st2:
            assert st2.index.n_live == 2 and st2.index.base_n == 0
            np.testing.assert_array_equal(
                st2.index.keys_of(np.arange(st2.index.n_total)), want_keys)


@pytest.mark.parametrize("writer", ["torch", "repro"])
def test_sharded_built_indexes_restored_without_rebuild(tmp_path, tiny_ds,
                                                        tds, tiny_queries,
                                                        monkeypatch, writer):
    """Per-shard method indexes persist as one file a shard and come back
    through `index_from_arrays` in the port's `open()` (and the
    reference's) with no build, searching as before the restart."""
    qs = tiny_queries[Predicate.AND]
    p = str(tmp_path / "s")
    src = _sharded(writer, tds if writer == "torch" else tiny_ds, 2)
    st = (IndexStore.create(p, src) if writer == "torch"
          else JStore.create(p, src))
    qb_cls = TQB if writer == "torch" else JQB
    with st:
        want = st.index.search(qb_cls(qs.vectors, qs.bitmaps,
                                      Predicate.AND, 10), "ivf_gamma")
        st.checkpoint()
        files = {b[0]: b[2] for b in st.manifest["built"]}["ivf_gamma"]
        assert isinstance(files, list) and len(files) == 2 and all(files)
    calls = count_builds(monkeypatch, tregistry)
    jcalls = count_builds(monkeypatch, jregistry)
    for reader, qb in (("torch", TQB), ("repro", JQB)):
        with open_store(reader, p) as st2:
            res = st2.index.search(qb(qs.vectors, qs.bitmaps,
                                      Predicate.AND, 10), "ivf_gamma")
            np.testing.assert_array_equal(res.ids, want.ids)
            np.testing.assert_array_equal(res.keys, want.keys)
    assert calls == [] and jcalls == []
