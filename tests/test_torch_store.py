"""`IndexStore` over one live handle on the CPU, across packages: the
same upserts, deletes and compaction run through a reference store and
a port store, and each package opens the other's directory; the reads
equal the reference's never-persisted live handle — ids and keys
identical, distances bit-identical on an integer-grid dataset (every
score is exact in fp32) and within `_tol` on random floats (fp32 scores
summed in other orders: about 2·D·u·(‖v‖ + ‖q‖)² each, u = 2^-24, and
twice that is allowed). Also held, with the patterns of
`tests/test_store.py`: replay against a clean checkpoint, stable keys
across compaction and reopen, a crash mid-compaction, raced deletes
translated on replay, persisted method and delta-chunk indexes adopted
without a rebuild, the router version stamps, an empty store. The
sharded store is in `test_torch_store_sharded.py`.

Every test draws its randomness from its own seeded generator."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.ann import registry as jregistry
from repro.ann.dataset import ANNDataset as JDataset
from repro.ann.index import QueryBatch as JQB
from repro.ann.live import LiveFilteredIndex as JLive
from repro.ann.store import IndexStore as JStore
from repro.ann.store import WriteAheadLog as JWal
from repro_torch.ann import registry as tregistry
from repro_torch.ann.dataset import ANNDataset
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.live import LiveFilteredIndex
from repro_torch.ann.predicates import Predicate
from repro_torch.ann.store import IndexStore, WriteAheadLog
from repro_torch.data.ann_synth import DatasetSpec, synthesize

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's
ALL_PREDS = (Predicate.EQUALITY, Predicate.AND, Predicate.OR)
SHIFT = np.float32(0.25)          # keeps integer-grid rows on the grid


@pytest.fixture(scope="module")
def tds():
    return synthesize(DatasetSpec(*TINY))


@pytest.fixture(scope="module")
def grids(tiny_ds):
    """The tiny spec's label sets under integer-grid vectors (multiples of
    1/4, a quarter of the rows duplicated): one dataset per package."""
    rng = np.random.default_rng(51)
    v = (rng.integers(-6, 7, (tiny_ds.n, tiny_ds.dim)) / 4.0).astype(
        np.float32)
    v[300:450] = v[:150]
    bm = tiny_ds.bitmaps
    return (JDataset.from_packed("grid", v, bm, tiny_ds.universe),
            ANNDataset.from_packed("grid", v, bm, tiny_ds.universe))


def data(kind, tiny_ds, tds, grids):
    """(reference dataset, port dataset) of one kind."""
    return (tiny_ds, tds) if kind == "float" else grids


def queries(kind, ds, tiny_queries, pred):
    """(vectors, bitmaps) of the tiny queries; grid vectors on the grid."""
    qs = tiny_queries[pred]
    if kind == "float":
        return qs.vectors, qs.bitmaps
    rng = np.random.default_rng(52 + int(pred))
    qv = (rng.integers(-6, 7, (qs.q, ds.dim)) / 4.0).astype(np.float32)
    return qv, qs.bitmaps


def ops(live, ds, compact=True):
    """A deterministic upsert/delete mix with a compaction between its
    halves (the store logs its barrier); either package's handle."""
    new_v = ds.vectors[:90] + SHIFT
    ids_a = live.upsert(new_v[:50], ds.bitmaps[:50])
    live.delete(ids_a[::7])
    live.delete(np.arange(0, 30, 5))          # base tombstones
    if compact:
        live.compact_async().result()
    ids_b = live.upsert(new_v[50:], ds.bitmaps[50:90])
    live.delete(ids_b[:3])


def tol(vectors, qvecs, ids):
    v = np.linalg.norm(vectors[np.maximum(ids, 0)], axis=-1)
    q = np.linalg.norm(qvecs, axis=-1)[:, None]
    return 4 * vectors.shape[1] * 2.0 ** -24 * (v + q) ** 2


def rows_of(live):
    """Host vectors of either package's handle in global id order."""
    with live.snapshot() as snap:
        st = live.export_state(snap)
    base = (st["base_ds"].vectors if "base_ds" in st
            else st["base_vectors"])
    if base is None:
        return st["delta_vectors"]
    return np.concatenate([base, st["delta_vectors"]])


def assert_reads(res, want, exact, vectors, qv):
    """ids and keys identical, NaN at −1; distance bits identical when
    `exact`, else within `tol`."""
    np.testing.assert_array_equal(res.ids, want.ids)
    np.testing.assert_array_equal(res.keys, want.keys)
    ok = res.ids >= 0
    assert np.isnan(res.distances[~ok]).all()
    if exact:
        np.testing.assert_array_equal(res.distances.view(np.int32),
                                      want.distances.view(np.int32))
    else:
        t = tol(vectors, qv, res.ids)
        assert (np.abs(res.distances - want.distances)[ok] <= t[ok]).all()


def read_all(live, kind, ds, tiny_queries, k=10):
    """Each predicate's prefilter read of the tiny queries, by either
    package's handle (its own QueryBatch)."""
    qb_cls = TQB if type(live).__module__.startswith("repro_torch") else JQB
    out = {}
    for pred in ALL_PREDS:
        qv, qb = queries(kind, ds, tiny_queries, pred)
        out[pred] = (qv, live.search(qb_cls(qv, qb, pred, k), "prefilter"))
    return out


def open_store(pkg, path):
    if pkg == "torch":
        return IndexStore.open(path, device="cpu")
    return JStore.open(path)


def count_builds(monkeypatch, registry):
    """Count every registered method's `build` calls (either package)."""
    calls = []
    for name in registry.all_methods():
        m = registry.get_method(name)
        orig = m.build

        def build(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(m, "build", build)
    return calls


# ---------------------------------------------------------------------------
# a store directory opens in either package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["grid", "float"])
@pytest.mark.parametrize("writer", ["torch", "repro"])
def test_store_opens_in_both_packages(tmp_path, tiny_ds, tds, grids,
                                      tiny_queries, writer, kind):
    """The same writes and compaction through a `writer` store; the
    other package (and the writer) opens the directory, replays the
    compaction barrier and reads as the reference's never-persisted
    handle."""
    jds, ds = data(kind, tiny_ds, tds, grids)
    with JLive(jds) as ref:
        ops(ref, jds)
        want = read_all(ref, kind, jds, tiny_queries)
        vectors = rows_of(ref)
    p = str(tmp_path / "s")
    st = (IndexStore.create(p, LiveFilteredIndex(ds, device="cpu"))
          if writer == "torch" else JStore.create(p, JLive(jds)))
    with st:
        ops(st.index, ds)
    for reader in ("repro", "torch") if writer == "torch" \
            else ("torch", "repro"):
        with open_store(reader, p) as st2:
            assert st2.stats()["replayed_records"] == 6
            assert st2.index.generation == 1
            got = read_all(st2.index, kind, ds, tiny_queries)
            for pred in ALL_PREDS:
                qv, res = got[pred]
                assert_reads(res, want[pred][1], kind == "grid", vectors,
                             qv)


@pytest.mark.parametrize("pred", ALL_PREDS)
def test_roundtrip_bit_identical_to_never_persisted(tmp_path, tds,
                                                    tiny_queries, pred):
    """Port store: writes → close → open equals the port's
    never-persisted handle bit for bit."""
    qs = tiny_queries[pred]
    batch = TQB(qs.vectors, qs.bitmaps, pred, 10)
    with LiveFilteredIndex(tds, device="cpu") as ref:
        ops(ref, tds)
        want = ref.search(batch, "prefilter")
    with IndexStore.create(str(tmp_path / "s"),
                           LiveFilteredIndex(tds, device="cpu")) as st:
        ops(st.index, tds)
        assert st.index.stats()["wal_attached"]
    with IndexStore.open(str(tmp_path / "s"), device="cpu") as st2:
        assert_reads(st2.index.search(batch, "prefilter"), want, True,
                     None, None)


def test_wal_replayed_equals_clean_checkpoint(tmp_path, tds, tiny_queries):
    qs = tiny_queries[Predicate.AND]
    batch = TQB(qs.vectors, qs.bitmaps, Predicate.AND, 10)
    for name, clean in (("dirty", False), ("clean", True)):
        with IndexStore.create(str(tmp_path / name),
                               LiveFilteredIndex(tds, device="cpu")) as st:
            ops(st.index, tds, compact=False)
            if clean:
                st.checkpoint()
    with IndexStore.open(str(tmp_path / "dirty"), device="cpu") as a, \
            IndexStore.open(str(tmp_path / "clean"), device="cpu") as b:
        assert a.stats()["replayed_records"] == 5
        # the clean store's log holds only the checkpoint's residual
        # delta (one upsert record) and tombstones (one delete record)
        assert b.stats()["replayed_records"] == 2
        assert_reads(a.index.search(batch, "prefilter"),
                     b.index.search(batch, "prefilter"), True, None, None)
        np.testing.assert_array_equal(a.index._keys, b.index._keys)


@pytest.mark.parametrize("reader", ["torch", "repro"])
def test_stable_keys_across_upsert_compact_reopen(tmp_path, tds,
                                                  tiny_queries, reader):
    """Client-visible keys survive compaction and a restart into either
    package, while row ids are remapped underneath."""
    qs = tiny_queries[Predicate.AND]
    p = str(tmp_path / "s")
    with IndexStore.create(p, LiveFilteredIndex(tds, device="cpu")) as st:
        ops(st.index, tds, compact=False)
        before = st.index.search(TQB(qs.vectors, qs.bitmaps,
                                     Predicate.AND, 10), "prefilter")
        vec_of_key = {int(key): st.index.fetch([rid])[0].copy()
                      for key, rid in zip(before.keys.ravel(),
                                          before.ids.ravel()) if rid >= 0}
        st.index.compact()
    qb_cls = TQB if reader == "torch" else JQB
    with open_store(reader, p) as st2:
        again = st2.index.search(qb_cls(qs.vectors, qs.bitmaps,
                                        Predicate.AND, 10), "prefilter")
        np.testing.assert_array_equal(again.keys, before.keys)
        assert not np.array_equal(again.ids, before.ids)
        for key, vec in vec_of_key.items():
            row = st2.index.rows_of([key])[0]
            np.testing.assert_array_equal(st2.index.fetch([row])[0], vec)


@pytest.mark.parametrize("reader", ["torch", "repro"])
def test_kill_mid_compaction_recovers_old_generation(tmp_path, tds,
                                                     tiny_queries,
                                                     monkeypatch, reader):
    """A crash after the new segment is written but before the manifest
    rename leaves the old generation serving; `open()` in either package
    sweeps the debris and replays the compaction from the barrier."""
    qs = tiny_queries[Predicate.AND]
    batch = TQB(qs.vectors, qs.bitmaps, Predicate.AND, 10)
    with LiveFilteredIndex(tds, device="cpu") as ref:
        ops(ref, tds, compact=False)
        ref.compact()
        want = ref.search(batch, "prefilter")
    p = str(tmp_path / "s")
    st = IndexStore.create(p, LiveFilteredIndex(tds, device="cpu"))
    ops(st.index, tds, compact=False)
    pre_crash = st.index.search(batch, "prefilter")

    class Boom(Exception):
        pass

    def crash(self, manifest):
        raise Boom()
    monkeypatch.setattr(IndexStore, "_commit_manifest", crash)
    with pytest.raises(Boom):
        st.compact()
    monkeypatch.undo()
    seg_root = os.path.join(p, "segments")
    assert len(os.listdir(seg_root)) == 1      # the failed attempt cleaned
    st._wal.close()
    st._index.close()
    shutil.copytree(os.path.join(seg_root, os.listdir(seg_root)[0]),
                    os.path.join(seg_root, "gen-000099"))
    with open(os.path.join(p, "wal", "wal-000099.log"), "wb") as f:
        f.write(b"debris")
    qb_cls = TQB if reader == "torch" else JQB
    with open_store(reader, p) as st2:
        assert os.listdir(seg_root) == ["gen-000000"]
        assert os.listdir(os.path.join(p, "wal")) == ["wal-000000.log"]
        assert st2.store_generation == 0 and st2.index.generation == 1
        res = st2.index.search(qb_cls(qs.vectors, qs.bitmaps,
                                      Predicate.AND, 10), "prefilter")
        np.testing.assert_array_equal(res.ids, want.ids)
        np.testing.assert_array_equal(res.keys, pre_crash.keys)
        if reader == "torch":
            assert_reads(res, want, True, None, None)


@pytest.mark.parametrize("writer", ["torch", "repro"])
def test_replay_translates_deletes_of_rows_upserted_during_compaction(
        tmp_path, tds, tiny_queries, writer):
    """Ops that raced a compaction, spliced into the log by either
    package's WAL: a barrier, then an upsert after its snapshot and a
    delete of that row and of a base row, all at the old generation.
    Replay in both packages translates the deletes through the remap."""
    qs = tiny_queries[Predicate.AND]
    p = str(tmp_path / "s")
    st = IndexStore.create(p, LiveFilteredIndex(tds, device="cpu"))
    n0 = st.index.n_total
    next_key = st.index.stats()["next_key"]
    wal_path = os.path.join(p, st.manifest["wal"])
    st.close()
    wal = (WriteAheadLog if writer == "torch" else JWal).open_append(
        wal_path, dim=tds.dim, width=tds.bitmaps.shape[1])
    wal.log_compact(0)
    wal.log_upsert(0, np.array([next_key], np.int64),
                   tds.vectors[:1] + SHIFT, tds.bitmaps[:1])
    wal.log_delete(0, np.array([n0, 5], np.int64))
    wal.close()
    with LiveFilteredIndex(tds, device="cpu") as ref:
        ref.delete([5])
        want = ref.search(TQB(qs.vectors, qs.bitmaps, Predicate.AND, 10),
                          "prefilter")
    for reader, qb_cls in (("torch", TQB), ("repro", JQB)):
        with open_store(reader, p) as st2:
            assert st2.index.generation == 1
            assert st2.index.n_live == tds.n - 1
            res = st2.index.search(qb_cls(qs.vectors, qs.bitmaps,
                                          Predicate.AND, 10), "prefilter")
            np.testing.assert_array_equal(res.ids, want.ids)


# ---------------------------------------------------------------------------
# persisted indexes, router stamps, empty stores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["torch", "repro"])
def test_built_indexes_adopted_without_rebuild(tmp_path, tiny_ds, tds,
                                               tiny_queries, monkeypatch,
                                               writer):
    """Every persisted method index written by either package is adopted
    by the port's `open()` with no build, and searches as the writer's
    handle did; the reference adopts the port's files the same way."""
    names = ["ivf_gamma", "postfilter", "labelnav", "sieve"]
    qs = tiny_queries[Predicate.AND]
    p = str(tmp_path / "s")
    if writer == "torch":
        st = IndexStore.create(p, LiveFilteredIndex(tds, device="cpu"))
        qb = TQB(qs.vectors, qs.bitmaps, Predicate.AND, 10)
    else:
        st = JStore.create(p, JLive(tiny_ds))
        qb = JQB(qs.vectors, qs.bitmaps, Predicate.AND, 10)
    with st:
        want = {m: st.index.search(qb, m) for m in names}
        st.checkpoint()
        built = {b[0]: b[2] for b in st.manifest["built"]}
        assert all(built[m] for m in names)
    calls = count_builds(monkeypatch, tregistry)
    jcalls = count_builds(monkeypatch, jregistry)
    with IndexStore.open(p, device="cpu") as st2:
        assert sorted(k[0] for k in st2.index.built_keys()) == sorted(names)
        for m in names:
            res = st2.index.search(TQB(qs.vectors, qs.bitmaps,
                                       Predicate.AND, 10), m)
            np.testing.assert_array_equal(res.ids, want[m].ids)
            np.testing.assert_array_equal(res.keys, want[m].keys)
    with JStore.open(p) as st3:
        res = st3.index.search(JQB(qs.vectors, qs.bitmaps, Predicate.AND,
                                   10), "ivf_gamma")
        np.testing.assert_array_equal(res.ids, want["ivf_gamma"].ids)
    assert calls == [] and jcalls == []


@pytest.mark.parametrize("writer", ["torch", "repro"])
def test_delta_chunk_indexes_persist_and_adopt(tmp_path, tiny_ds, tds,
                                               writer):
    """Sealed-chunk mini-IVFs checkpointed by either package are adopted
    by the port's `open()` (same `delta_chunk`, no compact barrier)
    with equal arrays; a different `delta_chunk` skips them."""
    p = str(tmp_path / "s")
    if writer == "torch":
        st = IndexStore.create(p, LiveFilteredIndex(tds, device="cpu",
                                                    delta_chunk=64))
    else:
        st = JStore.create(p, JLive(tiny_ds, delta_chunk=64),
                           delta_chunk=64)
    with st:
        st.index.upsert(tds.vectors[:160] + SHIFT, tds.bitmaps[:160])
        built = st.index._delta.chunk_indexes(160)
        assert len(built) == 2
        st.checkpoint()
        assert st.manifest["delta_chunks"]["chunk"] == 64
        want = [ci.arrays() for ci in built]
    with IndexStore.open(p, device="cpu", delta_chunk=64) as st2:
        assert st2.index.stats()["delta_chunk_indexes"] == 2
        for w, g in zip(want, st2.index._delta.built_chunk_indexes()):
            ga = g.arrays()
            assert sorted(ga) == sorted(w)
            for name in w:
                np.testing.assert_array_equal(ga[name], w[name])
    with IndexStore.open(p, device="cpu") as st3:
        assert st3.index.stats()["delta_chunk_indexes"] == 0


def _flip_table_digit(rdir):
    """Change one digit of a recall value in the table: valid JSON, the
    same format versions, other content."""
    path = os.path.join(rdir, "table.json")
    with open(path) as f:
        text = f.read()
    at = text.index('"recall": ') + len('"recall": ') + 2
    digit = "1" if text[at] != "1" else "2"
    with open(path, "w") as f:
        f.write(text[:at] + digit + text[at + 1:])


def test_router_version_stamp_and_content_checked_on_open(tmp_path, tds,
                                                          toy_router):
    """A router saved by the reference and linked by a port store: both
    packages validate it on open; a re-stamped or edited artifact fails
    with the migration hint until it is re-linked."""
    rdir = str(tmp_path / "router")
    toy_router.save(rdir)
    p = str(tmp_path / "s")
    with IndexStore.create(p, LiveFilteredIndex(tds, device="cpu"),
                           router_dir=rdir) as st:
        entry = st.manifest["router"]
        assert (entry["router_version"], entry["table_version"]) == (1, 1)
        assert st.load_router().methods == toy_router.methods
    JStore.open(p).close()
    IndexStore.open(p, device="cpu").close()
    _flip_table_digit(rdir)
    for opener in (lambda: IndexStore.open(p, device="cpu"),
                   lambda: JStore.open(p)):
        with pytest.raises(ValueError, match="content changed"):
            opener()
    rj = os.path.join(rdir, "router.json")
    with open(rj) as f:
        man = json.load(f)
    man["version"] = 0
    with open(rj, "w") as f:
        json.dump(man, f)
    with IndexStore.open(p, device="cpu", router_dir=rdir) as st:
        assert st.manifest["router"]["router_version"] == 0
    with IndexStore.open(p, device="cpu") as st:        # re-linked
        assert st.load_router() is not None
    man["version"] = 1
    with open(rj, "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match=r"router v1.*router v0"):
        IndexStore.open(p, device="cpu")
    shutil.rmtree(rdir)
    with pytest.raises(ValueError, match="link_router"):
        IndexStore.open(p, device="cpu")


@pytest.mark.parametrize("reader", ["torch", "repro"])
def test_empty_store_grows_and_recovers(tmp_path, tds, tiny_queries,
                                        reader):
    qs = tiny_queries[Predicate.AND]
    p = str(tmp_path / "s")
    with IndexStore.create(p, name=tds.name, dim=tds.dim,
                           universe=tds.universe, device="cpu") as st:
        st.index.upsert(tds.vectors, tds.bitmaps)
    with IndexStore.open(p, device="cpu") as st2:
        assert st2.index.n_live == tds.n and st2.index.base_n == 0
        st2.index.compact()
        st2.checkpoint()
        want = st2.index.search(TQB(qs.vectors, qs.bitmaps, Predicate.AND,
                                    10), "prefilter")
    qb_cls = TQB if reader == "torch" else JQB
    with open_store(reader, p) as st3:
        assert st3.index.base_n == tds.n
        assert st3.stats()["replayed_records"] == 0
        res = st3.index.search(qb_cls(qs.vectors, qs.bitmaps,
                                      Predicate.AND, 10), "prefilter")
        np.testing.assert_array_equal(res.ids, want.ids)
        np.testing.assert_array_equal(res.keys, want.keys)


def test_package_exports_and_every_module_imports_first():
    """`repro_torch.ann` exports the store as the reference's `repro.ann`
    does, and every module of the port imports as the first of the
    package in a fresh interpreter state (no import cycle through the
    package's exports: a kernel test imports a kernel wrapper first)."""
    src = Path(__file__).resolve().parents[1] / "src"
    names = [".".join(p.relative_to(src).with_suffix("").parts)
             .removesuffix(".__init__")
             for p in sorted((src / "repro_torch").rglob("*.py"))]
    code = "\n".join([
        "import importlib, sys",
        "import numpy, torch",
        f"for name in {names!r}:",
        "    for m in [m for m in sys.modules",
        "              if m.split('.')[0] == 'repro_torch']:",
        "        del sys.modules[m]",
        "    importlib.import_module(name)",
        "from repro_torch.ann import IndexStore, WriteAheadLog, Tracer",
        "from repro_torch.ann import store, trace",
        "assert (IndexStore, WriteAheadLog) == (store.IndexStore,",
        "                                       store.WriteAheadLog)",
        "assert Tracer is trace.Tracer",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_create_and_open_refusals(tmp_path, tds):
    """An existing store is not re-created, a directory without a
    manifest is not a store, and the default device is the card: without
    one, open raises instead of carrying on on the CPU."""
    p = str(tmp_path / "s")
    IndexStore.create(p, LiveFilteredIndex(tds, device="cpu")).close()
    with pytest.raises(ValueError, match="already an index store"):
        IndexStore.create(p, LiveFilteredIndex(tds, device="cpu"))
    with pytest.raises(ValueError, match="not an index store"):
        IndexStore.open(str(tmp_path / "nope"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            IndexStore.open(p)
