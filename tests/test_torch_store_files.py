"""The store's files on the CPU, across packages: segments written by
either package load in the other bit for bit (vectors, norms, bitmaps
in RLE and raw, groups), and a corrupt segment is refused by both; a
write-ahead log written by either package is byte-identical to the
other's for the same operations and replays in both to equal records;
a torn tail truncates to the last good record at every cut, mid-log
corruption is refused, and group commit acknowledges only after the
fsync. The patterns of `tests/test_store.py`'s file-level tests.

Every test draws its randomness from its own seeded generator."""

import json
import os
import threading

import numpy as np
import pytest

from repro.ann import dataset as jdataset
from repro.ann import store as jstore
from repro_torch.ann import dataset as tdataset
from repro_torch.ann import ledger as tledger
from repro_torch.ann import store as tstore
from repro_torch.data.ann_synth import DatasetSpec, synthesize

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's
PACKAGES = {"torch": (tdataset, tstore), "repro": (jdataset, jstore)}
FIELDS = ("vectors", "bitmaps", "norms_sq", "group_of", "group_bitmaps",
          "group_start", "group_size")


@pytest.fixture(scope="module")
def tds():
    return synthesize(DatasetSpec(*TINY))


def _other(name):
    return "repro" if name == "torch" else "torch"


def _dataset_in(pkg, ds):
    """`ds`'s arrays as package `pkg`'s ANNDataset."""
    return PACKAGES[pkg][0].ANNDataset(
        name=ds.name, vectors=ds.vectors, bitmaps=ds.bitmaps,
        universe=ds.universe, group_of=ds.group_of,
        group_bitmaps=ds.group_bitmaps, group_start=ds.group_start,
        group_size=ds.group_size, group_lookup=dict(ds.group_lookup),
        norms_sq=ds.norms_sq)


def _assert_same_dataset(got, want):
    assert got.name == want.name and got.universe == want.universe
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    assert got.group_lookup == want.group_lookup


def _incompressible(tds):
    rng = np.random.default_rng(41)
    bm = rng.integers(1, 2 ** 32, tds.bitmaps.shape).astype(np.uint32)
    return tds.__class__(**{**tds.__dict__, "bitmaps": bm})


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["torch", "repro"])
def test_segment_loads_in_the_other_package(tmp_path, tds, writer):
    """A segment (RLE bitmaps) saved by one package loads in the other,
    memmapped, bit for bit; both manifests are the same document."""
    reader = _other(writer)
    seg = str(tmp_path / "seg")
    meta = _dataset_in(writer, tds).save_segment(seg)
    assert meta["files"]["bitmaps"]["encoding"] == "rle-u32-colmajor"
    other = _dataset_in(reader, tds).save_segment(str(tmp_path / "seg2"))
    assert meta == other
    got = PACKAGES[reader][0].ANNDataset.load_segment(seg, verify=True)
    assert isinstance(got.vectors, np.memmap)
    _assert_same_dataset(got, tds)


@pytest.mark.parametrize("writer", ["torch", "repro"])
def test_raw_bitmap_segment_loads_in_the_other_package(tmp_path, tds,
                                                       writer):
    """Incompressible bitmaps fall back to raw `.npy` in both packages,
    and load across them memmapped."""
    ds = _incompressible(tds)
    seg = str(tmp_path / "seg")
    meta = _dataset_in(writer, ds).save_segment(seg)
    assert meta["files"]["bitmaps"]["encoding"] == "raw"
    got = PACKAGES[_other(writer)][0].ANNDataset.load_segment(seg)
    assert isinstance(got.bitmaps, np.memmap)
    _assert_same_dataset(got, ds)


@pytest.mark.parametrize("damage", ["sha1", "bytes"])
def test_corrupt_segment_refused_by_both(tmp_path, tds, damage):
    seg = str(tmp_path / "seg")
    tds.save_segment(seg)
    vec = os.path.join(seg, "vectors.npy")
    if damage == "sha1":                        # size-preserving flip
        with open(vec, "r+b") as f:
            f.seek(os.path.getsize(vec) - 4)
            f.write(b"\xff\xff\xff\xff")
    else:
        with open(vec, "ab") as f:
            f.write(b"x")
    for dmod, _ in PACKAGES.values():
        with pytest.raises(ValueError, match=damage):
            dmod.ANNDataset.load_segment(seg, verify=True)


def test_unknown_encoding_and_newer_version_refused_by_both(tmp_path, tds):
    seg = str(tmp_path / "seg")
    tds.save_segment(seg)
    meta_path = os.path.join(seg, "segment.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["files"]["bitmaps"]["encoding"] = "zstd-v9"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    for dmod, _ in PACKAGES.values():
        with pytest.raises(ValueError, match="unknown encoding"):
            dmod.ANNDataset.load_segment(seg)
    meta["version"] = 3
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    for dmod, _ in PACKAGES.values():
        with pytest.raises(ValueError, match="newer"):
            dmod.ANNDataset.load_segment(seg)


def test_v1_raw_manifest_loads_in_both(tmp_path, tds):
    """A v1-era segment (all raw, no "encoding" keys) loads unchanged in
    either package."""
    seg = str(tmp_path / "seg")
    tds.save_segment(seg)
    meta_path = os.path.join(seg, "segment.json")
    with open(meta_path) as f:
        meta = json.load(f)
    os.remove(os.path.join(seg, meta["files"]["bitmaps"]["file"]))
    npy = os.path.join(seg, "bitmaps.npy")
    np.save(npy, np.ascontiguousarray(tds.bitmaps))
    meta["files"]["bitmaps"] = {
        "file": "bitmaps.npy", "sha1": tdataset.sha1_file(npy),
        "bytes": os.path.getsize(npy), "shape": list(tds.bitmaps.shape),
        "dtype": "uint32"}
    for info in meta["files"].values():
        info.pop("encoding", None)
    meta["version"] = 1
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    for dmod, _ in PACKAGES.values():
        _assert_same_dataset(dmod.ANNDataset.load_segment(seg, verify=True),
                             tds)


def test_rle_matches_reference_and_rejects_torn_streams():
    rng = np.random.default_rng(43)
    cases = [
        np.zeros((100, 3), np.uint32),
        rng.integers(0, 2 ** 32, (64, 4)).astype(np.uint32),
        np.repeat(rng.integers(0, 2 ** 32, (7, 2)).astype(np.uint32), 137,
                  axis=0),
        np.arange(12, dtype=np.uint32).reshape(6, 2),
        np.empty((0, 5), np.uint32),
        np.zeros((70000, 1), np.uint32),
    ]
    for arr in cases:
        tv, tc = tdataset.rle_encode_words(arr)
        jv, jc = jdataset.rle_encode_words(arr)
        assert tv.dtype == jv.dtype and tc.dtype == jc.dtype
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tc, jc)
        out = tdataset.rle_decode_words(tv, tc, arr.shape)
        assert out.dtype == np.uint32
        np.testing.assert_array_equal(out, arr)
    with pytest.raises(ValueError, match="decodes to"):
        tdataset.rle_decode_words(np.array([1], np.uint32),
                                  np.array([3], np.int64), (2, 2))


# ---------------------------------------------------------------------------
# write-ahead log
# ---------------------------------------------------------------------------

def _write_ops(smod, path, rng_seed=45):
    rng = np.random.default_rng(rng_seed)
    vec = rng.normal(size=(5, 4)).astype(np.float32)
    bm = rng.integers(0, 2 ** 16, size=(5, 2)).astype(np.uint32)
    keys = np.arange(100, 105, dtype=np.int64)
    wal = smod.WriteAheadLog.create(path, dim=4, width=2, generation=3)
    wal.log_upsert(3, keys, vec, bm)
    wal.log_delete(3, np.array([7, 9], np.int64))
    wal.log_compact(3)
    wal.log_upsert(4, keys[:1] + 10, vec[:1], bm[:1])
    wal.close()
    return keys, vec, bm


@pytest.mark.parametrize("writer", ["torch", "repro"])
def test_wal_replays_in_the_other_package(tmp_path, writer):
    """Both packages write the same bytes for the same operations, and
    each replays the other's log to equal records."""
    paths = {pkg: str(tmp_path / f"{pkg}.log") for pkg in PACKAGES}
    for pkg, (_, smod) in PACKAGES.items():
        keys, vec, bm = _write_ops(smod, paths[pkg])
    with open(paths["torch"], "rb") as a, open(paths["repro"], "rb") as b:
        assert a.read() == b.read()
    recs = PACKAGES[_other(writer)][1].WriteAheadLog.replay(
        paths[writer], dim=4, width=2)
    assert [(r.kind, r.gen) for r in recs] == [
        ("upsert", 3), ("delete", 3), ("compact", 3), ("upsert", 4)]
    np.testing.assert_array_equal(recs[0].keys, keys)
    np.testing.assert_array_equal(recs[0].vectors, vec)
    np.testing.assert_array_equal(recs[0].bitmaps, bm)
    np.testing.assert_array_equal(recs[1].ids, [7, 9])
    with pytest.raises(ValueError, match="dim"):
        tstore.WriteAheadLog.replay(paths[writer], dim=8, width=2)


@pytest.mark.parametrize("reader", ["torch", "repro"])
@pytest.mark.parametrize("cut", [1, 10, 20])
def test_wal_torn_tail_truncates_to_last_good_record(tmp_path, cut, reader):
    """A log the port wrote, torn mid-record, replays in either package
    to the complete records before the tear, and the repaired file takes
    appends from the other package."""
    rng = np.random.default_rng(47)
    p = str(tmp_path / "w.log")
    wal = tstore.WriteAheadLog.create(p, dim=4, width=1, generation=0)
    for i in range(3):
        wal.log_upsert(0, np.array([i], np.int64),
                       rng.normal(size=(1, 4)).astype(np.float32),
                       np.ones((1, 1), np.uint32))
    wal.close()
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - cut)
    rmod = PACKAGES[reader][1]
    recs = rmod.WriteAheadLog.replay(p, dim=4, width=1)
    assert [r.keys.tolist() for r in recs] == [[0], [1]]
    wmod = PACKAGES[_other(reader)][1]
    wal = wmod.WriteAheadLog.open_append(p, dim=4, width=1)
    wal.log_delete(0, np.array([0], np.int64))
    wal.close()
    recs = tstore.WriteAheadLog.replay(p, dim=4, width=1)
    assert [r.kind for r in recs] == ["upsert", "upsert", "delete"]


@pytest.mark.parametrize("reader", ["torch", "repro"])
def test_wal_midlog_corruption_refused(tmp_path, reader):
    p = str(tmp_path / "w.log")
    wal = tstore.WriteAheadLog.create(p, dim=2, width=1, generation=0)
    for i in range(3):
        wal.log_delete(0, np.array([i], np.int64))
    wal.close()
    size = os.path.getsize(p)
    with open(p, "r+b") as f:                  # inside record 0's payload
        f.seek(24 + 21 + 4)
        b = f.read(1)
        f.seek(24 + 21 + 4)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="mid-log corruption"):
        PACKAGES[reader][1].WriteAheadLog.replay(p, dim=2, width=1)
    assert os.path.getsize(p) == size          # nothing was truncated


def test_wal_sync_every_batches_fsync(tmp_path):
    wal = tstore.WriteAheadLog.create(str(tmp_path / "w.log"), dim=2,
                                      width=1, generation=0, sync_every=8)
    for _ in range(5):
        wal.commit(wal.log_delete(0, np.array([0], np.int64)))
    assert wal._durable_seq == 0
    for _ in range(3):
        wal.commit(wal.log_delete(0, np.array([0], np.int64)))
    assert wal._durable_seq == 8
    wal.sync()
    assert wal._durable_seq == wal._seq == 8
    wal.close()


def test_wal_group_commit_acks_after_the_fsync(tmp_path, monkeypatch):
    """sync_every=1: commit() returns only once an fsync covered its
    record; one leader's fsync covers every record appended before it,
    and concurrent committers share fsyncs."""
    p = str(tmp_path / "w.log")
    wal = tstore.WriteAheadLog.create(p, dim=2, width=1, generation=0)
    synced = []                  # records appended when each fsync ran
    real = os.fsync

    def fsync(fd):
        synced.append(wal._seq)
        real(fd)
    monkeypatch.setattr(os, "fsync", fsync)
    seqs = [wal.log_delete(0, np.array([i], np.int64)) for i in range(4)]
    wal.commit(seqs[-1])
    assert synced == [4] and wal._durable_seq == 4
    for s in seqs:                             # followers: no fsync
        wal.commit(s)
    assert synced == [4]

    acked, go = [], threading.Barrier(8)

    def writer(i):
        go.wait()
        seq = wal.log_delete(0, np.array([i], np.int64))
        wal.commit(seq)
        acked.append((seq, max(synced)))       # the ack follows an fsync
    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert sorted(s for s, _ in acked) == list(range(5, 13))
    assert all(cover >= seq for seq, cover in acked)
    assert len(synced) <= 1 + 8
    wal.close()


def test_wal_backlog_reports_to_the_ledger(tmp_path):
    """The fsync backlog is a pull gauge on the port's process ledger,
    gone once the log closes."""
    with tledger.scoped() as led:
        wal = tstore.WriteAheadLog.create(str(tmp_path / "w.log"), dim=2,
                                          width=1, generation=0,
                                          sync_every=100)
        for i in range(3):
            wal.commit(wal.log_delete(0, np.array([i], np.int64)))
        (name,) = [n for n in led.gauges() if n.startswith("wal:w.log:")]
        assert led.gauges()[name] == {"records": 3.0, "bytes": 3.0 * 33}
        wal.sync()
        assert led.gauges()[name] == {"records": 0.0, "bytes": 0.0}
        wal.close()
        assert led.gauges() == {}
