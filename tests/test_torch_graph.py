"""The port's proximity graph (`repro_torch.ann.graph`) on the CPU against
the JAX package's `repro.ann.graph`: the host build gives identical
arrays, the device build (run here on CPU tensors) is bit-identical to
the host build on an integer-grid dataset, the beam search returns the
same pools, the occlusion prune the same edges, the graft the same graph,
and a live compaction's identity graft equals a fresh build.

Every test draws its randomness from its own seeded generator."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import graph as jgraph
from repro.ann.index import QueryBatch as JQB
from repro.ann.live import LiveFilteredIndex as JLive
from repro_torch.ann import graph as tgraph
from repro_torch.ann.dataset import ANNDataset
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.live import LiveFilteredIndex
from repro_torch.ann.predicates import Predicate
from repro_torch.ann.registry import default_registry
from repro_torch.data.ann_synth import DatasetSpec, synthesize

TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)  # conftest's
# pool distances are ‖v‖² − 2·q·v in fp32 summed in another order than
# the reference's: a few ulps of the largest term at these norms
RTOL = ATOL = 1e-4


@pytest.fixture(scope="module")
def tds():
    return synthesize(DatasetSpec(*TINY))


def grid_set(seed: int, n: int = 700, d: int = 16, universe: int = 40):
    """Integer-grid vectors (multiples of 1/4, many duplicated rows): every
    score and pairwise distance is exact in fp32 in any summation order,
    and ties are frequent. Each row carries 1-3 labels."""
    rng = np.random.default_rng(seed)
    v = (rng.integers(-6, 7, (n, d)) / 4.0).astype(np.float32)
    v[n // 2: n // 2 + n // 8] = v[: n // 8]
    w = (universe + 31) // 32
    bm = np.zeros((n, w), dtype=np.uint32)
    for i in range(n):
        for lab in rng.choice(universe, rng.integers(1, 4), replace=False):
            bm[i, lab >> 5] |= np.uint32(1) << np.uint32(lab & 31)
    return v, bm, universe


def graft_edges_host(pool_ids, pool_d, new_rows, vectors, norms,
                     n_cand: int, alpha: float, keep_n: int) -> np.ndarray:
    """The graft's new-row edges as the JAX package's `graft_graph` makes
    them on the host: each row's beam pool plus its nearest other new
    rows (from the [B, B] score matrix), the `n_cand` nearest of both
    (stable), itself dropped, then the occlusion prune."""
    b = new_rows.size
    pool_d = pool_d.astype(np.float32)
    if b > 1:
        nv = vectors[new_rows]
        dn = norms[new_rows][None, :] - 2.0 * (nv @ nv.T)
        np.fill_diagonal(dn, np.inf)
        t = min(16, b - 1)
        nn_idx = np.argsort(dn, axis=1, kind="stable")[:, :t]
        pool_ids = np.concatenate(
            [pool_ids, new_rows[nn_idx].astype(np.int32)], axis=1)
        pool_d = np.concatenate(
            [pool_d, np.take_along_axis(dn, nn_idx, axis=1)
             .astype(np.float32)], axis=1)
    merge = np.argsort(pool_d, axis=1, kind="stable")[:, :n_cand]
    cid = np.take_along_axis(pool_ids, merge, axis=1)
    cdist = np.take_along_axis(pool_d, merge, axis=1)
    cid = np.where(cid == new_rows[:, None], -1, cid)
    cdist = np.where(cid < 0, np.inf, cdist)
    return jgraph.occlusion_prune(cid, cdist, vectors, norms, alpha, keep_n)


def same_graph(a, b):
    np.testing.assert_array_equal(a.neighbors, b.neighbors)
    assert a.neighbors.dtype == b.neighbors.dtype == np.int32
    assert a.medoid == b.medoid
    np.testing.assert_array_equal(a.label_entry, b.label_entry)


@pytest.mark.parametrize("r", [32, 8])
def test_host_build_equals_reference(tiny_ds, r):
    want = jgraph.build_graph(tiny_ds.vectors, tiny_ds.bitmaps,
                              tiny_ds.universe, r=r, seed=17)
    got = tgraph.build_graph(tiny_ds.vectors, tiny_ds.bitmaps,
                             tiny_ds.universe, r=r, seed=17)
    same_graph(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_build_equals_host_build_on_grid(seed):
    v, bm, u = grid_set(seed)
    host = tgraph.build_graph(v, bm, u, r=16, seed=seed, n_cand=40,
                              block=64)
    dev = tgraph.build_graph_torch(v, bm, u, device="cpu", r=16, seed=seed,
                                   n_cand=40, block=64)
    same_graph(dev, host)


def test_device_build_on_random_floats(tds):
    """On random floats the two builds sum the pool distances in different
    orders; at the tiny spec they still agree edge for edge."""
    host = tgraph.build_graph(tds.vectors, tds.bitmaps, tds.universe,
                              seed=17)
    dev = tgraph.build_graph_torch(tds.vectors, tds.bitmaps, tds.universe,
                                   device="cpu", seed=17)
    same_graph(dev, host)


@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_occlusion_prune_matches_reference(alpha):
    v, _, _ = grid_set(5, n=300)
    norms = (v ** 2).sum(1).astype(np.float32)
    rng = np.random.default_rng(8)
    cid = rng.integers(-1, v.shape[0], (40, 24)).astype(np.int32)
    q = v[rng.integers(0, v.shape[0], 40)]
    cdist = norms[np.maximum(cid, 0)] - 2.0 * np.einsum(
        "bd,bcd->bc", q, v[np.maximum(cid, 0)])
    cdist = np.where(cid < 0, np.inf, cdist).astype(np.float32)
    order = np.argsort(cdist, axis=1, kind="stable")
    cid = np.take_along_axis(cid, order, 1)
    cdist = np.take_along_axis(cdist, order, 1)
    want = jgraph.occlusion_prune(cid, cdist, v, norms, alpha, 10)
    np.testing.assert_array_equal(
        tgraph.occlusion_prune(cid, cdist, v, norms, alpha, 10), want)
    got = tgraph.occlusion_prune_torch(
        torch.from_numpy(cid), torch.from_numpy(cdist), torch.from_numpy(v),
        torch.from_numpy(norms), alpha, 10)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("data,l_search", [("tiny", 16), ("grid", 16),
                                            ("grid", 48), ("grid", 100)])
def test_beam_search_matches_reference(tiny_ds, data, l_search):
    """The same pools as the reference's over a JAX-built graph: ids
    equal, distances to fp32 summation order (bit-identical on the
    integer grid). On random floats the two packages' distances of one
    row differ in the last bits, so where two pool entries are that
    close the searches may part: at L = 48 on the tiny spec one query
    of 30 does (ROADMAP, faults in the port); L = 16 does not."""
    rng = np.random.default_rng(11)
    nq = 30
    if data == "tiny":
        v, bm, u = tiny_ds.vectors, tiny_ds.bitmaps, tiny_ds.universe
        g = jgraph.build_graph(v, bm, u, seed=17)
        q = rng.normal(size=(nq, v.shape[1])).astype(np.float32)
    else:
        v, bm, u = grid_set(3)
        g = jgraph.build_graph(v, bm, u, r=16, seed=3)
        q = (rng.integers(-6, 7, (nq, v.shape[1])) / 4.0).astype(np.float32)
    seeds = np.full((nq, 5), -1, np.int32)
    seeds[:, 0] = g.medoid
    seeds[:, 1:3] = rng.integers(0, v.shape[0], (nq, 2))
    norms = (v ** 2).sum(1).astype(np.float32)
    jids, jd = jgraph.beam_search(
        jnp.asarray(q), jnp.asarray(seeds), jnp.asarray(g.neighbors),
        jnp.asarray(v), jnp.asarray(norms), l_search=l_search,
        iters=l_search)
    tids, td = tgraph.beam_search(
        torch.from_numpy(q), torch.from_numpy(seeds),
        torch.from_numpy(g.neighbors), torch.from_numpy(v),
        torch.from_numpy(norms), l_search=l_search, iters=l_search)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    if data == "grid":
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    else:
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                                   atol=ATOL)


def test_graft_identity_remap_reproduces_graph(tds):
    old = tgraph.build_graph(tds.vectors, tds.bitmaps, tds.universe,
                             seed=17)
    got = tgraph.graft_graph(old, tds.vectors, tds.bitmaps, tds.universe,
                             np.arange(tds.n), np.zeros(0, np.int64),
                             seed=17, device="cpu")
    same_graph(got, old)


def test_graft_with_deletes_and_new_rows_matches_reference(tiny_ds):
    """Deletes (the medoid and a label entry among them) and 80 new rows:
    the port's graft gives the reference's graph."""
    v, bm, u = tiny_ds.vectors, tiny_ds.bitmaps, tiny_ds.universe
    old = jgraph.build_graph(v, bm, u, seed=17)
    rng = np.random.default_rng(12)
    dead = np.unique(np.concatenate([
        rng.choice(tiny_ds.n, 60, replace=False),
        [old.medoid, old.label_entry[old.label_entry >= 0][0]]]))
    keep = np.setdiff1d(np.arange(tiny_ds.n), dead)
    add = 80
    nv = np.concatenate([v[keep], v[:add] + np.float32(0.05)])
    nbm = np.concatenate([bm[keep], bm[:add]])
    o2n = np.full(tiny_ds.n, -1, np.int64)
    o2n[keep] = np.arange(keep.size)
    new_rows = np.arange(keep.size, keep.size + add)
    want = jgraph.graft_graph(old, nv, nbm, u, o2n, new_rows, seed=17)
    got = tgraph.graft_graph(old, nv, nbm, u, o2n, new_rows, seed=17,
                             device="cpu")
    same_graph(got, want)


def test_fvamana_and_graft_default_to_the_card(tds):
    """`FVamana.build`, `FVamana.graft_index` and `graft_graph` default to
    the card like every other entry point; with `device="cpu"` they give
    the graphs they gave before the default moved: the host build, and
    the reference's graft (the test above holds it so)."""
    import inspect

    from repro_torch.ann.methods.fvamana import FVamana

    for fn in (FVamana.build, FVamana.graft_index, tgraph.graft_graph):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    m = FVamana()
    old = m.build(tds, {"r": 32}, device="cpu")
    same_graph(old, tgraph.build_graph(tds.vectors, tds.bitmaps,
                                       tds.universe, r=32, seed=17))
    keep = np.arange(20, tds.n)
    o2n = np.full(tds.n, -1, np.int64)
    o2n[keep] = np.arange(keep.size)
    nv = np.concatenate([tds.vectors[keep], tds.vectors[:10] + 0.1])
    nbm = np.concatenate([tds.bitmaps[keep], tds.bitmaps[:10]])
    new_ds = ANNDataset.from_packed("g", nv.astype(np.float32), nbm,
                                    tds.universe)
    new_rows = np.arange(keep.size, new_ds.n)
    got = m.graft_index(new_ds, old, tds, o2n, new_rows, {"r": 32},
                        device="cpu")
    same_graph(got, tgraph.graft_graph(old, new_ds.vectors, new_ds.bitmaps,
                                       tds.universe, o2n, new_rows, r=32,
                                       seed=17, device="cpu"))


@pytest.mark.parametrize("n_new,chunk", [(90, 16), (90, 2048), (1, 16)])
def test_graft_edges_on_tensors_equal_host(monkeypatch, n_new, chunk):
    """The graft's device step (`_graft_edges_torch`, run here on CPU
    tensors, a block of `chunk` new rows at a time) gives the reference's
    host step's edges (`graft_edges_host`) bit for bit on the integer
    grid: the nearest new rows without the [B, B] matrix, the stable
    merge, the prune."""
    v, bm, u = grid_set(6, n=500)
    g = tgraph.build_graph(v, bm, u, r=16, seed=6, n_cand=40)
    norms = (v ** 2).sum(1).astype(np.float32)
    new_rows = np.sort(np.random.default_rng(9).choice(v.shape[0], n_new,
                                                      replace=False))
    seeds = np.full((n_new, 4), -1, np.int32)
    seeds[:, 0] = g.medoid
    pool_ids, pool_d = tgraph.beam_search(
        torch.from_numpy(v[new_rows]), torch.from_numpy(seeds),
        torch.from_numpy(g.neighbors), torch.from_numpy(v),
        torch.from_numpy(norms), l_search=40, iters=20)
    want = graft_edges_host(pool_ids.numpy(), pool_d.numpy(), new_rows, v,
                            norms, 40, 1.2, 14)
    monkeypatch.setattr(tgraph, "ROW_CHUNK", chunk)
    got = tgraph._graft_edges_torch(pool_ids, pool_d,
                                    torch.from_numpy(new_rows),
                                    torch.from_numpy(v),
                                    torch.from_numpy(norms), 40, 1.2, 14)
    np.testing.assert_array_equal(got.numpy(), want)


def test_identity_graft_compaction_equals_fresh_build(tds, tiny_queries):
    """Compacting with no deletes and no delta is an identity remap, so
    the grafted fvamana graph equals a fresh build bit for bit (the
    pattern of `tests/test_live_fused.py`)."""
    pred = Predicate.AND
    qs = tiny_queries[pred]
    batch = TQB(qs.vectors, qs.bitmaps, pred, 10)
    with LiveFilteredIndex(tds, device="cpu") as live:
        live.search(batch, "fvamana")          # forces the offline build
        before = dict(live._base_fx._indexes)
        live.compact()
        after = dict(live._base_fx._indexes)
        assert set(after) == set(before)
        for (m_name, bp), idx in after.items():
            fresh = default_registry().get(m_name).build(
                live.ds, dict(bp), device="cpu")
            same_graph(idx, fresh)


def test_compaction_grafts_fvamana_as_reference(tiny_ds, tds, tiny_queries):
    """With deletes and upserts, compaction grafts the fvamana graph; the
    grafted graph and the searches over it match the reference's."""
    pred = Predicate.OR
    qs = tiny_queries[pred]
    jb = JQB(qs.vectors, qs.bitmaps, pred, 10)
    tb = TQB(qs.vectors, qs.bitmaps, pred, 10)
    dead = np.random.default_rng(13).choice(tds.n, 50, replace=False)
    with LiveFilteredIndex(tds, device="cpu") as tl, JLive(tiny_ds) as jl:
        tl.search(tb, "fvamana")
        jl.search(jb, "fvamana")
        for live, ds in ((tl, tds), (jl, tiny_ds)):
            live.upsert(ds.vectors[:60] + np.float32(0.02), ds.bitmaps[:60])
            live.delete(dead)
            live.compact()
        (key, got), = tl._base_fx._indexes.items()
        same_graph(got, jl._base_fx._indexes[key])
        tr, jr = tl.search(tb, "fvamana"), jl.search(jb, "fvamana")
        np.testing.assert_array_equal(tr.ids, jr.ids)
        np.testing.assert_array_equal(tr.keys, jr.keys)
