"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the
file imports only torch, numpy and `repro_torch`, so it also runs where
JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import bitmap_filter as bf
from repro_torch.kernels import masked_topk as mk
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions
    return torch.device("cuda")                      # stay in full fp32


def _tie_case(rng, q, n, d=24, w=2):
    """Integer-grid vectors (multiples of 1/4) with duplicated rows: every
    score is exact in fp32 whatever the summation order, and ties are
    frequent."""
    qv = (rng.integers(-6, 7, (q, d)) / 4.0).astype(np.float32)
    base = (rng.integers(-6, 7, (n, d)) / 4.0).astype(np.float32)
    base[n // 2: n // 2 + n // 4] = base[: n // 4]   # exact duplicates
    norms = (base.astype(np.float64) ** 2).sum(1).astype(np.float32)
    qb = (rng.integers(0, 2, (q, w)) * rng.integers(1, 8, (q, w))
          ).astype(np.uint32)
    bm = (rng.integers(0, 2, (n, w)) * rng.integers(1, 8, (n, w))
          ).astype(np.uint32)
    return qv, qb, base, norms, bm


def _on(dev, case):
    qv, qb, base, norms, bm = case
    return (torch.from_numpy(qv).to(dev), torch.from_numpy(qb.view(np.int32)).to(dev),
            torch.from_numpy(base).to(dev), torch.from_numpy(norms).to(dev),
            torch.from_numpy(bm.view(np.int32)).to(dev))


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("q,n,k", [(1, 64, 5), (7, 256, 41), (25, 1024, 10),
                                   (3, 20011, 128), (5, 3, 10),
                                   (37, 70001, 10)])
def test_masked_topk_kernel_bitwise_on_tie_grid(cuda, pred, q, n, k):
    args = _on(cuda, _tie_case(np.random.default_rng(q * 7 + n), q, n))
    gd, gi = mk.masked_topk_accum(*args, pred=pred, k=k)
    pd, pi = mk.masked_topk_plain(*args, pred=pred, k=k)
    torch.cuda.synchronize()
    assert torch.equal(gi, pi)
    assert torch.equal(gd, pd)


def test_masked_topk_kernel_empty_query_and_no_match(cuda):
    qv, qb, base, norms, bm = _tie_case(np.random.default_rng(1), 4, 3000)
    qb[0] = 0                       # empty label set
    bm[:, :] = 0
    bm[:5] = 3                      # only five rows carry labels
    args = _on(cuda, (qv, qb, base, norms, bm))
    for pred in (0, 1, 2):
        ids, d = ops.masked_topk(*args, pred=pred, k=10)
        pids, pd = ops.masked_topk(*[a.cpu() for a in args], pred=pred,
                                   k=10)
        assert torch.equal(ids.cpu(), pids)
        assert torch.equal(d.cpu(), pd)


def test_masked_topk_kernel_random_fp32_within_sum_order(cuda):
    rng = np.random.default_rng(0)
    q, n, d, w = 16, 50000, 192, 7
    qv = rng.normal(size=(q, d)).astype(np.float32)
    base = rng.normal(size=(n, d)).astype(np.float32)
    norms = (base.astype(np.float64) ** 2).sum(1).astype(np.float32)
    bm = (rng.random((n, w)) < 0.5).astype(np.uint32) * 5
    qb = np.full((q, w), 4, np.uint32)
    args = _on(cuda, (qv, qb, base, norms, bm))
    gd, gi = mk.masked_topk_accum(*args, pred=2, k=10)
    pd, pi = mk.masked_topk_plain(*args, pred=2, k=10)
    # two fp32 summation orders differ by at most 2·D·u·Σ|terms|
    scale = norms.max() + 2 * np.sqrt(norms.max() * (qv ** 2).sum(1).max())
    tol = 2 * d * 2.0 ** -24 * scale
    assert torch.equal(gi >= 0, pi >= 0) and bool((gi >= 0).all())
    assert torch.allclose(gd, pd, rtol=0, atol=tol)
    # each id carries its own plain score, and ids differ only where the
    # plain scores of both lie within tol
    scores = args[3][None] - 2.0 * (args[0] @ args[2].T)
    got_s = scores.gather(1, gi.long())
    assert bool((torch.abs(got_s - gd) <= tol).all())
    differ = gi != pi
    assert bool((torch.abs(got_s - scores.gather(1, pi.long()))[differ]
                 <= tol).all())
    assert bool(mk._predicate_mask_block(args[4], args[1], 2)
                .gather(1, gi.long()).all())
    assert all(len(set(row)) == len(row) for row in gi.tolist())


def test_masked_topk_kernel_scores_past_pad_score(cuda):
    """Rows whose score is +inf, NaN or past PAD_SCORE (overflowing or
    NaN norms) come back as (PAD_SCORE, -1) from the kernel's merge and
    from the plain version alike, after every real candidate."""
    qv, qb, base, norms, bm = _tie_case(np.random.default_rng(5), 9, 3000)
    norms[::7] = np.inf
    norms[3::11] = np.nan
    norms[5::13] = np.float32(3.3e38)
    args = _on(cuda, (qv, qb, base, norms, bm))
    for pred in (0, 1, 2):
        gd, gi = mk.masked_topk_accum(*args, pred=pred, k=41)
        pd, pi = mk.masked_topk_plain(*args, pred=pred, k=41)
        torch.cuda.synchronize()
        assert torch.equal(gi, pi)
        assert torch.equal(gd, pd)
        assert bool((gd[gi < 0] == mk.PAD_SCORE).all())


@pytest.mark.parametrize("d", [5, 400])
def test_masked_topk_kernel_odd_and_wide_dims(cuda, d):
    """An odd D, and a D whose shared-memory tiles pass 48 KB (the
    kernel then opts in to more)."""
    qv, qb, base, norms, bm = _tie_case(np.random.default_rng(d), 20, 5000,
                                        d=d)
    args = _on(cuda, (qv, qb, base, norms, bm))
    for pred in (0, 1, 2):
        gd, gi = mk.masked_topk_accum(*args, pred=pred, k=16)
        pd, pi = mk.masked_topk_plain(*args, pred=pred, k=16)
        torch.cuda.synchronize()
        assert torch.equal(gi, pi)
        assert torch.equal(gd, pd)


def test_masked_topk_kernel_refuses_too_wide_rows(cuda):
    """Rows whose label words do not fit the scan's two label tiles in
    shared memory are refused (any D fits: dimensions are staged in
    chunks, so D = 1300 is taken and equals the plain version)."""
    args = _on(cuda, _tie_case(np.random.default_rng(3), 2, 64, w=200))
    with pytest.raises(ValueError, match="shared memory"):
        mk.masked_topk_accum(*args, pred=0, k=5)
    args = _on(cuda, _tie_case(np.random.default_rng(3), 2, 64, d=1300))
    gd, gi = mk.masked_topk_accum(*args, pred=2, k=5)
    pd, pi = mk.masked_topk_plain(*args, pred=2, k=5)
    torch.cuda.synchronize()
    assert torch.equal(gi, pi) and torch.equal(gd, pd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q,n,d,w", [(33, 3001, 5, 1), (45, 5000, 192, 8),
                                     (17, 2500, 192, 1), (70, 4099, 37, 3),
                                     (1, 300, 1300, 2)])
def test_tile_scan_shapes_bitwise(cuda, dtype, q, n, d, w):
    """The register-blocked scan at odd and wide D (dimension chunks),
    one and eight label words, query counts that are not a multiple of
    the block's 32, bf16 staged to fp32: bit-identical to the plain
    version on the tie grid, through the split and the key kernels."""
    args = _on(cuda, _tie_case(np.random.default_rng(q + d + w), q, n, d=d,
                               w=w))
    if dtype == "bfloat16":
        args = (args[0].bfloat16(), args[1], args[2].bfloat16(), *args[3:])
    for pred in (0, 1, 2):
        for k in (10, 200):
            gd, gi = mk.masked_topk_accum(*args, pred=pred, k=k)
            pd, pi = mk.masked_topk_plain(*args, pred=pred, k=k)
            torch.cuda.synchronize()
            assert torch.equal(gi, pi) and torch.equal(gd, pd), (pred, k)


def test_masked_topk_kernel_counts_launches_and_checks(cuda):
    args = _on(cuda, _tie_case(np.random.default_rng(2), 4, 512))
    before = mk.masked_topk_accum.launches
    mk.masked_topk_accum(*args, pred=1, k=5)
    assert mk.masked_topk_accum.launches == before + 1
    # k past MAX_K is taken (as the reference takes it), by the k > MAX_K
    # kernels, which count their own launches
    large = mk.masked_topk_large.launches
    gd, gi = mk.masked_topk_accum(*args, pred=1, k=129)
    pd, pi = mk.masked_topk_plain(*args, pred=1, k=129)
    torch.cuda.synchronize()
    assert torch.equal(gi, pi) and torch.equal(gd, pd)
    assert mk.masked_topk_large.launches == large + 1
    with pytest.raises(TypeError):
        mk.masked_topk_accum(args[0].half(), args[1], args[2].half(),
                             *args[3:], pred=1, k=5)
    with pytest.raises(ValueError, match="contiguous"):
        mk.masked_topk_accum(args[0].T.contiguous().T, *args[1:], pred=1,
                             k=5)
    assert mk.masked_topk_accum.launches == before + 1


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("q,n", [(1, 50), (7, 131), (40, 100003),
                                 (300, 70000)])
def test_selectivity_kernel_exact(cuda, pred, q, n):
    _, qb, _, _, bm = _tie_case(np.random.default_rng(q + n), q, n, w=3)
    qb[0] = 0                       # empty query: all rows for AND
    qbt = torch.from_numpy(qb.view(np.int32)).to(cuda)
    bmt = torch.from_numpy(bm.view(np.int32)).to(cuda)
    before = bf.selectivity_count.launches
    got = bf.selectivity_count(qbt, bmt, pred=pred)
    want = bf.selectivity_plain(qbt, bmt, pred=pred)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bf.selectivity_count.launches == before + 1


def _pattern_bitmaps(rng, q, n, w, pred):
    """Rows drawn from 32 random label patterns, so every predicate passes
    a sizeable share of rows; queries built for `pred` (a pattern for
    EQUALITY, a subset of one for AND, a few bits for OR). Query 0 is
    empty: it matches every row for AND."""
    def words(shape):
        return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(
            np.uint32)

    pats = words((32, w)) & words((32, w)) & words((32, w))
    bm = pats[rng.integers(0, 32, n)]
    src = pats[rng.integers(0, 32, q)]
    if pred == 0:
        qb = src.copy()
    elif pred == 1:
        qb = src & words((q, w))
    else:
        qb = (rng.random((q, w)) < 0.3).astype(np.uint32) << \
            rng.integers(0, 32, (q, w)).astype(np.uint32)
    qb[0] = 0
    return qb, bm


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("q", [1, 7, 255, 300])
@pytest.mark.parametrize("w", [1, 7, 13, 16, 32, 63])
def test_selectivity_kernel_widths(cuda, pred, q, w):
    """Every register-resident width class and the chunked path (W > 16),
    at query counts that are not a multiple of the block's and a ragged
    row count (not a multiple of the tile, nor of 4 words at odd W)."""
    n = 70_001 if w < 32 else 9_001
    qb, bm = _pattern_bitmaps(np.random.default_rng(w * 1000 + q), q, n, w,
                              pred)
    qbt = torch.from_numpy(qb.view(np.int32)).to(cuda)
    bmt = torch.from_numpy(bm.view(np.int32)).to(cuda)
    before = bf.selectivity_count.launches
    got = bf.selectivity_count(qbt, bmt, pred=pred)
    want = bf.selectivity_plain(qbt, bmt, pred=pred)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bf.selectivity_count.launches == before + 1
    if q > 1 and pred == 1:
        assert int(got[0]) == n            # the empty query


@pytest.mark.parametrize("w", [3, 7])
def test_selectivity_kernel_unaligned_rows(cuda, w):
    """A view that starts one row in (not 16-byte aligned) counts as its
    own rows do."""
    qb, bm = _pattern_bitmaps(np.random.default_rng(w), 40, 5001, w, 2)
    qbt = torch.from_numpy(qb.view(np.int32)).to(cuda)
    bmt = torch.from_numpy(bm.view(np.int32)).to(cuda)[1:]
    assert bmt.data_ptr() % 16
    got = bf.selectivity_count(qbt, bmt, pred=2)
    torch.cuda.synchronize()
    assert torch.equal(got, bf.selectivity_plain(qbt, bmt, pred=2))


def _grid_set(seed, n=700, d=16, universe=40):
    """Integer-grid vectors (multiples of 1/4, duplicated rows), 1-3
    labels a row: every graph-build distance is exact in fp32."""
    rng = np.random.default_rng(seed)
    v = (rng.integers(-6, 7, (n, d)) / 4.0).astype(np.float32)
    v[n // 2: n // 2 + n // 8] = v[: n // 8]
    bm = np.zeros((n, (universe + 31) // 32), dtype=np.uint32)
    for i in range(n):
        for lab in rng.choice(universe, rng.integers(1, 4), replace=False):
            bm[i, lab >> 5] |= np.uint32(1) << np.uint32(lab & 31)
    return v, bm, universe


@pytest.mark.parametrize("seed,n", [(0, 700), (1, 5000)])
def test_graph_build_on_card_equals_host_build(cuda, seed, n):
    from repro_torch.ann import graph

    v, bm, u = _grid_set(seed, n=n)
    host = graph.build_graph(v, bm, u, r=16, seed=seed, n_cand=40)
    card = graph.build_graph_torch(v, bm, u, device=cuda, r=16, seed=seed,
                                   n_cand=40)
    np.testing.assert_array_equal(card.neighbors, host.neighbors)
    assert card.medoid == host.medoid
    np.testing.assert_array_equal(card.label_entry, host.label_entry)


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("q,n,k", [(7, 256, 41), (25, 1024, 10),
                                   (37, 70001, 10)])
def test_masked_topk_kernel_bf16(cuda, pred, q, n, k):
    """bf16 rows and queries: the kernel converts each value to fp32 as it
    stages it, so on the tie grid (exact in bf16) it equals its plain
    version, and the fp32 kernel, bit for bit."""
    args = _on(cuda, _tie_case(np.random.default_rng(q + n), q, n))
    b16 = (args[0].bfloat16(), args[1], args[2].bfloat16(), *args[3:])
    gd, gi = mk.masked_topk_accum(*b16, pred=pred, k=k)
    pd, pi = mk.masked_topk_plain(*b16, pred=pred, k=k)
    fd, fi = mk.masked_topk_accum(*args, pred=pred, k=k)
    torch.cuda.synchronize()
    assert torch.equal(gi, pi) and torch.equal(gd, pd)
    assert torch.equal(gi, fi) and torch.equal(gd, fd)


def test_masked_topk_kernel_bf16_random(cuda):
    """Random bf16: products are exact in fp32, so the kernel and its
    plain version differ only by summation order (2·D·u·Σ|terms|)."""
    rng = np.random.default_rng(3)
    q, n, d, w = 16, 50000, 192, 7
    qv = rng.normal(size=(q, d)).astype(np.float32)
    base = rng.normal(size=(n, d)).astype(np.float32)
    norms = (base.astype(np.float64) ** 2).sum(1).astype(np.float32)
    bm = (rng.random((n, w)) < 0.5).astype(np.uint32) * 5
    qb = np.full((q, w), 4, np.uint32)
    args = _on(cuda, (qv, qb, base, norms, bm))
    b16 = (args[0].bfloat16(), args[1], args[2].bfloat16(), *args[3:])
    gd, gi = mk.masked_topk_accum(*b16, pred=2, k=10)
    pd, pi = mk.masked_topk_plain(*b16, pred=2, k=10)
    scale = norms.max() + 2 * np.sqrt(norms.max() * (qv ** 2).sum(1).max())
    # bf16 rounding makes a vector's norm larger by at most 2^-8
    tol = 2 * d * 2.0 ** -24 * scale * 1.01
    assert torch.equal(gi >= 0, pi >= 0)
    assert torch.allclose(gd, pd, rtol=0, atol=tol)
    scores = args[3][None] - 2.0 * (b16[0].float() @ b16[2].float().T)
    assert bool((torch.abs(scores.gather(1, gi.long()) - gd) <= tol).all())


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("q,n,bn,k", [(8, 512, 128, 10), (16, 256, 64, 41),
                                      (8, 64, 16, 20), (5, 1001, 256, 10),
                                      (37, 70001, 1024, 10),
                                      (3, 20011, 1024, 128),
                                      (7, 5000, 1000, 200),
                                      (3, 20000, 8192, 300),
                                      (2, 700, 64, 129)])
def test_masked_topk_blocks_kernel_bitwise_on_tie_grid(cuda, pred, q, n, bn,
                                                       k):
    args = _on(cuda, _tie_case(np.random.default_rng(q * 3 + n + k), q, n))
    before = mk.masked_topk_blocks.launches
    gd, gi = mk.masked_topk_blocks(*args, pred=pred, k=k, bn=bn)
    pd, pi = mk.masked_topk_blocks_plain(*args, pred=pred, k=k, bn=bn)
    torch.cuda.synchronize()
    assert mk.masked_topk_blocks.launches == before + 1
    assert gd.shape == (-(-n // bn), q, k)
    assert torch.equal(gi, pi)
    assert torch.equal(gd.view(torch.int32), pd.view(torch.int32))
    ids, dists = ops.masked_topk_multiblock(*args, pred=pred, k=k, bn=bn)
    want_i, want_d = ops.masked_topk(*args, pred=pred, k=k)
    assert torch.equal(ids, want_i) and torch.equal(dists, want_d)


def _merge_grid(rng, s, q, kk):
    """Coarse-grid distances (ties within and across shards), ±0.0, NaN,
    ±inf, values past PAD_SCORE, repeated ids and −1 slots."""
    d = np.round(rng.normal(size=(s, q, kk)).astype(np.float32) ** 2, 1)
    d[rng.random(d.shape) < 0.2] *= -1
    zero = rng.random(d.shape) < 0.3
    d[zero] = np.where(rng.random(int(zero.sum())) < 0.5, np.float32(0.0),
                       np.float32(-0.0))
    for val, frac in ((np.nan, 0.05), (np.inf, 0.05), (-np.inf, 0.03),
                      (np.float32(3.2e38), 0.03)):
        d[rng.random(d.shape) < frac] = val
    ids = rng.integers(0, 10, (s, q, kk)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.1] = -1
    return d, ids


@pytest.mark.parametrize("s,q,kk,k", [(1, 11, 8, 8), (2, 8, 10, 10),
                                      (3, 25, 41, 10), (5, 64, 10, 41),
                                      (4, 256, 10, 10), (977, 64, 10, 10),
                                      (977, 256, 10, 10), (40, 7, 30, 128),
                                      (1500, 3, 4, 10), (2, 300, 64, 128),
                                      (3, 9, 4, 10), (3, 20, 100, 200),
                                      (40, 7, 30, 300), (977, 5, 10, 1000),
                                      # the shared-memory select
                                      (1, 64, 416, 10), (2, 256, 1016, 10),
                                      (2, 33, 1016, 1), (3, 9, 4096, 129),
                                      (3, 5, 4096, 1016), (1, 7, 100, 101),
                                      (2, 20, 1017, 128), (977, 17, 10, 10),
                                      # past shared memory: the workspace
                                      (1, 4, 60000, 10), (2, 3, 40000, 129),
                                      (1, 2, 30000, 30001)])
def test_merge_topk_kernel_bitwise(cuda, s, q, kk, k):
    rng = np.random.default_rng(s * 31 + q + kk)
    d, ids = _merge_grid(rng, s, q, kk)
    dt, it = torch.from_numpy(d).to(cuda), torch.from_numpy(ids).to(cuda)
    before = mk.merge_topk_accum.launches
    gd, gi = mk.merge_topk_accum(dt, it, k=k)
    pd, pi = mk.merge_topk_plain(dt, it, k=k)
    torch.cuda.synchronize()
    assert mk.merge_topk_accum.launches == before + 1
    assert torch.equal(gi, pi)
    assert torch.equal(gd.view(torch.int32), pd.view(torch.int32))
    # and through the entry point, against the CPU's plain version
    ci, cd = ops.merge_topk(it, dt, k=k)
    wi, wd = ops.merge_topk(it.cpu(), dt.cpu(), k=k)
    assert torch.equal(ci.cpu(), wi)
    assert torch.equal(cd.cpu().view(torch.int32), wd.view(torch.int32))


@pytest.mark.parametrize("sorted_lists", [False, True])
@pytest.mark.parametrize("s,q,kk,k", [(4, 256, 10, 10), (977, 64, 10, 10),
                                      (40, 7, 30, 128), (2, 256, 1016, 10),
                                      (1500, 3, 4, 10), (1, 5, 60000, 129),
                                      (977, 8, 32, 32), (1025, 4, 128, 128),
                                      (3, 4, 10000, 10)])
def test_merge_topk_kernel_sorted_lists(cuda, s, q, kk, k, sorted_lists):
    """Lists already ascending, as shards and the fused scan hand them
    over, launched as the scans launch their fold: read whole where the
    keys fit shared memory, past it stepped through with the scans'
    promise (no workspace; a thread that owns two lists past 1,024) or
    selected in a workspace without it; always the plain version's
    result."""
    rng = np.random.default_rng(s + q + kk)
    d, ids = _merge_grid(rng, s, q, kk)
    d = np.where(np.isnan(d) | (ids < 0), np.float32(mk.PAD_SCORE), d)
    key = mk.order_key(torch.from_numpy(
        np.minimum(d, np.float32(mk.PAD_SCORE)))).numpy()
    order = np.argsort(key, axis=2, kind="stable")   # -0.0 before +0.0
    d = np.take_along_axis(d, order, 2)
    ids = np.take_along_axis(ids, order, 2)
    dt, it = torch.from_numpy(d).to(cuda), torch.from_numpy(ids).to(cuda)
    lib = _build.library()
    if sorted_lists:
        assert lib.merge_topk_workspace_bytes(s, q, kk, k, 1) == 0
    gd = torch.empty((q, k), dtype=torch.float32, device=dt.device)
    gi = torch.empty((q, k), dtype=torch.int32, device=dt.device)
    assert mk._merge_launch(lib, dt.device, dt, it, gd, gi, k,
                            sorted_lists) == 0
    pd, pi = mk.merge_topk_plain(dt, it, k=k)
    torch.cuda.synchronize()
    assert torch.equal(gi, pi)
    assert torch.equal(gd.view(torch.int32), pd.view(torch.int32))


def _staged_lists(rng, s, q, kk, dead=0.35):
    """The staged live read's fold: a base overfetch of kk ascending
    candidates with (−1, +inf) holes where rows are tombstoned, and for
    s = 2 a delta top-k half as wide with a tail of (−1, +inf) pads,
    padded to kk. Coarse-grid distances, ±0.0 among them, so ties
    straddle the lists, the lanes' stripes and the k-th place."""
    def grid(n):
        x = np.round(rng.normal(size=(q, n)), 1).astype(np.float32)
        x[rng.random(x.shape) < 0.1] = np.float32(-0.0)
        key = mk.order_key(torch.from_numpy(x)).numpy()
        return np.take_along_axis(x, np.argsort(key, 1, kind="stable"), 1)
    base, b_ids = grid(kk), rng.permutation(q * kk).reshape(q, kk)
    hole = rng.random((q, kk)) < dead
    base[hole], b_ids[hole] = np.inf, -1
    ids, d = [b_ids.astype(np.int32)], [base]
    if s == 2:
        kd = kk // 2
        delta = np.full((q, kk), np.inf, np.float32)
        d_ids = np.full((q, kk), -1, np.int32)
        delta[:, :kd] = grid(kd)
        d_ids[:, :kd] = q * kk + np.arange(q * kd).reshape(q, kd)
        for qi, nval in enumerate(rng.integers(0, kd + 1, q)):
            delta[qi, nval:], d_ids[qi, nval:] = np.inf, -1
        ids.append(d_ids)
        d.append(delta)
    return np.stack(d), np.stack(ids)


@pytest.mark.parametrize("k", [1, 10, 128, 129, 1016, 2100])
@pytest.mark.parametrize("s,q,kk", [(1, 256, 416), (2, 256, 1016),
                                    (2, 7, 30000)])
def test_merge_topk_kernel_staged_lists(cuda, s, q, kk, k):
    d, ids = _staged_lists(np.random.default_rng(s * 7 + kk + k), s, q, kk)
    dt, it = torch.from_numpy(d).to(cuda), torch.from_numpy(ids).to(cuda)
    gd, gi = mk.merge_topk_accum(dt, it, k=k)
    pd, pi = mk.merge_topk_plain(dt, it, k=k)
    torch.cuda.synchronize()
    assert torch.equal(gi, pi)
    assert torch.equal(gd.view(torch.int32), pd.view(torch.int32))


@pytest.mark.parametrize("k", [1, 10, 129, 1016])
@pytest.mark.parametrize("s,q,kk", [(1, 5, 1016), (3, 4, 4096),
                                    (2, 3, 40000), (977, 3, 10)])
def test_merge_topk_kernel_all_ties(cuda, s, q, kk, k):
    """Every valid slot at one distance: the k-th key's ties straddle the
    lanes' stripes, the tiles and (past shared memory) the select's
    blocks, and go in position order."""
    rng = np.random.default_rng(s + kk + k)
    d = np.full((s, q, kk), 2.5, np.float32)
    ids = rng.integers(0, 1 << 30, (s, q, kk)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.2] = -1
    d[rng.random(d.shape) < 0.05] = np.nan
    dt, it = torch.from_numpy(d).to(cuda), torch.from_numpy(ids).to(cuda)
    gd, gi = mk.merge_topk_accum(dt, it, k=k)
    pd, pi = mk.merge_topk_plain(dt, it, k=k)
    torch.cuda.synchronize()
    assert torch.equal(gi, pi)
    assert torch.equal(gd.view(torch.int32), pd.view(torch.int32))


def test_merge_topk_kernel_signed_zero_order(cuda):
    d = torch.tensor([[[0.0, -0.0, 1.0]], [[-0.0, 0.0, -1.0]]], device=cuda)
    ids = torch.tensor([[[10, 11, 12]], [[20, 21, 22]]], dtype=torch.int32,
                       device=cuda)
    gd, gi = mk.merge_topk_accum(d, ids, k=6)
    assert gi.tolist() == [[22, 11, 20, 10, 21, 12]]
    assert torch.signbit(gd[0]).tolist() == [True, True, True, False,
                                             False, False]


# ---------------------------------------------------------------------------
# k past MAX_K, and the fused live read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("q,n,k", [(3, 2000, 129), (5, 70001, 1016),
                                   (2, 700, 1016), (17, 5000, 200),
                                   (2, 40000, 20000), (3, 100003, 200),
                                   (2, 5000, 6000), (33, 4097, 129)])
def test_masked_topk_large_kernel_bitwise_on_tie_grid(cuda, pred, q, n, k):
    """The key/select kernels for k > MAX_K against the plain version on
    the tie grid: ties to the lowest row, fill past the matches (k > N
    too), the shared-memory sort and (k = 20,000) the global one."""
    args = _on(cuda, _tie_case(np.random.default_rng(q * 11 + n), q, n))
    before = mk.masked_topk_large.launches
    gd, gi = mk.masked_topk_accum(*args, pred=pred, k=k)
    pd, pi = mk.masked_topk_plain(*args, pred=pred, k=k)
    torch.cuda.synchronize()
    assert mk.masked_topk_large.launches == before + 1
    assert torch.equal(gi, pi)
    assert torch.equal(gd, pd)


@pytest.mark.parametrize("k", [129, 200, 1016, 20000])
def test_select_kernel_ties_across_blocks(cuda, k):
    """The multi-block select where every passing key is equal (all rows
    one vector): the k lowest passing rows, ties straddling the blocks'
    position ranges; a query that passes no row (all kNoKey); bit-
    identical to the plain version."""
    rng = np.random.default_rng(k)
    q, n = 4, 100_003
    qv, qb, base, norms, bm = _tie_case(rng, q, n)
    base[:] = base[0]
    norms[:] = norms[0]
    bm[rng.random(n) < 0.3] = 0
    qb[1] = 0x7fff_ffff                # AND/EQUALITY pass no row
    args = _on(cuda, (qv, qb, base, norms, bm))
    for pred in (0, 1, 2):
        gd, gi = mk.masked_topk_large(*args, pred=pred, k=k)
        pd, pi = mk.masked_topk_plain(*args, pred=pred, k=k)
        torch.cuda.synchronize()
        assert torch.equal(gi, pi) and torch.equal(gd, pd), pred


def test_masked_topk_large_kernel_scores_equal_split_kernel(cuda):
    """Random fp32: the k > MAX_K kernels score with the split kernel's
    FMA chain, so the first 128 of a k = 300 answer are the split
    kernel's k = 128 answer bit for bit, and the per-block output at
    k = 200 holds the same scores."""
    rng = np.random.default_rng(3)
    q, n, d, w = 20, 30011, 192, 7
    args = (torch.from_numpy(rng.normal(size=(q, d)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 3, (q, w)).astype(np.int32)),
            torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)),
            None,
            torch.from_numpy(rng.integers(0, 8, (n, w)).astype(np.int32)))
    args = (args[0], args[1], args[2],
            (args[2].double() ** 2).sum(1).float(), args[4])
    args = tuple(a.to(cuda) for a in args)
    for pred in (0, 1, 2):
        gd, gi = mk.masked_topk_accum(*args, pred=pred, k=300)
        sd, si = mk.masked_topk_accum(*args, pred=pred, k=mk.MAX_K)
        torch.cuda.synchronize()
        assert torch.equal(gi[:, :mk.MAX_K], si)
        assert torch.equal(gd[:, :mk.MAX_K], sd)
        bi, bd = ops.masked_topk_multiblock(*args, pred=pred, k=200)
        wi, wd = ops.masked_topk(*args, pred=pred, k=200)
        assert torch.equal(bi, wi) and torch.equal(bd, wd)


def _live_case(rng, q, kb, nd, base_n, ns=None, d=24, w=2):
    """The CPU test's live grid: candidates with −1 ids, NaN, ±inf, past
    PAD_SCORE and ±0.0; one in five rows tombstoned; an optional sel."""
    qv, qb, dvec, dn, dbm = _tie_case(rng, q, max(nd, 1), d, w)
    dvec, dn, dbm = dvec[:nd], dn[:nd], dbm[:nd]
    cd = (rng.integers(-40, 400, (q, kb)) / 4.0).astype(np.float32)
    ci = rng.integers(0, base_n, (q, kb)).astype(np.int32)
    for val, frac in ((np.nan, 0.03), (np.inf, 0.03), (-np.inf, 0.02),
                      (np.float32(3.1e38), 0.02), (np.float32(-0.0), 0.05),
                      (np.float32(0.0), 0.05)):
        cd[rng.random(cd.shape) < frac] = val
    ci[rng.random(ci.shape) < 0.1] = -1
    tomb = rng.random(base_n + nd) < 0.2
    words = np.zeros(-(-(base_n + nd) // 4096) * 128, np.uint32)
    packed = np.packbits(tomb, bitorder="little")
    words.view(np.uint8)[: packed.size] = packed
    sel = None
    if ns is not None:
        sel = np.sort(rng.choice(nd, size=min(ns, nd), replace=False)
                      ).astype(np.int32)
        sel = np.concatenate([sel, np.full(3, -1, np.int32)])
    return qv, qb, cd, ci, dvec, dn, dbm, words, sel


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("q,kb,nd,k,ns", [
    (5, 1, 200, 10, None), (4, 300, 150, 10, None), (7, 3, 64, 41, None),
    (3, 8, 5, 30, None), (6, 20, 0, 10, None), (37, 1016, 5000, 10, None),
    (5, 40, 300, 10, 90), (2, 1, 100, 20, 40), (20, 1016, 70000, 10, 30000),
    (3, 50, 2000, 128, 700), (5, 300, 5000, 200, None),
    (20, 1016, 70000, 200, 30000), (7, 3, 64, 129, None),
    (6, 20, 0, 300, None), (33, 0, 9000, 1500, 6000)])
def test_fused_live_kernel_bitwise_on_grid(cuda, pred, q, kb, nd, k, ns):
    """Both variants (all delta rows; the rows `sel` picks) against the
    plain version on the grid: ids and distance bits, −0.0 included."""
    base_n = 5000
    qv, qb, cd, ci, dvec, dn, dbm, words, sel = _live_case(
        np.random.default_rng(q + kb + nd), q, kb, nd, base_n, ns=ns)
    on = lambda a: torch.from_numpy(
        a.view(np.int32) if a.dtype == np.uint32 else a).to(cuda)
    args = tuple(map(on, (qv, qb, cd, ci, dvec, dn, dbm, words)))
    s = None if sel is None else on(sel)
    before = mk.fused_live_accum.launches
    gd, gi = mk.fused_live_accum(*args, base_n=base_n, sel=s, pred=pred, k=k)
    pd, pi = mk.fused_live_plain(*args, base_n=base_n, sel=s, pred=pred,
                                 k=k)
    torch.cuda.synchronize()
    assert mk.fused_live_accum.launches == before + 1
    assert torch.equal(gi, pi)
    assert torch.equal(gd.view(torch.int32), pd.view(torch.int32))


def test_fused_live_kernel_delta_scores_equal_masked_topk(cuda):
    """Random fp32, no base candidates, no tombstones: the fused kernel's
    delta scores are the masked_topk kernel's bit for bit (one FMA
    chain), so the fused and staged live paths agree exactly."""
    rng = np.random.default_rng(8)
    q, nd, d, w = 40, 20000, 192, 7
    qv = torch.from_numpy(rng.normal(size=(q, d)).astype(np.float32)).to(cuda)
    qb = torch.from_numpy(rng.integers(0, 3, (q, w)).astype(np.int32)).to(cuda)
    dv = torch.from_numpy(rng.normal(size=(nd, d)).astype(np.float32)).to(cuda)
    dn = (dv.double() ** 2).sum(1).float()
    db = torch.from_numpy(rng.integers(0, 8, (nd, w)).astype(np.int32)).to(cuda)
    cand_d = torch.full((q, 1), mk.PAD_SCORE, device=cuda)
    cand_i = torch.full((q, 1), -1, dtype=torch.int32, device=cuda)
    words = torch.zeros(-(-(nd + 10) // 32), dtype=torch.int32, device=cuda)
    for pred in (0, 1, 2):
        for k in (10, 200):
            fd, fi = mk.fused_live_accum(qv, qb, cand_d, cand_i, dv, dn, db,
                                         words, base_n=10, pred=pred, k=k)
            md, mi = mk.masked_topk_accum(qv, qb, dv, dn, db, pred=pred,
                                          k=k)
            torch.cuda.synchronize()
            assert torch.equal(fi, torch.where(mi >= 0, mi + 10, mi))
            assert torch.equal(fd, md)


def test_fused_live_kernel_signed_zero_base_candidates(cuda):
    """k > MAX_K: a caller's −0.0 base candidate ranks before +0.0 (the
    IEEE total order) and keeps its sign bit, as in the plain version."""
    q, kb = 3, 300
    cand_d = torch.full((q, kb), 5.0, device=cuda)
    cand_d[:, 10] = 0.0
    cand_d[:, 20] = -0.0
    cand_i = torch.arange(kb, dtype=torch.int32, device=cuda).repeat(q, 1)
    qv = torch.zeros((q, 8), device=cuda)
    qb = torch.zeros((q, 1), dtype=torch.int32, device=cuda)
    dv = torch.ones((4, 8), device=cuda)
    dn = torch.full((4,), 8.0, device=cuda)
    db = torch.zeros((4, 1), dtype=torch.int32, device=cuda)
    words = torch.zeros(16, dtype=torch.int32, device=cuda)
    for k in (10, 200):
        gd, gi = mk.fused_live_accum(qv, qb, cand_d, cand_i, dv, dn, db,
                                     words, base_n=kb, pred=1, k=k)
        pd, pi = mk.fused_live_plain(qv, qb, cand_d, cand_i, dv, dn, db,
                                     words, base_n=kb, pred=1, k=k)
        torch.cuda.synchronize()
        assert torch.equal(gi, pi)
        assert torch.equal(gd.view(torch.int32), pd.view(torch.int32))
        assert gi[:, 0].tolist() == [20] * q and gi[:, 1].tolist() == [10] * q
        assert torch.signbit(gd[:, 0]).all() and not torch.signbit(gd[:, 1]).any()


def test_graft_on_card_equals_host_graft(cuda):
    """`graft_graph` on the card (beam search, nearest new rows a block at
    a time, prune) against the host graft on the integer grid: the same
    graph, bit for bit."""
    from repro_torch.ann import graph

    v, bm, u = _grid_set(2, n=3000)
    old = graph.build_graph(v[:2500], bm[:2500], u, r=16, seed=2, n_cand=40)
    o2n = np.arange(2500, dtype=np.int64)
    o2n[::7] = -1
    keep = np.nonzero(o2n >= 0)[0]
    o2n[keep] = np.arange(keep.size)
    nv = np.concatenate([v[keep], v[2500:]])
    nbm = np.concatenate([bm[keep], bm[2500:]])
    new_rows = np.arange(keep.size, nv.shape[0])
    host = graph.graft_graph(old, nv, nbm, u, o2n, new_rows, r=16, seed=2,
                             device="cpu")
    card = graph.graft_graph(old, nv, nbm, u, o2n, new_rows, r=16, seed=2,
                             device=cuda)
    np.testing.assert_array_equal(card.neighbors, host.neighbors)
    assert card.medoid == host.medoid
    np.testing.assert_array_equal(card.label_entry, host.label_entry)


def test_sharded_live_on_card_equals_cpu(cuda):
    """`ShardedLiveIndex` over 3 shards on the card (each shard's fused
    read with the chunk pruner, one shard's overfetch past 128, the
    `merge_topk` fold) against the port on the CPU on the integer grid:
    ids and distance bits equal, before and after `compact()`."""
    from repro_torch.ann.dataset import ANNDataset
    from repro_torch.ann.index import QueryBatch
    from repro_torch.ann.live import ShardedLiveIndex

    v, bm, u = _grid_set(4, n=2400, d=24)
    ds = ANNDataset.from_packed("grid", v[:2000], bm[:2000], u)
    rng = np.random.default_rng(5)
    qv = (rng.integers(-6, 7, (40, 24)) / 4.0).astype(np.float32)
    qb = bm[rng.integers(0, 2400, 40)]
    handles = [ShardedLiveIndex(ds, 3, device=dev, delta_chunk=32,
                                delta_prune_min_rows=64)
               for dev in (cuda, "cpu")]
    try:
        for live in handles:
            ids = live.upsert(v[2000:], bm[2000:])
            live.delete(np.concatenate([np.arange(0, 300), ids[::8]]))
        for gen in (0, 1):
            for pred in (0, 1, 2):
                for k in (10, 40):
                    b = QueryBatch(qv, qb, pred, k)
                    got, want = (h.search(b, "prefilter") for h in handles)
                    np.testing.assert_array_equal(got.ids, want.ids)
                    np.testing.assert_array_equal(
                        got.distances.view(np.int32),
                        want.distances.view(np.int32))
            if not gen:
                assert handles[0].stats()["shards"][0]["delta_prune"][
                    "calls"] > 0
                for live in handles:
                    live.compact()
                np.testing.assert_array_equal(handles[0].last_remap(),
                                              handles[1].last_remap())
    finally:
        for live in handles:
            live.close()


# ---- the offline stage on the card against the CPU --------------------------

# A fit on the card and one on the CPU start from the same parameters
# (`init_mlp` draws on the host) and take the same batches; they differ
# only by the rounding of the two devices' fp32 matmuls and reductions,
# which 200 epochs of Adam carry into the predictions. On these smooth,
# noise-free targets that stays far below FIT_TOL (the same fit on the
# CPU against the JAX package's: 2e-6); chip_smoke.py phase 13 (b) holds
# the router's own fit, whose labels make it chaotic in the rounding, by
# its MSE instead.
FIT_TOL = 1e-3
# One sweep's table-B recall on the card against the CPU: ids part only
# where two rows' distances lie within fp32 rounding (and where such a
# tie changed a graph edge of the fvamana build), moving a mean recall
# over the cell's queries by a few of its result slots at most
# (chip_smoke.py phase 13 (a)).
SWEEP_TOL = 0.05


@pytest.mark.parametrize("hidden,classification", [((64, 32), False),
                                                   ((), True)])
def test_train_mlp_on_card_equals_cpu(cuda, hidden, classification):
    from repro_torch.core import mlp

    rng = np.random.default_rng(31)
    x = rng.normal(size=(1080, 5)).astype(np.float32)
    if classification:
        y, n_out = (x[:, 0] > 0).astype(np.int64) + (x[:, 1] > 1), 3
    else:
        y = (1 / (1 + np.exp(-x[:, 0] * x[:, 1]))).astype(np.float32)
        n_out = 1
    kw = dict(hidden=hidden, n_out=n_out, classification=classification,
              epochs=200, seed=5)
    card = mlp.train_mlp(x, y, device=cuda, **kw)
    cpu = mlp.train_mlp(x, y, device="cpu", **kw)
    assert card[0]["w"].device.type == "cuda"
    got, want = mlp.predict(card, x), mlp.predict(cpu, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=FIT_TOL)


def test_collect_on_card_equals_cpu(cuda, monkeypatch):
    """`collect` on the tiny spec, on the card and on the CPU: the same
    features bit for bit (the `selectivity` kernel counts exactly), the
    same queries and ground truth, table B's recalls within SWEEP_TOL.
    The runs' clock is fixed, so recall ties pick the same setting."""
    import itertools

    from repro_torch.ann import bench
    from repro_torch.ann.index import FilteredIndex
    from repro_torch.core import training as T
    from repro_torch.data.ann_synth import DatasetSpec, synthesize

    tick = itertools.count()
    monkeypatch.setattr(bench, "time", type(
        "Clock", (), {"perf_counter": staticmethod(
            lambda: float(next(tick)))}))
    ds = synthesize(DatasetSpec("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5,
                                0.3, 7))
    launches = bf.selectivity_count.launches
    with FilteredIndex(ds) as fxc, FilteredIndex(ds, device="cpu") as fxh:
        card = T.collect({"tiny": fxc}, n_queries=25, verbose=False)
        cpu = T.collect({"tiny": fxh}, n_queries=25, verbose=False)
    assert bf.selectivity_count.launches > launches
    for key, cell in cpu.cells.items():
        got = card.cells[key]
        assert got.numeric.tobytes() == cell.numeric.tobytes(), key
        assert np.array_equal(got.gt, cell.gt)
    assert card.table.entries.keys() == cpu.table.entries.keys()
    worst = max(abs(card.table.entries[k]["recall"] - v["recall"])
                for k, v in cpu.table.entries.items())
    assert worst <= SWEEP_TOL
