"""The port's kernel entry points on the CPU (their plain PyTorch
versions) against the JAX package's oracles (`repro.kernels.ref`) and its
default off-TPU `ops` formulation. The CUDA kernels themselves are held
against these plain versions on the card in `test_torch_cuda_kernels.py`.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import predicates as jpr
from repro.ann.predicates import Predicate
from repro.core.features import _base_selectivity
from repro.ann import topk as jtopk
from repro.kernels import masked_topk as jmk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.ann import topk as ttopk
from repro_torch.ann import labels as tlb
from repro_torch.core import features as tF
from repro_torch.kernels import bitmap_filter as bf
from repro_torch.kernels import masked_topk as mk
from repro_torch.kernels import ops as tops


def _tie_case(rng, q, n, d=24, w=2):
    """`tests/test_kernels.py`'s integer grid: multiples of 1/4 and
    duplicated rows, so every score is exact in fp32 whatever the
    summation order and ties are frequent. Query 0 carries no labels."""
    qv = (rng.integers(-6, 7, (q, d)) / 4.0).astype(np.float32)
    base = (rng.integers(-6, 7, (n, d)) / 4.0).astype(np.float32)
    base[n // 2: n // 2 + n // 4] = base[: n // 4]
    norms = (base.astype(np.float64) ** 2).sum(1).astype(np.float32)
    qb = (rng.integers(0, 2, (q, w)) * rng.integers(1, 8, (q, w))
          ).astype(np.uint32)
    bm = (rng.integers(0, 2, (n, w)) * rng.integers(1, 8, (n, w))
          ).astype(np.uint32)
    qb[0] = 0
    return qv, qb, base, norms, bm


def _torch(case):
    qv, qb, base, norms, bm = case
    return (torch.from_numpy(qv), tlb.bitmap_tensor(qb, "cpu"),
            torch.from_numpy(base), torch.from_numpy(norms),
            tlb.bitmap_tensor(bm, "cpu"))


def _jax(case):
    return tuple(jnp.asarray(a) for a in case)


def _assert_bitwise(ids, dists, want_ids, want_dists):
    ids, dists = np.asarray(ids), np.asarray(dists)
    want_ids, want_dists = np.asarray(want_ids), np.asarray(want_dists)
    np.testing.assert_array_equal(ids, want_ids)
    fin = np.isfinite(want_dists)
    np.testing.assert_array_equal(np.isfinite(dists), fin)
    np.testing.assert_array_equal(dists[fin], want_dists[fin])


# (q, n, k): the cases of tests/test_kernels.py, a ragged N, and k above N
CASES = [(1, 64, 5), (7, 256, 41), (25, 1024, 10), (4, 1001, 10),
         (6, 40, 50)]


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("q,n,k", CASES)
def test_masked_topk_plain_bitwise_on_tie_grid(pred, q, n, k):
    case = _tie_case(np.random.default_rng(q * 31 + n), q, n)
    ids, dists = tops.masked_topk(*_torch(case), pred=pred, k=k)
    _assert_bitwise(ids, dists,
                    *jref.masked_topk_ref(*_jax(case), pred=pred, k=k))
    _assert_bitwise(ids, dists,
                    *jops.masked_topk(*_jax(case), pred=pred, k=k))


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("q,n,k", [(3, 2000, 129), (2, 3001, 1016),
                                   (4, 700, 1016)])
def test_masked_topk_plain_large_k_matches_reference(pred, q, n, k):
    """k past MAX_K (the live path's overfetch: 1,016 at 1,000 deletes and
    k = 10), on the tie grid: bit-identical to the reference's off-TPU
    `ops.masked_topk`, ties to the lowest row, fill past the matches."""
    case = _tie_case(np.random.default_rng(q * 13 + n), q, n)
    ids, dists = tops.masked_topk(*_torch(case), pred=pred, k=k)
    assert ids.shape == (q, k)
    _assert_bitwise(ids, dists,
                    *jops.masked_topk(*_jax(case), pred=pred, k=k))
    d, i = mk.masked_topk_large(*_torch(case), pred=pred, k=k)
    _assert_bitwise(*tops._clean(i, d), ids, dists)


def test_masked_topk_raw_sentinels():
    """The raw output keeps the TPU kernel's fill: (PAD_SCORE, -1) past
    the match count; `ops.masked_topk` turns it into (-1, +inf)."""
    case = _tie_case(np.random.default_rng(0), 3, 50)
    case[4][:] = 0
    case[4][:4] = 1
    qb = case[1]
    qb[:] = 1
    d, i = mk.masked_topk_accum(*_torch(case), pred=1, k=6)
    assert (i[:, :4] >= 0).all() and (i[:, 4:] == -1).all()
    assert (d[:, 4:] == mk.PAD_SCORE).all()
    ids, dists = tops.masked_topk(*_torch(case), pred=1, k=6)
    assert torch.isinf(dists[:, 4:]).all() and (ids[:, 4:] == -1).all()


@pytest.mark.parametrize("pred", [0, 1, 2])
def test_masked_topk_plain_random_floats(pred):
    """Random fp32: the port's matmul and XLA's sum in different orders.
    Two fp32 sums of D products differ by at most about 2·D·u·Σ|q_i·v_i|
    (u = 2^-24) <= 2·D·u·‖q‖·‖v‖, so scores agree to
    tol = 2·D·u·max(‖v‖² + 2‖q‖‖v‖). Every returned id passes the
    predicate, is returned once and carries its own score (float64 score
    of that row within tol), and ids may differ only where the float64
    scores of both ids lie within tol of each other."""
    rng = np.random.default_rng(10 + pred)
    q, n, d, w, k = 9, 3000, 48, 3, 10
    qv = rng.normal(size=(q, d)).astype(np.float32)
    base = rng.normal(size=(n, d)).astype(np.float32)
    norms = (base.astype(np.float64) ** 2).sum(1).astype(np.float32)
    bm = (rng.integers(0, 16, (n, w))).astype(np.uint32)
    qb = bm[rng.integers(0, n, q)] & rng.integers(0, 16, (q, w)).astype(
        np.uint32)
    if pred == 2:
        qb |= np.uint32(1)
    case = (qv, qb, base, norms, bm)
    ids, dists = tops.masked_topk(*_torch(case), pred=pred, k=k)
    want_ids, want_d = map(np.asarray, jref.masked_topk_ref(
        *_jax(case), pred=pred, k=k))
    vn, qn = np.sqrt(norms.max()), np.linalg.norm(qv, axis=1).max()
    tol = 2 * d * 2.0 ** -24 * (vn * vn + 2 * qn * vn)
    ids, dists = ids.numpy(), dists.numpy()
    np.testing.assert_array_equal(ids < 0, want_ids < 0)
    real = want_ids >= 0
    assert np.abs(dists[real] - want_d[real]).max() <= tol
    exact = (norms[None].astype(np.float64)
             - 2.0 * qv.astype(np.float64) @ base.T.astype(np.float64))
    rows = np.arange(q)[:, None]
    got_s, want_s = exact[rows, np.maximum(ids, 0)], exact[rows, want_ids]
    assert (np.abs(got_s - dists)[real] <= tol).all()
    differ = (ids != want_ids) & real
    assert (np.abs(got_s - want_s)[differ] <= tol).all()
    passes = jpr.eval_predicate_np(bm[np.maximum(ids, 0)], qb[:, None], pred)
    assert passes[real].all()
    for row, ok in zip(ids, real):
        assert len(set(row[ok].tolist())) == int(ok.sum())


@pytest.mark.parametrize("pred", [0, 1, 2])
def test_selectivity_plain_exact(pred, tiny_ds, tiny_queries):
    qbms = tiny_queries[Predicate(pred)].bitmaps.copy()
    qbms[0] = 0                                  # an empty label set
    counts = bf.selectivity_plain(tlb.bitmap_tensor(qbms, "cpu"),
                                  tlb.bitmap_tensor(tiny_ds.bitmaps, "cpu"),
                                  pred=pred).numpy()
    assert counts.dtype == np.int32
    np.testing.assert_array_equal(counts, np.asarray(jref.selectivity_ref(
        jnp.asarray(qbms), jnp.asarray(tiny_ds.bitmaps), pred=pred)))
    frac = _base_selectivity(tiny_ds, qbms, pred)
    np.testing.assert_array_equal(counts.astype(np.float64) / tiny_ds.n,
                                  frac)
    np.testing.assert_array_equal(np.rint(frac * tiny_ds.n), counts)
    np.testing.assert_array_equal(
        tF.batch_selectivity(tiny_ds, qbms, pred), frac)
    np.testing.assert_array_equal(
        tops.selectivity(tlb.bitmap_tensor(qbms, "cpu"),
                         tlb.bitmap_tensor(tiny_ds.bitmaps, "cpu"),
                         pred=pred).numpy(), counts)


def test_masked_topk_rejects_what_the_kernel_does_not_take():
    case = _tie_case(np.random.default_rng(2), 4, 64)
    args = _torch(case)
    # k past MAX_K is taken, as the reference takes it (here k > N too)
    want = jops.masked_topk(*_jax(case), pred=1, k=mk.MAX_K + 1)
    d, i = mk.masked_topk_accum(*args, pred=1, k=mk.MAX_K + 1)
    _assert_bitwise(*tops._clean(i, d), *want)
    _assert_bitwise(*tops.masked_topk(*args, pred=1, k=mk.MAX_K + 1), *want)
    with pytest.raises(ValueError):
        mk.masked_topk_accum(*args, pred=1, k=0)
    assert mk.masked_topk_accum(*args, pred=1, k=mk.MAX_K)[0].shape == \
        (4, mk.MAX_K)
    with pytest.raises(TypeError, match="bfloat16"):
        mk.masked_topk_accum(args[0].half(), args[1], args[2].half(),
                             *args[3:], pred=1, k=5)
    with pytest.raises(TypeError, match="one type"):
        mk.masked_topk_accum(args[0].bfloat16(), *args[1:], pred=1, k=5)
    with pytest.raises(TypeError, match="norms"):
        mk.masked_topk_accum(*args[:3], args[3].bfloat16(), args[4],
                             pred=1, k=5)
    with pytest.raises(TypeError, match="int32"):
        mk.masked_topk_accum(args[0], args[1].long(), *args[2:], pred=1,
                             k=5)
    with pytest.raises(ValueError, match="shape"):
        mk.masked_topk_accum(args[0], args[1], args[2][:10], *args[3:],
                             pred=1, k=5)
    with pytest.raises(ValueError, match="pred"):
        mk.masked_topk_accum(*args, pred=3, k=5)


def test_selectivity_rejects_what_the_kernel_does_not_take():
    qb = tlb.bitmap_tensor(np.ones((3, 2), np.uint32), "cpu")
    bm = tlb.bitmap_tensor(np.ones((9, 2), np.uint32), "cpu")
    with pytest.raises(TypeError):
        bf.selectivity_count(qb.long(), bm, pred=0)
    with pytest.raises(ValueError, match="word widths"):
        bf.selectivity_count(qb[:, :1].contiguous(), bm, pred=0)
    with pytest.raises(ValueError, match="pred"):
        bf.selectivity_count(qb, bm, pred=5)
    assert bf.selectivity_count(qb, bm, pred=0).tolist() == [9, 9, 9]


def test_stable_topk_ties_go_to_lowest_position():
    s = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0, mk.PAD_SCORE]])
    ids = torch.arange(6, dtype=torch.int32)[None]
    d, i = mk.stable_topk_raw(s, ids, 8)
    assert i.tolist() == [[1, 2, 4, 3, 0, -1, -1, -1]]
    assert d[0, :5].tolist() == [1.0, 1.0, 1.0, 2.0, 3.0]


def test_stable_topk_scores_past_pad_score_come_back_as_pad():
    """+inf, NaN and scores past PAD_SCORE rank after every real score and
    come back as (PAD_SCORE, -1), as the kernel's merge returns them."""
    s = torch.tensor([[math.inf, 2.0, math.nan, 3.2e38, -1.0, mk.PAD_SCORE]])
    ids = torch.arange(6, dtype=torch.int32)[None]
    d, i = mk.stable_topk_raw(s, ids, 7)
    assert i.tolist() == [[4, 1, -1, -1, -1, -1, -1]]
    assert d[0, :2].tolist() == [-1.0, 2.0]
    assert bool((d[0, 2:] == mk.PAD_SCORE).all())


# ---------------------------------------------------------------------------
# bf16 inputs to masked_topk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("q,n,k", [(7, 256, 41), (25, 1024, 10)])
def test_masked_topk_bf16_tie_grid_bitwise(pred, q, n, k):
    """The integer grid (multiples of 1/4 up to 1.5) is exact in bf16, and
    so is every product and sum: bf16 inputs give the float32 result bit
    for bit, and the JAX package's bf16 result."""
    case = _tie_case(np.random.default_rng(q + n), q, n)
    t32 = _torch(case)
    t16 = (t32[0].bfloat16(), t32[1], t32[2].bfloat16(), *t32[3:])
    ids, dists = tops.masked_topk(*t16, pred=pred, k=k)
    _assert_bitwise(ids, dists, *tops.masked_topk(*t32, pred=pred, k=k))
    j = _jax(case)
    j16 = (j[0].astype(jnp.bfloat16), j[1], j[2].astype(jnp.bfloat16),
           *j[3:])
    _assert_bitwise(ids, dists, *jops.masked_topk(*j16, pred=pred, k=k))


def test_masked_topk_bf16_random_matches_reference():
    """`tests/test_kernels.py::test_masked_topk_dtypes`'s case: random
    normal vectors cast to bf16, OR, k = 5, against `ref.masked_topk_ref`
    on the same bf16 values. bf16 x bf16 products are exact in fp32, so
    the two differ only by summation order: ids as sets, scores within
    2·D·u·max(‖v‖² + 2‖q‖‖v‖) (u = 2^-24)."""
    rng = np.random.default_rng(0)
    q, n, d, w = 8, 1024, 64, 2
    qv = rng.normal(size=(q, d)).astype(np.float32)
    base = rng.normal(size=(n, d)).astype(np.float32)
    norms = (base.astype(np.float64) ** 2).sum(1).astype(np.float32)
    bm = (rng.random((n, w, 32)) < 0.1)
    bm = (bm * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(
        np.uint32)
    qb = (rng.random((q, w, 32)) < 0.05)
    qb = (qb * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(
        np.uint32)
    j = _jax((qv, qb, base, norms, bm))
    rids, rd = map(np.asarray, jref.masked_topk_ref(
        j[0].astype(jnp.bfloat16), j[1], j[2].astype(jnp.bfloat16), *j[3:],
        pred=2, k=5))
    t = _torch((qv, qb, base, norms, bm))
    ids, dists = tops.masked_topk(t[0].bfloat16(), t[1], t[2].bfloat16(),
                                  *t[3:], pred=2, k=5)
    ids, dists = ids.numpy(), dists.numpy()
    for a, b in zip(ids, rids):
        assert set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
    q16 = t[0].bfloat16().float().numpy()
    b16 = t[2].bfloat16().float().numpy()
    vn = np.sqrt(norms.max())
    tol = 2 * d * 2.0 ** -24 * (vn * vn + 2 * np.linalg.norm(q16, axis=1)
                                .max() * np.linalg.norm(b16, axis=1).max())
    real = rids >= 0
    assert np.abs(dists[real] - rd[real]).max() <= tol


# ---------------------------------------------------------------------------
# the per-block variant and its entry point
# ---------------------------------------------------------------------------

# (q, n, bn, k): blocks of the reference kernel (q a multiple of bq = 8,
# n of bn), one with k above the block size
BLOCK_CASES = [(8, 512, 128, 10), (16, 256, 64, 41), (8, 64, 16, 20)]


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("q,n,bn,k", BLOCK_CASES)
def test_masked_topk_blocks_plain_bitwise_on_tie_grid(pred, q, n, bn, k):
    """Raw [NB, Q, k] against the reference's `masked_topk_blocks` in
    interpret mode (its `_block_kernel`): bit-identical, (PAD_SCORE, −1)
    past each block's matches."""
    case = _tie_case(np.random.default_rng(q * 13 + n + k), q, n)
    want_d, want_i = jmk.masked_topk_blocks(*_jax(case), pred=pred, k=k,
                                            bq=8, bn=bn, interpret=True)
    d, i = mk.masked_topk_blocks(*_torch(case), pred=pred, k=k, bn=bn)
    assert d.shape == i.shape == (n // bn, q, k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(d.numpy().view(np.int32),
                                  np.asarray(want_d).view(np.int32))


def test_masked_topk_blocks_plain_random_floats():
    """Random fp32: ids equal the reference's, scores agree to fp32
    summation order (2·D·u·max(‖v‖² + 2‖q‖‖v‖), u = 2^-24), fill
    identical. A ragged last block (N = 1000, bn = 256) compares with the
    reference's rows padded to 1024 with PAD_SCORE norms, as its wrapper
    pads them."""
    rng = np.random.default_rng(5)
    q, n, d, w, bn, k = 8, 1000, 32, 2, 256, 10
    qv = rng.normal(size=(q, d)).astype(np.float32)
    base = rng.normal(size=(n, d)).astype(np.float32)
    norms = (base.astype(np.float64) ** 2).sum(1).astype(np.float32)
    bm = rng.integers(0, 8, (n, w)).astype(np.uint32)
    qb = rng.integers(0, 8, (q, w)).astype(np.uint32)
    pad = 1024 - n
    padded = (qv, qb, np.concatenate([base, np.zeros((pad, d), np.float32)]),
              np.concatenate([norms, np.full(pad, jmk.PAD_SCORE,
                                             np.float32)]),
              np.concatenate([bm, np.zeros((pad, w), np.uint32)]))
    tol = 2 * d * 2.0 ** -24 * (norms.max() + 2 * np.sqrt(
        norms.max() * (qv ** 2).sum(1).max()))
    for pred in (0, 1, 2):
        want_d, want_i = map(np.asarray, jmk.masked_topk_blocks(
            *_jax(padded), pred=pred, k=k, bq=8, bn=bn, interpret=True))
        dd, ii = mk.masked_topk_blocks(*_torch((qv, qb, base, norms, bm)),
                                       pred=pred, k=k, bn=bn)
        np.testing.assert_array_equal(ii.numpy(), want_i)
        real = want_i >= 0
        np.testing.assert_array_equal(dd.numpy()[~real], want_d[~real])
        assert np.abs(dd.numpy()[real] - want_d[real]).max(initial=0) <= tol


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("q,n,bn,k", BLOCK_CASES + [(5, 1001, 256, 10)])
def test_masked_topk_multiblock_matches_reference(pred, q, n, bn, k):
    """`ops.masked_topk_multiblock` against the reference's (bitwise on
    the tie grid) and against `ops.masked_topk`."""
    case = _tie_case(np.random.default_rng(q + n * 3 + k), q, n)
    ids, dists = tops.masked_topk_multiblock(*_torch(case), pred=pred, k=k,
                                             bn=bn)
    _assert_bitwise(ids, dists, *jops.masked_topk_multiblock(
        *_jax(case), pred=pred, k=k, bn=bn))
    want_i, want_d = tops.masked_topk(*_torch(case), pred=pred, k=k)
    assert torch.equal(ids, want_i) and torch.equal(dists, want_d)


def test_masked_topk_blocks_rejects():
    case = _tie_case(np.random.default_rng(2), 4, 64)
    args = _torch(case)
    with pytest.raises(ValueError, match="blocks"):
        mk.masked_topk_blocks(*args, pred=1, k=5, bn=0)
    with pytest.raises(ValueError, match="blocks"):
        mk.masked_topk_blocks(*args[:2], args[2][:0], args[3][:0],
                              args[4][:0], pred=1, k=5)
    # k past MAX_K is taken and answers as the reference does (k > bn too)
    k = mk.MAX_K + 1
    d, i = mk.masked_topk_blocks(*args, pred=1, k=k, bn=16)
    assert d.shape == i.shape == (4, 4, k)
    _assert_bitwise(*tops.masked_topk_multiblock(*args, pred=1, k=k, bn=16),
                    *jops.masked_topk_multiblock(*_jax(case), pred=1, k=k,
                                                 bn=16))


# ---------------------------------------------------------------------------
# cross-shard merge
# ---------------------------------------------------------------------------

def _merge_case(rng, s, q, k, frac_valid=0.7):
    """`tests/test_kernels.py::_merge_case`: per-shard sorted candidates,
    disjoint ids, a random invalid suffix per (shard, query) row."""
    d = np.sort(np.abs(rng.normal(size=(s, q, k))).astype(np.float32), -1)
    ids = np.arange(s * q * k, dtype=np.int32).reshape(s, q, k)
    nval = rng.binomial(k, frac_valid, size=(s, q))
    for si in range(s):
        for qi in range(q):
            d[si, qi, nval[si, qi]:] = np.inf
            ids[si, qi, nval[si, qi]:] = -1
    return ids, d


def _assert_merge_alike(ids, d, k=None):
    """Port and JAX `merge_topk` on the same arrays: the same ids and the
    same distance bits."""
    gi, gd = tops.merge_topk(torch.from_numpy(ids), torch.from_numpy(d),
                             k=k)
    ri, rd = jops.merge_topk(jnp.asarray(ids), jnp.asarray(d), k=k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gd.numpy().view(np.int32),
                                  np.asarray(rd).view(np.int32))
    return gi.numpy(), gd.numpy()


@pytest.mark.parametrize("s,q,k", [(1, 8, 10), (2, 17, 10), (4, 33, 5),
                                   (8, 8, 16)])
def test_merge_topk_matches_reference(s, q, k):
    ids, d = _merge_case(np.random.default_rng(s * 100 + q), s, q, k)
    _assert_merge_alike(ids, d)
    _assert_merge_alike(ids, d, k=3)


def test_merge_topk_invalid_rows_and_fewer_than_k():
    rng = np.random.default_rng(1)
    ids, d = _merge_case(rng, 3, 9, 8)
    ids[:, 4, :] = -1
    d[:, 4, :] = np.inf
    gi, gd = _assert_merge_alike(ids, d)
    assert (gi[4] == -1).all() and np.isinf(gd[4]).all()
    ids, d = _merge_case(rng, 2, 6, 10, frac_valid=0.15)
    gi, _ = _assert_merge_alike(ids, d)
    np.testing.assert_array_equal((gi >= 0).sum(1), np.minimum(
        (ids >= 0).sum(axis=(0, 2)), 10))
    gi, gd = _assert_merge_alike(np.full((2, 7, 6), -1, np.int32),
                                 np.full((2, 7, 6), np.inf, np.float32), k=5)
    assert (gi == -1).all() and np.isinf(gd).all()


@pytest.mark.parametrize("s", [1, 3])
def test_merge_topk_k_exceeds_candidate_width(s):
    ids, d = _merge_case(np.random.default_rng(s), s, 9, 4)
    gi, _ = _assert_merge_alike(ids, d, k=10)
    assert gi.shape == (9, 10)
    np.testing.assert_array_equal((gi >= 0).sum(1), np.minimum(
        (ids >= 0).sum(axis=(0, 2)), 10))


def test_merge_topk_single_shard_unsorted():
    """S = 1 with unsorted candidates and invalid slots mid-row."""
    rng = np.random.default_rng(3)
    d = np.abs(rng.normal(size=(1, 11, 8))).astype(np.float32)
    ids = rng.permutation(11 * 8).astype(np.int32).reshape(1, 11, 8)
    d[0, :, 3] = np.inf
    ids[0, :, 5] = -1
    _assert_merge_alike(ids, d)


def _staged_case(rng, s, q, kk, dead=0.35):
    """The staged live read's fold (`LiveFilteredIndex._run_staged`): a
    base overfetch of kk ascending candidates whose tombstoned rows are
    (−1, +inf) holes mid-list, and for s = 2 a delta top-k half as wide
    with a tail of (−1, +inf) pads, padded to kk as `stack_candidates`
    pads it. Distances on a coarse grid, so ties straddle the lists."""
    def grid(n):
        return np.sort(np.round(np.abs(rng.normal(size=(q, n))), 1)
                       .astype(np.float32), 1)
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
    return np.stack(ids), np.stack(d)


@pytest.mark.parametrize("s,kk,k", [(1, 416, 10), (1, 1016, 1),
                                    (1, 1100, 129), (1, 300, 301),
                                    (2, 1016, 10), (2, 200, 1),
                                    (2, 520, 129), (2, 256, 600)])
def test_merge_topk_staged_lists(s, kk, k):
    """The staged read's kinds of input: S = 1 or 2 lists of hundreds to
    a thousand candidates with holes, at k = 1, 10, 129 and past S·K."""
    ids, d = _staged_case(np.random.default_rng(s * 1000 + kk + k), s, 6,
                          kk)
    gi, _ = _assert_merge_alike(ids, d, k=k)
    np.testing.assert_array_equal((gi >= 0).sum(1), np.minimum(
        (ids >= 0).sum(axis=(0, 2)), k))


@pytest.mark.parametrize("s,q,kk,k", [(2, 8, 10, 10), (3, 25, 41, 10),
                                      (5, 64, 10, 41), (1, 6, 7, 7)])
def test_merge_topk_ties_signed_zeros_nan(s, q, kk, k):
    """A coarse grid of distances (ties across and within shards), ids
    that repeat, a third of the slots at +0.0 or −0.0, and NaN, ±inf,
    and values past PAD_SCORE. `jax.lax.top_k` ranks −0.0 before +0.0,
    then by position (shard, then slot); the port gives the same ids and
    the same bits."""
    rng = np.random.default_rng(s * 7 + kk)
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
    _, gd = _assert_merge_alike(ids, d, k=k)
    assert (gd == 0).any()


def test_merge_topk_signed_zero_order():
    """−0.0 ranks before +0.0 within a shard and across shards; equal
    keys go to the earlier shard, then the earlier slot."""
    d = np.array([[[0.0, -0.0, 1.0]], [[-0.0, 0.0, -1.0]]], np.float32)
    ids = np.array([[[10, 11, 12]], [[20, 21, 22]]], np.int32)
    gi, gd = _assert_merge_alike(ids, d, k=6)
    assert gi.tolist() == [[22, 11, 20, 10, 21, 12]]
    assert np.signbit(gd[0]).tolist() == [True, True, True, False, False,
                                          False]


def test_merge_topk_plain_raw_fill():
    """The raw plain version keeps the kernel's fill: (PAD_SCORE, −1)."""
    d = torch.tensor([[[2.0, float("nan"), 1.0]], [[0.5, 4e38, 3.0]]])
    ids = torch.tensor([[[7, 8, -1]], [[9, 10, 11]]], dtype=torch.int32)
    od, oi = mk.merge_topk_plain(d, ids, k=6)
    assert oi.tolist() == [[9, 7, 11, -1, -1, -1]]
    assert od[0, :3].tolist() == [0.5, 2.0, 3.0]
    assert (od[0, 3:] == mk.PAD_SCORE).all()


def test_merge_topk_rejects():
    d = torch.zeros((2, 3, 4))
    i = torch.zeros((2, 3, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        mk.merge_topk_accum(d.double(), i, k=2)
    with pytest.raises(ValueError, match=r"\[S, Q, K\]"):
        mk.merge_topk_accum(d[0], i[0], k=2)
    # k past MAX_K is taken and answers as the reference does
    ids, dd = _merge_case(np.random.default_rng(7), 2, 3, 4)
    gi, gd = _assert_merge_alike(ids, dd, k=mk.MAX_K + 1)
    assert gi.shape == (3, mk.MAX_K + 1) and (gi[:, 8:] == -1).all()


# ---------------------------------------------------------------------------
# topk_ids(dedup=True) and the two-set merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dedup", [False, True])
def test_topk_ids_matches_reference(dedup):
    """Duplicate ids, ties, −1 pads, invalid slots and ±0.0 scores: the
    same ids and score bits as the JAX package's `topk_ids`."""
    rng = np.random.default_rng(8)
    q, c, k = 12, 30, 9
    s = np.round(rng.normal(size=(q, c)), 1).astype(np.float32)
    s[rng.random((q, c)) < 0.2] = np.float32(-0.0)
    ids = rng.integers(0, 12, (q, c)).astype(np.int32)
    ids[rng.random((q, c)) < 0.1] = -1
    valid = rng.random((q, c)) < 0.9
    gi, gs = ttopk.topk_ids(torch.from_numpy(s), torch.from_numpy(ids), k,
                            valid=torch.from_numpy(valid), dedup=dedup)
    ri, rs = jtopk.topk_ids(jnp.asarray(s), jnp.asarray(ids), k,
                            valid=jnp.asarray(valid), dedup=dedup)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gs.numpy().view(np.int32),
                                  np.asarray(rs).view(np.int32))


def test_topk_merge_matches_reference():
    rng = np.random.default_rng(9)
    args = []
    for _ in range(2):
        i = rng.integers(0, 20, (6, 8)).astype(np.int32)
        i[rng.random(i.shape) < 0.15] = -1
        args += [i, np.round(rng.normal(size=(6, 8)), 1).astype(np.float32)]
    for k in (5, 16):
        gi, gs = ttopk.merge_topk(*map(torch.from_numpy, args), k)
        ri, rs = jtopk.merge_topk(*map(jnp.asarray, args), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gs.numpy().view(np.int32),
                                      np.asarray(rs).view(np.int32))


# ---------------------------------------------------------------------------
# fused live read
# ---------------------------------------------------------------------------

def _live_case(rng, q, kb, nd, base_n, grid=True, ns=None, d=24, w=2):
    """Queries, base candidates and a delta mirror with tombstones in both.
    On the grid (multiples of 1/4, duplicated rows) every score is exact
    in fp32 and ties are frequent. Candidates carry −1 ids, NaN, ±inf,
    values past PAD_SCORE, ±0.0 and repeated grid values; one in five
    base and delta rows is tombstoned. `ns` adds a pruner-style `sel`
    (sorted rows, −1 pads)."""
    qv, qb, dvec, dn, dbm = _tie_case(rng, q, max(nd, 1), d, w)
    if not grid:
        qv = rng.normal(size=qv.shape).astype(np.float32)
        dvec = rng.normal(size=dvec.shape).astype(np.float32)
        dn = (dvec.astype(np.float64) ** 2).sum(1).astype(np.float32)
    dvec, dn, dbm = dvec[:nd], dn[:nd], dbm[:nd]
    cd = (rng.integers(-40, 400, (q, kb)) / 4.0).astype(np.float32)
    if not grid:
        cd = rng.normal(scale=20.0, size=(q, kb)).astype(np.float32)
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
    return qv, qb, ci, cd, dvec, dn, dbm, words, sel


def _live_both(case, base_n, pred, k):
    """(port, reference) results of fused_live_topk(_select)."""
    qv, qb, ci, cd, dvec, dn, dbm, words, sel = case
    t = (torch.from_numpy(qv), tlb.bitmap_tensor(qb, "cpu"),
         torch.from_numpy(ci), torch.from_numpy(cd), torch.from_numpy(dvec),
         torch.from_numpy(dn), tlb.bitmap_tensor(dbm, "cpu"))
    tw = tlb.bitmap_tensor(words, "cpu")
    j = tuple(jnp.asarray(a) for a in (qv, qb, ci, cd, dvec, dn, dbm))
    jw = jnp.asarray(words)
    if sel is None:
        got = tops.fused_live_topk(*t, base_n, tw, pred=pred, k=k)
        want = jops.fused_live_topk(*j, np.int32(base_n), jw, pred=pred, k=k)
    else:
        got = tops.fused_live_topk_select(*t, torch.from_numpy(sel), base_n,
                                          tw, pred=pred, k=k)
        want = jops.fused_live_topk_select(*j, jnp.asarray(sel),
                                           np.int32(base_n), jw, pred=pred,
                                           k=k)
    return got, want


# (q, kb, nd, k, ns): KB = 0, KB >> k, KB < k, k past every candidate,
# an empty delta, and a pruner's sel with pads
LIVE_CASES = [(5, 0, 200, 10, None), (4, 300, 150, 10, None),
              (7, 3, 64, 41, None), (3, 8, 5, 30, None), (6, 20, 0, 10, None),
              (5, 40, 300, 10, 90), (2, 0, 100, 20, 40)]


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("q,kb,nd,k,ns", LIVE_CASES)
def test_fused_live_plain_bitwise_on_grid(pred, q, kb, nd, k, ns):
    """On the grid the port's fused live read is the reference's off-TPU
    `ops.fused_live_topk(_select)` bit for bit: the candidate cleanup
    (−1, NaN, ±inf, past PAD_SCORE, tombstones), the delta mask, the
    fold order (base first; −0.0 before +0.0), the fill and the pads."""
    base_n = 500
    case = _live_case(np.random.default_rng(q * 7 + kb + nd), q, kb, nd,
                      base_n, ns=ns)
    (ids, dists), want = _live_both(case, base_n, pred, k)
    assert ids.shape == (q, k) and ids.dtype == torch.int32
    _assert_bitwise(ids, dists, *want)
    np.testing.assert_array_equal(
        np.signbit(dists.numpy()), np.signbit(np.asarray(want[1])))


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("ns", [None, 120])
def test_fused_live_plain_random_floats(pred, ns):
    """Random floats: ids equal, distances to fp32 rounding (the port's
    matmul and XLA's sum the delta dots in different orders; the scale
    keeps every gap between neighbours far above that rounding)."""
    base_n = 400
    case = _live_case(np.random.default_rng(40 + pred), 6, 200, 300,
                      base_n, grid=False, ns=ns, d=32)
    (ids, dists), (want_i, want_d) = _live_both(case, base_n, pred, 10)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(dists.numpy(), np.asarray(want_d),
                               rtol=1e-5, atol=1e-4)


def test_tombstone_bits_plain_matches_reference():
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2 ** 32, 4, dtype=np.uint64).astype(np.uint32)
    ids = np.array([-1, 0, 5, 31, 32, 63, 127, 128, 500], np.int32)
    got = mk.tombstone_bits_plain(tlb.bitmap_tensor(words, "cpu"),
                                  torch.from_numpy(ids)).numpy()
    want = np.asarray(jmk._tombstone_bits(jnp.asarray(words),
                                          jnp.asarray(ids)))
    np.testing.assert_array_equal(got, want)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    np.testing.assert_array_equal(got[1:7], bits[ids[1:7]].astype(bool))


def test_fused_live_rejects():
    case = _live_case(np.random.default_rng(1), 2, 5, 20, 50)
    qv, qb, ci, cd, dvec, dn, dbm, words, _ = case
    args = (torch.from_numpy(qv), tlb.bitmap_tensor(qb, "cpu"),
            torch.from_numpy(cd), torch.from_numpy(ci),
            torch.from_numpy(dvec), torch.from_numpy(dn),
            tlb.bitmap_tensor(dbm, "cpu"), tlb.bitmap_tensor(words, "cpu"))
    # k past MAX_K is taken and answers as the reference does
    (ids, dists), want = _live_both(case, 50, 0, mk.MAX_K + 1)
    assert ids.shape == (2, mk.MAX_K + 1)
    _assert_bitwise(ids, dists, *want)
    with pytest.raises(ValueError, match="pred"):
        mk.fused_live_accum(*args, base_n=50, pred=3, k=5)
    with pytest.raises(TypeError, match="float32"):
        mk.fused_live_accum(args[0].double(), *args[1:], base_n=50, pred=0,
                            k=5)
    with pytest.raises(ValueError, match="shape"):
        mk.fused_live_accum(*args[:7], args[7][:0], base_n=50, pred=0, k=5)
