"""The port's kernel entry points on the CPU (their plain PyTorch
versions) against the JAX package's oracles (`repro.kernels.ref`) and its
default off-TPU `ops` formulation. The CUDA kernels themselves are held
against these plain versions on the card in `test_torch_cuda_kernels.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import predicates as jpr
from repro.ann.predicates import Predicate
from repro.core.features import _base_selectivity
from repro.kernels import ops as jops
from repro.kernels import ref as jref
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
    args = _torch(_tie_case(np.random.default_rng(2), 4, 64))
    with pytest.raises(ValueError, match=str(mk.MAX_K)):
        mk.masked_topk_accum(*args, pred=1, k=mk.MAX_K + 1)
    with pytest.raises(ValueError, match=str(mk.MAX_K)):
        tops.masked_topk(*args, pred=1, k=mk.MAX_K + 1)
    with pytest.raises(ValueError):
        mk.masked_topk_accum(*args, pred=1, k=0)
    assert mk.masked_topk_accum(*args, pred=1, k=mk.MAX_K)[0].shape == \
        (4, mk.MAX_K)
    with pytest.raises(TypeError, match="bf16"):
        mk.masked_topk_accum(args[0].bfloat16(), *args[1:], pred=1, k=5)
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
